"""Structured precode replay on torch tensors: D [M_pad, t] -> C [L, t].

Counterpart of `nanorq_tpu.ops.replay` (`_replay_jit`), running the same
`DeviceSchedule` (precode/device_schedule.py) stage by stage:

  1. y = D[piv_rows];  z = T^-1 y   chunked triangular solve
  2. zsel = D[sel_rows] ^ B_sel z  (^ HDPC: mhd (x) z, placed by hd_sel)
  3. x_u = Vinv (x) zsel
  4. x_a = z ^ Wut x_u
  5. C = concat(x_a, x_u)[out_sel]

Every gather is kernel K1 (`ops/kernels.gather_xor`), the chunk inverses and
Wut are K2 (`gf2_matmul`, on the packed bits as stored) and HDPC and Vinv are
K3 (`gf256_matmul`, on the raw byte matrices).  PyTorch runs eagerly, so the
TPU program's `lax.scan` over chunks is a Python loop, and the replay updates
buffers it owns in place where JAX had to copy.
"""

import numpy as np
import torch

from nanorq_tpu.precode.device_schedule import DeviceSchedule
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops.kernels import gather_xor, gf2_matmul, gf256_matmul


def _idx(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Index array -> int32 tensor (schedules store uint16 where it fits;
    torch's uint16 supports few ops, and the gather kernel reads int32).
    Always a copy, so a CPU tensor never aliases a read-only array."""
    return torch.from_numpy(np.array(a, np.int32)).to(dev)


def _col(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """1-D row selector -> [n, 1] int32, a width-1 gather."""
    return _idx(np.asarray(a).reshape(-1, 1), dev)


def _u8(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)


def device_arrays(ds: DeviceSchedule, device) -> dict:
    """A DeviceSchedule's tensors on `device`, cached on the schedule.

    The cache lives under the port's own attribute (`_torch_arrays`, keyed
    by device), apart from the JAX executor's `_dev_arrays`.
    """
    dev = resolve(device)
    cache = ds.__dict__.setdefault("_torch_arrays", {})
    arr = cache.get(dev)
    if arr is not None:
        return arr
    arr = {
        "Lpad": ds.Lpad,
        "CB": ds.CB,
        "u_pad": ds.u_pad,
        "piv_rows": _col(ds.piv_rows, dev),
        "tri": [
            {
                "q0": seg.q0,
                "tinv": _u8(seg.tinv, dev),  # [nq, CB, CB/8], packed as stored
                "ranges": [(a, b, _idx(ix, dev)) for a, b, ix in seg.ranges],  # ix [nq, b-a, w]
            }
            for seg in ds.tri
        ],
        "sel_rows": _col(ds.sel_rows, dev),
        "bsel_passes": [_idx(p, dev) for p in ds.bsel.passes],
        "bsel_overflow": [(_idx(ix, dev), _col(sel, dev)) for ix, sel in ds.bsel.overflow],
        "hd_sel": None if ds.mhd is None else _col(ds.hd_sel, dev),
        "mhd": None if ds.mhd is None else _u8(ds.mhd, dev),  # [H_pad, Lpad] bytes
        "vinv": _u8(ds.vinv, dev),  # [u_pad, u_pad] bytes
        "wut": _u8(ds.wut, dev),  # [Lpad, u_pad/8], packed as stored
        "out_sel": _col(ds.out_sel, dev),
    }
    cache[dev] = arr
    return arr


def take_rows(src: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """src[rows] for rows [n, 1] int32 (a width-1 K1 gather)."""
    return gather_xor(src, rows)


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(1, x.shape[1])], dim=0)


def _select_rows(red: torch.Tensor, sel: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out ^= red_ext[sel], red_ext = red plus a zero row (sentinel len(red))."""
    return gather_xor(_with_zero_row(red), sel, out=out)


def _apply_plan(src_ext: torch.Tensor, passes, overflow, base: torch.Tensor) -> torch.Tensor:
    """base ^= the GatherPlan applied to src_ext (last row zero), in place."""
    for p in passes:
        gather_xor(src_ext, p, out=base)
    for ix, sel in overflow:
        _select_rows(gather_xor(src_ext, ix), sel, base)
    return base


def _trisolve(arr: dict, y: torch.Tensor, z: torch.Tensor) -> None:
    """z[:Lpad] = T^-1 y, chunk by chunk; z[Lpad] is the zero sentinel row.

    Chunk q XORs its dependency ranges, gathered from the rows of z solved
    so far, into y's rows of that chunk (y is the replay's own scratch), then
    multiplies by the chunk inverse straight into z's zero rows."""
    CB = arr["CB"]
    for seg in arr["tri"]:
        for qi in range(seg["tinv"].shape[0]):
            q = seg["q0"] + qi
            yq = y[q * CB : (q + 1) * CB]
            for a, b, ix in seg["ranges"]:
                gather_xor(z, ix[qi], out=yq[a:b])
            gf2_matmul(seg["tinv"][qi], yq, out=z[q * CB : (q + 1) * CB])


def replay(arr: dict, D: torch.Tensor) -> torch.Tensor:
    """Structured replay: D [M_pad, t] uint8 (row M_pad-1 zero) -> C [L, t]."""
    Lpad, u_pad = arr["Lpad"], arr["u_pad"]
    t = D.shape[1]
    # z holds t1 (rows < Lpad), then x_u (rows Lpad..Lpad+u_pad-1); row Lpad
    # stays zero -- the sentinel of every gather into t1 -- until stage 3
    # writes x_u over it, so stage 5 gathers from one buffer with no concat
    z = torch.zeros((Lpad + u_pad, t), dtype=torch.uint8, device=D.device)

    y = take_rows(D, arr["piv_rows"])  # [Lpad, t]
    _trisolve(arr, y, z)  # stage 1
    del y
    t1 = z[:Lpad]

    # stage 2: zsel = y_sel ^ B_sel t1 (+ HDPC dense part)
    zsel = _apply_plan(z, arr["bsel_passes"], arr["bsel_overflow"], take_rows(D, arr["sel_rows"]))
    if arr["mhd"] is not None:
        _select_rows(gf256_matmul(arr["mhd"], t1), arr["hd_sel"], zsel)

    xu = z[Lpad : Lpad + u_pad]
    gf256_matmul(arr["vinv"], zsel, out=xu)  # stage 3 (xu rows are zero)
    gf2_matmul(arr["wut"], xu, out=t1)  # stage 4: x_a = t1 ^ Wut x_u
    return take_rows(z, arr["out_sel"])  # stage 5
