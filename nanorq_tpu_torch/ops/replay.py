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
K3 (`gf256_matmul`, on the raw byte matrices).  The TPU program's `lax.scan`
over chunks is a Python loop of launches, and the replay updates buffers it
owns in place where JAX had to copy.

`replay` runs in three parts: the `prologue` (the two gathers that read D,
into the buffers of `buffers`), the `body` (stages 1-4 over those buffers
alone) and the `epilogue` (stage 5, into a fresh C).  Here they run eagerly,
one launch after another: the CPU path, and the body a CUDA graph captures.
The counterpart of `_replay_jit` -- one program per schedule, dispatched
once -- is `ops/program.py`, which captures the body for a width and a
stream and replays it with one launch between the prologue and the
epilogue; so neither D nor C is an address of the graph.

The TPU program is scatter-free (a dynamic row scatter costs ~30x there):
each overflow class of a GatherPlan, and the HDPC products, are gathered
into a fresh buffer, a zero row is appended, and a width-1 gather over every
output row places them.  K1 names its output rows instead (`rows`), so the
port composes each class with its placement once, when the arrays are built
(`placed`), and runs one launch per class that touches only its rows.  The
gathers into t1 read its sentinel index Lpad as an implicit zero row
(`zero_index`).
"""

import numpy as np
import torch

from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops.kernels import check_rows, gather_xor, gf2_matmul, gf256_matmul
from nanorq_tpu_torch.precode.device_schedule import DeviceSchedule
from nanorq_tpu_torch.utils import stats


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


def _extent(a: np.ndarray, axis: int) -> int:
    """1 + the last index along `axis` (0 rows, 1 columns) holding a nonzero."""
    nz = np.nonzero(np.asarray(a).any(axis=1 - axis))[0]
    return int(nz[-1]) + 1 if nz.size else 0


def place(idx: np.ndarray, rows: np.ndarray, n_out: int, dev: torch.device) -> tuple:
    """(idx [m, w], rows [m]) as int32 tensors on `dev`: a gather whose row i
    is XORed into output row rows[i] (`gather_xor`'s `rows`).  The rows are
    checked here, once: distinct and in [0, n_out)."""
    check_rows(rows, n_out)
    return _idx(idx, dev), _idx(rows, dev)


def placed(ix: np.ndarray, sel: np.ndarray, dev: torch.device, lo: int = 0) -> tuple:
    """A gather ix [nb, w] and its width-1 placement sel [n_out] composed
    into one gather with output rows: output row r receives row sel[r] - lo
    of the gather when that lies in [0, nb), else nothing (sel's sentinel,
    or another class's row).  So (ix[sel[r] - lo], r) over those r."""
    ix, sel = np.asarray(ix), np.asarray(sel, np.int64)
    r = np.nonzero((sel >= lo) & (sel < lo + ix.shape[0]))[0]
    return place(ix[sel[r] - lo], r, sel.size, dev)


def device_arrays(ds: DeviceSchedule, device) -> dict:
    """A DeviceSchedule's tensors on `device`, cached on the schedule.

    The cache lives under the port's own attribute (`_torch_arrays`, keyed
    by device).  The dense products run on their nonzero extents: HDPC's
    `mhd` padded to H_pad rows and Lpad columns holds H rows and ~L columns,
    Wut's [Lpad, u_pad] bits ~L rows and u columns, so the kernels skip the
    zero padding (rows of `mhd` past its extent give zero products, which
    no zsel row needs to receive; columns of `mhd` and `wut` past it select
    nothing).  The bsel overflow classes and the HDPC placement `hd_sel`
    are kept composed with their placements (`placed`) only.

    On a card the dict also keeps the schedule's programs (`programs`,
    `ops/program.py`), so that they die with it.  Each schedule's signature
    is counted once here (`_count_signature`).
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
        "bsel_placed": [placed(ix, sel, dev) for ix, sel in ds.bsel.overflow],
        "vinv": _u8(ds.vinv, dev),  # [u_pad, u_pad] bytes
        "out_sel": _col(ds.out_sel, dev),
    }
    if ds.mhd is not None:  # [H_pad, Lpad] bytes -> its extent, columns to a multiple of 16
        hr = _extent(ds.mhd, 0)
        hc = min(-(-_extent(ds.mhd, 1) // 16) * 16, ds.mhd.shape[1])
        arr["mhd"] = _u8(ds.mhd[:hr, :hc], dev)
        # zsel row r receives product row hd_sel[r] when it is below the extent
        arr["hd_placed"] = placed(np.arange(hr, dtype=np.int32)[:, None], ds.hd_sel, dev)
    # [Lpad, u_pad/8] packed bits -> rows of its extent, k = 8 * its bytes
    arr["wut"] = _u8(ds.wut[: _extent(ds.wut, 0)], dev)
    arr["wut_k"] = 8 * _extent(ds.wut, 1)
    cache[dev] = arr
    _count_signature(arr)
    return arr


_seen_signatures: set = set()


def _count_signature(arr: dict) -> None:
    """Count a schedule's signature -- every tensor's shape and every static
    int, what a program of it is shaped by (the JAX package's compile key) --
    as new or seen before, in `utils.stats` under the JAX package's names
    (`replay_compile_new` / `replay_compile_hit`): how often decode schedules
    of one K' could share one program.  The port does not share them yet
    (`ops/program.py`)."""
    hd = arr.get("mhd")
    sig = (
        arr["Lpad"], arr["CB"], arr["u_pad"], arr["piv_rows"].shape,
        tuple((s["q0"], s["tinv"].shape, tuple((a, b, ix.shape) for a, b, ix in s["ranges"])) for s in arr["tri"]),
        arr["sel_rows"].shape,
        tuple(p.shape for p in arr["bsel_passes"]),
        tuple((ix.shape, rows.shape) for ix, rows in arr["bsel_placed"]),
        None if hd is None else (hd.shape, *(x.shape for x in arr["hd_placed"])),
        arr["vinv"].shape, arr["wut"].shape, arr["wut_k"], arr["out_sel"].shape,
    )
    if sig in _seen_signatures:
        stats.count("replay_compile_hit")
    else:
        _seen_signatures.add(sig)
        stats.count("replay_compile_new")


def take_rows(src: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """src[rows] for rows [n, 1] int32 (a width-1 K1 gather)."""
    return gather_xor(src, rows)


def apply_plan(src: torch.Tensor, passes, placed_classes, base: torch.Tensor,
               zero_index: int | None = None) -> torch.Tensor:
    """base ^= a GatherPlan applied to src, in place: its row-aligned passes,
    then its overflow classes composed with their placements (`placed`)."""
    for p in passes:
        gather_xor(src, p, out=base, zero_index=zero_index)
    for ix, rows in placed_classes:
        gather_xor(src, ix, out=base, rows=rows, zero_index=zero_index)
    return base


def _trisolve(arr: dict, y: torch.Tensor, t1: torch.Tensor) -> None:
    """t1 = T^-1 y, chunk by chunk, into the zeroed t1 [Lpad, t]; the
    sentinel index Lpad reads as a zero row.

    Chunk q XORs its dependency ranges, gathered from the rows of t1 solved
    so far, into y's rows of that chunk (y is the replay's own scratch), then
    multiplies by the chunk inverse straight into t1's zero rows."""
    CB, Lpad = arr["CB"], arr["Lpad"]
    for seg in arr["tri"]:
        for qi in range(seg["tinv"].shape[0]):
            q = seg["q0"] + qi
            yq = y[q * CB : (q + 1) * CB]
            for a, b, ix in seg["ranges"]:
                gather_xor(t1, ix[qi], out=yq[a:b], zero_index=Lpad)
            gf2_matmul(seg["tinv"][qi], yq, out=t1[q * CB : (q + 1) * CB])


def buffers(arr: dict, t: int, device) -> dict:
    """The buffers the body owns at width t: y [Lpad, t] (D's pivot rows, the
    trisolve's scratch), z [Lpad + u_pad, t] (t1, then x_u: stage 5 gathers
    from one buffer with no concat) and zsel [u_pad, t]."""
    Lpad, u_pad = arr["Lpad"], arr["u_pad"]
    return {name: torch.empty((rows, t), dtype=torch.uint8, device=device)
            for name, rows in (("y", Lpad), ("z", Lpad + u_pad), ("zsel", u_pad))}


def prologue(arr: dict, D: torch.Tensor, buf: dict) -> None:
    """The two gathers that read D [M_pad, t] (row M_pad-1 zero), written
    into the body's y and zsel."""
    gather_xor(D, arr["piv_rows"], out=buf["y"], overwrite=True)
    gather_xor(D, arr["sel_rows"], out=buf["zsel"], overwrite=True)


def body(arr: dict, buf: dict) -> None:
    """Stages 1-4 over the buffers alone: z = (x_a, x_u)."""
    Lpad, u_pad = arr["Lpad"], arr["u_pad"]
    z, zsel = buf["z"], buf["zsel"]
    z.zero_()  # the gathers into t1 read their sentinel Lpad as K1's implicit zero row
    t1 = z[:Lpad]
    _trisolve(arr, buf["y"], t1)  # stage 1

    # stage 2: zsel = y_sel ^ B_sel t1 (+ HDPC dense part)
    apply_plan(t1, arr["bsel_passes"], arr["bsel_placed"], zsel, Lpad)
    hd = arr.get("mhd")
    if hd is not None and hd.numel():  # HDPC products, XORed into the zsel rows that take one
        ix, rows = arr["hd_placed"]
        gather_xor(gf256_matmul(hd, t1[: hd.shape[1]]), ix, out=zsel, rows=rows)

    xu = z[Lpad : Lpad + u_pad]
    gf256_matmul(arr["vinv"], zsel, out=xu)  # stage 3 (xu rows are zero)
    wut = arr["wut"]  # stage 4: x_a = t1 ^ Wut x_u
    if wut.numel() and arr["wut_k"]:
        gf2_matmul(wut, xu[: arr["wut_k"]], out=t1[: wut.shape[0]])


def epilogue(arr: dict, buf: dict) -> torch.Tensor:
    """Stage 5: C = z[out_sel], a fresh tensor."""
    return take_rows(buf["z"], arr["out_sel"])


def replay(arr: dict, D: torch.Tensor) -> torch.Tensor:
    """Structured replay, eagerly: D [M_pad, t] uint8 (row M_pad-1 zero) -> C [L, t]."""
    buf = buffers(arr, D.shape[1], D.device)
    prologue(arr, D, buf)
    body(arr, buf)
    return epilogue(arr, buf)
