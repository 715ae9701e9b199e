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
The counterpart of `_replay_jit` -- one program per shape signature,
dispatched once -- is `ops/program.py`, which captures the body for a
signature, a width and a stream and replays it with one launch between the
prologue and the epilogue; so neither D nor C is an address of the graph.

Every tensor the body reads lies in one flat uint8 buffer per schedule and
device (`arr["packed"]`, each tensor at a multiple of 256 bytes), uploaded
in one copy; the body's arrays are views of it (`views`).  Two schedules of
one `signature` have the same layout, so a program captured over a buffer
of that layout (its slot) serves both: a replay copies the schedule's
buffer into the slot.  A canonical (decode) schedule keeps every shape the
DeviceSchedule pads to, so its signature is the JAX package's compile key;
an encoder schedule's products run on their nonzero extents instead.

The TPU program is scatter-free (a dynamic row scatter costs ~30x there):
each overflow class of a GatherPlan, and the HDPC products, are gathered
into a fresh buffer, a zero row is appended, and a width-1 gather over every
output row places them.  K1 names its output rows instead (`rows`), so the
port composes each class with its placement once, when the arrays are built
(`compose`), and runs one launch per class that touches only its rows.  The
gathers into t1 read its sentinel index Lpad as an implicit zero row
(`zero_index`).
"""

import itertools

import numpy as np
import torch

from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops.kernels import check_rows, gather_xor, gf2_matmul, gf256_matmul
from nanorq_tpu_torch.precode.device_schedule import DeviceSchedule
from nanorq_tpu_torch.utils import stats

ALIGN = 256  # bytes: where each tensor of a packed buffer starts
_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32}


def _idx(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Index array -> int32 tensor (schedules store uint16 where it fits;
    torch's uint16 supports few ops, and the gather kernel reads int32).
    Always a copy, so a CPU tensor never aliases a read-only array; on a
    card, in memory that `ops/program.empty` finds."""
    host = torch.from_numpy(np.array(a, np.int32))
    if torch.device(dev).type != "cuda":
        return host
    from nanorq_tpu_torch.ops import program  # program imports this module

    return program.empty(tuple(host.shape), torch.int32, dev).copy_(host)


def _col(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """1-D row selector -> [n, 1] int32, a width-1 gather."""
    return _idx(np.asarray(a).reshape(-1, 1), dev)


def _extent(a: np.ndarray, axis: int) -> int:
    """1 + the last index along `axis` (0 rows, 1 columns) holding a nonzero."""
    nz = np.nonzero(np.asarray(a).any(axis=1 - axis))[0]
    return int(nz[-1]) + 1 if nz.size else 0


def compose(ix: np.ndarray, sel: np.ndarray, lo: int = 0, n_rows: int | None = None,
            zero_index: int | None = None) -> tuple:
    """A gather ix [nb, w] and its width-1 placement sel [n_out] composed
    into one gather with output rows, as int32 numpy arrays (idx [m, w],
    rows [m]): output row r receives row sel[r] - lo of the gather when that
    lies in [0, nb), else nothing (sel's sentinel, or another class's row).

    With `n_rows`, padded to that many rows: the rows added are output rows
    the class does not reach, each reading `zero_index` alone (K1's implicit
    zero row), so they XOR nothing in.  n_rows <= n_out keeps the rows
    distinct; they are checked here, once."""
    ix, sel = np.asarray(ix), np.asarray(sel, np.int64)
    r = np.nonzero((sel >= lo) & (sel < lo + ix.shape[0]))[0]
    idx = ix[sel[r] - lo]
    if n_rows is not None and n_rows > r.size:
        free = np.setdiff1d(np.arange(sel.size), r, assume_unique=True)[: n_rows - r.size]
        idx = np.concatenate([idx, np.full((free.size, ix.shape[1]), zero_index, ix.dtype)])
        r = np.concatenate([r, free])
    check_rows(r, sel.size)
    return np.asarray(idx, np.int32), r.astype(np.int32)


def place(idx: np.ndarray, rows: np.ndarray, n_out: int, dev: torch.device) -> tuple:
    """(idx [m, w], rows [m]) as int32 tensors on `dev`: a gather whose row i
    is XORed into output row rows[i] (`gather_xor`'s `rows`).  The rows are
    checked here, once: distinct and in [0, n_out)."""
    check_rows(rows, n_out)
    return _idx(idx, dev), _idx(rows, dev)


def placed(ix: np.ndarray, sel: np.ndarray, dev: torch.device, lo: int = 0) -> tuple:
    """`compose(ix, sel, lo)` as int32 tensors on `dev`."""
    idx, rows = compose(ix, sel, lo)
    return _idx(idx, dev), _idx(rows, dev)


def _body_parts(ds: DeviceSchedule) -> tuple:
    """(skeleton, parts): every array the body reads, in a fixed order
    (`parts`, host arrays), and the body's structure with each array given
    by its place in that order and every int the body reads (`skeleton`).

    A canonical schedule keeps the shapes the DeviceSchedule pads to: `mhd`
    [H_pad, Lpad], `wut` [Lpad, u_pad/8] with k = u_pad, and each placed
    overflow class at min(nb, u_pad) rows (`compose`'s padding; nb joins
    the skeleton, since min loses it).  Every shape is then one of the
    DeviceSchedule's own, which the JAX package's compile key lists.  An
    encoder schedule runs its dense products on their nonzero extents
    (rows of `mhd` past its extent give zero products, which no zsel row
    needs; columns of `mhd` and `wut` past it select nothing), and places
    its classes unpadded."""
    parts = []

    def put(a, dtype=np.int32) -> int:
        parts.append(np.ascontiguousarray(a, dtype))
        return len(parts) - 1

    pad = getattr(ds, "canonical", False)  # a schedule of the JAX package's compiler has no flag
    tri = tuple((seg.q0, put(seg.tinv, np.uint8), tuple((a, b, put(ix)) for a, b, ix in seg.ranges))
                for seg in ds.tri)  # tinv [nq, CB, CB/8] packed as stored; ix [nq, b-a, w]
    passes = tuple(put(p) for p in ds.bsel.passes)
    classes = []
    for ix, sel in ds.bsel.overflow:
        nb = int(np.asarray(ix).shape[0])
        idx, rows = compose(ix, sel, n_rows=min(nb, ds.u_pad) if pad else None, zero_index=ds.Lpad)
        classes.append((nb, put(idx), put(rows)))
    hd = None
    if ds.mhd is not None:  # [H_pad, Lpad] bytes
        mhd = ds.mhd
        if not pad:  # its extent, columns to a multiple of 16
            hc = min(-(-_extent(mhd, 1) // 16) * 16, mhd.shape[1])
            mhd = mhd[: _extent(mhd, 0), :hc]
        H = mhd.shape[0]  # zsel row r receives product row hd_sel[r] when it is below H
        idx, rows = compose(np.arange(H, dtype=np.int32)[:, None], ds.hd_sel,
                            n_rows=min(H, ds.u_pad) if pad else None, zero_index=H)
        hd = (put(mhd, np.uint8), put(idx), put(rows))
    vinv = put(ds.vinv, np.uint8)  # [u_pad, u_pad] bytes
    wut = ds.wut  # [Lpad, u_pad/8] packed bits; trimmed: rows of its extent, k = 8 * its bytes
    wut_k = 8 * wut.shape[1] if pad else 8 * _extent(wut, 1)
    if not pad:
        wut = wut[: _extent(wut, 0)]
    skeleton = (ds.Lpad, ds.CB, ds.u_pad, wut_k, tri, passes, tuple(classes), hd, vinv, put(wut, np.uint8))
    return skeleton, parts


def _layout(parts: list) -> tuple:
    """((torch dtype, shape, byte offset) per part, total bytes): each part
    at a multiple of ALIGN, so that no kernel copies a view to align it."""
    layout, n = [], 0
    for a in parts:
        layout.append((_DTYPES[a.dtype], a.shape, n))
        n += -(-a.nbytes // ALIGN) * ALIGN
    return tuple(layout), max(n, ALIGN)


def views(arr: dict, flat: torch.Tensor) -> dict:
    """The body's arrays as views of `flat`, a buffer of arr's layout
    (the schedule's own `arr["packed"]`, or a program's slot)."""
    T = [flat[off : off + int(np.prod(shape, dtype=np.int64)) * dt.itemsize].view(dt).view(shape)
         for dt, shape, off in arr["layout"]]
    Lpad, CB, u_pad, wut_k, tri, passes, classes, hd, vinv, wut = arr["skeleton"]
    body = {
        "Lpad": Lpad, "CB": CB, "u_pad": u_pad, "wut_k": wut_k,
        "tri": [{"q0": q0, "tinv": T[ti], "ranges": [(a, b, T[i]) for a, b, i in rr]} for q0, ti, rr in tri],
        "bsel_passes": [T[i] for i in passes],
        "bsel_placed": [(T[i], T[r]) for _, i, r in classes],
        "vinv": T[vinv], "wut": T[wut],
    }
    if hd is not None:
        body["mhd"], body["hd_placed"] = T[hd[0]], (T[hd[1]], T[hd[2]])
    return body


def _upload(parts: list, layout: tuple, nbytes: int, dev: torch.device) -> torch.Tensor:
    """The parts packed into one flat uint8 tensor on `dev`: filled in host
    memory (pinned on a card), then one `non_blocking` copy on the current
    stream (PyTorch keeps a pinned block from reuse until the copies that
    read it are done) into memory that `ops/program.empty` finds, evicting
    the card's replay programs where it is out of memory."""
    cuda = dev.type == "cuda"
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
    h = host.numpy()
    ends = [off for _, _, off in layout[1:]] + [nbytes]
    for a, (_, _, off), end in zip(parts, layout, ends):
        h[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
        h[off + a.nbytes : end] = 0  # the padding up to the next part: no stale bytes in a slot
    if not cuda:
        return host
    from nanorq_tpu_torch.ops import program  # program imports this module

    flat = program.empty((nbytes,), torch.uint8, dev)
    flat.copy_(host, non_blocking=True)
    return flat


def device_arrays(ds: DeviceSchedule, device) -> dict:
    """A DeviceSchedule's tensors on `device`, cached on the schedule.

    The cache lives under the port's own attribute (`_torch_arrays`, keyed
    by device).  The dict holds the body's arrays (`views` of the packed
    buffer `packed`, laid out as `layout` says), the three row selectors the
    prologue and the epilogue read (`piv_rows`, `sel_rows`, `out_sel`,
    tensors of their own), the body's `skeleton`, the number of its
    `signature` (`sig`, the program cache's key) and a number of its own
    (`uid`).  The signature is counted here, once per schedule and device.
    """
    dev = resolve(device)
    cache = ds.__dict__.setdefault("_torch_arrays", {})
    arr = cache.get(dev)
    if arr is not None:
        return arr
    skeleton, parts = _body_parts(ds)
    layout, nbytes = _layout(parts)
    arr = {
        "piv_rows": _col(ds.piv_rows, dev),
        "sel_rows": _col(ds.sel_rows, dev),
        "out_sel": _col(ds.out_sel, dev),
        "skeleton": skeleton,
        "layout": layout,
        "sig": _number(signature(skeleton, layout, ds.out_sel.shape[0])),
        "uid": next(_uids),
        "packed": _upload(parts, layout, nbytes, dev),
    }
    arr.update(views(arr, arr["packed"]))
    cache[dev] = arr
    return arr


def signature(skeleton: tuple, layout: tuple, L: int) -> tuple:
    """What a program of a schedule is shaped by: every int the body reads
    and every array's dtype and shape (the skeleton and the layout), and
    L, the output's rows.  Schedules of one signature run one captured
    program.  On canonical schedules this is the JAX package's compile key
    (`nanorq_tpu.ops.replay._count_signature`): every entry of one is a
    function of the other's."""
    return skeleton, tuple((dt, shape) for dt, shape, _ in layout), L


_signatures: dict = {}  # signature -> its number
_numbers = itertools.count()
_uids = itertools.count()


def _number(sig: tuple) -> int:
    """The signature's number (a new one the first time it is met), counted
    as new or seen before in `utils.stats` under the JAX package's names
    (`replay_compile_new` / `replay_compile_hit`)."""
    n = _signatures.get(sig)
    if n is not None:
        stats.count("replay_compile_hit")
        return n
    n = _signatures[sig] = next(_numbers)
    stats.count("replay_compile_new")
    return n


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
        gather_xor(gf256_matmul(hd, t1[: hd.shape[1]]), ix, out=zsel, rows=rows, zero_index=hd.shape[0])

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
