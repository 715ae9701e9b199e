"""Multi-device scaling: blocks split over the lanes of a mesh (counterpart of
`nanorq_tpu.parallel.mesh`).

RaptorQ source blocks are fully independent, and every payload kernel is
elementwise along the payload width (blocks laid side by side, t = B*T).  The
JAX package shards that width over a 1-D 'blocks' mesh with one `shard_map`:
every device runs the same replay / LT program on its own slice, the schedule
arrays replicated, no collectives.  Here the same layout is a tuple of
**lanes**.  A lane is a device plus, on CUDA, a stream of its own: every lane
uploads its slice from pinned memory on its stream (`non_blocking`), runs the
port's unsharded function on it there, and downloads its slice of the result
into pinned memory; one host thread starts all of it and waits once.  Several
lanes may name one device: two lanes of one card overlap the upload of one
slice with the kernels of another, two lanes of two cards are two GPUs.  A
lane's column range of a pinned object crosses in one pitched copy
(`kernels.copy2d`), with no host staging.  The default path itself takes
lanes of one card for a wide object (`default_mesh`: width slices, so that
copies and kernels overlap), else one lane on the current stream.

"Replicated" schedule tensors are what the unsharded code caches already, per
device: `device_arrays(ds, dev)`, `lt_plan(isis, P, dev)`,
`WSchedule.staged(dev)`.  So the sharded functions take the schedule (or the
ISIs and parameters, or the WSchedule) and fetch each lane's copy, where the
JAX ones take arrays placed beforehand.

Nothing here falls back: a CUDA lane without a card raises (`device.resolve`),
and a failed pin, stream or launch raises where it happens.
"""

import contextlib
import mmap
import threading

import numpy as np
import torch

from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops import kernels
from nanorq_tpu_torch.ops import program
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays
from nanorq_tpu_torch.utils import stats


class Lane:
    """One shard's place: a device and, on CUDA, the stream its work goes to.
    A lane of a mesh has a stream of its own; the default path's lane
    (`local_mesh`) takes the device's current stream."""

    __slots__ = ("device", "stream")

    def __init__(self, device: torch.device, own_stream: bool = True):
        self.device = device
        self.stream = torch.cuda.Stream(device=device) if own_stream and device.type == "cuda" else None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def queue(self):
        """The CUDA stream this lane's copies and launches go to."""
        return self.stream if self.stream is not None else torch.cuda.current_stream(self.device)

    @contextlib.contextmanager
    def on(self):
        """Inside, torch allocates and launches on this lane's device and
        stream.  A stream of its own first waits for the device's current
        stream: the tensors cached per device (schedules, plans, the kernels'
        tables and flags) are uploaded there."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield


class Mesh:
    """An ordered tuple of lanes over the 1-D axis "blocks".  `devices` is an
    object array of the lanes' torch devices, so that call sites read as the
    JAX ones do (`int(np.prod(mesh.devices.shape))`)."""

    axis_names = ("blocks",)

    def __init__(self, lanes):
        self.lanes = tuple(lanes)
        if not self.lanes:
            raise ValueError("a mesh needs at least one lane")
        self.devices = np.empty(len(self.lanes), object)
        self.devices[:] = [lane.device for lane in self.lanes]

    @property
    def size(self) -> int:
        return len(self.lanes)

    @property
    def shape(self) -> dict:
        return {"blocks": self.size}

    def synchronize(self) -> None:
        """Wait for every lane's stream."""
        for lane in self.lanes:
            if lane.cuda:
                lane.queue().synchronize()

    def take_index_errors(self) -> bool:
        """Whether a gather on any CUDA device of the mesh met an index
        outside its source since the last call; joins the lanes first, then
        reads each device's flag once."""
        self.synchronize()
        cuda = {lane.device for lane in self.lanes if lane.cuda}
        return any([kernels.take_index_errors(dev) for dev in sorted(cuda, key=str)])


def check_mesh(mesh) -> None:
    """Refuse a `mesh=` argument that is no Mesh of this package (a JAX mesh,
    say) before any work is split over it."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: expected a nanorq_tpu_torch.parallel.mesh.Mesh, got {type(mesh).__name__}")


def make_mesh(devices=None, axis: str = "blocks") -> Mesh:
    """A mesh with one lane per entry of `devices` (default: every visible
    CUDA device).  An entry may repeat: each is a lane of its own.  A CUDA
    device that torch cannot see raises; nothing stands in for it."""
    if axis != "blocks":
        raise ValueError(f"the only mesh axis is 'blocks', got {axis!r}")
    if devices is None:
        resolve("cuda")  # raises where torch sees no card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve(d) for d in devices]
    for dev in {d for d in devs if d.type == "cuda"}:
        kernels.prepare(dev)
    return Mesh(Lane(d) for d in devs)


def auto_mesh() -> Mesh | None:
    """A mesh over all visible cards, or None when there is at most one (a
    single device needs no split).  What the CLIs' --mesh auto resolves to."""
    return make_mesh() if torch.cuda.device_count() > 1 else None


def local_mesh(device) -> Mesh:
    """The mesh of the default path (`mesh=None`): one lane of `device` on its
    current stream.  The codec moves its data through it as a mesh's lanes
    do, so no call site keeps a second, pageable way; only an explicit mesh
    routes a decode to the device arm."""
    return Mesh([Lane(resolve(device), own_stream=False)])


# The default object encode on a card runs in up to SLICES width slices, a
# lane each, each slice uploading SLICE_BYTES of live rows at least: a slice
# is at least SLICE_BYTES / (live rows) wide.  Set from tools/pipe_sweep.py
# on the H100 (PERF.md): with fewer bytes a slice, its kernels' fixed costs
# outgrow the copy time it hides.
SLICES = 4
SLICE_BYTES = 24 << 20

_slices: dict = {}  # (device, n) -> the mesh of n lanes of that card


def slice_mesh(device, n: int) -> Mesh:
    """n lanes of one card, each on a stream of its own, made once per
    (device, n) and kept: a program's key holds its stream
    (`ops/program.py`), so lanes made afresh at every call would never
    replay a captured program."""
    dev = resolve(device)
    mesh = _slices.get((dev, n))
    if mesh is None:
        mesh = _slices[(dev, n)] = make_mesh([dev] * n)
    return mesh


def slice_count(t: int, block: int, live: int) -> int:
    """The rule: how many width slices the default path cuts an object of
    width t (blocks of `block` bytes side by side) with `live` payload rows
    into on a card -- as many as fit, up to SLICES, where each slice holds
    whole blocks and uploads SLICE_BYTES (live * width) at least; 1 where
    none fits or the width is no whole number of blocks."""
    if t % block:
        return 1
    return max(1, min(SLICES, t // block, live * t // SLICE_BYTES))


def default_mesh(device, t: int, block: int, live: int) -> Mesh:
    """The lanes the default path (`mesh=None`) splits an object of width t
    over: on a card cut into `slice_count(t, block, live)` > 1 slices, that many
    lanes of the card (`slice_mesh`), so that one slice's upload from the
    pinned object runs on a copy engine while another's replay and LT
    combine run on the SMs and a third's download on the other copy engine;
    else (the CPU, a narrow object) the one lane of `local_mesh`."""
    dev = resolve(device)
    n = slice_count(t, block, live) if dev.type == "cuda" else 1
    return slice_mesh(dev, n) if n > 1 else local_mesh(dev)


def is_sliced(mesh) -> bool:
    """Whether `mesh` is one of the kept meshes of `slice_mesh`: an array
    sharded over it belongs to the default path as much as to its caller."""
    return any(mesh is m for m in _slices.values())


def host_zeros(shape: tuple, device) -> np.ndarray:
    """A zeroed uint8 host array bound for `device`: pinned on CUDA, so that
    its contiguous rows cross to the card in one `non_blocking` copy with no
    staging copy (the array keeps the pinned tensor alive); plain numpy on
    the CPU."""
    if resolve(device).type == "cuda":
        return torch.zeros(shape, dtype=torch.uint8, pin_memory=True).numpy()
    return np.zeros(shape, np.uint8)


class HostSlab:
    """Zeroed host memory of one `shape` (uint8) that stays pageable until a
    card reads it: it starts on a page and fills whole pages, so that `pin`
    page-locks it in place (cudaHostRegister, portable to every card) with
    no copy and nothing in PyTorch's pinned cache.  `np.asarray(slab)` is
    the memory as an array, and every view of it keeps the slab alive; when
    the last dies the pages are unregistered (after the card they were
    pinned for has finished its work, so no copy still reads them) and
    freed.  `HostSlab.registered` counts the bytes pinned in place now."""

    __slots__ = ("_raw", "ptr", "nbytes", "shape", "pinned_on")
    registered = 0  # bytes of every live pinned slab
    _count_lock = threading.RLock()  # a slab may die on any thread, inside a count on this one

    def __init__(self, shape: tuple):
        self.pinned_on = None
        self.shape = tuple(int(n) for n in shape)
        self.nbytes = -(-max(1, int(np.prod(self.shape))) // mmap.PAGESIZE) * mmap.PAGESIZE
        self._raw = np.zeros(self.nbytes + mmap.PAGESIZE, np.uint8)  # its pages are faulted in as written
        self.ptr = self._raw.ctypes.data + -self._raw.ctypes.data % mmap.PAGESIZE

    @property
    def __array_interface__(self) -> dict:
        return {"shape": self.shape, "typestr": "|u1", "data": (self.ptr, False), "version": 3}

    def pin(self, device: torch.device) -> None:
        """Page-lock the slab in place for copies to `device` (once)."""
        if self.pinned_on is None:
            err = int(torch.cuda.cudart().cudaHostRegister(self.ptr, self.nbytes, 1))  # cudaHostRegisterPortable
            if err:
                raise RuntimeError(f"cudaHostRegister of {self.nbytes} bytes failed: cudaError {err}")
            self.pinned_on = device
            with HostSlab._count_lock:
                HostSlab.registered += self.nbytes

    def __del__(self, _sync=torch.cuda.synchronize, _cudart=torch.cuda.cudart):
        if self.pinned_on is not None:
            _sync(self.pinned_on)
            _cudart().cudaHostUnregister(self.ptr)
            with type(self)._count_lock:
                type(self).registered -= self.nbytes


def slab_of(a) -> HostSlab | None:
    """The HostSlab under the numpy array `a`, if it lies over one."""
    while isinstance(a, np.ndarray):
        a = a.base
    return a if isinstance(a, HostSlab) else None


def pinned_bytes(a: np.ndarray) -> int:
    """The host bytes that keep `a` page-locked: a HostSlab's pages once
    pinned (else 0), the `pinned_class` of a block of PyTorch's pinned
    allocator (`host_zeros` on a card), 0 for other memory."""
    slab = slab_of(a)
    if slab is not None:
        return slab.nbytes if slab.pinned_on is not None else 0
    return pinned_class(a.nbytes) if torch.from_numpy(a).is_pinned() else 0


def host_matrix(live: int, rows: int, width: int, device) -> np.ndarray:
    """A zeroed host payload matrix bound for `device`, of which only the
    leading `live` rows may be nonzero: [live, width] pinned on CUDA, which
    `upload` copies straight to the card; on the CPU the plain numpy [rows,
    width] the device path reads in place (`host_zeros`)."""
    return host_zeros((live if resolve(device).type == "cuda" else rows, width), device)


def pinned_class(nbytes: int) -> int:
    """The bytes PyTorch's caching host allocator pins for a request of
    `nbytes`: it rounds every block up to a power of two."""
    return 1 << max(0, nbytes - 1).bit_length()


SLAB_MOST = 16  # blocks in one ingestion slab, at most


def slab_blocks(n: int, nbytes: int) -> int:
    """How many of n equal host blocks of `nbytes` to lay in one slab (up to
    `SLAB_MOST`) so that their slabs pin the fewest bytes (`pinned_class`), the
    fewer blocks a slab on a tie.  Blocks of 1.28 MB pin 2 MiB one by one
    (+64%); 13 of them fill 16 MiB (+0.8%)."""
    def pinned(g: int) -> int:
        q, r = divmod(n, g)
        return q * pinned_class(g * nbytes) + (pinned_class(r * nbytes) if r else 0)

    return min(range(1, max(1, min(n, SLAB_MOST)) + 1), key=lambda g: (pinned(g), g))


def pad_width(D: np.ndarray, n_dev: int) -> np.ndarray:
    """Zero-pad the width (payload) axis up to a multiple of n_dev; zero
    columns are exact no-ops under every GF kernel."""
    t = D.shape[1]
    tp = -(-t // n_dev) * n_dev
    if tp == t:
        return D
    out = np.zeros((D.shape[0], tp), D.dtype)
    out[:, :t] = D
    return out


def deal(count: int, n: int) -> list[tuple[int, int]]:
    """`count` items in order as n contiguous runs [(lo, hi)], the first
    count % n one longer; runs past the items are empty (lo == hi)."""
    q, r = divmod(count, n)
    cuts = np.concatenate([[0], np.cumsum([q + (i < r) for i in range(n)])])
    return [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]


def shard_ranges(t: int, n: int, block: int | None = None) -> list[tuple[int, int]]:
    """The column range of each of n lanes over a width t, in order.

    Cut on whole blocks (multiples of `block`) where the width holds at least
    n of them: a lane then owns whole source blocks.  Else on multiples of 16
    bytes where there are n such units, so that every shard keeps the kernels'
    16-byte lanes (a shard of another width runs them byte by byte, which is
    right and slow).  Else byte by byte, and lanes past the width stay empty.
    Shards need not be equal: an absent column is as much a no-op as a zero
    one."""
    if block and t % block == 0 and t // block >= n:
        unit = block
    elif t >= 16 * n:
        unit = 16
    else:
        unit = 1
    return [(min(lo * unit, t), min(hi * unit, t)) for lo, hi in deal(-(-t // unit), n)]


def stage(lane: Lane, shape: tuple, fill, dtype=torch.uint8, rows: int | None = None) -> torch.Tensor:
    """A tensor of `shape` on the lane's device whose leading `rows` rows
    (default: all) are what `fill(host)` writes into the host staging tensor
    [rows, *shape[1:]]; the rows past them are zeroed on the device.

    On a CUDA lane the staging is pinned and the copy is started on the lane's
    stream without waiting (PyTorch keeps a pinned block from reuse until the
    copies that read it are done); where the card is out of memory, its
    replay programs are evicted first (`ops/program.empty`).  A CPU lane's
    tensor is its own staging."""
    live = shape[0] if rows is None else min(rows, shape[0])
    if not lane.cuda:
        x = torch.empty(shape, dtype=dtype)
        fill(x[:live])
        x[live:] = 0
        return x
    host = torch.empty((live, *shape[1:]), dtype=dtype, pin_memory=True)
    fill(host)
    with lane.on():
        x = program.empty(shape, dtype, lane.device)
        x[:live].copy_(host, non_blocking=True)
        if live < shape[0]:
            x[live:].zero_()
    return x


def upload(lane: Lane, D, rows: int, live: int) -> torch.Tensor:
    """A host matrix D (numpy or a CPU tensor, [>= live, ...]) on the lane's
    device as [rows, ...]: D's leading `live` rows, then zeros.  D's rows at or
    past `live` are zero (or absent), so they are neither copied nor uploaded.

    On a CUDA lane the live rows cross in one copy on the lane's stream,
    straight out of D where it is pinned: a contiguous D in one
    `non_blocking` copy (`host_matrix`; PyTorch then keeps that pinned block
    from reuse until the copy is done), a column range of one (rows apart,
    columns contiguous) in one pitched copy (`kernels.copy2d`, which keeps
    D alive until its stream has passed the copy, and raises on any other
    layout).  Only a pageable D goes
    through a pinned staging copy (`stage`).  A CPU lane reads D in place
    where it has exactly `rows` contiguous rows, else copies."""
    src = torch.as_tensor(D)
    head = src[:live]
    shape = (rows, *src.shape[1:])
    if not lane.cuda and src.shape[0] == rows and src.is_contiguous():
        return src
    if not (lane.cuda and head.is_pinned()):
        return stage(lane, shape, lambda h: h.copy_(head), src.dtype, rows=live)
    with lane.on():
        x = program.empty(shape, src.dtype, lane.device)
        if head.is_contiguous():
            x[:live].copy_(head, non_blocking=True)
        else:
            kernels.copy2d(x[:live], head)
        if live < rows:
            x[live:].zero_()
    return x


def assemble(lane: Lane, shape: tuple, heads: list, extra: list, places: np.ndarray) -> torch.Tensor:
    """A stack of n host blocks on the lane's device, `shape` = (n, rows, w):
    item j's leading rows are the host matrix heads[j] ([h_j, w]; None: no
    rows) and its other rows zero; then the rows of `extra` (host matrices
    [m_k, w], taken in order as one [m, w]) are placed: row i is XORed into
    row places[i] of the stack seen as [n * rows, w], by K1 with output rows
    (`ops/kernels.gather_xor(rows=)`).  The callers' places are rows that
    are zero, so each lands as it is; they are distinct and in range.

    On a CUDA lane each head crosses in one `non_blocking` copy of its own,
    with no staging copy: a head is pinned (`host_zeros`), or lies over a
    `HostSlab`, which is page-locked in place here the first time a card
    reads it (any other pageable head is copied as it is, and the host
    waits for that copy); `extra` and the two index rows cross through
    one pinned staging buffer and one copy; the stack and that buffer are
    allocated through `ops/program.empty`.  The host copy into the staging
    buffer is timed (`utils.stats` timer "host_stage").  A CPU lane builds
    the same stack with K1's plain version."""
    n, rows, w = shape
    m = sum(e.shape[0] for e in extra)
    off = -(-m * w // 16) * 16  # the index rows start 16-byte aligned
    buf = torch.empty(off + 8 * m, dtype=torch.uint8, pin_memory=lane.cuda)
    with stats.timer("host_stage"):
        if m:
            np.concatenate(extra, out=buf[: m * w].numpy().reshape(m, w))
        ix = buf[off:].view(torch.int32).view(2, m).numpy()
        ix[0] = np.arange(m)
        ix[1] = places
    lo = min(0 if h is None else h.shape[0] for h in heads)
    with lane.on():
        x = program.empty(shape, torch.uint8, lane.device)
        x[:, lo:].zero_()  # lo = 0 where a head is None
        for j, h in enumerate(heads):
            if h is not None:
                slab = slab_of(h) if lane.cuda else None
                if slab is not None:
                    slab.pin(lane.device)
                x[j, : h.shape[0]].copy_(torch.as_tensor(h), non_blocking=True)
        if m:
            dev = buf
            if lane.cuda:
                dev = program.empty(buf.shape, torch.uint8, lane.device)
                dev.copy_(buf, non_blocking=True)
            ix_dev = dev[off:].view(torch.int32).view(2, m)
            kernels.gather_xor(dev[: m * w].view(m, w), ix_dev[0].view(m, 1), out=x.view(n * rows, w),
                               rows=ix_dev[1])
    return x


def fetch(pairs) -> list[np.ndarray]:
    """Host copies of contiguous tensors, each on its lane: every download is
    started on its lane's stream into a pinned destination, then one wait per
    stream (span `fetch.wait`: the host blocked on the card).  pairs:
    [(lane, tensor)]."""
    with stats.span("fetch"):
        out = []
        for lane, x in pairs:
            if not lane.cuda:
                out.append(x)
                continue
            with torch.cuda.stream(lane.queue()):
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
            out.append(h)
        with stats.span("fetch.wait"):
            for lane in {lane for lane, _ in pairs}:
                if lane.cuda:
                    lane.queue().synchronize()
        return [h.numpy() for h in out]


class Sharded:
    """One array split along `axis` over a mesh: `parts[i]` is lane i's
    tensor (None for an empty lane) and `ranges[i]` its [lo, hi) along the
    axis.  The parts live on their lanes' devices and were produced on their
    lanes' streams: run more work on them through `each`, and bring them to
    the host with `host*`."""

    def __init__(self, mesh: Mesh, parts: list, ranges: list, axis: int):
        self.mesh, self.parts, self.ranges, self.axis = mesh, parts, ranges, axis

    def each(self, prepare, run, *others: "Sharded") -> "Sharded":
        """run(prepare(lane.device), part, *other parts) on every lane that
        holds a part, on its stream.  `prepare` (or None: run gets None)
        fetches what is cached per device and runs for every lane before the
        first launch, on the current stream, which each lane then waits for.
        `others` are split as this array is."""
        for o in others:
            if o.mesh is not self.mesh or o.ranges != self.ranges:
                raise ValueError("arrays that are not split alike")
        ready = [None if x is None or prepare is None else prepare(lane.device)
                 for lane, x in zip(self.mesh.lanes, self.parts)]
        parts = []
        for i, (lane, x) in enumerate(zip(self.mesh.lanes, self.parts)):
            if x is None:
                parts.append(None)
                continue
            with lane.on():
                parts.append(run(ready[i], x, *(o.parts[i] for o in others)))
        return Sharded(self.mesh, parts, self.ranges, self.axis)

    def host_parts(self, rows: int | None = None) -> list:
        """Each lane's part on the host (None for an empty lane): every
        download on its lane's stream into pinned memory, one wait at the
        end.  `rows` cuts the leading axis first (width-sharded arrays)."""
        held = [(lane, x if rows is None else x[:rows])
                for lane, x in zip(self.mesh.lanes, self.parts) if x is not None]
        got = iter(fetch(held))
        return [None if x is None else next(got) for x in self.parts]

    def host(self, rows: int | None = None) -> np.ndarray:
        """The whole array on the host, the parts joined along the axis."""
        parts = [p for p in self.host_parts(rows) if p is not None]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=self.axis)

    def host_blocks(self, T: int, n: int, rows: int | None = None) -> dict[int, np.ndarray]:
        """Of a width-sharded array: {b: [rows, T]} for the blocks b < n of
        width T laid side by side.  A block that lies in one lane's part is a
        view of that download; one that straddles a cut is joined."""
        parts = self.host_parts(rows)
        out = {}
        for b in range(n):
            lo, hi = b * T, (b + 1) * T
            pieces = [p[:, max(lo, a) - a : min(hi, e) - a]
                      for p, (a, e) in zip(parts, self.ranges) if p is not None and a < hi and lo < e]
            out[b] = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=1)
        return out

    def gather(self, device) -> torch.Tensor:
        """The whole array as one tensor on `device`: waits for the lanes,
        then copies every part there and joins them (an explicit re-placing,
        for a caller that goes on without the mesh)."""
        dev = resolve(device)
        self.mesh.synchronize()
        parts = [p for p in self.parts if p is not None]
        for p in parts:  # allocated on a lane's stream, read from here on by the current one
            if p.is_cuda:
                p.record_stream(torch.cuda.current_stream(p.device))
        return torch.cat([p.to(dev) for p in parts], dim=self.axis)


def shard_width(D: np.ndarray, mesh: Mesh, block: int | None = None, live_rows: int | None = None,
                rows: int | None = None) -> Sharded:
    """Place a host payload matrix D [n, t] with its width split over the
    mesh: lane i holds the columns `shard_ranges(t, lanes, block)[i]` as a
    [rows, hi - lo] tensor (rows: default n), uploaded on its stream
    (`upload`).  Out of a pinned D every lane takes its rows in one copy: the
    whole width as it is, a column range by one pitched copy; a pageable D
    goes through pinned staging, host work inside whatever clock runs
    around this call.  Every upload is issued before any lane's kernels, so
    that one lane's copy runs beside another's replay.

    `live_rows`: rows at or past it are known to be zero (an encoder's D
    holds K payload rows of M_pad); they are neither staged nor uploaded but
    zeroed on the device."""
    check_mesh(mesh)
    src = torch.as_tensor(D)
    ranges = shard_ranges(D.shape[1], mesh.size, block)
    rows = D.shape[0] if rows is None else rows
    live = min(D.shape[0], rows) if live_rows is None else live_rows
    parts = [None if lo == hi else upload(lane, src[:, lo:hi], rows, live)
             for lane, (lo, hi) in zip(mesh.lanes, ranges)]
    return Sharded(mesh, parts, ranges, axis=1)


def whole(x: torch.Tensor) -> Sharded:
    """An unsharded [rows, t] tensor as a width-split array of one part, on
    the local mesh of its device (the default path's view of it)."""
    return Sharded(local_mesh(x.device), [x], [(0, x.shape[1])], axis=1)


def shard_stack(n_items: int, mesh: Mesh, shape: tuple, fill, dtype=torch.uint8) -> Sharded:
    """A stack [n_items, *shape] split over the mesh on its leading axis, in
    contiguous runs (`deal`): lane i's run [lo, hi) is staged by
    `fill(host [hi - lo, *shape], lo, hi)` and uploaded on its stream.  Runs
    may be uneven and a lane past the items stays empty."""
    check_mesh(mesh)
    ranges = deal(n_items, mesh.size)
    parts = [None if lo == hi else
             stage(lane, (hi - lo, *shape), lambda h, lo=lo, hi=hi: fill(h, lo, hi), dtype)
             for lane, (lo, hi) in zip(mesh.lanes, ranges)]
    return Sharded(mesh, parts, ranges, axis=0)


def shard_assemble(n_items: int, mesh: Mesh, shape: tuple, part) -> Sharded:
    """A stack [n_items, *shape] split over the mesh on its leading axis as
    `shard_stack` splits it: lane i's run [lo, hi) is `assemble`d on its
    stream from part(lo, hi) = (heads, extra, places), places counted in
    that run's stack."""
    check_mesh(mesh)
    ranges = deal(n_items, mesh.size)
    parts = [None if lo == hi else assemble(lane, (hi - lo, *shape), *part(lo, hi))
             for lane, (lo, hi) in zip(mesh.lanes, ranges)]
    return Sharded(mesh, parts, ranges, axis=0)


def shard_blocks(a: np.ndarray, mesh: Mesh) -> Sharded:
    """A ready host stack [n, ...] (uint8 or int32) split as `shard_stack`
    splits: small per-block operands beside a payload stack.  They too go
    through pinned staging: a copy from pageable memory would make the host
    wait for the lane's stream."""
    dtype = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32}[a.dtype]
    return shard_stack(a.shape[0], mesh, a.shape[1:], lambda h, lo, hi: np.copyto(h.numpy(), a[lo:hi]), dtype)


def _same(D: Sharded, mesh: Mesh) -> None:
    if D.mesh is not mesh:
        raise ValueError("the array is sharded over another mesh than the one given")


def replay_sharded(ds, D: Sharded, mesh: Mesh) -> Sharded:
    """Sharded structured replay: D [M_pad, t] split on width -> C [L, t].
    Each lane replays the program of the schedule's signature for its width on its stream
    (`ops/program.py`; the local mesh's one lane: the current stream)."""
    _same(D, mesh)
    return D.each(lambda dev: device_arrays(ds, dev), program.replay)


def lt_sharded(C: Sharded, isis: np.ndarray, P, mesh: Mesh) -> Sharded:
    """Sharded LT combine: C [L, t] split on width -> symbols [n_pad, t]."""
    _same(C, mesh)
    return C.each(lambda dev: lt_plan(isis, P, dev), lambda plan, c: lt_combine(c, plan))


def codec_step_sharded(ds, isis: np.ndarray, P, D: Sharded, mesh: Mesh) -> tuple[Sharded, Sharded]:
    """Full device step (replay + LT) on every lane: (C, symbols)."""
    C = replay_sharded(ds, D, mesh)
    return C, lt_sharded(C, isis, P, mesh)


def w_step_sharded(plan, D: Sharded, mesh: Mesh) -> Sharded:
    """Sharded dense-W decode (`WSchedule.apply`): W replicated, payload
    width split -- the matmul is elementwise in the t axis."""
    _same(D, mesh)
    return D.each(plan.staged, lambda _staged, d: plan.apply(d))
