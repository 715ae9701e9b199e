"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:

0. device: the card, its power limit, the software stack;
1. build: the CUDA kernels of nanorq_tpu_torch/csrc, compiled by nvcc;
2. kernel parity: each kernel against its plain torch version on the same
   inputs, bit-exact, at the shapes the K=1000 main path gives it (t = 1280
   and t = 200*1280) and at a ragged shape; the three gather probes at K1's
   shapes, timed with their plain versions and with K1's time beside
   theirs, each shape's bytes bound and, at width 1, torch.index_select's
   time; gather_v1's heaviest shape in each wait mode; gather_v2 and
   torch.index_select (its library_ms) at take_rows, both in CUDA graphs,
   in turn; gather_db at the object-wide shapes in CUDA graphs; K1 at every
   gather of one warm encode (tools/gather_launches.py: the 17 launches of
   a replay and a repair LT combine at t = 200*1280, recorded as they run,
   in every mode -- out=, rows, zero_index -- each bit-exact, timed, with
   its bounds, index_select beside the width-1 ones, and the sums); K2 and
   K3 through tools/matmul_forms.py (the encoder's own matrices, the single
   and batched W decodes -- nb = 200 -- and the residual chunk, then the
   edge shapes: ragged k and t, m < 16, k split across blocks, nb = 1 and
   200), with their bounds; an index outside the source makes gather_xor
   raise, a ragged width makes the probes raise;
3. encode: an object of Z=200 blocks x K=1000 x T=1280 through the port's
   Encoder and codec.batch (generate + 200 repair symbols per block), the
   object loaded into pinned memory (`load_s`); the default path cuts it
   into width slices on lanes of the card (`parallel.mesh.default_mesh`:
   S = `slice_count(Z*T, T, K)` slices, each its own stream), each slice's K
   live rows uploaded by one pitched copy out of the object
   (`kernels.copy2d`, counted in `kernels.COPIES`: S an encode); cold,
   second and warm: each slice's replay is the encoder schedule's program
   (ops/program.py), which the cold run (eager) leaves uncaptured, the
   second captures and the warm replays; 17 K1 launches a slice; the
   device memory allocated after the phase and at its peak;
4. decode: 6% source loss + 5% repair overhead per block, recovered by
   Decoder.repair_all(backend="device") (at K=1000 every plan is a dense-W
   one; a structured plan would replay its program from its second
   replay on); each block's received rows sit in the decoder's pinned
   ingestion slab and are uploaded from there as they are; the warm run
   must take one K2 and two K1 launches per stacked batch of blocks (the
   placement of the repair rows into the stack, then the stacked gather);
   its first two K1 launches (the placement, and the stacked gather at
   t = 1280) are timed after the main path as the encode's are; each run's
   ingestion ms, the repair's host staging ms and the bytes its ingestion
   slabs hold and pin (`[decode-ingest]` lines); the device memory as in
   phase 3;
5. checks and times: the systematic property on every block, one block
   against the numpy oracle (nanorq_tpu_torch.host), the decoded bytes, the
   kernel launch counts of the main path (phases 3-4: 17 K1 launches per
   encode slice), no out-of-range gather index in it, and the encode/decode
   wall times; then one warm encode and one warm device decode under
   torch.profiler: the device time of each kernel and copy, summed over the
   run, beside its wall time (`busy` = that sum over the wall: on the sliced
   encode the slices' work overlaps, so it may pass 1; `busy_union` counts
   the time the card was doing anything once), and the copies by kind (and
   the decode's ingestion and host staging ms); the encode's host-to-device
   copies that ran while a kernel ran (`htod_overlap_ms`,
   `tools/pipe_sweep.overlap`); the encode must show 17 K1 kernels a slice
   and no torch.cat copy, and neither run may copy from or into pageable
   memory;
6. probe path: nanorq_tpu_torch.tools.gather_probe over both probe tables,
   every line bit-exact, with its launch counts;
7. decode arms: the phase-4 object and losses through repair_all with
   backend "auto" (warm plans from phase 4), then "res", "res_host" and
   "host", cold (memos cleared) and warm, then "auto" cold; every "auto"
   block goes to the arm the port's rule names for K' (`codec.api.auto_arm`,
   its boundaries on an `[arms]` line); every run restores the bytes;
   seconds and Mb/s per arm;
8. cli: nanorq_tpu_torch.cli.encode and .decode on an 8 MiB file at
   T=1280, decoded with the default backend and with --layout-cache (the
   device arm), byte-compared with the file;
9. bench: nanorq_tpu_torch.bench at K = 1000 and K = 100 with every decode
   arm cold and warm (--arms --iters 4 --deadline 120), in this process: one
   line per K with every key, a number or null, `dec_plan` "W" at K = 1000,
   the program counters of each K (`bench.PROGRAM_KEYS`) with at least one
   capture and one replay; its lines are printed again as `[bench] ...`;
10. mesh: the object of phase 3 and the deliveries of phase 4 over lanes
   (nanorq_tpu_torch/parallel: a lane is a card, a stream of its own and
   pinned staging) -- over `make_mesh()` (every visible card, a lane each) and
   over 1, 2 and 4 lanes dealt round-robin over the cards (on one card: lanes
   of cuda:0).  `batch.generate(mesh=)` + `batch.repair_symbols(mesh=)` four
   times in turn with the default path (`mesh=None`: the slices of phase
   3) and the unsliced `1`-lane mesh, host clock between
   synchronisations, the first two rounds of a mesh apart (the first pins
   its staging, the second captures its lanes' programs),
   every result held bit for bit against phase 3's repair symbols; the upload
   alone: one lane's copy of the live rows (contiguous, the unsliced path),
   the default path's slices (a pitched copy each), a pageable copy of
   every row, 4 lanes with every row (staged) and with the K live rows (a
   pitched copy each), the host's staging copy into pinned memory and the
   copy from pinned memory to the card; the four sharded calls of one warm
   encode on the default path's slices, on 1 and on 4 lanes with a wait
   after each (where a warm encode's time goes); `repair_all(backend="device", mesh=)` cold
   on `make_mesh()`, then warm with `mesh=None` and 4 lanes in turn, twice,
   every run restoring the object; `parallel._dryrun.run(4, device)` in both
   modes; no gather index flagged on any card.  One `[mesh]` line holds the
   times and the device memory (as in phase 3) beside the card's name and
   power limit; then the `[pipeline]` line: the slices and their streams,
   the warm encode sliced (`none`) and unsliced (`1`) in ms, the phase 5
   profile's overlapped host-to-device ms, phase 3's programs and peak
   memory, the card's name and power limit;
11. sweeps: each retuning sweep of nanorq_tpu_torch/tools at one small point
   (K = 1000, 4 blocks): cb_probe over two chunk sizes, C bit-identical;
   slotfill_probe; bsweep; wb_probe, every form exact; replay_stage_prof;
   decprep_prof (a cold decode block's host prep and device steps, K = 1000,
   structured, two patterns); hostarm_prof (the host arms' prep, batch call,
   native call and native stage split, and the dense-W device arm's steps,
   at K = 1000 over 4 blocks, cold and warm);
12. program: the replay through the schedule's program (one captured CUDA
   graph between the prologue's two gathers and the epilogue's one) against
   the eager replay, bit for bit, at K=1000 B=32, K=10000 B=4 and 16,
   K=50000 B=1 and 4 (encoder schedules) and on one warm structured decode
   pattern at K=50000, one block: both timed in turn (CUDA events around
   back-to-back calls), after one eager call the capturing call and the
   capture by the host clock,
   the launches of one call; then `decode-shared`: the K=50000 layout frozen
   by _FREEZE_AFTER + 1 patterns, 6 fresh patterns each replayed once
   through the program of its signature (the second of a signature
   captures, the later ones replay it: `replay_program_shared`), bit for bit
   against the eager replay, per pattern the eager and the program call's
   ms; then the program counters and the bytes the program cache holds;
13. soak: nanorq_tpu_torch.tools.longfuzz on the card from a fixed seed
   until 60 s or 60 trials have passed -- random sizes, T, Al, Z, N, loss,
   overhead, ingestion, delivery order, IO backend, plan path, entry point,
   decode arm, lanes and program budget -- the first trial at a 1-byte
   program budget (every capture evicts), the second over 2 lanes; every
   trial bit-exact, with at least one program captured and one evicted; its
   `[soak]` line holds the trials and the program counters.

Phases 3, 9 and 10 replay the encoder schedule through its program, as the
codec does on a card.  Each of the paths 3-4, 6, 7, 8, 9, 10, 11, 12 and 13 runs with the launch counts set
to 0 just before it and read just after, and fails if a kernel it runs never
launched.
Any failure raises and the script exits non-zero.  The last line is one JSON
object: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports no JAX and nothing of the JAX package: the host pieces it needs come
through nanorq_tpu_torch.
"""

import contextlib
import io
import json
import os
import platform
import subprocess
import tempfile
import time

import numpy as np
import torch

K, T, Z, N_REPAIR = 1000, 1280, 200, 200  # 256 MB: Z blocks of K symbols of T bytes
SEED = 0  # object bytes, parity inputs and loss patterns all derive from it
WIDE = Z * T  # the payload width of the whole object
CLI_BYTES = 8 << 20
# kernel -> (its source, the TPU kernel it replaces)
PORTED = {
    "gather_xor": ("nanorq_tpu_torch/csrc/gather_xor.cu", "nanorq_tpu/ops/pallas_kernels.py:290"),
    "gf2_matmul": ("nanorq_tpu_torch/csrc/gf2_matmul.cu", "nanorq_tpu/ops/pallas_kernels.py:148"),
    "gf256_matmul": ("nanorq_tpu_torch/csrc/gf256_matmul.cu", "nanorq_tpu/ops/pallas_kernels.py:221"),
    "gather_v1": ("nanorq_tpu_torch/csrc/gather_probe.cu", "tools/gather_v2_probe.py:58"),
    "gather_v2": ("nanorq_tpu_torch/csrc/gather_probe.cu", "tools/gather_v2_probe.py:111"),
    "gather_db": ("nanorq_tpu_torch/csrc/gather_probe.cu", "tools/gather_db_probe.py:68"),
}
PROBES = ("gather_v1", "gather_v2", "gather_db")


def _say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _device() -> torch.device:
    return torch.device("cuda", 0)


def _cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _once_ms(fn) -> float:
    """The time of one call of fn() (no warm-up: a call that must run once),
    CUDA events around it after a synchronisation."""
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max()) if a.numel() else 0


HBM_BPS = 3.35e12  # the H100 SXM data sheet's memory rate


def _gather_bytes(src: torch.Tensor, idx: torch.Tensor) -> int:
    """Bytes a gather must move: each distinct source row read once, each
    output row written once, the indices read once."""
    return int(torch.unique(idx).numel()) * src.shape[1] + idx.shape[0] * src.shape[1] + idx.numel() * 4


def phase_matmul(dev) -> dict:
    """K2 and K3 against the plain versions at the main path's shapes and at
    the edge shapes (tools/matmul_forms.py): one line each; the report
    holds, per kernel, its heaviest main-path shape (t = 200*T)."""
    from nanorq_tpu_torch.tools import matmul_forms

    report = {}
    for name, spec in {**matmul_forms.SHAPES, **matmul_forms.EDGES}.items():
        line = matmul_forms.measure(name, spec, dev, 20, timed=name in matmul_forms.SHAPES)
        _say("matmul", **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in line.items()})
        kern = "gf2_matmul" if line["kind"] == "gf2" else "gf256_matmul"
        rep = report.setdefault(kern, {"max_abs_err": 0, "ms": 0.0})
        if line["t"] == WIDE and "_full" not in name and line["ms"] >= rep["ms"]:  # uncut: not the main path
            rep.update(ms=line["ms"], plain_ms=line["plain_ms"], shape=f"{name} ({line['form']})",
                       bound_ms=line["bound_ms"], bound_by=line["bound_by"], library_ms=None)
        torch.cuda.empty_cache()
    return report


def phase_parity(dev, rng, P) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    from nanorq_tpu_torch.host import encoder_schedule
    from nanorq_tpu_torch.ops import gfmat, kernels
    from nanorq_tpu_torch.ops.lt import lt_plan
    from nanorq_tpu_torch.ops.replay import device_arrays
    from nanorq_tpu_torch.tools.matmul_forms import graph_ms

    ds = encoder_schedule(P.Kp)
    arr = device_arrays(ds, dev)
    lt = lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def zero_last(x):
        x[-1] = 0  # the sentinel row the codec's indices point at
        return x

    seg = next(s for s in arr["tri"] if s["ranges"])
    widest = max(lt.classes, key=lambda c: c.numel())
    cases = {n: [] for n in PORTED}  # name -> [(label, main-path shape?, kernel fn, plain fn, K1 label)]
    bounds, library = {}, {}  # gather label -> (bound ms, "bytes"); K1 label -> one torch call
    select_label = None  # the main path's width-1 gather: where gather_v2 meets index_select
    for t in (T, WIDE):
        D = zero_last(u8(ds.M_pad, t))
        z = zero_last(u8(ds.Lpad + ds.u_pad, t))
        C_ext = zero_last(u8(ds.L + 1, t))
        g = [
            (f"take_rows D[{ds.M_pad},{t}] idx{tuple(arr['piv_rows'].shape)}", D, arr["piv_rows"]),
            (f"trisolve z[{ds.Lpad + ds.u_pad},{t}] idx{tuple(seg['ranges'][-1][2][0].shape)}",
             z, seg["ranges"][-1][2][0]),
            (f"bsel z[{ds.Lpad + ds.u_pad},{t}] idx{tuple(arr['bsel_passes'][0].shape)}", z, arr["bsel_passes"][0]),
            (f"lt_class C_ext[{ds.L + 1},{t}] idx{tuple(widest.shape)}", C_ext, widest),
        ]
        for label, src, ix in g:
            bounds[label] = (_gather_bytes(src, ix) / HBM_BPS * 1e3, "bytes")
            if ix.shape[1] == 1:  # a width-1 gather is one torch.index_select
                library[label] = lambda s=src, i=ix[:, 0]: torch.index_select(s, 0, i)
            main = t == WIDE
            if main and ix.shape[1] == 1:
                select_label = label
            plain = lambda s=src, i=ix: gfmat.xor_reduce_gather(s, i)  # noqa: E731
            cases["gather_xor"].append((label, main, lambda s=src, i=ix: kernels.gather_xor(s, i), plain, None))
            for mode in (0, 1, 2):
                cases["gather_v1"].append((f"{label} mode{mode}", main,
                                           lambda s=src, i=ix, m=mode: kernels.gather_v1(s, i, m), plain, label))
            sent = src.shape[0] - 1
            cnt = kernels.probe_counts(ix, sent)
            cases["gather_v2"].append((f"{label} sentinel{sent}", main,
                                       lambda s=src, i=ix, c=cnt, x=sent: kernels.gather_v2(s, i, c, x),
                                       lambda s=src, i=ix, x=sent: gfmat.xor_reduce_gather_skip(s, i, x), label))
            cases["gather_db"].append((label, main, lambda s=src, i=ix: kernels.gather_db(s, i), plain, label))
    # ragged: t not a multiple of 16 (K2/K3's ragged shapes: phase_matmul)
    tr = 1283
    src = zero_last(u8(300, tr))
    ix = torch.from_numpy(rng.integers(0, 300, (100, 5)).astype(np.int32)).to(dev)
    cases["gather_xor"].append(("ragged src[300,1283] idx(100,5)", False,
                                lambda: kernels.gather_xor(src, ix), lambda: gfmat.xor_reduce_gather(src, ix), None))
    # ragged, with output rows and the implicit zero row: index 299 of src[:299]
    out_rows = torch.from_numpy(rng.permutation(150)[:100].astype(np.int32)).to(dev)
    kout = zero_last(u8(150, tr))
    pout = kout.clone()
    cases["gather_xor"].append((
        "ragged src[299,1283] idx(100,5) rows out[150] zero_index", False,
        lambda: kernels.gather_xor(src[:299], ix, out=kout, rows=out_rows, zero_index=299),
        lambda: gfmat.xor_reduce_gather(src[:299], ix, out=pout, rows=out_rows, zero_index=299), None))
    for name, fn in (("gather_v1", lambda: kernels.gather_v1(src, ix)),
                     ("gather_v2", lambda: kernels.gather_v2(src, ix, kernels.probe_counts(ix, 299), 299)),
                     ("gather_db", lambda: kernels.gather_db(src, ix))):
        try:
            fn()
        except ValueError:
            _say("parity", kernel=name, ragged_t=tr, refused="ValueError")
            continue
        raise AssertionError(f"{name} took a width t={tr}, not a multiple of 16")
    for s300 in (src, zero_last(u8(300, T))):  # byte lanes, then 16-byte lanes
        kernels.gather_xor(s300, ix, check=True)  # in range: no error
        for bad in (300, -1):  # one past the last row, and a negative index
            bad_ix = ix.clone()
            bad_ix[37, 2] = bad
            try:
                kernels.gather_xor(s300, bad_ix, check=True)
            except IndexError:
                continue
            raise AssertionError(f"gather_xor took index {bad} of a 300-row source")
    _say("parity", kernel="gather_xor", out_of_range_index="IndexError")
    # K1 is timed here only for the probe lines beside it (k1_ms); its own
    # report comes from every launch of one encode (phase_k1_launches)
    report, k1_ms, lib_ms = {}, {}, {}
    for name, rows in cases.items():
        if not rows:  # K2 and K3: phase_matmul below
            continue
        worst, main_ms, main_plain, main_shape, main_k1 = 0, 0.0, 0.0, "", None
        main_lib = None
        modes = {}  # gather_v1: wait mode -> (ms, shape) of its heaviest main-path shape
        for label, main, kfn, pfn, k1 in rows:
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            err = _max_err(got, want)
            worst = max(worst, err)
            if err:
                raise AssertionError(f"{name} {label}: kernel differs from plain, max_abs_err={err}")
            graphed = name == "gather_db" and main  # device time: one CUDA graph of 10 launches
            ms = graph_ms(kfn, 10) if graphed else _cuda_ms(kfn, 10 if main else 20)
            if name == "gather_xor":
                k1_ms[label] = ms
                _say("parity", kernel=name, shape=label.replace(" ", ""), exact=True, ms=f"{ms:.4f}")
                continue
            pms = _cuda_ms(pfn, 3 if main else 10)
            extra = {"k1_ms": f"{k1_ms[k1]:.4f}"}
            if k1 in library:  # a width-1 gather: index_select's function
                if k1 not in lib_ms:
                    lib_ms[k1] = _cuda_ms(library[k1], 10 if main else 20)
                extra["library_ms"] = f"{lib_ms[k1]:.4f}"
            extra["bound_ms"] = f"{bounds[k1][0]:.4f}"
            if graphed:
                extra.update(timing="cuda_graph", share=f"{bounds[k1][0] / ms:.3f}")
            _say("parity", kernel=name, shape=label.replace(" ", ""), exact=True,
                 ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", **extra)
            if main and name == "gather_v1":
                mode = label.rsplit(" mode", 1)[1]
                if ms >= modes.get(mode, (0.0,))[0]:
                    modes[mode] = (ms, label, k1)
            if name == "gather_v2" and k1 == select_label:
                # one method, one place: the kernel and index_select in CUDA graphs, in turn, twice
                runs = [(graph_ms(kfn, 10), graph_ms(library[k1], 10)) for _ in range(2)]
                ms, lib = (sum(r[i] for r in runs) / len(runs) for i in (0, 1))
                _say("parity", kernel=name, shape=label.replace(" ", ""), timing="cuda_graph", ms=f"{ms:.4f}",
                     library_ms=f"{lib:.4f}", runs=json.dumps([[round(x, 4) for x in r] for r in runs]),
                     bound_ms=f"{bounds[k1][0]:.4f}", share=f"{bounds[k1][0] / ms:.3f}")
                main_ms, main_plain, main_shape, main_k1, main_lib = ms, pms, label, k1, lib
            elif main and ms >= main_ms and name != "gather_v2":  # the heaviest main-path shape at t=200*T
                main_ms, main_plain, main_shape, main_k1 = ms, pms, label, k1
                main_lib = float(extra["library_ms"]) if "library_ms" in extra else None
        if name == "gather_xor":
            report[name] = {**phase_k1_launches(dev), "max_abs_err": worst}
            continue
        b_ms, b_by = bounds[main_k1]
        report[name] = {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain, "shape": main_shape,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": main_lib,
                        "timing": "cuda_events" if name == "gather_v1" else "cuda_graph"}
        for mode, (ms, label, k1) in sorted(modes.items()):
            _say("parity", kernel=name, mode=mode, heaviest=label.replace(" ", ""), ms=f"{ms:.4f}",
                 k1_ms=f"{k1_ms[k1]:.4f}", bound_ms=f"{bounds[k1][0]:.4f}", share=f"{bounds[k1][0] / ms:.3f}")
        if modes:
            report[name]["modes"] = {mode: {"ms": ms, "shape": label} for mode, (ms, label, _) in modes.items()}
    report.update(phase_matmul(dev))
    if kernels.take_index_errors(dev) or kernels.take_count_errors(dev):
        raise AssertionError("a parity launch flagged an index or a count")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return report


def _k1_line(tag, line: dict) -> None:
    _say("k1", launch=tag, **{k: (f"{v:.4f}" if isinstance(v, float) else str(v).replace(" ", ""))
                              for k, v in line.items()})


def phase_k1_launches(dev) -> dict:
    """K1 at each of the 17 launches of one warm encode at t = Z*T
    (tools/gather_launches.py), bit-exact and timed; the sums per encode.
    Returns K1's report at its heaviest launch."""
    from nanorq_tpu_torch.tools import gather_launches

    rec = gather_launches.encode_launches(dev, WIDE, SEED)
    if len(rec) != gather_launches.ENCODE_LAUNCHES:
        raise AssertionError(f"one encode ran {len(rec)} K1 launches, expected {gather_launches.ENCODE_LAUNCHES}")
    lines = [gather_launches.measure(r, 10) for r in rec]
    del rec
    for i, line in enumerate(lines):
        _k1_line(i + 1, line)
    _k1_line("sum", gather_launches.totals(lines))
    top = max(lines, key=lambda x: x["ms"])
    torch.cuda.empty_cache()
    return {"max_abs_err": 0, "ms": top["ms"], "plain_ms": top["plain_ms"], "shape": top["shape"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes", "library_ms": top["library_ms"]}


def phase_device() -> tuple[str, str, torch.device]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    from nanorq_tpu_torch.host import native_available

    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    _say("device", kind=json.dumps(kind), count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, machine=platform.machine(), native_solver=native_available(),
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi, kind, _device()


def phase_build() -> None:
    from nanorq_tpu_torch.ops import _build

    _build.load()
    info = _build.build_info
    _say("build", seconds=f"{info['seconds']:.2f}", built=info["built"], lib=info["path"])
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas" + line.split("ptxas", 1)[-1], flush=True)


def phase_encode(enc, batch, dev) -> tuple[dict, list[float]]:
    """generate + repair_symbols for the whole object: cold, second, warm."""
    from nanorq_tpu_torch.codec import batch as tbatch

    secs = []
    for _ in range(ENCODE_RUNS):  # cold (schedule upload, LT plan), the program's capture, warm
        batch.C = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tbatch.generate(batch, dev)
        reps = tbatch.repair_symbols(batch, N_REPAIR, dev)  # fetched to the host
        secs.append(time.perf_counter() - t0)
    return reps, secs


ENCODE_RUNS = 3  # phase 3's runs: cold, second (captures the program), warm


def _mem() -> str:
    """The device memory allocated now and at its peak since the last reset
    (GiB), and what the program cache holds (MB), as one JSON object."""
    from nanorq_tpu_torch.ops import program

    return json.dumps({"allocated_GiB": round(torch.cuda.memory_allocated() / 2**30, 3),
                       "peak_GiB": round(torch.cuda.max_memory_allocated() / 2**30, 3),
                       "programs_MB": round(program.cached_bytes() / 2**20, 1)})


def _deliveries(seed: int) -> list:
    """Per block (received source ESIs, received repair ESIs): 6% source loss,
    gaps + 5% repair symbols (the loss model of bench.py:166-167)."""
    rng = np.random.default_rng(seed)
    out = []
    for sbn in range(Z):
        gaps = np.nonzero(rng.random(K) < 0.06)[0]
        nrep = gaps.size + max(1, int(0.05 * K))
        if nrep > N_REPAIR:
            raise AssertionError(f"block {sbn} needs {nrep} repair symbols, encoded {N_REPAIR}")
        out.append((np.setdiff1d(np.arange(K), gaps), np.arange(K, K + nrep)))
    return out


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _stage_s() -> float:
    from nanorq_tpu_torch.host import stats

    return stats.snapshot()["timers"].get("host_stage", {}).get("total_s", 0.0)


def _host_pinned() -> dict:
    """The torch's own account of its pinned host blocks now (bytes), where
    it has one."""
    if not hasattr(torch.cuda, "host_memory_stats"):
        return {}
    return {k: v for k, v in torch.cuda.host_memory_stats().items() if "bytes" in k and k.endswith(".current")}


def _decode_once(enc, data, reps, deliveries, dev, backend: str, around=contextlib.nullcontext, mesh=None):
    """A fresh Decoder fed with `deliveries` (its ingestion timed), then
    repair_all(backend, mesh) inside the context `around()`, timed
    (ingestion excluded): (restored object, seconds, {"preps": per-block
    patterns, "ingest_ms", "stage_ms": the repair's host copy into pinned
    staging, "ingest_bytes" / "pinned_bytes": its ingestion slabs, and what
    they pin, `Decoder.ingest_bytes`})."""
    from nanorq_tpu_torch.codec.api import Decoder
    from nanorq_tpu_torch.host import MemoryIO, make_tag

    payloads = data.reshape(Z * K, T)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    sends = [(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], reps[sbn][: rep_esis.size],
              [make_tag(sbn, int(e)) for e in rep_esis]) for sbn, (keep, rep_esis) in enumerate(deliveries)]
    t0 = time.perf_counter()
    for src, src_tags, rep, rep_tags in sends:
        dec.add_symbols(src, src_tags, io)
        dec.add_symbols(rep, rep_tags, io)
    info = {"ingest_ms": 1e3 * (time.perf_counter() - t0)}
    info["ingest_bytes"], info["pinned_bytes"] = dec.ingest_bytes()
    info["preps"] = [dec._repair_prepare(sbn) for sbn in range(Z)]
    _sync_all()
    stage0 = _stage_s()
    with around():
        t0 = time.perf_counter()
        if not dec.repair_all(io, backend=backend, mesh=mesh):
            raise AssertionError(f"repair_all({backend!r}) reported unrecovered blocks")
        secs = time.perf_counter() - t0
    info["stage_ms"] = 1e3 * (_stage_s() - stage0)
    return out, secs, info


def phase_decode(enc, data, reps, dev, deliveries):
    """repair_all(backend="device") at 6% loss + 5% overhead on every block,
    cold (every pattern solved fresh) then warm (plans cached).  The warm
    run must stack its dense-W blocks: per batch of up to
    Decoder._BATCH_FLUSH blocks one K2 launch and two K1 launches (the
    placement of the repair rows into the stack, `parallel.mesh.assemble`,
    then the stacked gather), not one set per block.  Prints each run's
    ingestion ms, the repair's host staging ms and the bytes the
    ingestion slabs hold and pin.  Returns the warm run's first two K1
    launches (`kernels.record_gathers`) too."""
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.codec.api import Decoder
    from nanorq_tpu_torch.ops import kernels

    tcache.clear_decoder_cache()
    out_cold, cold_s, cold_info = _decode_once(enc, data, reps, deliveries, dev, "device")
    preps = cold_info["preps"]
    before = dict(kernels.LAUNCHES)
    with kernels.record_gathers(limit=2) as rec:  # holds no later batch's payload
        out_warm, warm_s, info = _decode_once(enc, data, reps, deliveries, dev, "device")
    warm = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    batches = -(-Z // Decoder._BATCH_FLUSH)
    _say("decode", warm_launches=json.dumps(warm), batches=batches)
    for name, got in (("cold", cold_info), ("warm", info)):
        _say("decode-ingest", run=name, ingest_ms=f"{got['ingest_ms']:.3f}", stage_ms=f"{got['stage_ms']:.3f}",
             ingest_bytes=got["ingest_bytes"], pinned_bytes=got["pinned_bytes"],
             host_pinned=json.dumps(_host_pinned()))
    if warm["gf2_matmul"] != batches or warm["gather_xor"] != 2 * batches:
        raise AssertionError(f"warm device decode ran {warm}, expected {batches} K2 and {2 * batches} K1 launches")
    kinds = {"gf2_w": 0, "gf256_w": 0, "structured": 0}
    for _gaps, isis, ov in preps:  # the plans decoder_plan cached for these patterns
        plan = tcache.decoder_plan(enc.P, isis, ov)
        if isinstance(plan, tcache.WSchedule):
            kinds["gf2_w" if plan.Wbits is not None else "gf256_w"] += 1
        else:
            kinds["structured"] += 1
    gaps = sum(p[0].size for p in preps)
    return (out_cold, out_warm), (cold_s, warm_s), kinds, gaps, rec


def _mbps(nbytes: int, s: float) -> str:  # BASELINE.md's unit: 8 * bytes / (2**20 * seconds)
    return f"{8 * nbytes / (1 << 20) / s:.1f}"


def _counts() -> dict:
    from nanorq_tpu_torch.host import stats

    c = stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in ("repair_device_blocks", "repair_res_blocks", "repair_res_host_blocks",
                                      "repair_host_blocks")}


def phase_arms(enc, data, reps, dev, deliveries) -> dict:
    """The decode arms on the phase-4 object: "auto" warm (phase 4 cached every
    pattern's plan), then "res", "res_host" and "host" cold (decode memos
    cleared; the per-K' canonical factorization stays, as in nanorq_tpu) and
    warm, then "auto" cold.  Every block of an "auto" run must go to the arm
    the port's rule names for K' (`codec.api.auto_arm`), whose boundaries
    the `[arms]` line prints."""
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.codec.api import auto_arm, auto_rule

    _say("arms", Kp=enc.P.Kp, rule=json.dumps(auto_rule()), warm=auto_arm(enc.P.Kp, True),
         cold=auto_arm(enc.P.Kp, False))
    runs = [("auto", "warm", {f"repair_{auto_arm(enc.P.Kp, True)}_blocks": Z})]
    for arm, counter in (("res", "repair_res_blocks"), ("res_host", "repair_res_host_blocks"),
                         ("host", "repair_host_blocks")):
        runs += [(arm, "cold", {counter: Z}), (arm, "warm", {counter: Z})]
    runs.append(("auto", "cold", {f"repair_{auto_arm(enc.P.Kp, False)}_blocks": Z}))
    secs = {}
    for arm, state, routed in runs:
        if state == "cold":
            tcache.clear_decoder_cache()
        before = _counts()
        out, s, _ = _decode_once(enc, data, reps, deliveries, dev, arm)
        after = _counts()
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if moved != routed:
            raise AssertionError(f"{arm} {state}: blocks went {moved}, expected {routed}")
        if not np.array_equal(out, data):
            raise AssertionError(f"{arm} {state} did not restore the object")
        secs[f"{arm}_{state}"] = s
        _say("arms", backend=arm, state=state, routed=json.dumps(moved), seconds=f"{s:.4f}",
             mbps=_mbps(data.size, s))
    return secs


def phase_probe() -> list:
    """The probe driver over both probe tables, on the card."""
    from nanorq_tpu_torch.tools import gather_probe

    return gather_probe.main(["--device", "cuda"])


def phase_cli(rng) -> dict:
    """The port's CLI round trip on an 8 MiB file at T=1280: encode, decode
    with the default backend, decode with --layout-cache (the device arm)."""
    from nanorq_tpu_torch.cli import decode as cli_decode
    from nanorq_tpu_torch.cli import encode as cli_encode

    secs = {}
    with tempfile.TemporaryDirectory() as d:
        src, rq = os.path.join(d, "in.bin"), os.path.join(d, "data.rq")
        blob = rng.integers(0, 256, CLI_BYTES, dtype=np.uint8).tobytes()
        with open(src, "wb") as f:
            f.write(blob)
        runs = [("encode", cli_encode.main, [src, str(T), "-o", rq, "--seed", str(SEED), "--device", "cuda"]),
                ("decode", cli_decode.main, [os.path.join(d, "out.bin"), "-i", rq, "--device", "cuda"]),
                ("decode_layout_cache", cli_decode.main,
                 [os.path.join(d, "out2.bin"), "-i", rq, "--layout-cache", os.path.join(d, "lay"),
                  "--device", "cuda"])]
        for name, fn, argv in runs:
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = fn(argv)
            secs[name] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"cli {name} exited {rc}:\n{log.getvalue()[-2000:]}")
            _say("cli", step=name, seconds=f"{secs[name]:.3f}", blocks=len(log.getvalue().splitlines()))
        for out in ("out.bin", "out2.bin"):
            with open(os.path.join(d, out), "rb") as f:
                if f.read() != blob:
                    raise AssertionError(f"cli decode into {out} did not restore the file")
    return secs


def phase_bench() -> dict:
    """The port's bench in this process at K = 1000 and K = 100, every decode
    arm cold and warm (--arms): both lines came, every key is there, a finite
    number or null, the main cells are numbers unless the bench's deadline
    cut the run, and K = 1000 decodes by the dense-W plan."""
    from nanorq_tpu_torch import bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--ks", "1000", "100", "--iters", "4", "--deadline", "120", "--arms"])
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    for line in lines:
        print("[bench] " + json.dumps(line), flush=True)
    if rc != 0:
        raise AssertionError(f"the bench exited {rc}")
    per_k = {line["K"]: line for line in lines if "K" in line}
    if list(per_k) != [1000, 100] or "metric" not in lines[-1]:
        raise AssertionError(f"the bench printed lines for K = {list(per_k)} and no summary after them")
    for k, line in per_k.items():
        for key in bench.KEYS:
            v = line[key]  # a missing key raises
            if not (v is None or isinstance(v, (bool, str)) or np.isfinite(v)):
                raise AssertionError(f"bench K={k}: {key} = {v!r}")
        main_cells = ("encode", "encode_e2e", "decode", "decode0", "decode_e2e", "e2e_device", "e2e_res",
                      "e2e_res_host", "e2e_host", *(f"e2e_{arm}_warm" for arm in bench.ARMS))
        if not line["partial"] and not all(line[c] and line[c] > 0 for c in main_cells):
            raise AssertionError(f"bench K={k}: a cell is missing from a whole run: { {c: line[c] for c in main_cells} }")
        if not (line["replay_program_capture"] >= 1 and line["replay_program_replay"] >= 1
                and line["capture_ms"] > 0):
            raise AssertionError(f"bench K={k}: the encoder's program was not captured and replayed: "
                                 f"{ {p: line[p] for p in bench.PROGRAM_KEYS} }")
    if per_k[1000]["dec_plan"] != "W":
        raise AssertionError(f"bench K=1000 decoded by the {per_k[1000]['dec_plan']} plan, expected the dense-W one")
    return per_k


def phase_mesh(enc, batch, data, reps, dev, deliveries, smi: str) -> dict:
    """Phase 10: phase 3's object and phase 4's deliveries over lanes."""
    from nanorq_tpu_torch import bench as tbench
    from nanorq_tpu_torch.codec import batch as tbatch
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.parallel import _dryrun
    from nanorq_tpu_torch.parallel import mesh as lanes

    n = torch.cuda.device_count()
    meshes = {"cards": lanes.make_mesh(), **{str(k): tbench.lanes_mesh(k, dev) for k in (1, 2, 4)}}
    configs = [("none", None), *meshes.items()]

    def flagged() -> bool:
        return any([m.take_index_errors() for m in meshes.values()])

    enc_s = {name: [] for name, _ in configs}
    for rnd in range(4):  # in turn; a mesh's first round pins its staging, its second captures its programs
        for name, mesh in configs:
            batch.C = None
            _sync_all()
            t0 = time.perf_counter()
            tbatch.generate(batch, dev, mesh=mesh)
            got = tbatch.repair_symbols(batch, N_REPAIR, dev, mesh=mesh)  # on the host when it returns
            enc_s[name].append(time.perf_counter() - t0)
            if sorted(got) != list(range(Z)) or not all(np.array_equal(got[b], reps[b]) for b in range(Z)):
                raise AssertionError(f"encode over mesh {name!r} (round {rnd}): repair symbols differ from phase 3's")
            del got
    batch.C = None
    if flagged():
        raise AssertionError("a gather of the mesh encode met an index outside its source")

    # the upload alone: one lane's copy of the K live rows out of the pinned
    # object (contiguous: the unsliced path's); the default path's slices,
    # a pitched copy each; the copy of every row of a pageable D (what the
    # default path did before it staged through the lanes); 4 lanes, every
    # row of a pageable D (staged) and the K live ones of the pinned object
    # (a pitched copy each); then the two halves of a staged lane's upload
    # apart, the host's staging copy of the live rows into pinned memory and
    # the copy from there to the card; each twice, in turn
    M_pad = tcache.encoder_schedule(enc.P.Kp).M_pad
    paged = np.zeros((M_pad, Z * T), np.uint8)
    paged[:K] = batch.D[:K]
    pinned = torch.empty((K, Z * T), dtype=torch.uint8, pin_memory=True)
    local = lanes.local_mesh(dev)
    sliced = lanes.default_mesh(dev, Z * T, T, K)
    up_s = {}
    for _ in range(2):
        for name, fn in (("default_live_rows", lambda: lanes.shard_width(batch.D, local, block=T, live_rows=K,
                                                                         rows=M_pad)),
                         ("sliced_live_rows", lambda: lanes.shard_width(batch.D, sliced, block=T, live_rows=K,
                                                                        rows=M_pad)),
                         ("pageable_all_rows", lambda: torch.from_numpy(paged).to(dev)),
                         ("lanes4_all_rows", lambda: lanes.shard_width(paged, meshes["4"], block=T)),
                         ("lanes4_live_rows", lambda: lanes.shard_width(batch.D, meshes["4"], block=T, live_rows=K,
                                                                        rows=M_pad)),
                         ("host_staging_live_rows", lambda: pinned.copy_(torch.from_numpy(batch.D)[:K])),
                         ("pinned_copy_live_rows", lambda: pinned.to(dev, non_blocking=True))):
            _sync_all()
            t0 = time.perf_counter()
            x = fn()
            _sync_all()
            up_s.setdefault(name, []).append(time.perf_counter() - t0)
            del x
    del pinned, paged

    # where a warm encode's time goes, on the default path's slices, on 1
    # and on 4 lanes: its four sharded calls with a wait after each (so
    # nothing overlaps), twice
    ds = tcache.encoder_schedule(enc.P.Kp)
    isis = np.arange(enc.P.Kp, enc.P.Kp + N_REPAIR, dtype=np.uint32)
    step_ms = {}

    def timed(key: str, fn):
        _sync_all()
        t0 = time.perf_counter()
        got = fn()
        _sync_all()
        step_ms.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        return got

    for _ in range(2):
        for name, mesh in (("none", sliced), ("1", meshes["1"]), ("4", meshes["4"])):
            Dsh = timed(f"{name}_shard_width", lambda: lanes.shard_width(batch.D, mesh, block=T, live_rows=K,
                                                                         rows=M_pad))
            C = timed(f"{name}_replay", lambda: lanes.replay_sharded(ds, Dsh, mesh))
            sym = timed(f"{name}_lt", lambda: lanes.lt_sharded(C, isis, enc.P, mesh))
            timed(f"{name}_download", lambda: sym.host_blocks(T, Z, N_REPAIR))
            del Dsh, C, sym

    tcache.clear_decoder_cache()
    dec_s = {"cards_cold": [], "none_warm": [], "4_warm": []}
    for key, mesh in [("cards_cold", meshes["cards"])] + 2 * [("none_warm", None), ("4_warm", meshes["4"])]:
        out, s, _ = _decode_once(enc, data, reps, deliveries, dev, "device", mesh=mesh)
        if not np.array_equal(out, data):
            raise AssertionError(f"decode {key} did not restore the object")
        dec_s[key].append(s)
    if flagged():
        raise AssertionError("a gather of the mesh decode met an index outside its source")

    t0 = time.perf_counter()
    for mode in ("full", "structured"):
        _dryrun.run(4, dev, mode)  # checks its own gathers' flags
    dry_s = time.perf_counter() - t0

    fmt = lambda xs: [round(x, 6) for x in xs]  # noqa: E731
    line = {"card": smi, "count": n, "bytes": int(data.size),
            "encode_s": {"none": fmt(enc_s["none"]),
                         **{f"{name}_first": fmt(enc_s[name][:2]) for name in meshes},
                         **{f"{name}_warm": fmt(enc_s[name][2:]) for name in meshes}},
            "upload_s": {k: fmt(v) for k, v in up_s.items()},
            "encode_step_ms": {k: [round(x, 2) for x in v] for k, v in step_ms.items()},
            "decode_s": {k: fmt(v) for k, v in dec_s.items()}, "dryrun_s": round(dry_s, 2),
            "mem": json.loads(_mem())}
    print("[mesh] " + json.dumps(line), flush=True)
    return line


def phase_sweeps() -> dict:
    """Phase 11: each retuning sweep of nanorq_tpu_torch/tools at one small
    point on the card, every line printed again as `[sweep] ...`: cb_probe
    over CB = 128 and 256 (the tool raises unless C is bit-identical),
    slotfill_probe, bsweep, wb_probe (every form exact against the dropped
    source rows) and replay_stage_prof, at K = 1000 and 4 blocks; then
    decprep_prof's cold decode blocks at K = 1000 through the structured
    path (two patterns, the replay through the signature's program), and
    hostarm_prof at K = 1000 over 4 blocks (every arm cold and warm, each
    run bit-exact)."""
    from nanorq_tpu_torch.tools import (bsweep, cb_probe, decprep_prof, hostarm_prof, replay_stage_prof,
                                        slotfill_probe, wb_probe)

    runs = {"cb_probe": (cb_probe.main, ["1000", "128", "256", "--blocks", "4", "--iters", "2"]),
            "slotfill_probe": (slotfill_probe.main, ["1000"]),
            "bsweep": (bsweep.main, ["1000", "4", "--iters", "2"]),
            "wb_probe": (wb_probe.main, ["1000", "--bs", "4", "--iters", "2"]),
            "replay_stage_prof": (replay_stage_prof.main, ["1000", "4", "2"]),
            "decprep_prof": (decprep_prof.main, ["1000", "--structured", "--patterns", "2"]),
            "hostarm_prof": (hostarm_prof.main, ["1000", "--blocks", "4", "--iters", "1"])}
    got = {}
    for name, (fn, argv) in runs.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            lines = fn(argv)
        for line in lines:
            print("[sweep] " + json.dumps(line), flush=True)
        if not lines:
            raise AssertionError(f"{name} printed no line")
        _say("sweep", tool=name, lines=len(lines), seconds=f"{time.perf_counter() - t0:.2f}")
        got[name] = lines
    if not (all(ln["C_equal"] for ln in got["cb_probe"]) and all(ln["exact"] for ln in got["wb_probe"])):
        raise AssertionError("a sweep's result differs")
    torch.cuda.empty_cache()
    return got


# phase 12: (K, blocks) of the encoder schedules the program is held and timed at
PROGRAM_SHAPES = ((1000, 32), (10000, 4), (10000, 16), (50000, 1), (50000, 4))
PROGRAM_DECODE = (50000, 1)  # and one warm structured decode pattern, one block (t = T), as repair_all replays it
PROGRAM_ITERS = 10
SHARED_FRESH = 6  # cold K=50000 patterns, each replayed once through its signature's program


def _decode_pattern(K: int, seed: int):
    """(params, received ISIs, overhead) of a 6% loss + 5% overhead pattern (bench.loss_pattern)."""
    from nanorq_tpu_torch import bench
    from nanorq_tpu_torch.rfc.params import params_init

    P = params_init(K)
    gaps, nrep = bench.loss_pattern(np.random.default_rng(seed), K)
    ov = nrep - gaps.size
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    rep = (np.arange(K, K + nrep) + (P.Kp - K)).astype(np.uint32)
    isis[gaps] = rep[: gaps.size]
    isis[P.Kp:] = rep[gaps.size:]
    return P, isis, ov


def phase_program(dev, smi: str) -> list:
    """Phase 12: the replay through the schedule's program (ops/program.py:
    the prologue's two gathers, one captured CUDA graph, the epilogue's
    gather) against the eager replay (ops/replay.replay), bit for bit, at
    each of PROGRAM_SHAPES and on one warm structured decode schedule: after
    one eager call, the program call that captures by the host clock with a
    wait after it, and the capture's own host time; then eager and program
    in turn, twice each, CUDA events around PROGRAM_ITERS back-to-back calls; the
    launches of one call (the same on both paths), the program's bytes.
    One `[program]` line per shape, then the counters and the bytes the
    program cache holds."""
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.ops import kernels, program
    from nanorq_tpu_torch.ops import replay as treplay
    from nanorq_tpu_torch.rfc.params import params_init
    from nanorq_tpu_torch.utils import stats

    cases = [("encode", K, B) for K, B in PROGRAM_SHAPES] + [("decode", *PROGRAM_DECODE)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lines = []
    for kind, K, B in cases:
        rng = np.random.default_rng(SEED + K + B)
        if kind == "encode":
            ds, live = tcache.encoder_schedule(params_init(K).Kp), K
        else:
            P, isis, ov = _decode_pattern(K, SEED + K)
            ds, live = tcache.decoder_schedule(P, isis, ov), P.Kp + ov
            if ds is None:
                raise AssertionError(f"the K={K} decode pattern did not solve")
        arr = treplay.device_arrays(ds, dev)
        t = B * T
        D = torch.zeros((ds.M_pad, t), dtype=torch.uint8, device=dev)
        D[:live] = torch.from_numpy(rng.integers(0, 256, (live, t), dtype=np.uint8)).to(dev)
        want = treplay.replay(arr, D)
        program.replay(arr, D)  # a width's first replay runs eagerly; the second captures
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = program.replay(arr, D)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {n: kernels.LAUNCHES[n] - before[n] for n in before if kernels.LAUNCHES[n] != before[n]}
        prog = program.lookup(arr, t, stream)
        if not torch.equal(got, want):
            raise AssertionError(f"program {kind} K={K} B={B}: C differs from the eager replay")
        ms = {"eager": [], "program": []}
        for which in ("eager", "program", "program", "eager"):
            fn = treplay.replay if which == "eager" else program.replay
            ms[which].append(_cuda_ms(lambda: fn(arr, D), PROGRAM_ITERS))
        if not torch.equal(program.replay(arr, D), want):
            raise AssertionError(f"program {kind} K={K} B={B}: a replay differs from the eager replay")
        line = {"kind": kind, "K": K, "Kp": params_init(K).Kp, "B": B, "t": t, "exact": True,
                "eager_ms": [round(x, 4) for x in ms["eager"]], "program_ms": [round(x, 4) for x in ms["program"]],
                "speedup": round(min(ms["eager"]) / min(ms["program"]), 3), "launches": launches,
                "first_call_s": round(first_s, 4), "capture_s": round(prog.capture_s, 4),
                "program_MB": round(prog.nbytes / 2**20, 1), "card": smi}
        _say("program", **{k: json.dumps(v) if isinstance(v, (dict, list, str)) else v for k, v in line.items()})
        lines.append(line)
        del D, want, got, prog
    lines.append(_decode_shared(dev, smi))
    c = stats.snapshot()["counters"]
    _say("program", counters=json.dumps({k: c.get(k, 0) for k in ("replay_program_capture", "replay_program_replay",
                                                                    "replay_program_shared", "replay_program_evict",
                                                                    "replay_compile_new", "replay_compile_hit")}),
         cached_MB=round(program.cached_bytes() / 2**20, 1),
         allocated_GiB=round(torch.cuda.memory_allocated() / 2**30, 2))
    return lines


def _decode_shared(dev, smi: str) -> dict:
    """Phase 12's `decode-shared` case: _FREEZE_AFTER + 1 patterns at K=50000
    compiled so that the canonical layout freezes, then SHARED_FRESH fresh
    patterns, each replayed once through `program.replay` (as a receiver
    decodes each block once), bit for bit against the eager replay of its
    own arrays; per pattern the eager ms and the program call's ms (the
    copy-in and the graph, or the capture, or the eager first call of a
    signature; CUDA events around one call) and its route."""
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.ops import program
    from nanorq_tpu_torch.ops import replay as treplay
    from nanorq_tpu_torch.precode.device_schedule import _FREEZE_AFTER
    from nanorq_tpu_torch.utils import stats

    K = PROGRAM_DECODE[0]
    keys = ("replay_program_capture", "replay_program_replay", "replay_program_shared")

    def counts() -> dict:
        c = stats.snapshot()["counters"]
        return {k: c.get(k, 0) for k in keys}

    for s in range(_FREEZE_AFTER + 1):
        P, isis, ov = _decode_pattern(K, SEED + 7000 + s)
        if tcache.decoder_schedule(P, isis, ov) is None:
            raise AssertionError(f"a K={K} warm-up pattern did not solve")
    start = counts()
    rows = []
    for s in range(SHARED_FRESH):
        P, isis, ov = _decode_pattern(K, SEED + 8000 + s)
        ds = tcache.decoder_schedule(P, isis, ov)
        if ds is None:
            raise AssertionError(f"the K={K} pattern {s} did not solve")
        arr = treplay.device_arrays(ds, dev)
        rng = np.random.default_rng(SEED + 8000 + s)
        D = torch.zeros((ds.M_pad, T), dtype=torch.uint8, device=dev)
        D[: P.Kp + ov] = torch.from_numpy(rng.integers(0, 256, (P.Kp + ov, T), dtype=np.uint8)).to(dev)
        D[K : P.Kp] = 0
        got = {}
        eager_ms = _once_ms(lambda: got.__setitem__("eager", treplay.replay(arr, D)))
        before = counts()
        program_ms = _once_ms(lambda: got.__setitem__("program", program.replay(arr, D)))
        d = {k: counts()[k] - before[k] for k in keys}
        if not torch.equal(got["program"], got["eager"]):
            raise AssertionError(f"decode-shared K={K} pattern {s}: C differs from the eager replay")
        route = ("capture" if d["replay_program_capture"] else
                 "shared" if d["replay_program_shared"] else "replay" if d["replay_program_replay"] else "eager")
        rows.append({"eager_ms": round(eager_ms, 4), "program_ms": round(program_ms, 4), "route": route,
                     "sig": arr["sig"]})
        del D, got
    d = {k: counts()[k] - start[k] for k in keys}
    if not d["replay_program_shared"]:
        raise AssertionError(f"decode-shared: no pattern replayed a shared program: {rows}")
    line = {"kind": "decode-shared", "K": K, "B": 1, "t": T, "exact": True, "patterns": rows,
            "captures": d["replay_program_capture"], "shared": d["replay_program_shared"],
            "replays": d["replay_program_replay"], "cached_MB": round(program.cached_bytes() / 2**20, 1),
            "card": smi}
    _say("program", **{k: json.dumps(v) if isinstance(v, (dict, list, str)) else v for k, v in line.items()})
    return line


SOAK_SEED = 7_000_000  # phase 13's first seed (longfuzz.BASE_SEED)
SOAK_S, SOAK_TRIALS = 60, 60  # it stops at whichever comes first
SOAK_FORCED = ({"budget": 1}, {"lanes": 2})  # trial 0 at a 1-byte program budget, trial 1 over two lanes


def phase_soak(dev) -> dict:
    """Phase 13: the soak (nanorq_tpu_torch/tools/longfuzz.py) on the card
    from SOAK_SEED until SOAK_S seconds or SOAK_TRIALS trials have passed,
    the first trials forced as SOAK_FORCED says; every trial bit-exact (the
    tool raises at the first that is not), and the phase fails unless a
    program was captured and one evicted.  Prints the `[soak]` line."""
    from nanorq_tpu_torch.tools import longfuzz

    line = longfuzz.soak(SOAK_SEED, dev, minutes=SOAK_S / 60, trials=SOAK_TRIALS, forced=SOAK_FORCED, quiet=True)
    print("[soak] " + json.dumps(line), flush=True)
    if line["trials"] < len(SOAK_FORCED):
        raise AssertionError(f"the soak ran {line['trials']} trials, fewer than the {len(SOAK_FORCED)} forced ones")
    if not (line["replay_program_capture"] > 0 and line["replay_program_evict"] > 0):
        raise AssertionError(f"the soak captured or evicted no program: {json.dumps(line)}")
    return line


def _short(name: str) -> str:
    """A profiler event's kernel name without its return type and arguments."""
    name = name.replace("(anonymous namespace)", "{anon}").split("(", 1)[0]
    return name[5:] if name.startswith("void ") else name


def phase_profile(enc, batch, data, reps, dev, deliveries, slices: int) -> dict:
    """One warm encode and one warm device decode (repair_all alone, as
    phase 4 times it) under torch.profiler, device activity only: per run,
    its wall seconds, the summed device time, per kernel or copy its ms and
    count, and the copies by kind; `busy` is that sum over the wall, which
    the encode's `slices` overlapping slices may take past 1, `busy_union`
    the share of the wall in which the card did anything.  The encode's
    host-to-device copies, and the part of them that ran while a kernel
    ran (`tools/pipe_sweep.overlap`).  Neither run may copy from or into
    pageable memory ("Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH
    (Device -> Pageable)"): the default path stages in pinned memory."""
    from torch.profiler import ProfilerActivity, profile

    from nanorq_tpu_torch.codec import batch as tbatch
    from nanorq_tpu_torch.tools import gather_launches
    from nanorq_tpu_torch.tools.pipe_sweep import overlap
    from nanorq_tpu_torch.utils import stats

    report = {}
    for name in ("encode", "decode"):
        prof = profile(activities=[ProfilerActivity.CUDA])
        if name == "encode":
            batch.C = None
            torch.cuda.synchronize()
            with prof:
                t0 = time.perf_counter()
                tbatch.generate(batch, dev)
                tbatch.repair_symbols(batch, N_REPAIR, dev)  # fetched to the host
                wall = time.perf_counter() - t0
        else:
            out, wall, info = _decode_once(enc, data, reps, deliveries, dev, "device", around=lambda: prof)
            if not np.array_equal(out, data):
                raise AssertionError("the profiled decode did not restore the object")
            _say("profile-ingest", run=name, ingest_ms=f"{info['ingest_ms']:.3f}",
                 stage_ms=f"{info['stage_ms']:.3f}", pinned_bytes=info["pinned_bytes"])
        stats.take_spans()  # what the profile turned on: nothing here reads it
        per, copies = {}, {}
        for e in prof.key_averages():
            if stats.is_range(e.key):  # a span of the program, not device work
                continue
            ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
            if e.key.startswith("Memcpy"):  # by kind: "Memcpy HtoD (Pinned -> Device)", ...
                tot, cnt = copies.get(e.key, (0.0, 0))
                copies[e.key] = (tot + ms, cnt + e.count)
            if ms > 0:
                key = _short(e.key)
                tot, cnt = per.get(key, (0.0, 0))
                per[key] = (tot + ms, cnt + e.count)
        device_ms = sum(ms for ms, _ in per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
        k1 = [v for k, v in per.items() if "gather_xor_kernel" in k]
        spans = overlap(prof.events())
        report[name] = {"wall_s": wall, "device_ms": device_ms, **spans}
        _say("profile", run=name, wall_s=f"{wall:.4f}", device_ms=f"{device_ms:.3f}",
             busy=f"{device_ms / 1e3 / wall:.3f}", busy_union=f"{spans['device_ms'] / 1e3 / wall:.3f}",
             htod_ms=f"{spans['htod_ms']:.4f}", htod_overlap_ms=f"{spans['htod_overlap_ms']:.4f}",
             k1_ms=f"{sum(ms for ms, _ in k1):.4f}",
             k1_launches=sum(c for _, c in k1), top=json.dumps({k: [round(ms, 4), n] for k, (ms, n) in top}),
             copies=json.dumps({k: [round(ms, 4), n] for k, (ms, n) in sorted(copies.items())}))
        pageable = [k for k in copies if "Pageable" in k]
        if pageable:  # the default path moves every payload through pinned memory
            raise AssertionError(f"the profiled warm {name} copied through pageable memory: {pageable}")
        if name == "encode":
            cats = [k for k in per if "CatArray" in k]
            if sum(c for _, c in k1) != slices * gather_launches.ENCODE_LAUNCHES or cats:
                raise AssertionError(f"the profiled encode ran {sum(c for _, c in k1)} K1 kernels (expected "
                                     f"{slices} x {gather_launches.ENCODE_LAUNCHES}) and the copies {cats}")
    return report


def phase_checks(enc, batch, reps, data, outs, dev) -> tuple[int, float]:
    """The systematic property on every block, one block against the numpy
    oracle (the numpy replay takes ~30 s a block), and the decoded bytes."""
    from nanorq_tpu_torch.host import encoder_schedule, lt_numpy, replay_numpy
    from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan

    P, C = enc.P, batch.C
    if not isinstance(C, torch.Tensor):  # the default path's slices: joined for the checks
        C = C.gather(dev)
    sys_sym = lt_combine(C, lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev))
    D_dev = torch.from_numpy(batch.D).to(dev)
    if not torch.equal(sys_sym[:K], D_dev[:K]) or bool(sys_sym[K : P.Kp].any()):
        raise AssertionError("systematic property fails: LT(C, isi < K') != source rows")
    del sys_sym, D_dev
    t0 = time.perf_counter()
    nb = 1
    ds = encoder_schedule(P.Kp)
    D_np = np.zeros((ds.M_pad, nb * T), np.uint8)  # batch.D holds the K live rows (pinned)
    D_np[:K] = batch.D[:K, : nb * T]
    C_np = replay_numpy(D_np, ds)
    if not np.array_equal(C[:, : nb * T].cpu().numpy(), C_np):
        raise AssertionError("C differs from the numpy replay")
    want = lt_numpy(C_np, np.arange(P.Kp, P.Kp + N_REPAIR), P)
    for b in range(nb):
        if not np.array_equal(reps[b], want[:, b * T : (b + 1) * T]):
            raise AssertionError(f"repair symbols of block {b} differ from the numpy LT")
    oracle_s = time.perf_counter() - t0
    for name, out in zip(("cold", "warm"), outs):
        if not np.array_equal(out, data):
            raise AssertionError(f"{name} decode did not restore the object")
    del C
    return nb, oracle_s


def main() -> None:
    t_start = time.perf_counter()
    smi, kind, dev = phase_device()  # phase 0
    phase_build()  # phase 1

    from nanorq_tpu_torch import bench
    from nanorq_tpu_torch.codec import batch as tbatch
    from nanorq_tpu_torch.codec.api import Encoder
    from nanorq_tpu_torch.host import MemoryIO
    from nanorq_tpu_torch.ops import kernels
    from nanorq_tpu_torch.parallel import mesh as lanes
    from nanorq_tpu_torch.tools import gather_launches

    F = Z * K * T
    enc = Encoder(F, T, Al=8, Z=Z, device=dev)
    if enc.num_blocks != Z or any(enc.block_symbols(b) != K for b in range(Z)):
        raise AssertionError(f"scheme is not {Z} blocks of K={K}")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    report = phase_parity(dev, rng, enc.P)  # phase 2
    _say("phase", name="parity", seconds=f"{time.perf_counter() - t0:.2f}")
    data = rng.integers(0, 256, F, dtype=np.uint8)
    t0 = time.perf_counter()
    batch = tbatch.load_object(enc, MemoryIO(data))
    load_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # the main path starts here
    reps, enc_s = phase_encode(enc, batch, dev)  # phase 3
    enc_launches, enc_copies = dict(kernels.LAUNCHES), dict(kernels.COPIES)
    enc_mem = _mem()
    sliced = lanes.default_mesh(dev, WIDE, T, K)  # the lanes phase 3 ran on
    slices = sliced.size
    _say("encode", blocks=Z, K=K, T=T, bytes=F, load_s=f"{load_s:.3f}", cold_s=f"{enc_s[0]:.4f}",
         second_s=f"{enc_s[1]:.4f}", warm_s=f"{enc_s[2]:.4f}", slices=slices, launches=json.dumps(enc_launches),
         copies=json.dumps(enc_copies), mem=enc_mem)
    if slices > 1 and not (isinstance(batch.C, lanes.Sharded) and batch.C.mesh is sliced):
        raise AssertionError("the sliced encode left batch.C off its slices")
    deliveries = _deliveries(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    outs, dec_s, kinds, ngaps, dec_gather = phase_decode(enc, data, reps, dev, deliveries)  # phase 4
    main_launches = dict(kernels.LAUNCHES)  # the main path ends here
    dec_mem = _mem()
    if kernels.take_index_errors(dev):
        raise AssertionError("a gather of the main path met an index outside its source")
    if enc_launches["gather_xor"] != ENCODE_RUNS * slices * gather_launches.ENCODE_LAUNCHES:
        raise AssertionError(f"phase 3's encodes ran {enc_launches['gather_xor']} K1 launches, "
                             f"expected {ENCODE_RUNS} x {slices} slices x {gather_launches.ENCODE_LAUNCHES}")
    if enc_copies["copy2d"] != (ENCODE_RUNS * slices if slices > 1 else 0):
        raise AssertionError(f"phase 3's encodes issued {enc_copies['copy2d']} pitched copies, "
                             f"expected one a slice ({slices} slices, {ENCODE_RUNS} encodes)")
    dec_launches = {n: main_launches[n] - enc_launches[n] for n in main_launches}
    _k1_line("decode-place", gather_launches.measure(dec_gather[0], 20))
    _k1_line("decode", gather_launches.measure(dec_gather[1], 20))
    del dec_gather
    _say("decode", loss=0.06, overhead=0.05, gaps=ngaps, cold_s=f"{dec_s[0]:.4f}",
         warm_s=f"{dec_s[1]:.4f}", plans=json.dumps(kinds), launches=json.dumps(dec_launches), mem=dec_mem)
    _say("phase", name="encode+decode", seconds=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    nb, oracle_s = phase_checks(enc, batch, reps, data, outs, dev)  # phase 5
    if not all(enc_launches[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul")):
        raise AssertionError(f"encode missed a kernel: {enc_launches}")
    if not (dec_launches["gather_xor"] > 0 and dec_launches["gf2_matmul"] > 0):
        raise AssertionError(f"decode missed a kernel: {dec_launches}")
    _say("checks", systematic_blocks=Z, oracle_blocks=nb, oracle_s=f"{oracle_s:.2f}",
         decode_bytes_equal=True, launches=json.dumps(main_launches))
    _say("times", card=json.dumps(smi), encode_cold_mbps=_mbps(F, enc_s[0]), encode_warm_mbps=_mbps(F, enc_s[-1]),
         decode_cold_mbps=_mbps(F, dec_s[0]), decode_warm_mbps=_mbps(F, dec_s[1]),
         peak_mem_gib=f"{torch.cuda.max_memory_allocated() / (1 << 30):.2f}")
    profiled = phase_profile(enc, batch, data, reps, dev, deliveries, slices)
    _say("phase", name="checks", seconds=f"{time.perf_counter() - t0:.2f}")
    batch.C = None  # the host matrix stays for phase 10

    t0 = time.perf_counter()
    kernels.reset_launches()  # the probe path starts here
    lines = phase_probe()  # phase 6
    probe_launches = dict(kernels.LAUNCHES)  # and ends here
    if not all(probe_launches[n] > 0 for n in PROBES + ("gather_xor",)):
        raise AssertionError(f"the probe path missed a kernel: {probe_launches}")
    if kernels.take_index_errors(dev) or kernels.take_count_errors(dev):
        raise AssertionError("a probe launch flagged an index or a count")
    _say("probe", shapes=len(lines), exact=all(line["exact"] for line in lines),
         launches=json.dumps(probe_launches), seconds=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    kernels.reset_launches()  # the decode arms start here
    arm_s = phase_arms(enc, data, reps, dev, deliveries)  # phase 7
    arm_launches = dict(kernels.LAUNCHES)  # and end here
    if not (arm_launches["gf256_matmul"] > 0 and arm_launches["gf2_matmul"] > 0
            and arm_launches["gather_xor"] > 0):
        raise AssertionError(f"the decode arms missed a kernel: {arm_launches}")
    _say("arms", launches=json.dumps(arm_launches), device_cold_s=f"{dec_s[0]:.4f}",
         device_warm_s=f"{dec_s[1]:.4f}", seconds=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    kernels.reset_launches()  # the CLI starts here
    cli_s = phase_cli(rng)  # phase 8
    cli_launches = dict(kernels.LAUNCHES)  # and ends here
    if not all(cli_launches[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul")):
        raise AssertionError(f"the CLI missed a kernel: {cli_launches}")
    _say("cli", bytes=CLI_BYTES, T=T, restored=True, launches=json.dumps(cli_launches),
         encode_mbps=_mbps(CLI_BYTES, cli_s["encode"]), decode_mbps=_mbps(CLI_BYTES, cli_s["decode"]),
         seconds=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    kernels.reset_launches()  # the bench starts here
    bench_lines = phase_bench()  # phase 9
    bench_launches = dict(kernels.LAUNCHES)  # and ends here
    if not all(bench_launches[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul")):
        raise AssertionError(f"the bench missed a kernel: {bench_launches}")
    b1000 = bench_lines[1000]  # beside phases 3, 4 and 7, in BASELINE.md's unit (the bench's arms are all cold)
    _say("bench", ks=json.dumps(list(bench_lines)), launches=json.dumps(bench_launches),
         encode_e2e_mbps=b1000["encode_e2e_mbps"], phase3_encode_warm_mbps=_mbps(F, enc_s[-1]),
         e2e_device_mbps=b1000["e2e_device_mbps"], phase4_device_cold_mbps=_mbps(F, dec_s[0]),
         **{f"e2e_{arm}_mbps": b1000[f"e2e_{arm}_mbps"] for arm in ("res", "res_host", "host")},
         **{f"phase7_{arm}_cold_mbps": _mbps(F, arm_s[f"{arm}_cold"]) for arm in ("res", "res_host", "host")},
         e2e_auto_ok=b1000["e2e_auto_ok"], e2e_auto_warm_ok=b1000["e2e_auto_warm_ok"],
         warm_mbps=json.dumps({arm: b1000[f"e2e_{arm}_warm_mbps"] and round(b1000[f"e2e_{arm}_warm_mbps"], 1)
                               for arm in bench.ARMS}),
         seconds=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # the lanes start here
    mesh_line = phase_mesh(enc, batch, data, reps, dev, deliveries, smi)  # phase 10
    mesh_launches = dict(kernels.LAUNCHES)  # and end here
    if not all(mesh_launches[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul")):
        raise AssertionError(f"the mesh paths missed a kernel: {mesh_launches}")
    _say("mesh", launches=json.dumps(mesh_launches), encode_none_mbps=_mbps(F, min(mesh_line["encode_s"]["none"])),
         encode_4_warm_mbps=_mbps(F, min(mesh_line["encode_s"]["4_warm"])),
         decode_none_warm_mbps=_mbps(F, min(mesh_line["decode_s"]["none_warm"])),
         decode_4_warm_mbps=_mbps(F, min(mesh_line["decode_s"]["4_warm"])),
         seconds=f"{time.perf_counter() - t0:.2f}")
    del batch
    mem3 = json.loads(enc_mem)
    print("[pipeline] " + json.dumps({
        "slices": slices, "streams": [lane.queue().cuda_stream for lane in sliced.lanes],
        "slice_bytes": lanes.SLICE_BYTES, "width": WIDE,
        "warm_encode_ms": {"sliced": [round(1e3 * x, 3) for x in mesh_line["encode_s"]["none"]],
                           "unsliced": [round(1e3 * x, 3) for x in mesh_line["encode_s"]["1_warm"]],
                           "phase3_sliced": round(1e3 * enc_s[-1], 3)},
        "htod_ms": round(profiled["encode"]["htod_ms"], 4),
        "htod_overlap_ms": round(profiled["encode"]["htod_overlap_ms"], 4),
        "programs_MB": mem3["programs_MB"], "peak_GiB": mem3["peak_GiB"], "allocated_GiB": mem3["allocated_GiB"],
        "card": smi}), flush=True)

    t0 = time.perf_counter()
    kernels.reset_launches()  # the sweeps start here
    phase_sweeps()  # phase 11
    sweep_launches = dict(kernels.LAUNCHES)  # and end here
    if not all(sweep_launches[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul")):
        raise AssertionError(f"the sweeps missed a kernel: {sweep_launches}")
    if kernels.take_index_errors(dev):
        raise AssertionError("a gather of the sweeps met an index outside its source")
    _say("sweeps", launches=json.dumps(sweep_launches), seconds=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    kernels.reset_launches()  # the program's comparison starts here
    phase_program(dev, smi)  # phase 12
    program_launches = dict(kernels.LAUNCHES)  # and ends here
    if not all(program_launches[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul")):
        raise AssertionError(f"the program phase missed a kernel: {program_launches}")
    if kernels.take_index_errors(dev):
        raise AssertionError("a gather of the program phase met an index outside its source")
    _say("programs", launches=json.dumps(program_launches), seconds=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    kernels.reset_launches()  # the soak starts here
    soak = phase_soak(dev)  # phase 13
    soak_launches = dict(kernels.LAUNCHES)  # and ends here
    if not all(soak_launches[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul")):
        raise AssertionError(f"the soak missed a kernel: {soak_launches}")
    if kernels.take_index_errors(dev):
        raise AssertionError("a gather of the soak met an index outside its source")
    _say("soak", trials=soak["trials"], launches=json.dumps(soak_launches),
         seconds=f"{time.perf_counter() - t0:.2f}")
    _say("phase", name="all", seconds=f"{time.perf_counter() - t_start:.2f}")

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": PORTED[n][0], "replaces": PORTED[n][1],
         "launches": (probe_launches if n in PROBES else main_launches)[n],
         "launches_mesh": mesh_launches[n],
         "path": "probe" if n in PROBES else "encode+decode",
         "max_abs_err": report[n]["max_abs_err"], "ms": report[n]["ms"], "plain_ms": report[n]["plain_ms"],
         "bound_ms": report[n]["bound_ms"], "bound_by": report[n]["bound_by"],
         "share": report[n]["bound_ms"] / report[n]["ms"],
         "library_ms": report[n]["library_ms"], "shape": report[n]["shape"],
         "timing": report[n].get("timing", "cuda_graph"),  # how ms and library_ms were taken
         **({"modes": report[n]["modes"]} if "modes" in report[n] else {})}
        for n in PORTED]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
