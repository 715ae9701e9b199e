"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:

0. device: the card, its power limit, the software stack;
1. build: the CUDA kernels of nanorq_tpu_torch/csrc, compiled by nvcc;
2. kernel parity: each kernel against its plain torch version on the same
   inputs, bit-exact, at the shapes the K=1000 main path gives it (t = 1280
   and t = 200*1280) and at a ragged shape; kernel and plain times (the
   three gather probes at K1's shapes, with K1's time beside theirs), each
   gather's bytes bound and, at width 1, torch.index_select's time (K1's
   library_ms); K2 and K3 through tools/matmul_forms.py (the encoder's own
   matrices, the single and batched W decodes -- nb = 200 -- and the
   residual chunk, then the edge shapes: ragged k and t, m < 16, k split
   across blocks, nb = 1 and 200), with their bounds; an index outside the
   source makes gather_xor raise, a ragged width makes the probes raise;
3. encode: an object of Z=200 blocks x K=1000 x T=1280 through the port's
   Encoder and codec.batch (generate + 200 repair symbols per block);
4. decode: 6% source loss + 5% repair overhead per block, recovered by
   Decoder.repair_all(backend="device"); the warm run must take one K1 and
   one K2 launch per stacked batch of blocks;
5. checks and times: the systematic property on every block, one block
   against the numpy oracle (nanorq_tpu_torch.host), the decoded bytes, the
   kernel launch counts of the main path (phases 3-4), no out-of-range
   gather index in it, and the encode/decode wall times; then one warm
   encode and one warm device decode under torch.profiler: the device time
   of each kernel and copy, summed over the run, beside its wall time;
6. probe path: nanorq_tpu_torch.tools.gather_probe over both probe tables,
   every line bit-exact, with its launch counts;
7. decode arms: the phase-4 object and losses through repair_all with
   backend "auto" (warm plans from phase 4: every block on the device),
   then "res", "res_host" and "host", cold (memos cleared) and warm, then
   "auto" cold; every run restores the bytes; seconds and Mb/s per arm;
8. cli: nanorq_tpu_torch.cli.encode and .decode on an 8 MiB file at
   T=1280, decoded with the default backend and with --layout-cache (the
   device arm), byte-compared with the file.

Each of the paths 3-4, 6, 7 and 8 runs with the launch counts set to 0 just
before it and read just after, and fails if a kernel it runs never launched.
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


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max()) if a.numel() else 0


HBM_BPS = 3.35e12  # the H100 SXM data sheet's memory rate


def _gather_bytes(src: torch.Tensor, idx: torch.Tensor) -> int:
    """Bytes a gather must move: each distinct source row read once, each
    output row written once, the indices read once."""
    return int(torch.unique(idx).numel()) * src.shape[1] + idx.shape[0] * src.shape[1] + idx.numel() * 4


def rows_k1(rows: list, label: str) -> str:
    """The K1 label a probe row of `label` was timed beside (its own for K1)."""
    return next((k1 or lab) for lab, _, _, _, k1 in rows if lab == label)


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
    report, k1_ms = {}, {}
    for name, rows in cases.items():
        if not rows:  # K2 and K3: phase_matmul below
            continue
        worst, main_ms, main_plain, main_shape = 0, 0.0, 0.0, ""
        main_lib = None
        for label, main, kfn, pfn, k1 in rows:
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            err = _max_err(got, want)
            worst = max(worst, err)
            if err:
                raise AssertionError(f"{name} {label}: kernel differs from plain, max_abs_err={err}")
            ms = _cuda_ms(kfn, 10 if main else 20)
            pms = _cuda_ms(pfn, 3 if main else 10)
            extra = {}
            if name == "gather_xor":
                k1_ms[label] = ms
                if label in library:
                    extra["library_ms"] = f"{_cuda_ms(library[label], 10 if main else 20):.4f}"
            if k1 is not None:
                extra["k1_ms"] = f"{k1_ms[k1]:.4f}"
            bound = bounds.get(k1 or label)
            if bound:
                extra["bound_ms"] = f"{bound[0]:.4f}"
            _say("parity", kernel=name, shape=label.replace(" ", ""), exact=True,
                 ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", **extra)
            if main and ms >= main_ms:  # the heaviest main-path shape at t=200*T
                main_ms, main_plain, main_shape = ms, pms, label
                main_lib = float(extra["library_ms"]) if "library_ms" in extra else None
        b_ms, b_by = bounds[rows_k1(rows, main_shape)]
        report[name] = {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain, "shape": main_shape,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": main_lib}
    report.update(phase_matmul(dev))
    if kernels.take_index_errors(dev) or kernels.take_count_errors(dev):
        raise AssertionError("a parity launch flagged an index or a count")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return report


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
    """generate + repair_symbols for the whole object, cold then warm."""
    from nanorq_tpu_torch.codec import batch as tbatch

    secs = []
    for _ in range(2):  # cold (schedule upload, LT plan), then warm
        batch.C = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tbatch.generate(batch, dev)
        reps = tbatch.repair_symbols(batch, N_REPAIR, dev)  # fetched to the host
        secs.append(time.perf_counter() - t0)
    return reps, secs


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


def _decode_once(enc, data, reps, deliveries, dev, backend: str, around=contextlib.nullcontext):
    """A fresh Decoder fed with `deliveries`, then repair_all(backend) inside
    the context `around()`, timed (ingestion excluded): (restored object,
    seconds, per-block patterns)."""
    from nanorq_tpu_torch.codec.api import Decoder
    from nanorq_tpu_torch.host import MemoryIO, make_tag

    payloads = data.reshape(Z * K, T)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    for sbn, (keep, rep_esis) in enumerate(deliveries):
        dec.add_symbols(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(reps[sbn][: rep_esis.size], [make_tag(sbn, int(e)) for e in rep_esis], io)
    preps = [dec._repair_prepare(sbn) for sbn in range(Z)]
    torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        if not dec.repair_all(io, backend=backend):
            raise AssertionError(f"repair_all({backend!r}) reported unrecovered blocks")
        secs = time.perf_counter() - t0
    return out, secs, preps


def phase_decode(enc, data, reps, dev, deliveries):
    """repair_all(backend="device") at 6% loss + 5% overhead on every block,
    cold (every pattern solved fresh) then warm (plans cached).  The warm
    run must stack its dense-W blocks: one K1 and one K2 launch per batch
    of up to Decoder._BATCH_FLUSH blocks, not one pair per block."""
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.codec.api import Decoder
    from nanorq_tpu_torch.ops import kernels

    tcache.clear_decoder_cache()
    out_cold, cold_s, preps = _decode_once(enc, data, reps, deliveries, dev, "device")
    before = dict(kernels.LAUNCHES)
    out_warm, warm_s, _ = _decode_once(enc, data, reps, deliveries, dev, "device")
    warm = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    batches = -(-Z // Decoder._BATCH_FLUSH)
    _say("decode", warm_launches=json.dumps(warm), batches=batches)
    if warm["gf2_matmul"] != batches or warm["gather_xor"] != batches:
        raise AssertionError(f"warm device decode ran {warm}, expected {batches} K1 and K2 launches")
    kinds = {"gf2_w": 0, "gf256_w": 0, "structured": 0}
    for _gaps, isis, ov in preps:  # the plans decoder_plan cached for these patterns
        plan = tcache.decoder_plan(enc.P, isis, ov)
        if isinstance(plan, tcache.WSchedule):
            kinds["gf2_w" if plan.Wbits is not None else "gf256_w"] += 1
        else:
            kinds["structured"] += 1
    gaps = sum(p[0].size for p in preps)
    return (out_cold, out_warm), (cold_s, warm_s), kinds, gaps


def _mbps(nbytes: int, s: float) -> str:  # BASELINE.md's unit: 8 * bytes / (2**20 * seconds)
    return f"{8 * nbytes / (1 << 20) / s:.1f}"


def _counts() -> dict:
    from nanorq_tpu_torch.host import stats

    c = stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in ("repair_device_blocks", "repair_res_blocks", "repair_res_host_blocks",
                                      "repair_host_blocks")}


def phase_arms(enc, data, reps, dev, deliveries) -> dict:
    """The decode arms on the phase-4 object: "auto" warm (phase 4 cached every
    pattern's plan, so every block must go to the device arm), then "res",
    "res_host" and "host" cold (decode memos cleared; the per-K' canonical
    factorization stays, as in nanorq_tpu) and warm, then "auto" cold."""
    from nanorq_tpu_torch.codec import cache as tcache

    runs = [("auto", "warm", {"repair_device_blocks": Z})]
    for arm, counter in (("res", "repair_res_blocks"), ("res_host", "repair_res_host_blocks"),
                         ("host", "repair_host_blocks")):
        runs += [(arm, "cold", {counter: Z}), (arm, "warm", {counter: Z})]
    runs.append(("auto", "cold", {"repair_host_blocks": Z}))  # K' = 1002 > NANORQ_RES_HOST_MAX
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


def _short(name: str) -> str:
    """A profiler event's kernel name without its return type and arguments."""
    name = name.split("(", 1)[0]
    return name[5:] if name.startswith("void ") else name


def phase_profile(enc, batch, data, reps, dev, deliveries) -> dict:
    """One warm encode and one warm device decode (repair_all alone, as
    phase 4 times it) under torch.profiler, device activity only: per run,
    its wall seconds, the summed device time, and per kernel or copy its ms
    and count."""
    from torch.profiler import ProfilerActivity, profile

    from nanorq_tpu_torch.codec import batch as tbatch

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
            out, wall, _ = _decode_once(enc, data, reps, deliveries, dev, "device", around=lambda: prof)
            if not np.array_equal(out, data):
                raise AssertionError("the profiled decode did not restore the object")
        per = {}
        for e in prof.key_averages():
            ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
            if ms > 0:
                key = _short(e.key)
                tot, cnt = per.get(key, (0.0, 0))
                per[key] = (tot + ms, cnt + e.count)
        device_ms = sum(ms for ms, _ in per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
        report[name] = {"wall_s": wall, "device_ms": device_ms}
        _say("profile", run=name, wall_s=f"{wall:.4f}", device_ms=f"{device_ms:.3f}",
             busy=f"{device_ms / 1e3 / wall:.3f}",
             top=json.dumps({k: [round(ms, 4), n] for k, (ms, n) in top}))
    return report


def phase_checks(enc, batch, reps, data, outs, dev) -> tuple[int, float]:
    """The systematic property on every block, one block against the numpy
    oracle (the numpy replay takes ~30 s a block), and the decoded bytes."""
    from nanorq_tpu_torch.host import encoder_schedule, lt_numpy, replay_numpy
    from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan

    P, C = enc.P, batch.C
    sys_sym = lt_combine(C, lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev))
    D_dev = torch.from_numpy(batch.D).to(dev)
    if not torch.equal(sys_sym[:K], D_dev[:K]) or bool(sys_sym[K : P.Kp].any()):
        raise AssertionError("systematic property fails: LT(C, isi < K') != source rows")
    del sys_sym, D_dev
    t0 = time.perf_counter()
    nb = 1
    C_np = replay_numpy(batch.D[:, : nb * T], encoder_schedule(P.Kp))
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
    return nb, oracle_s


def main() -> None:
    t_start = time.perf_counter()
    smi, kind, dev = phase_device()  # phase 0
    phase_build()  # phase 1

    from nanorq_tpu_torch.codec import batch as tbatch
    from nanorq_tpu_torch.codec.api import Encoder
    from nanorq_tpu_torch.host import MemoryIO
    from nanorq_tpu_torch.ops import kernels

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
    kernels.reset_launches()  # the main path starts here
    reps, enc_s = phase_encode(enc, batch, dev)  # phase 3
    enc_launches = dict(kernels.LAUNCHES)
    _say("encode", blocks=Z, K=K, T=T, bytes=F, load_s=f"{load_s:.3f}",
         cold_s=f"{enc_s[0]:.4f}", warm_s=f"{enc_s[1]:.4f}", launches=json.dumps(enc_launches))
    deliveries = _deliveries(SEED + 1)
    outs, dec_s, kinds, ngaps = phase_decode(enc, data, reps, dev, deliveries)  # phase 4
    main_launches = dict(kernels.LAUNCHES)  # the main path ends here
    if kernels.take_index_errors(dev):
        raise AssertionError("a gather of the main path met an index outside its source")
    dec_launches = {n: main_launches[n] - enc_launches[n] for n in main_launches}
    _say("decode", loss=0.06, overhead=0.05, gaps=ngaps, cold_s=f"{dec_s[0]:.4f}",
         warm_s=f"{dec_s[1]:.4f}", plans=json.dumps(kinds), launches=json.dumps(dec_launches))
    _say("phase", name="encode+decode", seconds=f"{time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    nb, oracle_s = phase_checks(enc, batch, reps, data, outs, dev)  # phase 5
    if not all(enc_launches[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul")):
        raise AssertionError(f"encode missed a kernel: {enc_launches}")
    if not (dec_launches["gather_xor"] > 0 and dec_launches["gf2_matmul"] > 0):
        raise AssertionError(f"decode missed a kernel: {dec_launches}")
    _say("checks", systematic_blocks=Z, oracle_blocks=nb, oracle_s=f"{oracle_s:.2f}",
         decode_bytes_equal=True, launches=json.dumps(main_launches))
    _say("times", card=json.dumps(smi), encode_cold_mbps=_mbps(F, enc_s[0]), encode_warm_mbps=_mbps(F, enc_s[1]),
         decode_cold_mbps=_mbps(F, dec_s[0]), decode_warm_mbps=_mbps(F, dec_s[1]),
         peak_mem_gib=f"{torch.cuda.max_memory_allocated() / (1 << 30):.2f}")
    phase_profile(enc, batch, data, reps, dev, deliveries)
    _say("phase", name="checks", seconds=f"{time.perf_counter() - t0:.2f}")
    del batch

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
    _say("phase", name="all", seconds=f"{time.perf_counter() - t_start:.2f}")

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": PORTED[n][0], "replaces": PORTED[n][1],
         "launches": (probe_launches if n in PROBES else main_launches)[n],
         "path": "probe" if n in PROBES else "encode+decode",
         "max_abs_err": report[n]["max_abs_err"], "ms": report[n]["ms"], "plain_ms": report[n]["plain_ms"],
         "bound_ms": report[n]["bound_ms"], "bound_by": report[n]["bound_by"],
         "library_ms": report[n]["library_ms"], "shape": report[n]["shape"]}
        for n in PORTED]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
