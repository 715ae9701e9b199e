"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:

0. device: the card, its power limit, the software stack;
1. build: the CUDA kernels of nanorq_tpu_torch/csrc, compiled by nvcc;
2. kernel parity: each kernel against its plain torch version on the same
   inputs, bit-exact, at the shapes the K=1000 main path gives it (t = 1280
   and t = 200*1280) and at a ragged shape; kernel and plain times (the
   three gather probes at K1's shapes, with K1's time beside theirs; K3
   batched at the residual arm's shape); an index outside the source makes
   gather_xor raise, a ragged width makes the probes raise;
3. encode: an object of Z=200 blocks x K=1000 x T=1280 through the port's
   Encoder and codec.batch (generate + 200 repair symbols per block);
4. decode: 6% source loss + 5% repair overhead per block, recovered by
   Decoder.repair_all(backend="device");
5. checks and times: the systematic property on every block, one block
   against the numpy oracle (nanorq_tpu_torch.host), the decoded bytes, the
   kernel launch counts of the main path (phases 3-4), no out-of-range
   gather index in it, and the encode/decode wall times;
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
RES_CHUNK = (32, 110, 1024)  # the residual arm's K3 batch: blocks, repair rows, columns
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

    def packed(m, k):
        return torch.from_numpy(np.packbits(rng.integers(0, 2, (m, k), dtype=np.uint8),
                                            axis=1, bitorder="little")).to(dev)

    def zero_last(x):
        x[-1] = 0  # the sentinel row the codec's indices point at
        return x

    seg = next(s for s in arr["tri"] if s["ranges"])
    widest = max(lt.classes, key=lambda c: c.numel())
    kq = 1024
    cases = {n: [] for n in PORTED}  # name -> [(label, main-path shape?, kernel fn, plain fn, K1 label)]
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
        for label, bits, X in [
            (f"tinv[{ds.CB},{ds.CB}] X[{ds.CB},{t}]", seg["tinv"][0], u8(ds.CB, t)),
            (f"wut[{ds.Lpad},{ds.u_pad}] X[{ds.u_pad},{t}]", arr["wut"], u8(ds.u_pad, t)),
        ] + ([(f"W_dec[64,{kq}] X[{kq},{t}]", packed(64, kq), u8(kq, t))] if t == T else []):
            k = X.shape[0]
            cases["gf2_matmul"].append((label, t == WIDE, lambda b=bits, x=X: kernels.gf2_matmul(b, x),
                                        lambda b=bits, x=X, k=k: gfmat.gf2_matmul(gfmat.unpack_bits(b)[:, :k], x),
                                        None))
        for label, M, X in [
            (f"mhd{tuple(arr['mhd'].shape)} X[{ds.Lpad},{t}]", arr["mhd"], u8(ds.Lpad, t)),
            (f"vinv{tuple(arr['vinv'].shape)} X[{ds.u_pad},{t}]", arr["vinv"], u8(ds.u_pad, t)),
        ] + ([(f"W_dec256[64,{ds.M_pad}] X[{ds.M_pad},{t}]", u8(64, ds.M_pad), u8(ds.M_pad, t)),
              ("res batched W[{0},{1},{2}] D0[{0},{2},{3}]".format(*RES_CHUNK, t), u8(*RES_CHUNK),
               u8(RES_CHUNK[0], RES_CHUNK[2], t))]
             if t == T else []):
            plain = gfmat.gf256_matmul_batch if M.dim() == 3 else gfmat.gf256_matmul
            cases["gf256_matmul"].append((label, t == WIDE, lambda m=M, x=X: kernels.gf256_matmul(m, x),
                                          lambda m=M, x=X, f=plain: f(m, x), None))
    # ragged: t not a multiple of 16, k not a multiple of 8
    tr, kr = 1283, 203
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
    bits, Xr = packed(50, kr), u8(kr, tr)
    cases["gf2_matmul"].append((f"ragged bits[50,{kr}] X[{kr},{tr}]", False,
                                lambda: kernels.gf2_matmul(bits, Xr),
                                lambda: gfmat.gf2_matmul(gfmat.unpack_bits(bits)[:, :kr], Xr), None))
    Mr = u8(20, kr)
    cases["gf256_matmul"].append((f"ragged M[20,{kr}] X[{kr},{tr}]", False,
                                  lambda: kernels.gf256_matmul(Mr, Xr), lambda: gfmat.gf256_matmul(Mr, Xr), None))

    report, k1_ms = {}, {}
    for name, rows in cases.items():
        worst, main_ms, main_plain, main_shape = 0, 0.0, 0.0, ""
        for label, main, kfn, pfn, k1 in rows:
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            err = _max_err(got, want)
            worst = max(worst, err)
            if err:
                raise AssertionError(f"{name} {label}: kernel differs from plain, max_abs_err={err}")
            ms = _cuda_ms(kfn, 10 if main else 20)
            pms = _cuda_ms(pfn, 3 if main else 10)
            if name == "gather_xor":
                k1_ms[label] = ms
            extra = {} if k1 is None else {"k1_ms": f"{k1_ms[k1]:.4f}"}
            _say("parity", kernel=name, shape=label.replace(" ", ""), exact=True,
                 ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", **extra)
            if main and ms >= main_ms:  # the heaviest main-path shape at t=200*T
                main_ms, main_plain, main_shape = ms, pms, label
        report[name] = {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain,
                        "shape": main_shape}
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


def _decode_once(enc, data, reps, deliveries, dev, backend: str):
    """A fresh Decoder fed with `deliveries`, then repair_all(backend), timed
    (ingestion excluded): (restored object, seconds, per-block patterns)."""
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
    t0 = time.perf_counter()
    if not dec.repair_all(io, backend=backend):
        raise AssertionError(f"repair_all({backend!r}) reported unrecovered blocks")
    return out, time.perf_counter() - t0, preps


def phase_decode(enc, data, reps, dev, deliveries):
    """repair_all(backend="device") at 6% loss + 5% overhead on every block,
    cold (every pattern solved fresh) then warm (plans cached)."""
    from nanorq_tpu_torch.codec import cache as tcache

    tcache.clear_decoder_cache()
    out_cold, cold_s, preps = _decode_once(enc, data, reps, deliveries, dev, "device")
    out_warm, warm_s, _ = _decode_once(enc, data, reps, deliveries, dev, "device")
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
         "shape": report[n]["shape"]}
        for n in PORTED]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
