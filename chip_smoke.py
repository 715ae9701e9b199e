"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

0. device: the card, its power limit, the software stack;
1. build: the CUDA kernels of nanorq_tpu_torch/csrc, compiled by nvcc;
2. kernel parity: each kernel against its plain torch version on the same
   inputs, bit-exact, at the shapes the K=1000 main path gives it (t = 1280
   and t = 200*1280) and at a ragged shape; kernel and plain times; an
   index outside the source makes gather_xor raise;
3. encode: an object of Z=200 blocks x K=1000 x T=1280 through the port's
   Encoder and codec.batch (generate + 200 repair symbols per block);
4. decode: 6% source loss + 5% repair overhead per block, recovered by
   Decoder.repair_all(backend="device");
5. checks and times: the systematic property on every block, two blocks
   against the numpy oracle (nanorq_tpu_torch.host), the decoded bytes, the
   kernel launch counts of the main path (phases 3-4), no out-of-range
   gather index in it, and the encode/decode wall times.

Any failure raises and the script exits non-zero.  The last line is one JSON
object: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports no JAX and nothing of the JAX package: the host pieces it needs come
through nanorq_tpu_torch.
"""

import json
import platform
import subprocess
import time

import numpy as np
import torch

K, T, Z, N_REPAIR = 1000, 1280, 200, 200  # 256 MB: Z blocks of K symbols of T bytes
SEED = 0  # object bytes, parity inputs and loss patterns all derive from it
WIDE = Z * T  # the payload width of the whole object


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
    cases = {  # name -> [(label, main-path shape?, kernel fn, plain fn)]
        "gather_xor": [], "gf2_matmul": [], "gf256_matmul": [],
    }
    for t in (T, WIDE):
        D = zero_last(u8(ds.M_pad, t))
        z = zero_last(u8(ds.Lpad + ds.u_pad, t))
        C_ext = zero_last(u8(ds.L + 1, t))
        g = [
            (f"take_rows D[{ds.M_pad},{t}] idx{tuple(arr['piv_rows'].shape)}", D, arr["piv_rows"]),
            (f"trisolve z[{ds.Lpad + ds.u_pad},{t}] idx{tuple(seg['ranges'][-1][2][0].shape)}",
             z, seg["ranges"][-1][2][0]),
            (f"bsel z idx{tuple(arr['bsel_passes'][0].shape)}", z, arr["bsel_passes"][0]),
            (f"lt_class C_ext[{ds.L + 1},{t}] idx{tuple(widest.shape)}", C_ext, widest),
        ]
        for label, src, ix in g:
            cases["gather_xor"].append((label, t == WIDE, lambda s=src, i=ix: kernels.gather_xor(s, i),
                                        lambda s=src, i=ix: gfmat.xor_reduce_gather(s, i)))
        for label, bits, X in [
            (f"tinv[{ds.CB},{ds.CB}] X[{ds.CB},{t}]", seg["tinv"][0], u8(ds.CB, t)),
            (f"wut[{ds.Lpad},{ds.u_pad}] X[{ds.u_pad},{t}]", arr["wut"], u8(ds.u_pad, t)),
        ] + ([(f"W_dec[64,{kq}] X[{kq},{t}]", packed(64, kq), u8(kq, t))] if t == T else []):
            k = X.shape[0]
            cases["gf2_matmul"].append((label, t == WIDE, lambda b=bits, x=X: kernels.gf2_matmul(b, x),
                                        lambda b=bits, x=X, k=k: gfmat.gf2_matmul(gfmat.unpack_bits(b)[:, :k], x)))
        for label, M, X in [
            (f"mhd{tuple(arr['mhd'].shape)} X[{ds.Lpad},{t}]", arr["mhd"], u8(ds.Lpad, t)),
            (f"vinv{tuple(arr['vinv'].shape)} X[{ds.u_pad},{t}]", arr["vinv"], u8(ds.u_pad, t)),
        ] + ([(f"W_dec256[64,{ds.M_pad}] X[{ds.M_pad},{t}]", u8(64, ds.M_pad), u8(ds.M_pad, t))] if t == T else []):
            cases["gf256_matmul"].append((label, t == WIDE, lambda m=M, x=X: kernels.gf256_matmul(m, x),
                                          lambda m=M, x=X: gfmat.gf256_matmul(m, x)))
    # ragged: t not a multiple of 16, k not a multiple of 8
    tr, kr = 1283, 203
    src = zero_last(u8(300, tr))
    ix = torch.from_numpy(rng.integers(0, 300, (100, 5)).astype(np.int32)).to(dev)
    cases["gather_xor"].append(("ragged src[300,1283] idx(100,5)", False,
                                lambda: kernels.gather_xor(src, ix), lambda: gfmat.xor_reduce_gather(src, ix)))
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
                                lambda: gfmat.gf2_matmul(gfmat.unpack_bits(bits)[:, :kr], Xr)))
    Mr = u8(20, kr)
    cases["gf256_matmul"].append((f"ragged M[20,{kr}] X[{kr},{tr}]", False,
                                  lambda: kernels.gf256_matmul(Mr, Xr), lambda: gfmat.gf256_matmul(Mr, Xr)))

    report = {}
    for name, rows in cases.items():
        worst, main_ms, main_plain, main_shape = 0, 0.0, 0.0, ""
        for label, main, kfn, pfn in rows:
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            err = _max_err(got, want)
            worst = max(worst, err)
            if err:
                raise AssertionError(f"{name} {label}: kernel differs from plain, max_abs_err={err}")
            ms = _cuda_ms(kfn, 10 if main else 20)
            pms = _cuda_ms(pfn, 3 if main else 10)
            _say("parity", kernel=name, shape=label.replace(" ", ""), exact=True,
                 ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}")
            if main and ms >= main_ms:  # the heaviest main-path shape at t=200*T
                main_ms, main_plain, main_shape = ms, pms, label
        report[name] = {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain,
                        "shape": main_shape}
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


def phase_decode(enc, data, reps, dev, seed: int):
    """repair_all(backend="device") at 6% loss + 5% overhead on every block,
    cold (every pattern solved fresh) then warm (plans cached)."""
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.codec.api import Decoder
    from nanorq_tpu_torch.host import MemoryIO, make_tag

    payloads = data.reshape(Z * K, T)
    rng = np.random.default_rng(seed)
    deliveries = []
    for sbn in range(Z):  # the loss model of bench.py:166-167
        gaps = np.nonzero(rng.random(K) < 0.06)[0]
        nrep = gaps.size + max(1, int(0.05 * K))
        if nrep > N_REPAIR:
            raise AssertionError(f"block {sbn} needs {nrep} repair symbols, encoded {N_REPAIR}")
        deliveries.append((np.setdiff1d(np.arange(K), gaps), np.arange(K, K + nrep)))

    def once():
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
        out = np.zeros(data.size, np.uint8)
        io = MemoryIO(out)
        for sbn, (keep, rep_esis) in enumerate(deliveries):
            dec.add_symbols(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
            dec.add_symbols(reps[sbn][: rep_esis.size], [make_tag(sbn, int(e)) for e in rep_esis], io)
        preps = [dec._repair_prepare(sbn) for sbn in range(Z)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not dec.repair_all(io, backend="device"):
            raise AssertionError("repair_all reported unrecovered blocks")
        return out, time.perf_counter() - t0, preps

    tcache.clear_decoder_cache()
    out_cold, cold_s, preps = once()
    out_warm, warm_s, _ = once()
    kinds = {"gf2_w": 0, "gf256_w": 0, "structured": 0}
    for _gaps, isis, ov in preps:  # the plans decoder_plan cached for these patterns
        plan = tcache.decoder_plan(enc.P, isis, ov)
        if isinstance(plan, tcache.WSchedule):
            kinds["gf2_w" if plan.Wbits is not None else "gf256_w"] += 1
        else:
            kinds["structured"] += 1
    gaps = sum(p[0].size for p in preps)
    return (out_cold, out_warm), (cold_s, warm_s), kinds, gaps


def phase_checks(enc, batch, reps, data, outs, dev) -> tuple[int, float]:
    """The systematic property on every block, two blocks against the numpy
    oracle, and the decoded bytes."""
    from nanorq_tpu_torch.host import encoder_schedule, lt_numpy, replay_numpy
    from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan

    P, C = enc.P, batch.C
    sys_sym = lt_combine(C, lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev))
    D_dev = torch.from_numpy(batch.D).to(dev)
    if not torch.equal(sys_sym[:K], D_dev[:K]) or bool(sys_sym[K : P.Kp].any()):
        raise AssertionError("systematic property fails: LT(C, isi < K') != source rows")
    del sys_sym, D_dev
    t0 = time.perf_counter()
    nb = 2
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
    report = phase_parity(dev, rng, enc.P)  # phase 2
    data = rng.integers(0, 256, F, dtype=np.uint8)
    t0 = time.perf_counter()
    batch = tbatch.load_object(enc, MemoryIO(data))
    load_s = time.perf_counter() - t0

    kernels.reset_launches()  # the main path starts here
    reps, enc_s = phase_encode(enc, batch, dev)  # phase 3
    enc_launches = dict(kernels.LAUNCHES)
    _say("encode", blocks=Z, K=K, T=T, bytes=F, load_s=f"{load_s:.3f}",
         cold_s=f"{enc_s[0]:.4f}", warm_s=f"{enc_s[1]:.4f}", launches=json.dumps(enc_launches))
    outs, dec_s, kinds, ngaps = phase_decode(enc, data, reps, dev, SEED + 1)  # phase 4
    main_launches = dict(kernels.LAUNCHES)  # the main path ends here
    if kernels.take_index_errors(dev):
        raise AssertionError("a gather of the main path met an index outside its source")
    dec_launches = {n: main_launches[n] - enc_launches[n] for n in main_launches}
    _say("decode", loss=0.06, overhead=0.05, gaps=ngaps, cold_s=f"{dec_s[0]:.4f}",
         warm_s=f"{dec_s[1]:.4f}", plans=json.dumps(kinds), launches=json.dumps(dec_launches))

    nb, oracle_s = phase_checks(enc, batch, reps, data, outs, dev)  # phase 5
    if not all(enc_launches[n] > 0 for n in enc_launches):
        raise AssertionError(f"encode missed a kernel: {enc_launches}")
    if not (dec_launches["gather_xor"] > 0 and dec_launches["gf2_matmul"] > 0):
        raise AssertionError(f"decode missed a kernel: {dec_launches}")
    _say("checks", systematic_blocks=Z, oracle_blocks=nb, oracle_s=f"{oracle_s:.2f}",
         decode_bytes_equal=True, launches=json.dumps(main_launches))

    def mbps(s):  # BASELINE.md's unit: 8 * bytes / (2**20 * seconds)
        return f"{8 * F / (1 << 20) / s:.1f}"

    _say("times", card=json.dumps(smi), encode_cold_mbps=mbps(enc_s[0]), encode_warm_mbps=mbps(enc_s[1]),
         decode_cold_mbps=mbps(dec_s[0]), decode_warm_mbps=mbps(dec_s[1]),
         peak_mem_gib=f"{torch.cuda.max_memory_allocated() / (1 << 30):.2f}")

    src = {"gather_xor": ("nanorq_tpu_torch/csrc/gather_xor.cu", "nanorq_tpu/ops/pallas_kernels.py:290"),
           "gf2_matmul": ("nanorq_tpu_torch/csrc/gf2_matmul.cu", "nanorq_tpu/ops/pallas_kernels.py:148"),
           "gf256_matmul": ("nanorq_tpu_torch/csrc/gf256_matmul.cu", "nanorq_tpu/ops/pallas_kernels.py:221")}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src[n][0], "replaces": src[n][1],
         "launches": main_launches[n], "max_abs_err": report[n]["max_abs_err"],
         "ms": report[n]["ms"], "plain_ms": report[n]["plain_ms"], "shape": report[n]["shape"]}
        for n in ("gather_xor", "gf2_matmul", "gf256_matmul")]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
