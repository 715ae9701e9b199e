"""Dry run of the sharded codec over n lanes of one device (counterpart of
`nanorq_tpu.parallel._dryrun`).

    python -m nanorq_tpu_torch.parallel._dryrun [N] [full|structured] [--device cuda]

The same sequence of gates as the JAX package's dry run, each bit-exact: the
sharded codec step (structured replay + LT combine) at K=100, T=128, two
blocks a lane; repair through the patched system; the dense-W decode; the
public round trip `Encoder.encode_batch(mesh=)` -> `Decoder.repair_all(mesh=)`
with a distinct loss pattern per block; an uneven block count Z = n + 3; N = 4
sub-blocks; mixed GF(2) / GF(256) W plans in one repair; and, in mode
"structured", every pattern on the structured replay plan, launched block by
block on the lanes.

The JAX dry run starts a fresh interpreter, because a device count must be
forced before JAX initialises.  The lanes of a mesh may name one device as
often as asked, so this one runs in the calling process.  Its structured mode
needs every pattern on the structured plan: the JAX one spawns with
NANORQ_WPATH_MAX_KP=0 in the environment, which `codec/cache.py` reads at
import; this one sets the module's two values to 0 for its duration, clears
the decode plans cached under the other values before and after, and puts the
values back.
"""

import argparse
import sys

import numpy as np

from nanorq_tpu_torch.codec import cache as _cache
from nanorq_tpu_torch.codec.api import Decoder, Encoder
from nanorq_tpu_torch.codec.cache import WSchedule, decoder_plan, decoder_schedule, encoder_schedule
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.parallel.mesh import codec_step_sharded, make_mesh, shard_width, w_step_sharded
from nanorq_tpu_torch.precode.device_schedule import DeviceSchedule
from nanorq_tpu_torch.rfc.params import params_init


def _gate(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def run(n_lanes: int, device, mode: str = "full") -> None:
    """Build and run the sharded codec on n lanes of `device`; raises on the
    first result that is not bit-exact."""
    dev = resolve(device)
    mesh = make_mesh([dev] * n_lanes)
    if mode == "structured":
        saved = _cache.WPATH_MAX_KP, _cache.WPATH_GF256_MAX_KP
        _cache.WPATH_MAX_KP = _cache.WPATH_GF256_MAX_KP = 0
        _cache.clear_decoder_cache()
        try:
            kinds = _public_roundtrip(mesh, np.random.default_rng(3), dev, Zb=n_lanes, label="structured plans")
        finally:
            _cache.WPATH_MAX_KP, _cache.WPATH_GF256_MAX_KP = saved
            _cache.clear_decoder_cache()
        _gate(kinds == {"structured"}, f"expected structured plans, got {kinds}")
        _gate(not mesh.take_index_errors(), "a gather of the dry run met an index outside its source")
        return
    if mode != "full":
        raise ValueError(f"mode {mode!r} is not 'full' or 'structured'")

    K, T, per_lane = 100, 128, 2
    blocks = n_lanes * per_lane
    P = params_init(K)
    ds = encoder_schedule(P.Kp)
    ngaps = 5  # sources dropped in the repair step below
    # the encode plan covers K' systematic ISIs plus ngaps repair ISIs
    isis_enc = np.arange(P.Kp + ngaps, dtype=np.uint32)
    rng = np.random.default_rng(0)
    D = np.zeros((ds.M_pad, blocks * T), np.uint8)
    D[:K] = rng.integers(0, 256, (K, blocks * T), dtype=np.uint8)

    Dsh = shard_width(D, mesh, block=T, live_rows=K)
    _, sym = codec_step_sharded(ds, isis_enc, P, Dsh, mesh)
    sym = sym.host()
    # systematic check: the sharded step must reproduce the source symbols
    _gate(np.array_equal(sym[:K], D[:K]), "sharded codec step lost bit-exactness")
    print(f"dryrun_multichip({n_lanes}): encode OK -- mesh {mesh.shape} on {dev}, {sym.shape} symbols, bit-exact")

    # --- repair path (reference decode flow, lib/nanorq.c:591-630): drop
    # ngaps sources, splice their repair ISIs into the patched system, solve
    # the per-pattern schedule, and run the sharded replay + gap-LT step
    gaps = np.asarray(sorted(rng.choice(K, size=ngaps, replace=False)), np.int64)
    isis = np.arange(P.Kp, dtype=np.uint32)
    isis[gaps] = P.Kp + np.arange(ngaps, dtype=np.uint32)  # repair ESI j -> ISI K'+j
    ds2 = decoder_schedule(P, isis, overhead=0)
    _gate(ds2 is not None, "patched-system solve unexpectedly rank deficient")
    D2 = np.zeros((ds2.M_pad, blocks * T), np.uint8)
    D2[:K] = D[:K]
    D2[gaps] = sym[P.Kp : P.Kp + ngaps]  # repair payloads in the gap slots
    _, rec = codec_step_sharded(ds2, gaps.astype(np.uint32), P, shard_width(D2, mesh, block=T), mesh)
    _gate(np.array_equal(rec.host(gaps.size), D[gaps]),
          "sharded repair step failed to recover dropped sources bit-exact")
    print(f"dryrun_multichip({n_lanes}): repair OK -- {gaps.size} dropped sources recovered bit-exact "
          "through the sharded patched-system step")

    # --- dense-W decode path (ops/wpath.py), the small-K' plan: the same
    # pattern recovered by the sharded combination matmul
    isw = np.arange(P.Kp + P.H + 4, dtype=np.uint32)  # >= H overhead: binary solve
    nrep2 = ngaps + P.H + 4
    isw[gaps] = (P.Kp + np.arange(ngaps)).astype(np.uint32)
    isw[P.Kp :] = (P.Kp + ngaps + np.arange(P.H + 4)).astype(np.uint32)
    plan_w = decoder_plan(P, isw, overhead=P.H + 4)
    _gate(isinstance(plan_w, WSchedule), "expected the dense-W plan at small K'")
    _, sym2 = codec_step_sharded(ds, np.arange(P.Kp + nrep2, dtype=np.uint32), P, Dsh, mesh)
    sym2 = sym2.host()
    D3 = np.zeros((plan_w.M_pad, blocks * T), np.uint8)
    D3[:K] = D[:K]
    D3[gaps] = sym2[P.Kp : P.Kp + ngaps]
    D3[P.Kp : P.Kp + P.H + 4] = sym2[P.Kp + ngaps : P.Kp + nrep2]
    rec2 = w_step_sharded(plan_w, shard_width(D3, mesh, block=T), mesh).host(gaps.size)
    _gate(np.array_equal(rec2, D[gaps]), "sharded dense-W decode failed to recover dropped sources bit-exact")
    print(f"dryrun_multichip({n_lanes}): dense-W decode OK -- {gaps.size} gaps recovered bit-exact "
          "via the sharded combination matmul")

    # --- public-API round trip over the mesh: Encoder (sharded replay + LT
    # via encode_batch) feeds a Decoder whose repair_all(mesh=) splits the
    # stacked per-block W batches, each block with a DISTINCT loss pattern
    _public_roundtrip(mesh, rng, dev, Zb=n_lanes, label="public API")
    # --- breadth gates: shapes the happy path above does not cover
    # (a) uneven blocks: Z not a multiple of the lane count
    _public_roundtrip(mesh, rng, dev, Zb=n_lanes + 3, label=f"uneven Z={n_lanes + 3}")
    # (b) N > 1 sub-block interleaving over the mesh
    _public_roundtrip(mesh, rng, dev, Zb=n_lanes, N=4, label="N=4 sub-blocks")
    # (c) mixed decode plans in ONE repair_all: per-block overhead alternates
    #     above and below H, so the planner emits binary-W (stacked GF(2)
    #     matmul) and HDPC GF(256)-W plans, stacked and split separately
    kinds = _public_roundtrip(mesh, rng, dev, Zb=n_lanes, ov_mode="mixed", label="mixed W plans")
    _gate(kinds == {"W-gf2", "W-gf256"}, f"expected mixed plan kinds, got {kinds}")
    _gate(not mesh.take_index_errors(), "a gather of the dry run met an index outside its source")


def _public_roundtrip(mesh, rng, dev, Zb, N=1, ov_mode=None, label=""):
    """Encoder.encode_batch(mesh=) -> Decoder.repair_all(mesh=) round trip
    with a distinct loss pattern per block; returns the set of decode plan
    kinds the planner chose."""
    n_lanes = mesh.size
    Kb, Tb = 64, 96
    data = rng.integers(0, 256, Kb * Tb * Zb, dtype=np.uint8)
    enc = Encoder(data.size, Tb, Al=1, Z=Zb, N=N, device=dev)
    _gate(enc.scheme.N == N, f"the scheme has N={enc.scheme.N}, asked {N}")
    src = MemoryIO(data)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    H = enc.P.H
    for sbn in range(Zb):
        g = np.sort(rng.choice(Kb, size=3 + (sbn % 3), replace=False))
        keep = np.setdiff1d(np.arange(Kb), g)
        # mixed mode: even blocks get >= H overhead (binary factorization ->
        # GF(2) W), odd blocks get 1 (HDPC pivots -> GF(256) W)
        ov = (H + 4 if sbn % 2 == 0 else 1) if ov_mode == "mixed" else 2
        rep_esis = np.arange(Kb, Kb + g.size + ov)
        rep_pl = enc.encode_batch(sbn, rep_esis, src, mesh=mesh)
        # source payloads via the encoder's own reader: exact for N > 1, where
        # symbol bytes interleave across sub-blocks
        srcs = np.stack([enc._read_symbol(src, sbn, int(e), Kb) for e in keep])
        dec.add_symbols(srcs, [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(rep_pl, [make_tag(sbn, int(e)) for e in rep_esis], io)
    kinds = set()  # the plan kinds the planner picks for these patterns
    for sbn in range(Zb):
        prep = dec._repair_prepare(sbn)
        if isinstance(prep, bool):
            continue
        plan = decoder_plan(dec.P, prep[1], prep[2])
        _gate(plan is not None, f"rank-deficient plan in dryrun block {sbn}")
        if isinstance(plan, DeviceSchedule):
            kinds.add("structured")
        else:
            kinds.add("W-gf2" if plan.Wbits is not None else "W-gf256")
    _gate(dec.repair_all(io, mesh=mesh), f"mesh repair_all failed [{label}]")
    _gate(np.array_equal(out, data), f"mesh round trip lost bit-exactness [{label}]")
    print(f"dryrun_multichip({n_lanes}): {label} OK -- {Zb} blocks, distinct loss patterns, "
          f"plans {sorted(kinds)}, bit-exact through encode_batch(mesh=) + repair_all(mesh=)")
    return kinds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nanorq-torch-dryrun")
    ap.add_argument("n", type=int, nargs="?", default=8, help="lanes")
    ap.add_argument("mode", nargs="?", default="full", choices=("full", "structured"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.n, args.device, args.mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
