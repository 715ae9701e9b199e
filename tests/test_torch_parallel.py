"""The port's lanes (`nanorq_tpu_torch.parallel`) against `nanorq_tpu.parallel`
on the 8-device virtual CPU mesh of tests/conftest.py, and against the port's
own unsharded functions: the same numpy inputs from a seed, byte equality
throughout (GF arithmetic is exact).  CPU lanes may name "cpu" as often as
wanted; the `cuda` twins run the same splits on the card's streams."""

import jax
import numpy as np
import pytest
import torch

from nanorq_tpu.codec import cache as jcache
from nanorq_tpu.codec.api import Decoder as JDecoder
from nanorq_tpu.codec.api import Encoder as JEncoder
from nanorq_tpu.io.ioctx import MemoryIO as JMemoryIO
from nanorq_tpu.ops.lt import lt_plan as jlt_plan
from nanorq_tpu.ops.replay import device_arrays as jdevice_arrays
from nanorq_tpu.parallel import mesh as jmesh
from nanorq_tpu.rfc.params import params_init as jparams_init
from nanorq_tpu_torch import entry
from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.ops.lt import lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays
from nanorq_tpu_torch.parallel import mesh as tmesh
from nanorq_tpu_torch.rfc.params import params_init


def _lanes(n, device="cpu"):
    return tmesh.make_mesh([device] * n)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def native():
    if not native_available():
        pytest.skip("the W plans need the native solver")


# --- (e) the split rules ------------------------------------------------------


@pytest.mark.parametrize("shape,n", [((5, 100), 8), ((3, 96), 8), ((4, 7), 3), ((2, 1), 4)])
def test_pad_width_equals_jax(shape, n):
    D = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got, want = tmesh.pad_width(D, n), jmesh.pad_width(D, n)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert (got is D) == (shape[1] % n == 0)  # no copy where the width divides


@pytest.mark.parametrize("t,n,block,want", [
    # whole blocks where there are at least as many as lanes, uneven runs first
    (800, 8, 100, [(i * 100, (i + 1) * 100) for i in range(8)]),
    (1000, 3, 100, [(0, 400), (400, 700), (700, 1000)]),
    # fewer blocks than lanes, or a width that is no whole number of them: 16-byte units
    (300, 8, 100, [(0, 48), (48, 96), (96, 144), (144, 176), (176, 208), (208, 240), (240, 272), (272, 300)]),
    (1000, 3, None, [(0, 336), (336, 672), (672, 1000)]),
    (130, 8, 100, [(0, 32), (32, 48), (48, 64), (64, 80), (80, 96), (96, 112), (112, 128), (128, 130)]),
    # fewer than n 16-byte units: bytes (the 13-byte shards of T = 100 padded to 104 on 8 lanes)
    (104, 8, None, [(i * 13, (i + 1) * 13) for i in range(8)]),
    # fewer bytes than lanes: empty lanes at the end
    (5, 8, None, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 5), (5, 5), (5, 5)]),
    (64, 1, 16, [(0, 64)]),
])
def test_shard_ranges(t, n, block, want):
    got = tmesh.shard_ranges(t, n, block)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == t and all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("count,n,want", [(4, 3, [(0, 2), (2, 3), (3, 4)]), (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)]),
                                          (8, 8, [(i, i + 1) for i in range(8)]), (11, 2, [(0, 6), (6, 11)])])
def test_deal(count, n, want):
    assert tmesh.deal(count, n) == want


def test_mesh_reads_like_the_jax_one():
    mesh = _lanes(8)
    assert mesh.axis_names == ("blocks",) and int(np.prod(mesh.devices.shape)) == 8 and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices) and mesh.shape == {"blocks": 8}
    assert len({id(lane) for lane in mesh.lanes}) == 8  # one device, eight lanes of their own
    with pytest.raises(ValueError):
        tmesh.make_mesh([])
    with pytest.raises(ValueError):
        tmesh.make_mesh(["cpu"], axis="width")
    with pytest.raises(ValueError):
        tmesh.make_mesh(["xla"])


def test_no_card_no_cuda_lane():
    """A CUDA lane without a card raises, the default mesh too, and
    auto_mesh has nothing to split: no CPU lane stands in."""
    if torch.cuda.is_available():
        assert tmesh.make_mesh().size == torch.cuda.device_count()
        assert (tmesh.auto_mesh() is None) == (torch.cuda.device_count() == 1)
        return
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(["cpu", "cuda:0"])
    with pytest.raises(RuntimeError):
        tmesh.make_mesh()
    assert tmesh.auto_mesh() is None


def test_sharded_holder():
    """shard_width's parts, its zeroed dead rows, the host joins, and the
    refusal of arrays that are not split alike."""
    rng = np.random.default_rng(5)
    D = np.zeros((12, 70), np.uint8)
    D[:7] = rng.integers(0, 256, (7, 70), dtype=np.uint8)
    mesh = _lanes(3)
    sh = tmesh.shard_width(D, mesh, block=10, live_rows=7)
    assert sh.ranges == [(0, 30), (30, 50), (50, 70)] and sh.axis == 1
    assert all(p.is_contiguous() and p.shape == (12, hi - lo) for p, (lo, hi) in zip(sh.parts, sh.ranges))
    assert np.array_equal(sh.host(), D) and np.array_equal(sh.host(5), D[:5])
    assert np.array_equal(sh.gather("cpu").numpy(), D)
    blocks = sh.host_blocks(10, 7, rows=7)
    assert all(np.array_equal(blocks[b], D[:7, b * 10 : (b + 1) * 10]) for b in range(7))
    wide = sh.host_blocks(35, 2)  # a block that straddles two lanes is joined
    assert np.array_equal(wide[0], D[:, :35]) and np.array_equal(wide[1], D[:, 35:])
    few = tmesh.shard_width(D[:, :2], _lanes(4))  # two columns on four lanes: two lanes stay empty
    assert [p is None for p in few.parts] == [False, False, True, True] and np.array_equal(few.host(), D[:, :2])
    ds = tcache.encoder_schedule(params_init(10).Kp)
    with pytest.raises(ValueError):
        tmesh.replay_sharded(ds, sh, _lanes(3))  # another mesh than the array's
    with pytest.raises(ValueError):
        sh.each(None, lambda _r, x, y: x, tmesh.shard_width(D, mesh))  # cut elsewhere
    stack = tmesh.shard_blocks(np.arange(5 * 3, dtype=np.int32).reshape(5, 3), mesh)
    assert stack.ranges == [(0, 2), (2, 4), (4, 5)] and stack.parts[0].dtype == torch.int32
    assert np.array_equal(stack.host(), np.arange(15).reshape(5, 3))


# --- (a), (b) the sharded functions -------------------------------------------


def _step_inputs(K, T, B, seed=0):
    P = params_init(K)
    ds = tcache.encoder_schedule(P.Kp)
    D = np.zeros((ds.M_pad, B * T), np.uint8)
    D[:K] = np.random.default_rng(seed).integers(0, 256, (K, B * T), dtype=np.uint8)
    return P, ds, D


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's sharded codec step on its 8-device mesh: (C, symbols)."""
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    K, T, B = 100, 64, 16
    _, _, D = _step_inputs(K, T, B)
    jP = jparams_init(K)
    mesh = jmesh.make_mesh()
    plan = jlt_plan(np.arange(jP.Kp, dtype=np.uint32), jP)
    C, sym = jmesh.codec_step_sharded(jdevice_arrays(jcache.encoder_schedule(jP.Kp)), plan,
                                      jmesh.shard_width(D, mesh), mesh)
    return np.asarray(C), np.asarray(sym)


@pytest.mark.parametrize("n", [8, 3, 1])
def test_codec_step_sharded_equals_jax_and_unsharded(jax_step, n):
    K, T, B = 100, 64, 16  # 16 blocks: two a lane on 8, runs of 6, 5, 5 on 3
    P, ds, D = _step_inputs(K, T, B)
    isis = np.arange(P.Kp, dtype=np.uint32)
    mesh = _lanes(n)
    Dsh = tmesh.shard_width(D, mesh, block=T, live_rows=K)
    assert [hi - lo for lo, hi in Dsh.ranges] == [T * (B // n + (i < B % n)) for i in range(n)]
    C, sym = tmesh.codec_step_sharded(ds, isis, P, Dsh, mesh)
    C, sym = C.host(), sym.host()
    assert np.array_equal(C, jax_step[0]) and np.array_equal(sym, jax_step[1])
    assert np.array_equal(sym[:K], D[:K])  # the systematic window through the lanes
    want = entry.step(device_arrays(ds, "cpu"), lt_plan(isis, P, "cpu"), torch.from_numpy(D)).numpy()
    assert np.array_equal(sym, want)
    # replay_sharded and lt_sharded alone are the two halves of the step
    C2 = tmesh.replay_sharded(ds, tmesh.shard_width(D, mesh), mesh)  # cut on 16 bytes, every row uploaded
    assert np.array_equal(C2.host(), C)
    assert np.array_equal(tmesh.lt_sharded(C2, isis, P, mesh).host(), sym)


def _w_pattern(K, seed=3):
    P = params_init(K)
    rng = np.random.default_rng(seed)
    gaps = np.sort(rng.choice(K, size=6, replace=False))
    ov = P.H + 4
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    rep = (P.Kp + np.arange(gaps.size + ov)).astype(np.uint32)
    isis[gaps] = rep[: gaps.size]
    isis[P.Kp :] = rep[gaps.size :]
    return P, rng, isis, ov


@pytest.mark.parametrize("n", [8, 3])
def test_w_step_sharded_equals_jax_and_unsharded(native, n):
    K, T, B = 100, 64, 16
    P, rng, isis, ov = _w_pattern(K)
    plan = tcache.decoder_plan(P, isis, ov)
    assert isinstance(plan, tcache.WSchedule)
    D = np.zeros((plan.M_pad, B * T), np.uint8)
    D[: P.Kp + ov] = rng.integers(0, 256, (P.Kp + ov, B * T), dtype=np.uint8)
    mesh = _lanes(n)
    got = tmesh.w_step_sharded(plan, tmesh.shard_width(D, mesh, block=T, live_rows=P.Kp + ov), mesh).host()
    assert np.array_equal(got, plan.apply(torch.from_numpy(D)).numpy())
    jplan = jcache.decoder_plan(jparams_init(K), isis, ov)
    jm = jmesh.make_mesh()
    want = np.asarray(jmesh.w_step_sharded(jplan.staged(), jmesh.shard_width(D, jm), jm))
    assert np.array_equal(got, want)


# --- (c) the encoder -----------------------------------------------------------


def test_encoder_mesh_equals_jax_and_unsharded():
    """Encoder.encode_batch(mesh=) at T = 100, which 8 does not divide: the
    block's own width, not padded (the JAX package pads it to 104), cut into
    shards of 13 and 12 bytes (the kernels' byte lanes), equals the padded
    JAX result and the unsharded port bit for bit."""
    K, T = 40, 100
    data = np.random.default_rng(7).integers(0, 256, K * T, dtype=np.uint8)
    esis = np.r_[np.arange(0, K, 3), np.arange(K, K + 9)]
    ref = Encoder(data.size, T, Al=1, device="cpu").encode_batch(0, esis, MemoryIO(data))
    mesh = _lanes(8)
    enc = Encoder(data.size, T, Al=1, device="cpu")
    got = enc.encode_batch(0, esis, MemoryIO(data), mesh=mesh)
    C = enc._blocks[0].C
    assert isinstance(C, tmesh.Sharded) and [hi - lo for lo, hi in C.ranges] == [13] * 4 + [12] * 4
    assert C.ranges[-1][1] == T and all(p.shape[1] == hi - lo for p, (lo, hi) in zip(C.parts, C.ranges))
    want = JEncoder(data.size, T, Al=1).encode_batch(0, esis, JMemoryIO(data), mesh=jmesh.make_mesh())
    assert np.array_equal(got, ref) and np.array_equal(got, want)
    # the sharded C then serves a call with no mesh, and one with another mesh: gathered, explicitly
    assert np.array_equal(enc.encode_batch(0, esis, MemoryIO(data)), ref)
    assert isinstance(enc._blocks[0].C, torch.Tensor)
    enc2 = Encoder(data.size, T, Al=1, device="cpu")
    enc2.generate_symbols(0, MemoryIO(data), mesh=mesh)
    assert np.array_equal(enc2.encode_batch(0, esis, MemoryIO(data), mesh=_lanes(3)), ref)
    # an unsharded C met with a mesh stays where it is
    enc3 = Encoder(data.size, T, Al=1, device="cpu")
    enc3.generate_symbols(0, MemoryIO(data))
    assert np.array_equal(enc3.encode_batch(0, esis, MemoryIO(data), mesh=mesh), ref)
    assert isinstance(enc3._blocks[0].C, torch.Tensor)


@pytest.mark.parametrize("n,Z,T", [(8, 16, 48), (3, 4, 48), (4, 3, 100), (8, 5, 100)])
def test_batch_generate_and_repair_symbols_mesh(n, Z, T):
    """codec.batch over a mesh equals the unsharded object encode and the JAX
    package's: whole blocks a lane, uneven runs, fewer blocks than lanes."""
    K = 40
    data = np.random.default_rng(n + Z).integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=1, Z=Z, device="cpu")
    batch = tbatch.load_object(enc, MemoryIO(data))
    ref = tbatch.repair_symbols(batch, 9, "cpu")
    mesh = _lanes(n)
    batch.C = None
    got = tbatch.repair_symbols(batch, 9, "cpu", mesh=mesh)
    assert isinstance(batch.C, tmesh.Sharded) and sorted(got) == list(range(Z))
    assert all(got[b].shape == (9, T) and np.array_equal(got[b], ref[b]) for b in range(Z))
    again = tbatch.repair_symbols(batch, 9, "cpu")  # the sharded C, gathered for a call with no mesh
    assert isinstance(batch.C, torch.Tensor) and all(np.array_equal(again[b], ref[b]) for b in range(Z))
    jenc = JEncoder(data.size, T, Al=1, Z=Z)
    for b in range(Z):
        assert np.array_equal(got[b], jenc.encode_batch(b, np.arange(K, K + 9), JMemoryIO(data)))


# --- (d) the public round trip ---------------------------------------------------

ROUND_TRIPS = {  # name: (lanes, blocks, N, overhead mode, structured plans)
    "8-lanes": (8, 8, 1, None, False),
    "3-lanes-4-blocks": (3, 4, 1, None, False),
    "uneven-Z=n+3": (4, 7, 1, None, False),
    "N=4-sub-blocks": (4, 4, 4, None, False),
    "mixed-W-plans": (4, 4, 1, "mixed", False),
    "structured-plans": (3, 4, 1, None, True),
    "one-block": (4, 1, 1, None, False),
}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_repair_all_mesh_round_trip(native, monkeypatch, name):
    """Encoder.encode_batch(mesh=) -> Decoder.repair_all(mesh=), a distinct
    loss pattern per block: the repair payloads equal the JAX package's, the
    port restores the object over its lanes, and the JAX package restores it
    from the same symbols over its mesh."""
    n, Z, N, ov_mode, structured = ROUND_TRIPS[name]
    if structured:
        for mod in (tcache, jcache):
            monkeypatch.setattr(mod, "WPATH_MAX_KP", 0)
            monkeypatch.setattr(mod, "WPATH_GF256_MAX_KP", 0)
    tcache.clear_decoder_cache()
    jcache.clear_decoder_cache()
    K, T = 64, 48
    rng = np.random.default_rng(len(name))
    data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
    mesh = _lanes(n)
    enc = Encoder(data.size, T, Al=1, Z=Z, N=N, device="cpu")
    jenc = JEncoder(data.size, T, Al=1, Z=Z, N=N)
    assert enc.scheme.N == N
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")
    jdec = JDecoder(jenc.oti_common(), jenc.oti_scheme_specific())
    out, jout = np.zeros(data.size, np.uint8), np.zeros(data.size, np.uint8)
    io, jio, src = MemoryIO(out), JMemoryIO(jout), MemoryIO(data)
    H = enc.P.H
    for sbn in range(Z):
        gaps = np.sort(rng.choice(K, size=3 + (sbn % 3), replace=False))
        keep = np.setdiff1d(np.arange(K), gaps)
        ov = (H + 4 if sbn % 2 == 0 else 1) if ov_mode == "mixed" else 2 + (sbn % 2)
        rep_esis = np.arange(K, K + gaps.size + ov)
        rep_pl = enc.encode_batch(sbn, rep_esis, src, mesh=mesh)
        assert np.array_equal(rep_pl, jenc.encode_batch(sbn, rep_esis, JMemoryIO(data)))
        srcs = np.stack([enc._read_symbol(src, sbn, int(e), K) for e in keep])
        for d, o in ((dec, io), (jdec, jio)):
            d.add_symbols(srcs, [make_tag(sbn, int(e)) for e in keep], o)
            d.add_symbols(rep_pl, [make_tag(sbn, int(e)) for e in rep_esis], o)
    kinds = set()
    for sbn in range(Z):
        _gaps, isis, ov = dec._repair_prepare(sbn)
        plan = tcache.decoder_plan(dec.P, isis, ov)
        kinds.add("structured" if not isinstance(plan, tcache.WSchedule) else
                  "W-gf2" if plan.Wbits is not None else "W-gf256")
    if structured:
        assert kinds == {"structured"}
    elif ov_mode == "mixed":
        assert kinds == {"W-gf2", "W-gf256"}
    else:
        assert "structured" not in kinds
    assert dec.repair_all(io, mesh=mesh)  # a mesh forces the device arm, whatever the default backend
    assert np.array_equal(out, data)
    jm = jmesh.make_mesh(jax.devices()[:n])
    assert jdec.repair_all(jio, mesh=jm) and np.array_equal(jout, data)


def test_mesh_forces_the_device_arm(native):
    """repair_all(mesh=) sends every block to the device arm under any
    backend name, as the JAX package does: the host arms are single-node."""
    from nanorq_tpu_torch.utils import stats

    K, T, Z = 64, 48, 3
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=1, Z=Z, device="cpu")
    mesh = _lanes(2)
    for backend in ("auto", "host", "res", "res_host"):
        tcache.clear_decoder_cache()
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")
        out = np.zeros(data.size, np.uint8)
        io = MemoryIO(out)
        for sbn in range(Z):
            gaps = np.sort(rng.choice(K, size=4, replace=False))
            keep = np.setdiff1d(np.arange(K), gaps)
            rep_esis = np.arange(K, K + 6)
            dec.add_symbols(data.reshape(Z * K, T)[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
            dec.add_symbols(enc.encode_batch(sbn, rep_esis, MemoryIO(data)),
                            [make_tag(sbn, int(e)) for e in rep_esis], io)
        c0 = stats.snapshot()["counters"].get("repair_device_blocks", 0)
        assert dec.repair_all(io, mesh=mesh, backend=backend) and np.array_equal(out, data)
        assert stats.snapshot()["counters"].get("repair_device_blocks", 0) - c0 == Z


# --- (f) the dry run -------------------------------------------------------------


def test_dryrun_multichip_on_cpu_lanes(capsys):
    entry.dryrun_multichip(2, "cpu")
    said = capsys.readouterr().out
    for gate in ("encode OK", "repair OK", "dense-W decode OK", "public API OK", "uneven Z=5 OK",
                 "N=4 sub-blocks OK", "mixed W plans OK", "structured plans OK"):
        assert gate in said, gate
    assert tcache.WPATH_MAX_KP > 0 and tcache.WPATH_GF256_MAX_KP > 0  # the structured mode put them back


# --- (g) on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
def test_cuda_codec_step_sharded(n):
    """n lanes of one card, each on its own stream from pinned staging,
    against the unsharded step on the CPU."""
    dev = _card()
    K, T, B = 100, 1280, 8
    P, ds, D = _step_inputs(K, T, B, seed=n)
    isis = np.arange(P.Kp + 7, dtype=np.uint32)
    mesh = _lanes(n, dev)
    assert all(lane.stream is not None for lane in mesh.lanes)
    assert len({lane.stream.cuda_stream for lane in mesh.lanes}) == n
    C, sym = tmesh.codec_step_sharded(ds, isis, P, tmesh.shard_width(D, mesh, block=T, live_rows=K), mesh)
    want = entry.step(device_arrays(ds, "cpu"), lt_plan(isis, P, "cpu"), torch.from_numpy(D)).numpy()
    assert all(p.device == dev for p in sym.parts) and np.array_equal(sym.host(), want)
    assert np.array_equal(sym.host(5), want[:5]) and not mesh.take_index_errors()


@pytest.mark.cuda
@pytest.mark.parametrize("n,Z,T", [(4, 8, 1280), (3, 4, 100), (4, 1, 96)])
def test_cuda_round_trip_over_lanes(n, Z, T):
    """Object encode and repair_all over n lanes of one card: whole blocks,
    uneven runs with byte-lane shards, and a single block."""
    dev = _card()
    K = 64
    rng = np.random.default_rng(n * Z)
    data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
    mesh = _lanes(n, dev)
    enc = Encoder(data.size, T, Al=1, Z=Z, device=dev)
    batch = tbatch.load_object(enc, MemoryIO(data))
    reps = tbatch.repair_symbols(batch, 12, dev, mesh=mesh)
    cpu = Encoder(data.size, T, Al=1, Z=Z, device="cpu")
    ref = tbatch.repair_symbols(tbatch.load_object(cpu, MemoryIO(data)), 12, "cpu")
    assert all(np.array_equal(reps[b], ref[b]) for b in range(Z))
    tcache.clear_decoder_cache()
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    for sbn in range(Z):
        gaps = np.sort(rng.choice(K, size=3 + (sbn % 3), replace=False))
        keep = np.setdiff1d(np.arange(K), gaps)
        nrep = gaps.size + 2 + (sbn % 2)
        dec.add_symbols(data.reshape(Z * K, T)[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(reps[sbn][:nrep], [make_tag(sbn, int(e)) for e in range(K, K + nrep)], io)
    assert dec.repair_all(io, mesh=mesh) and np.array_equal(out, data)
    assert not mesh.take_index_errors()


@pytest.mark.cuda
def test_cuda_dryrun_on_the_card():
    entry.dryrun_multichip(4, _card())


@pytest.mark.cuda
def test_cuda_two_cards():
    """One lane a card over every visible card; skips below two."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    mesh = tmesh.auto_mesh()
    assert mesh is not None and mesh.size == torch.cuda.device_count()
    K, T, B = 100, 1280, 2 * mesh.size
    P, ds, D = _step_inputs(K, T, B)
    isis = np.arange(P.Kp, dtype=np.uint32)
    _, sym = tmesh.codec_step_sharded(ds, isis, P, tmesh.shard_width(D, mesh, block=T, live_rows=K), mesh)
    assert [p.device.index for p in sym.parts] == list(range(mesh.size))
    assert np.array_equal(sym.host()[:K], D[:K]) and not mesh.take_index_errors()
