"""The default path (`mesh=None`) moves its data as a mesh's lanes do: one
lane of the device on its current stream (`parallel.mesh.local_mesh`), only
the live rows uploaded, pinned memory on a card (`host_matrix`, `upload`,
`fetch`).  On the CPU: the helpers, and the codec's sources hold no other way
to move a payload.  On the card (`cuda`, K = 1000): the default path, a
1-lane and a 2-lane mesh and the CPU path give the same bytes for encode, the
GF(2) W decode, the GF(256) W decode and the structured decode."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.parallel import mesh as tmesh

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_local_mesh_is_one_lane_on_the_current_stream():
    mesh = tmesh.local_mesh("cpu")
    assert mesh.size == 1 and mesh.lanes[0].stream is None and not mesh.lanes[0].cuda
    x = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    w = tmesh.whole(x)
    assert w.parts == [x] and w.ranges == [(0, 4)] and w.axis == 1 and w.mesh.size == 1
    assert np.array_equal(w.host(2), x[:2].numpy())


def test_host_matrix_and_upload_on_the_cpu():
    """On the CPU the matrix is plain numpy with every row, and a lane reads
    it in place; any other shape is copied, the rows past `live` zeroed."""
    D = tmesh.host_matrix(3, 8, 5, "cpu")
    assert isinstance(D, np.ndarray) and D.shape == (8, 5) and not D.any()
    D[:3] = np.arange(15, dtype=np.uint8).reshape(3, 5)
    lane = tmesh.local_mesh("cpu").lanes[0]
    same = tmesh.upload(lane, D, 8, 3)
    assert same.data_ptr() == D.ctypes.data  # no copy
    more = tmesh.upload(lane, D[:3], 10, 3)  # fewer rows than asked: copied, zeros after
    assert more.shape == (10, 5) and np.array_equal(more[:3].numpy(), D[:3]) and not more[3:].any()
    D[5] = 7  # a row past `live` is taken to be zero: a copy leaves it out
    cols = tmesh.upload(lane, D[:, 1:4], 8, 3)
    assert np.array_equal(cols[:3].numpy(), D[:3, 1:4]) and not cols[3:].any()


def _calls(path: pathlib.Path) -> set:
    """Names of the methods a module calls (x.name(...))."""
    tree = ast.parse(path.read_text())
    return {n.func.attr for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}


@pytest.mark.parametrize("module", ["codec/api.py", "codec/batch.py"])
def test_codec_moves_payloads_only_through_the_lanes(module):
    """No pageable `.to(device)` or `.cpu()` is left in the codec: every upload
    and download goes through `parallel.mesh` (upload / stage / fetch)."""
    path = REPO / "nanorq_tpu_torch" / module
    assert not {"to", "cpu"} & _calls(path)
    assert "_upload" not in path.read_text()


def test_default_and_mesh_encode_equal_on_the_cpu():
    """codec.batch and the per-block Encoder with no mesh, over 1 and 2 CPU
    lanes, at T = 100 (byte lanes): the same repair symbols."""
    K, T, Z = 60, 100, 3
    data = np.random.default_rng(9).integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=1, Z=Z, device="cpu")
    batch = tbatch.load_object(enc, MemoryIO(data))
    ref = tbatch.repair_symbols(batch, 7, "cpu")
    assert isinstance(batch.C, torch.Tensor)
    for n in (1, 2):
        batch.C = None
        got = tbatch.repair_symbols(batch, 7, "cpu", mesh=tmesh.make_mesh(["cpu"] * n))
        assert all(np.array_equal(got[b], ref[b]) for b in range(Z))
    esis = np.arange(K, K + 7)
    for b in range(Z):
        assert np.array_equal(Encoder(data.size, T, Al=1, Z=Z, device="cpu").encode_batch(b, esis, MemoryIO(data)),
                              ref[b])


# --- on the card, K = 1000 ----------------------------------------------------------

K, T, Z = 1000, 1280, 4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _placements(dev):
    """(name, device, mesh) of every way the card test runs one path."""
    return [("cpu", "cpu", None), ("default", dev, None), ("1-lane", dev, tmesh.make_mesh([dev])),
            ("2-lanes", dev, tmesh.make_mesh([dev, dev]))]


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [T, 100])
def test_cuda_encode_default_equals_lanes_and_cpu(T_):
    dev = _card()
    data = np.random.default_rng(T_).integers(0, 256, K * T_ * Z, dtype=np.uint8)
    got = {}
    for name, d, mesh in _placements(dev):
        enc = Encoder(data.size, T_, Al=1, Z=Z, device=d)
        batch = tbatch.load_object(enc, MemoryIO(data))
        assert (name == "cpu") != torch.as_tensor(batch.D).is_pinned()  # the object is pinned on the card
        got[name] = tbatch.repair_symbols(batch, 60, d, mesh=mesh)
        per_block = Encoder(data.size, T_, Al=1, Z=Z, device=d).encode_batch(1, np.arange(K - 5, K + 60),
                                                                             MemoryIO(data), mesh=mesh)
        assert np.array_equal(per_block[5:], got[name][1]), name
    for name in got:
        assert all(np.array_equal(got[name][b], got["cpu"][b]) for b in range(Z)), name


def _decode_all(dev, mesh, overhead: int, seed: int = 3):
    """An object of Z blocks of K = 1000 at 6% loss + `overhead`, decoded by
    repair_all(backend="device") on `dev` (or over `mesh`): (out, data, plan kinds)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=1, Z=Z, device="cpu")
    reps = tbatch.repair_symbols(tbatch.load_object(enc, MemoryIO(data)), 120, "cpu")
    tcache.clear_decoder_cache()
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    for sbn in range(Z):
        gaps = np.nonzero(rng.random(K) < 0.06)[0]
        keep = np.setdiff1d(np.arange(K), gaps)
        nrep = gaps.size + overhead
        dec.add_symbols(data.reshape(Z * K, T)[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(reps[sbn][:nrep], [make_tag(sbn, int(e)) for e in range(K, K + nrep)], io)
    kinds = set()
    for sbn in range(Z):
        _gaps, isis, ov = dec._repair_prepare(sbn)
        plan = tcache.decoder_plan(dec.P, isis, ov)
        kinds.add("structured" if not isinstance(plan, tcache.WSchedule) else
                  "gf2" if plan.Wbits is not None else "gf256")
    tcache.clear_decoder_cache()
    assert dec.repair_all(io, backend="device", mesh=mesh)
    return out, data, kinds


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["gf2", "gf256", "structured"])
def test_cuda_decode_default_equals_lanes_and_cpu(monkeypatch, plan):
    """The three device plans at K = 1000: the GF(2) W (50 overhead), the
    GF(256) W (overhead 2 < H, as the bench's K = 100 cell has it) and the
    structured replay (`WPATH_MAX_KP` and `WPATH_GF256_MAX_KP` set below K')."""
    dev = _card()
    if not native_available():
        pytest.skip("the W plans need the native solver")
    if plan == "structured":
        monkeypatch.setattr(tcache, "WPATH_MAX_KP", 0)
        monkeypatch.setattr(tcache, "WPATH_GF256_MAX_KP", 0)
    overhead = 2 if plan == "gf256" else 50
    for name, d, mesh in _placements(dev):
        out, data, kinds = _decode_all(d, mesh, overhead)
        assert kinds == {plan}, (name, kinds)
        assert np.array_equal(out, data), name
        if mesh is not None:
            assert not mesh.take_index_errors()
