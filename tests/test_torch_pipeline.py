"""The default path's width slices (`parallel.mesh.default_mesh`): on a card a
wide object is encoded as slices on lanes of the card, each slice's columns
uploaded by one pitched copy out of the pinned object (`ops/kernels.copy2d`).

On the CPU the rule never slices, so the sliced path is forced here by
standing in for the rule (`slice_count`) and runs on CPU lanes: C and the
repair symbols, bit for bit, against the unsliced path and against the JAX
package's `codec.batch.generate` / `repair_symbols`; a sliced C is combined
where it lies.  The copy's plain version against a contiguous copy.  The
`cuda` tests hold the copy, the sliced default and a lane's upload on the
card."""

import functools

import numpy as np
import pytest
import torch

from nanorq_tpu.codec import batch as jbatch
from nanorq_tpu.codec.api import Encoder as JEncoder
from nanorq_tpu.io.ioctx import MemoryIO as JMemoryIO
from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec.api import Encoder
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.ops import kernels
from nanorq_tpu_torch.parallel import mesh as tmesh

N_REPAIR = 9


def _data(K: int, Z: int, T: int) -> np.ndarray:
    return np.random.default_rng(K * 1000 + Z * 10 + T).integers(0, 256, K * T * Z, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax(K: int, Z: int, T: int):
    """The JAX package's C and repair symbols of the object."""
    jb = jbatch.load_object(JEncoder(K * T * Z, T, Al=1, Z=Z), JMemoryIO(_data(K, Z, T)))
    C = np.asarray(jbatch.generate(jb))
    return C, jbatch.repair_symbols(jb, N_REPAIR)


def _force(monkeypatch, S: int) -> None:
    """The default path slices every object into S, on any device."""
    monkeypatch.setattr(tmesh, "default_mesh", lambda device, t, block, live: tmesh.slice_mesh(device, S))


CASES = [(K, T, Z, S) for T in (100, 1280) for K, Z in ((40, 1), (47, 3), (53, 7), (60, 8)) for S in (2, 4)]


@pytest.mark.parametrize("K,T,Z,S", CASES)
def test_sliced_default_equals_unsliced_and_jax(monkeypatch, K, T, Z, S):
    """A ragged last slice (Z = 3, 7 over 2 or 4), fewer blocks than slices
    (Z = 1, 3 over 4: 16-byte or byte cuts), byte lanes (T = 100)."""
    data = _data(K, Z, T)
    enc = Encoder(data.size, T, Al=1, Z=Z, device="cpu")
    batch = tbatch.load_object(enc, MemoryIO(data))
    C_ref = tbatch.generate(batch, "cpu")
    assert isinstance(C_ref, torch.Tensor)  # the rule, on the CPU: one lane
    ref = tbatch.repair_symbols(batch, N_REPAIR, "cpu")
    _force(monkeypatch, S)
    batch.C = None
    C = tbatch.generate(batch, "cpu")
    assert isinstance(C, tmesh.Sharded) and C.mesh is tmesh.slice_mesh("cpu", S)
    assert C.ranges == tmesh.shard_ranges(Z * T, S, T)
    got = tbatch.repair_symbols(batch, N_REPAIR, "cpu")
    assert batch.C is C
    C_jax, want = _jax(K, Z, T)
    assert np.array_equal(C.host(), C_ref.numpy()) and np.array_equal(C_ref.numpy(), C_jax)
    assert sorted(got) == list(range(Z))
    for b in range(Z):
        assert np.array_equal(got[b], ref[b]) and np.array_equal(ref[b], want[b]), b


@pytest.mark.parametrize("S", [2, 4])
def test_sliced_c_is_combined_where_it_lies(monkeypatch, S):
    """After a sliced generate, repair_symbols(mesh=None) gathers nothing: C
    stays the same Sharded over the same mesh object; an explicit mesh of
    another layout still gathers it."""
    K, T, Z = 40, 100, 8
    data = _data(K, Z, T)
    batch = tbatch.load_object(Encoder(data.size, T, Al=1, Z=Z, device="cpu"), MemoryIO(data))
    _force(monkeypatch, S)
    C = tbatch.generate(batch, "cpu")

    def no_gather(self, device):
        raise AssertionError("a sliced C was gathered")

    with monkeypatch.context() as m:
        m.setattr(tmesh.Sharded, "gather", no_gather)
        first = tbatch.repair_symbols(batch, N_REPAIR, "cpu")
        again = tbatch.repair_symbols(batch, N_REPAIR, "cpu")
    assert batch.C is C and C.mesh is tmesh.slice_mesh("cpu", S) and tmesh.is_sliced(C.mesh)
    assert all(np.array_equal(first[b], again[b]) for b in range(Z))
    other = tmesh.make_mesh(["cpu"] * 3)
    assert not tmesh.is_sliced(other)
    moved = tbatch.repair_symbols(batch, N_REPAIR, "cpu", mesh=other)  # another mesh: gathered, combined unsharded
    assert isinstance(batch.C, torch.Tensor) and all(np.array_equal(moved[b], first[b]) for b in range(Z))


def test_slice_mesh_is_kept():
    """One mesh per (device, lanes): a program's key holds its lane's stream."""
    assert tmesh.slice_mesh("cpu", 3) is tmesh.slice_mesh("cpu", 3)
    assert tmesh.slice_mesh("cpu", 3).size == 3 and tmesh.slice_mesh("cpu", 2).size == 2


@pytest.mark.parametrize("K", [1000, 50000])
def test_rule_keeps_the_cpu_and_narrow_objects_unsliced(K):
    S, least = tmesh.SLICES, tmesh.SLICE_BYTES
    T = 1280

    def width(n: int, block: int) -> int:  # the least whole-block width whose n slices each upload SLICE_BYTES
        return -(-n * least // (K * block)) * block

    wide = max(S * T, width(S, T))
    m = tmesh.default_mesh("cpu", wide, T, K)
    assert m.size == 1 and m.lanes[0].stream is None and not tmesh.is_sliced(m)
    assert tmesh.slice_count(wide, T, K) == S and tmesh.slice_count(8 * wide, T, K) == S  # at most SLICES
    assert tmesh.slice_count(wide + 1, T, K) == 1  # not whole blocks
    assert tmesh.slice_count((S - 1) * T, T, 10**9) == S - 1  # no more slices than blocks
    for n in range(1, S + 1):  # as many slices as SLICE_BYTES fit (16-byte blocks: the bytes decide)
        assert tmesh.slice_count(width(n, 16), 16, K) == n
        assert tmesh.slice_count(width(n, 16) - 16, 16, K) == max(1, n - 1)


def test_default_encode_on_the_cpu_stays_one_tensor():
    K, T, Z = 40, 1280, 8
    data = _data(K, Z, T)
    batch = tbatch.load_object(Encoder(data.size, T, Al=1, Z=Z, device="cpu"), MemoryIO(data))
    assert isinstance(tbatch.generate(batch, "cpu"), torch.Tensor)


@pytest.mark.parametrize("rows,lo,w", [(37, 0, 301), (37, 3, 17), (5, 101, 1), (1, 7, 200), (64, 300, 1),
                                       (0, 5, 9), (13, 11, 0)])
def test_copy2d_plain_equals_a_contiguous_copy(rows, lo, w):
    src = torch.from_numpy(np.random.default_rng(rows * 7 + lo).integers(0, 256, (rows, 301), dtype=np.uint8))
    view = src[:, lo : lo + w]
    dst = torch.full((rows, w), 0xA5, dtype=torch.uint8)
    before = dict(kernels.COPIES)
    assert kernels.copy2d(dst, view) is dst
    assert torch.equal(dst, view.contiguous()) and kernels.COPIES == before  # the CPU counts no copy


def test_copy2d_refuses_what_it_cannot_copy():
    src = torch.zeros((8, 32), dtype=torch.uint8)
    for dst, view in [(torch.zeros((8, 16), dtype=torch.uint8), src[:, ::2]),  # columns apart
                      (torch.zeros((8, 15), dtype=torch.uint8), src[:, :16]),  # shapes differ
                      (torch.zeros((8, 16), dtype=torch.int16), src[:, :16]),  # types differ
                      (torch.zeros((8, 32), dtype=torch.uint8)[:, ::2], src[:, :16])]:  # dst columns apart
        with pytest.raises(ValueError):
            kernels.copy2d(dst, view)


@pytest.mark.parametrize("lo,hi", [(0, 300), (100, 200), (7, 290)])
def test_column_range_upload_on_a_cpu_lane(lo, hi):
    D = tmesh.host_matrix(5, 9, 300, "cpu")
    D[:5] = np.random.default_rng(lo).integers(0, 256, (5, 300), dtype=np.uint8)
    x = tmesh.upload(tmesh.slice_mesh("cpu", 2).lanes[1], D[:, lo:hi], 9, 5)
    assert x.shape == (9, hi - lo) and np.array_equal(x[:5].numpy(), D[:5, lo:hi]) and not x[5:].any()


def test_pipe_sweep_rehearses_on_the_cpu(capsys):
    from nanorq_tpu_torch.tools import pipe_sweep

    lines = pipe_sweep.main(["--device", "cpu", "--points", "40:4", "40:1", "--slices", "1", "2", "4",
                             "--rounds", "2", "--T", "16"])
    assert [ln["slices"] for ln in lines] == [[1, 2, 4], [1]]  # a slice is never less than a block
    assert all(len(v) == 2 for v in lines[0]["ms"].values()) and lines[0]["best"] in (1, 2, 4)
    assert lines[0]["device"] == "cpu" and lines[0]["timing"] == "perf_counter" and lines[0]["evicted"] == 0
    assert len(capsys.readouterr().out.splitlines()) == 2


class _Span:
    def __init__(self, name, a, b):
        self.name, self.device_type = name, torch.autograd.DeviceType.CUDA
        self.time_range = type("R", (), {"start": a, "end": b})


def test_overlap_of_copies_and_kernels():
    from nanorq_tpu_torch.tools.pipe_sweep import overlap

    spans = [_Span("Memcpy HtoD (Pinned -> Device)", 0, 1000), _Span("Memcpy HtoD (Pinned -> Device)", 900, 2000),
             _Span("gather_xor_kernel", 500, 1500), _Span("gf2_kernel", 1400, 2500),
             _Span("Memcpy DtoH (Device -> Pinned)", 2500, 3000), _Span("Memset (Device)", 3000, 3100),
             _Span("nrq.generate", 0, 4000)]  # a program span's range on the card's timeline: not device work
    got = overlap(spans)
    assert got == {"htod_ms": 2.0, "htod_overlap_ms": 1.5, "device_ms": 3.1, "kernel_sum_ms": 2.1}


# --- on the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,lo,w", [(1, 0, 1), (37, 3, 17), (1000, 1280, 2560), (999, 5, 12801), (3, 4095, 1)])
def test_cuda_copy2d_equals_copy_of_the_contiguous_range(rows, lo, w):
    dev = _card()
    host = torch.empty((rows, 16384), dtype=torch.uint8, pin_memory=True)
    host.copy_(torch.from_numpy(np.random.default_rng(rows + lo).integers(0, 256, (rows, 16384), dtype=np.uint8)))
    view = host[:, lo : lo + w]
    dst = torch.full((rows, w), 0x5A, dtype=torch.uint8, device=dev)
    before = kernels.COPIES["copy2d"]
    kernels.copy2d(dst, view)
    assert kernels.COPIES["copy2d"] == before + 1
    assert any(s is view for _, s in kernels._IN_FLIGHT)  # held until the stream passes the copy
    want = view.contiguous().to(dev)
    torch.cuda.synchronize(dev)
    assert torch.equal(dst, want)
    pitched = torch.zeros((rows, w + 40), dtype=torch.uint8, device=dev)  # a pitched destination
    kernels.copy2d(pitched[:, 7 : 7 + w], view)
    torch.cuda.synchronize(dev)
    assert torch.equal(pitched[:, 7 : 7 + w], want) and not pitched[:, :7].any() and not pitched[:, 7 + w :].any()
    with pytest.raises(ValueError):  # pageable memory is refused, not staged
        kernels.copy2d(dst, view.contiguous().clone()[:, :w])


@pytest.mark.cuda
def test_cuda_sliced_default_equals_one_lane(monkeypatch):
    """The sliced default at K = 1000, Z = 16 against an explicit 1-lane mesh:
    the same repair symbols bit for bit, a pitched copy per slice, 17 K1
    launches per slice."""
    dev = _card()
    K, T, Z, S = 1000, 1280, 16, 4
    data = np.random.default_rng(16).integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=8, Z=Z, device=dev)
    batch = tbatch.load_object(enc, MemoryIO(data))
    one = tbatch.repair_symbols(batch, 200, dev, mesh=tmesh.make_mesh([dev]))
    monkeypatch.setattr(tmesh, "slice_count", lambda t, block, live: S)
    for _ in range(3):  # eager, capture, replay
        batch.C = None
        copies, k1 = kernels.COPIES["copy2d"], kernels.LAUNCHES["gather_xor"]
        tbatch.generate(batch, dev)
        got = tbatch.repair_symbols(batch, 200, dev)
        assert kernels.COPIES["copy2d"] - copies == S and kernels.LAUNCHES["gather_xor"] - k1 == 17 * S
        assert isinstance(batch.C, tmesh.Sharded) and batch.C.mesh is tmesh.slice_mesh(dev, S)
        assert all(np.array_equal(got[b], one[b]) for b in range(Z))
    assert not batch.C.mesh.take_index_errors()


_UPLOAD_PROFILE = """
import json
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from nanorq_tpu_torch.ops import kernels
from nanorq_tpu_torch.parallel import mesh as tmesh

def no_stage(*args, **kw):
    raise AssertionError("a pinned column range went through staging")

dev = torch.device("cuda", 0)
D = tmesh.host_matrix(1000, 1024, 8 * 1280, dev)
D[:] = np.random.default_rng(3).integers(0, 256, D.shape, dtype=np.uint8)
mesh = tmesh.slice_mesh(dev, 2)
tmesh.stage = no_stage
tmesh.shard_width(D, mesh, block=1280, live_rows=1000, rows=1024)  # warm
mesh.synchronize()
before = kernels.COPIES["copy2d"]
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    Dsh = tmesh.shard_width(D, mesh, block=1280, live_rows=1000, rows=1024)
    mesh.synchronize()
want = np.concatenate([D, np.zeros((24, D.shape[1]), np.uint8)])
print(json.dumps({"copies": kernels.COPIES["copy2d"] - before, "equal": bool(np.array_equal(Dsh.host(), want)),
                  "keys": [e.key for e in prof.key_averages()]}))
"""


@pytest.mark.cuda
def test_cuda_column_range_upload_copies_nothing_pageable():
    """Two lanes' column ranges of a pinned object, each by one pitched copy,
    none staged, and no profiled copy from pageable memory.  The profile runs
    in a fresh process: late in a long one (a whole test session) torch.profiler
    has been seen to record the runtime calls of a lane's copies but none of
    their device activity."""
    import json
    import pathlib
    import subprocess
    import sys

    _card()
    repo = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", _UPLOAD_PROFILE], cwd=repo, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    copies = [k for k in got["keys"] if k.startswith("Memcpy HtoD")]
    assert got["copies"] == 2 and got["equal"]  # a pitched copy a lane
    assert copies and not [k for k in copies if "Pageable" in k], got["keys"]
