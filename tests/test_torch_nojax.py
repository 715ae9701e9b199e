"""The port runs without JAX and without the JAX package `nanorq_tpu`, and
never falls back from the CUDA kernels.

The test process itself has JAX loaded (tests/conftest.py), so the no-JAX
run happens in a fresh interpreter."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import pathlib
import sys
import tempfile
import numpy as np
from nanorq_tpu_torch import bench, entry
from nanorq_tpu_torch.cli import decode as cli_decode, encode as cli_encode
from nanorq_tpu_torch.codec import batch
from nanorq_tpu_torch.codec import cache
from nanorq_tpu_torch.codec.api import Decoder, Encoder
from nanorq_tpu_torch.host import MemoryIO, make_tag, native_available
from nanorq_tpu_torch.tools import gather_probe

K, T, Z = 100, 32, 2
rng = np.random.default_rng(0)
data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
enc = Encoder(data.size, T, Al=8, Z=Z, device="cpu")
reps = batch.repair_symbols(batch.load_object(enc, MemoryIO(data)), 20, "cpu")
losses = []
for sbn in range(Z):
    gaps = np.nonzero(rng.random(K) < 0.06)[0]
    losses.append((np.setdiff1d(np.arange(K), gaps), np.arange(K, K + gaps.size + 5)))
# every arm, the residual ones (canonical w-rows) first and on cold memos
backends = ["res", "res_host", "auto", "device"] if native_available() else ["device"]
for backend in backends:
    cache.clear_decoder_cache()
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    for sbn, (keep, rep) in enumerate(losses):
        dec.add_symbols(data.reshape(Z * K, T)[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(reps[sbn][: rep.size], [make_tag(sbn, int(e)) for e in rep], io)
    assert dec.repair_all(io, backend=backend), backend
    assert np.array_equal(out, data), backend
# the same object over a mesh of CPU lanes: parallel/ too runs without JAX
from nanorq_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh(["cpu"] * 3)
mreps = batch.repair_symbols(batch.load_object(enc, MemoryIO(data)), 20, "cpu", mesh=mesh)
assert all(np.array_equal(mreps[b], reps[b]) for b in range(Z))
dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")
out = np.zeros(data.size, np.uint8)
io = MemoryIO(out)
for sbn, (keep, rep) in enumerate(losses):
    dec.add_symbols(data.reshape(Z * K, T)[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
    dec.add_symbols(mreps[sbn][: rep.size], [make_tag(sbn, int(e)) for e in rep], io)
assert dec.repair_all(io, mesh=mesh) and np.array_equal(out, data)
entry.dryrun_multichip(2, "cpu")
fn, args = entry.entry("cpu")
assert fn(*args).shape[0] >= 1002
from nanorq_tpu_torch.ops import program, replay
assert program.replay(args[0], args[2]).equal(replay.replay(args[0], args[2]))
with tempfile.TemporaryDirectory() as d:
    src, rq, dst = (pathlib.Path(d) / f for f in ("in.bin", "data.rq", "out.bin"))
    src.write_bytes(data[:5000].tobytes())
    assert cli_encode.main([str(src), "256", "-o", str(rq), "--seed", "1", "--device", "cpu"]) == 0
    assert cli_decode.main([str(dst), "-i", str(rq), "--device", "cpu"]) == 0
    assert dst.read_bytes() == src.read_bytes()
assert gather_probe.run_shape("v2", (301, 37, 5, 64, 0.3, "tiny"), rng, "cpu")["exact"]
assert bench.main(["--device", "cpu", "--ks", "10", "--T", "16", "--iters", "1", "--blocks", "2", "--arms"]) == 0
# the retuning sweeps, each at a tiny point
from nanorq_tpu_torch.tools import bsweep, cb_probe, replay_stage_prof, slotfill_probe, wb_probe
tiny = ["--T", "16", "--device", "cpu"]
assert all(ln["C_equal"] for ln in cb_probe.main(["100", "64", "128", "--blocks", "1", "--iters", "1", *tiny]))
assert slotfill_probe.main(["300"]) and bsweep.main(["100", "1", "--iters", "1", *tiny])
assert all(ln["exact"] for ln in wb_probe.main(["300", "--bs", "1", "--iters", "1", *tiny]))
assert replay_stage_prof.main(["100", "1", "1", *tiny])
# the soak, one ASan round trip and the host-arm profiler, each at a tiny point
from nanorq_tpu_torch.tools import asan_drive, hostarm_prof, longfuzz
assert longfuzz.run_trial(7000104, "cpu")["seed"] == 7000104
if native_available():
    assert asan_drive.drive(100, 64, 3, 0.08, 1, "host")["backend"] == "host" and asan_drive.no_jax()
    assert len(hostarm_prof.main(["30", "--blocks", "2", "--iters", "1", *tiny])) == 3
print("jax" in sys.modules, sorted(m for m in sys.modules if m.split(".")[0] == "nanorq_tpu"))
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False []"


def _imports(path: pathlib.Path) -> set[str]:
    """Every module a file imports, at any depth of its code."""
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _jax_package(mod: str) -> bool:
    return mod.split(".")[0] in ("jax", "jaxlib", "nanorq_tpu")


def test_no_module_of_the_port_imports_jax():
    for path in (REPO / "nanorq_tpu_torch").rglob("*.py"):
        for mod in _imports(path):
            assert not _jax_package(mod), f"{path}: {mod}"


@pytest.mark.parametrize("where", ["nanorq_tpu_torch", "chip_smoke.py"])
def test_ast_scan_finds_no_import_of_the_jax_package(where):
    """No file of the port (its bench among them), nor chip_smoke.py, imports
    nanorq_tpu or a module of it (the port keeps its own copy of the host
    half), at any depth."""
    root = REPO / where
    paths = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert paths and (not root.is_dir() or root / "bench.py" in paths)
    bad = [(p.relative_to(REPO), m) for p in paths for m in _imports(p) if m.split(".")[0] == "nanorq_tpu"]
    assert not bad


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the codec through nanorq_tpu_torch alone, and
    importing all it imports, and every module of the port, loads no JAX."""
    mods = _imports(REPO / "chip_smoke.py")
    for mod in mods:
        assert not _jax_package(mod), f"chip_smoke.py imports {mod}"
    port = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in (REPO / "nanorq_tpu_torch").rglob("*.py"))
    script = "\n".join(["import importlib, sys",
                        f"for m in {sorted(mods) + port + ['chip_smoke']!r}:",
                        "    importlib.import_module(m.removesuffix('.__init__'))",
                        "print('jax' in sys.modules, sorted(m for m in sys.modules if m.split('.')[0] == 'nanorq_tpu'))"])
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False []"


def test_kernels_raise_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc to be found, asking for the kernels raises; nothing falls
    back to the plain versions."""
    import shutil

    from nanorq_tpu_torch.ops import _build

    if shutil.which("nvcc") or os.path.isfile(os.path.join(_build.DEFAULT_CUDA_HOME, "bin", "nvcc")):
        monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    if not torch.cuda.is_available():
        from nanorq_tpu_torch.device import resolve

        with pytest.raises(RuntimeError):
            resolve("cuda")
