"""The port's CLI (nanorq_tpu_torch.cli) against nanorq_tpu.cli: the same stream
for the same seed, each decoder restoring the other's stream, and the flags
that persist caches or pick the mesh and the device."""

import numpy as np
import pytest
import torch

from nanorq_tpu.cli.decode import main as jdecode
from nanorq_tpu.cli.encode import main as jencode
from nanorq_tpu_torch.cli.decode import main as tdecode
from nanorq_tpu_torch.cli.encode import main as tencode


@pytest.fixture
def src(tmp_path):
    """Random bytes plus text, not a multiple of the packet size."""
    rng = np.random.default_rng(42)
    p = tmp_path / "input.bin"
    p.write_bytes(bytes(rng.integers(0, 256, 20_001, dtype=np.uint8)) + b"war and peace " * 300)
    return p


@pytest.mark.parametrize("T,seed,loss", [(1280, 7, "6"), (256, 3, "20")])
def test_stream_equals_jax_and_decoders_swap(src, tmp_path, T, seed, loss):
    jrq, trq = tmp_path / "j.rq", tmp_path / "t.rq"
    common = [str(src), str(T), "--seed", str(seed), "--loss", loss]
    assert jencode(common + ["-o", str(jrq)]) == 0
    assert tencode(common + ["-o", str(trq), "--device", "cpu"]) == 0
    assert trq.read_bytes() == jrq.read_bytes()
    assert tdecode([str(tmp_path / "t_of_j.bin"), "-i", str(jrq), "--device", "cpu"]) == 0
    assert jdecode([str(tmp_path / "j_of_t.bin"), "-i", str(trq)]) == 0
    for out in ("t_of_j.bin", "j_of_t.bin"):
        assert (tmp_path / out).read_bytes() == src.read_bytes()


def test_layout_and_schedule_caches(src, tmp_path, monkeypatch):
    """--schedule-cache writes the encoder schedule; --layout-cache forces the
    device arm and saves the frozen layouts of its structured plans."""
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.precode import device_schedule as dsm

    monkeypatch.setattr(tcache, "WPATH_MAX_KP", 0)
    monkeypatch.setattr(tcache, "WPATH_GF256_MAX_KP", 0)
    tcache.clear_decoder_cache()
    dsm.clear_layout_cache()
    rq, sched, lay = tmp_path / "data.rq", tmp_path / "sched", tmp_path / "lay"
    assert tencode([str(src), "512", "-o", str(rq), "--seed", "5", "--schedule-cache", str(sched),
                    "--device", "cpu"]) == 0
    assert any(p.suffix == ".sched" for p in sched.iterdir())
    for run in range(2):
        out = tmp_path / f"out{run}.bin"
        assert tdecode([str(out), "-i", str(rq), "--layout-cache", str(lay), "--device", "cpu"]) == 0
        assert out.read_bytes() == src.read_bytes()
        assert (lay / "decode_layouts.bin").exists()


def test_unported_and_missing_device(src, tmp_path):
    """`--mesh auto` on `--device cpu` has one device and nothing to split: it
    encodes and decodes byte for byte, as `off` does.  The default device is
    the card: with none, the CLI raises, with or without a mesh."""
    rq, rq_off = tmp_path / "data.rq", tmp_path / "off.rq"
    common = [str(src), "256", "--seed", "9", "--device", "cpu"]
    assert tencode(common + ["-o", str(rq), "--mesh", "auto"]) == 0
    assert tencode(common + ["-o", str(rq_off)]) == 0
    assert rq.read_bytes() == rq_off.read_bytes()
    assert tdecode([str(tmp_path / "o.bin"), "-i", str(rq), "--mesh", "auto", "--device", "cpu"]) == 0
    assert (tmp_path / "o.bin").read_bytes() == src.read_bytes()
    if not torch.cuda.is_available():  # the default device is the card: no silent CPU
        for mesh in ([], ["--mesh", "auto"]):
            with pytest.raises(RuntimeError):
                tencode([str(src), "256", "-o", str(rq)] + mesh)
            with pytest.raises(RuntimeError):
                tdecode([str(tmp_path / "o2.bin"), "-i", str(rq_off)] + mesh)
