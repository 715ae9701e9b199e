"""The port against the golden regression corpus (tests/golden/), the
counterpart of tests/test_golden.py:

  1. every committed `.rq` stream, fed symbol by symbol to the port's
     Decoder and repaired through each backend, reconstructs the payload
     whose SHA-256 the manifest pins;
  2. the port's Encoder regenerates each config of tools/gen_golden.py to
     the pinned repair-payload and stream hashes.

Byte equality (the codec is exact GF(2)/GF(256) arithmetic).  On the CPU the
kernels' plain versions run; the `cuda` twins run the same on the card.  The
interop cases need the reference C tree and skip where it is absent, as
tests/test_interop.py does.
"""

import hashlib
import json
import os
import random
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import BACKENDS, SYM_ERR, Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.native import native_available

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
sys.path.insert(0, os.path.join(HERE, "..", "tools"))

import gen_golden  # noqa: E402  (the configs and the stream layout; forces JAX onto the CPU)
from test_interop import ref_bins  # noqa: E402,F401  (the reference binaries, or a skip)

with open(os.path.join(GOLDEN, "manifest.json")) as f:
    MANIFEST = json.load(f)
NAMES = sorted(k for k in MANIFEST if not k.startswith("_"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


def _decode(name: str, backend: str, device) -> None:
    meta = MANIFEST[name]
    with open(os.path.join(GOLDEN, name + ".rq"), "rb") as f:
        blob = f.read()
    assert hashlib.sha256(blob).hexdigest() == meta["sha256_rq"], "corpus file changed"
    oti_common, oti_scheme = struct.unpack_from("<QI", blob, 0)
    dec = Decoder(oti_common, oti_scheme, device=device)
    T = dec.symbol_size
    out = np.zeros(dec.transfer_length, np.uint8)
    io = MemoryIO(out)
    for off in range(12, len(blob), 4 + T):
        (tag,) = struct.unpack_from("<I", blob, off)
        assert dec.add_symbol(blob[off + 4 : off + 4 + T], tag, io) != SYM_ERR
    tcache.clear_decoder_cache()  # every pattern cold: "auto" routes as a first decode does
    assert dec.repair_all(io, backend=backend)
    assert hashlib.sha256(out.tobytes()).hexdigest() == meta["sha256_data"]


def _backends():
    """The residual arms need the native factorization; every K of the
    corpus (1 to 400) is within every arm's range."""
    return [b for b in BACKENDS if native_available() or b in ("auto", "device")]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", NAMES)
def test_torch_golden_decode(name, backend):
    if backend not in _backends():
        pytest.skip("the native solver did not build: no host or residual arm")
    _decode(name, backend, "cpu")


def gen_one_port(device, name, F, T, Al, Z, loss, overhead, seed):
    """tools/gen_golden.gen_one through the port: the same payload, loss
    pattern and stream layout (u64 oti_common, u32 oti_scheme, (u32 tag, T)*)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=Al, Z=Z, device=device)
    batch = tbatch.load_object(enc, MemoryIO(data))
    tbatch.generate(batch, device)
    pr = random.Random(seed)
    drops = []
    for sbn in range(enc.num_blocks):
        num_esi = enc.block_symbols(sbn)
        kept = [e for e in range(num_esi) if pr.random() * 100.0 >= loss]
        drops.append((kept, num_esi - len(kept)))
    rep = tbatch.repair_symbols(batch, max(d for _, d in drops) + overhead, device)
    rq = bytearray(struct.pack("<QI", enc.oti_common(), enc.oti_scheme_specific()))
    rep_sha = hashlib.sha256()
    for b, sbn in enumerate(batch.sbns):
        num_esi = enc.block_symbols(sbn)
        kept, dropped = drops[b]
        for esi in kept:
            rq += struct.pack("<I", make_tag(sbn, esi)) + tbatch.source_symbol(batch, b, esi).tobytes()
        for ri in range(dropped + overhead):
            payload = rep[b][ri].tobytes()
            rq += struct.pack("<I", make_tag(sbn, num_esi + ri)) + payload
            rep_sha.update(payload)
    return bytes(rq), {"sha256_rq": hashlib.sha256(bytes(rq)).hexdigest(), "sha256_repair": rep_sha.hexdigest(),
                       "sha256_data": hashlib.sha256(data.tobytes()).hexdigest()}


def _reencode(name: str, device) -> None:
    cfg = next(c for c in gen_golden.CONFIGS if c[0] == name)
    _rq, got = gen_one_port(device, *cfg)
    for key in ("sha256_data", "sha256_repair", "sha256_rq"):
        assert got[key] == MANIFEST[name][key], f"{key} changed: the port's encoder output differs"


@pytest.mark.parametrize("name", NAMES)
def test_torch_golden_reencode(name):
    _reencode(name, "cpu")


def test_torch_golden_covers_the_corpus():
    """The manifest, the committed streams and gen_golden's configs name the
    same ten entries."""
    assert len(NAMES) == 10 and NAMES == sorted(c[0] for c in gen_golden.CONFIGS)
    assert NAMES == sorted(f[:-3] for f in os.listdir(GOLDEN) if f.endswith(".rq"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_torch_golden_decode_on_card(name):
    dev = _card()
    for backend in _backends():
        _decode(name, backend, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_torch_golden_reencode_on_card(name):
    _reencode(name, _card())


def _port_cli(mod, args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    r = subprocess.run([sys.executable, "-m", f"nanorq_tpu_torch.cli.{mod}", *args, "--device", "cpu"],
                       capture_output=True, text=True, cwd=cwd, env=env, timeout=600)
    assert r.returncode == 0, f"the port's {mod} failed: {r.stderr[-800:]}"


def test_torch_reference_encode_port_decode(ref_bins, tmp_path):  # noqa: F811
    """A stream written by the reference `encode` binary reconstructs
    bit-exact through the port's decoder."""
    data = np.random.default_rng(42).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    (tmp_path / "input.bin").write_bytes(data)
    r = subprocess.run([ref_bins["encode"], "input.bin", "1280"], capture_output=True, cwd=tmp_path, timeout=300)
    assert r.returncode == 0 and (tmp_path / "data.rq").exists()
    _port_cli("decode", ["out.bin", "-i", "data.rq"], tmp_path)
    assert (tmp_path / "out.bin").read_bytes() == data


def test_torch_port_encode_reference_decode(ref_bins, tmp_path):  # noqa: F811
    """The port's stream (with simulated loss + overhead) reconstructs
    bit-exact through the reference `decode` binary."""
    data = np.random.default_rng(43).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    (tmp_path / "input.bin").write_bytes(data)
    _port_cli("encode", ["input.bin", "1280", "-o", "data.rq", "--loss", "6", "--overhead", "5", "--seed", "11"],
              tmp_path)
    r = subprocess.run([ref_bins["decode"], "out.bin"], capture_output=True, cwd=tmp_path, timeout=300)
    assert r.returncode == 0 and b"failed" not in r.stdout, r.stdout[-500:]
    assert (tmp_path / "out.bin").read_bytes() == data
