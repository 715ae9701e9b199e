"""The main path's encode, device decode, lanes and CLI, timed with the device
memory each holds, so that two checkouts can be compared in one call.

At chip_smoke's sizes by default (K=1000, T=1280, an object of Z=200
blocks, K // 5 repair symbols a block, 6% loss + 5% overhead, an 8 MiB file
for the CLI), one JSON line per step, each with the card's name and power
limit:

- encode (chip_smoke phase 3): `codec.batch.generate` + `repair_symbols` of
  the object, `--encodes` times in a row, host clock with a wait after each
  (`s`: cold, second, then warm), and the width slices the default path
  took (`slices`);
- decode (phase 4): `repair_all(backend="device")` of the object, cold (the
  plans cleared) then warm, host clock;
- lanes (phase 10): the encode over 4 lanes of the card(s), 4 rounds;
- cli (phase 8): `cli.encode` then `cli.decode` of the file, in this process
  (the kernels loaded), `--cli` times.

Each step's line has `allocated_GiB` (`torch.cuda.memory_allocated` after the
step) and `peak_GiB` (`max_memory_allocated` over it), and `programs_MB`, the
bytes the replay's program cache holds after it (null where the package has
no program layer); on `--device cpu` (a rehearsal at a tiny size, host clock)
the three are null.  To compare an older checkout, unpack it into a gitignored
directory and run this file on it, in turn with this tree:

    PYTHONPATH=_parent python nanorq_tpu_torch/tools/main_path_ab.py --tag parent
    python -m nanorq_tpu_torch.tools.main_path_ab --tag change
"""

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

SEED = 20240617


def _programs_mb():
    try:
        from nanorq_tpu_torch.ops import program
    except ImportError:  # a package from before the program layer
        return None
    return round(program.cached_bytes() / 2**20, 1)


def _slices(dev, t: int, T: int, K: int) -> int:
    """The width slices the default path cuts the object into (1 for a
    package from before it had them)."""
    from nanorq_tpu_torch.parallel import mesh as lanes

    return lanes.default_mesh(dev, t, T, K).size if hasattr(lanes, "default_mesh") else 1


def _sync() -> None:
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        torch.cuda.synchronize(i)


def _step(name: str, fn, fields: dict, dev: torch.device) -> dict:
    """fn() -> {key: value}, between a reset of the peak and the memory read."""
    card = dev.type == "cuda"
    _sync()
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    line = {"tool": "main_path_ab", "step": name, **fn()}
    _sync()
    line.update(allocated_GiB=round(torch.cuda.memory_allocated(dev) / 2**30, 3) if card else None,
                peak_GiB=round(torch.cuda.max_memory_allocated(dev) / 2**30, 3) if card else None,
                programs_MB=_programs_mb() if card else None, **fields)
    print(json.dumps(line), flush=True)
    return line


def _walls(fn, n: int) -> list:
    out = []
    for _ in range(n):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        out.append(round(time.perf_counter() - t0, 5))
    return out


def _deliveries(rng, K: int, Z: int) -> list:
    """Per block (received source ESIs, received repair ESIs) at 6% loss + 5% overhead."""
    from nanorq_tpu_torch import bench

    out = []
    for _ in range(Z):
        gaps, nrep = bench.loss_pattern(rng, K)
        out.append((np.setdiff1d(np.arange(K), gaps), np.arange(K, K + nrep)))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a name for this checkout, copied into every line")
    ap.add_argument("--encodes", type=int, default=8)
    ap.add_argument("--cli", type=int, default=2)
    ap.add_argument("--K", type=int, default=1000)
    ap.add_argument("--T", type=int, default=1280)
    ap.add_argument("--Z", type=int, default=200)
    ap.add_argument("--cli-bytes", type=int, default=8 << 20)
    ap.add_argument("--device", default="cuda", help="cuda (timed on the card) or cpu (a rehearsal, host clock)")
    args = ap.parse_args(argv)
    K, T, Z = args.K, args.T, args.Z
    from nanorq_tpu_torch import bench
    from nanorq_tpu_torch.cli import decode as cli_decode
    from nanorq_tpu_torch.cli import encode as cli_encode
    from nanorq_tpu_torch.codec import batch as tbatch
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.codec.api import Decoder, Encoder
    from nanorq_tpu_torch.device import resolve
    from nanorq_tpu_torch.host import MemoryIO, make_tag

    dev = resolve(args.device)
    fields = {"tag": args.tag, **bench.device_fields(dev)}
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 256, Z * K * T, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=8, Z=Z, device=dev)
    batch = tbatch.load_object(enc, MemoryIO(data))
    reps = {}

    def encode(mesh=None):
        batch.C = None
        tbatch.generate(batch, dev, mesh=mesh)
        reps.update(tbatch.repair_symbols(batch, K // 5, dev, mesh=mesh))

    lines = [_step("encode", lambda: {"s": _walls(encode, args.encodes), "slices": _slices(dev, Z * T, T, K)},
                   fields, dev)]
    batch.C = None

    deliveries = _deliveries(np.random.default_rng(SEED + 1), K, Z)
    payloads = data.reshape(Z * K, T)

    def decode():
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
        out = np.zeros(data.size, np.uint8)
        io = MemoryIO(out)
        for sbn, (keep, rep_esis) in enumerate(deliveries):
            dec.add_symbols(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
            dec.add_symbols(reps[sbn][: rep_esis.size], [make_tag(sbn, int(e)) for e in rep_esis], io)
        _sync()
        t0 = time.perf_counter()
        if not dec.repair_all(io, backend="device"):
            raise AssertionError("repair_all reported unrecovered blocks")
        _sync()
        if not np.array_equal(out, data):
            raise AssertionError("the decode did not restore the object")
        return round(time.perf_counter() - t0, 5)

    tcache.clear_decoder_cache()
    lines.append(_step("decode", lambda: {"s": [decode(), decode()]}, fields, dev))

    mesh = bench.lanes_mesh(4, dev)
    lines.append(_step("lanes4", lambda: {"s": _walls(lambda: encode(mesh), 4)}, fields, dev))
    batch.C = None
    del batch

    def cli():
        secs = {"encode": [], "decode": []}
        blob = np.random.default_rng(SEED + 2).integers(0, 256, args.cli_bytes, dtype=np.uint8).tobytes()
        with tempfile.TemporaryDirectory() as d:
            src = os.path.join(d, "in.bin")
            with open(src, "wb") as f:
                f.write(blob)
            for i in range(args.cli):
                rq, out = os.path.join(d, f"data{i}.rq"), os.path.join(d, f"out{i}.bin")
                for name, fn, argv in (("encode", cli_encode.main, [src, str(T), "-o", rq, "--seed", str(SEED),
                                                                    "--device", args.device]),
                                       ("decode", cli_decode.main, [out, "-i", rq, "--device", args.device])):
                    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
                        t0 = time.perf_counter()
                        rc = fn(argv)
                        secs[name].append(round(time.perf_counter() - t0, 5))
                    if rc != 0:
                        raise AssertionError(f"cli {name} exited {rc}")
                with open(out, "rb") as f:
                    if f.read() != blob:
                        raise AssertionError("the cli decode did not restore the file")
        return {f"{k}_s": v for k, v in secs.items()}

    lines.append(_step("cli", cli, fields, dev))
    return lines


if __name__ == "__main__":
    main()
