"""CLI encoder of the port: file -> data.rq packet stream.

    python -m nanorq_tpu_torch.cli.encode FILE 1280 [--device cuda]

The counterpart of `nanorq_tpu.cli.encode`, with the same wire format
(little-endian u64 oti_common, u32 oti_scheme, then (u32 tag, T-byte payload)
records), the same flags and the same `random.Random(seed)` drop simulation,
so one seed gives the same stream from either package.  The object encodes
through `nanorq_tpu_torch.codec.batch` on `--device` (default cuda, which
raises when torch sees no card).  `--mesh auto` is not ported yet.
"""

import argparse
import random
import struct
import sys

from nanorq_tpu_torch.codec.api import _NO_MESH, Encoder
from nanorq_tpu_torch.codec.batch import generate, load_object, repair_symbols, source_symbol
from nanorq_tpu_torch.codec.cache import warm_encoder_cache
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.io.ioctx import FileIO


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nanorq-torch-encode")
    ap.add_argument("filename")
    ap.add_argument("packet_size", type=int)
    ap.add_argument("-o", "--output", default="data.rq")
    ap.add_argument("--loss", type=float, default=6.0, help="simulated drop %%")
    ap.add_argument("--overhead", type=int, default=5, help="extra repair per block")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--schedule-cache", default=None, metavar="DIR",
                    help="persist the per-K' encoder schedule to disk (a warm start skips "
                    "the schedule solve)")
    ap.add_argument("--mesh", choices=("auto", "off"), default="off",
                    help="'auto' (several GPUs) is not ported yet and raises")
    ap.add_argument("--device", default="cuda", help="torch device of the payload math")
    args = ap.parse_args(argv)
    if args.mesh == "auto":
        raise NotImplementedError(_NO_MESH)
    dev = resolve(args.device)

    rng = random.Random(args.seed)
    with FileIO(args.filename) as io:
        enc = Encoder(io.size(), args.packet_size, Al=8, device=dev)
        if args.schedule_cache:
            warm_encoder_cache(enc.P.Kp, args.schedule_cache)
        batch = load_object(enc, io)
        generate(batch, dev)
        drops = []
        for sbn in range(enc.num_blocks):
            num_esi = enc.block_symbols(sbn)
            kept = [e for e in range(num_esi) if rng.random() * 100.0 >= args.loss]
            drops.append((kept, num_esi - len(kept)))
        max_rep = max(d for _, d in drops) + args.overhead if drops else 0
        rep = repair_symbols(batch, max_rep, dev) if max_rep else {}
        with open(args.output, "wb") as oh:
            oh.write(struct.pack("<QI", enc.oti_common(), enc.oti_scheme_specific()))
            for b, sbn in enumerate(batch.sbns):
                num_esi = enc.block_symbols(sbn)
                kept, dropped = drops[b]
                for esi in kept:
                    oh.write(struct.pack("<I", make_tag(sbn, esi)))
                    oh.write(source_symbol(batch, b, esi).tobytes())
                n_rep = dropped + args.overhead
                for ri in range(n_rep):
                    oh.write(struct.pack("<I", make_tag(sbn, num_esi + ri)))
                    oh.write(rep[b][ri].tobytes())
                print(f"block {sbn} is {num_esi} packets, dropped {dropped}, created {n_rep} repair")
    return 0


if __name__ == "__main__":
    sys.exit(main())
