"""CLI decoder of the port: data.rq -> output file.

    python -m nanorq_tpu_torch.cli.decode OUT -i data.rq [--device cuda]

The counterpart of `nanorq_tpu.cli.decode`: the same flags and stream, the
port's Decoder on `--device` (default cuda, which raises when torch sees no
card).  Blocks are repaired by `repair_all` with the default backend (env
NANORQ_DECODE_BACKEND, else "auto"); `--layout-cache` forces the device arm,
since the persisted decode layouts exist only for device plans.  `--mesh
auto` is not ported yet.
"""

import argparse
import os
import struct
import sys

from nanorq_tpu_torch.codec.api import _NO_MESH, SYM_ERR, Decoder
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.io.ioctx import FileIO
from nanorq_tpu_torch.precode.device_schedule import load_layout_cache, save_layout_cache


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nanorq-torch-decode")
    ap.add_argument("filename", help="output file to reconstruct into")
    ap.add_argument("-i", "--input", default="data.rq")
    ap.add_argument("--layout-cache", default=None, metavar="DIR",
                    help="persist the per-K' frozen decode layouts across invocations "
                    "(forces the device arm)")
    ap.add_argument("--mesh", choices=("auto", "off"), default="off",
                    help="'auto' (several GPUs) is not ported yet and raises")
    ap.add_argument("--device", default="cuda", help="torch device of the payload math")
    args = ap.parse_args(argv)
    if args.mesh == "auto":
        raise NotImplementedError(_NO_MESH)
    dev = resolve(args.device)

    lay_path = None
    if args.layout_cache:
        os.makedirs(args.layout_cache, exist_ok=True)
        lay_path = os.path.join(args.layout_cache, "decode_layouts.bin")
        if os.path.exists(lay_path):
            n = load_layout_cache(lay_path)
            print(f"loaded {n} frozen decode layout(s) from {lay_path}", file=sys.stderr)

    with open(args.input, "rb") as ih:
        oti_common, oti_scheme = struct.unpack("<QI", ih.read(12))
        dec = Decoder(oti_common, oti_scheme, device=dev)
        T = dec.symbol_size
        with FileIO(args.filename, write=True, create_size=dec.transfer_length) as io:
            while True:
                hdr = ih.read(4)
                if len(hdr) < 4:
                    break
                (tag,) = struct.unpack("<I", hdr)
                packet = ih.read(T)
                if dec.add_symbol(packet, tag, io) == SYM_ERR:
                    print(f"adding symbol {tag} failed.", file=sys.stderr)
                    return 1
            for sbn in range(dec.num_blocks):
                print(f"block {sbn} is {dec.block_symbols(sbn)} packets, "
                      f"lost {dec.num_missing(sbn)}, have {dec.num_repair(sbn)} repair")
            ok = dec.repair_all(io, backend="device" if lay_path is not None else None)
            if not ok:
                for sbn in range(dec.num_blocks):
                    if dec.num_missing(sbn):
                        print(f"decode of sbn {sbn} failed.", file=sys.stderr)
            for sbn in range(dec.num_blocks):
                dec.cleanup(sbn)
    if lay_path is not None:
        save_layout_cache(lay_path)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
