"""The port's native runtime under AddressSanitizer (counterpart of
`tools/asan_drive.py`, `make asan-native`).

    make asan-torch
    # which runs:
    NANORQ_NATIVE_SANITIZE=address,undefined LD_PRELOAD=$(gcc -print-file-name=libasan.so) \\
        ASAN_OPTIONS=detect_leaks=0 python -m nanorq_tpu_torch.tools.asan_drive

It drives every raw-pointer path of the port's native copy
(`nanorq_tpu_torch/native/solver.cc`, built sanitized into
`native/_build/san-address-undefined/`): the solve and schedule export, and
the host arms' reads and writes through `Decoder._row_ptrs` /
`_out_row_ptrs` (`codec/api.py`): `host` at K = 100, 500 and 1000 and
`res_host` at K = 100 and 200, as `tools/asan_drive.py` does.  The payload
math of the encode is numpy (`precode.solver.solve_encoder`,
`precode.schedule.replay_numpy`, `rfc.tuples.lt_indices`), and the decoder
is the port's, on the CPU.  Then one round trip whose ingestion matrices are
pinned (`parallel.mesh.host_matrix` of a card, placed under each block
before its symbols arrive): the native arm reads its rows out of pinned
memory.  That case needs CUDA to initialize under the preloaded ASan,
which a child process tries first (on an H100 host it needs
`ASAN_OPTIONS=detect_leaks=0:protect_shadow_gap=0`); where it does not, the
script says why and the CPU cases stand.  The JAX package's script must not
create an XLA client under the preload; this one imports torch, which
survives it, and asserts that no JAX and no module of the JAX package is
loaded.

The last line is one JSON object: the cases run, the card case's outcome
and the sanitizer setting.  `make ubsan-torch` runs the port's native,
residual and codec tests under UBSan (`NANORQ_NATIVE_SANITIZE=undefined`).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

# K, T, Z, loss, seed, backend: the five round trips of tools/asan_drive.py
CASES = ((100, 64, 3, 0.08, 1, "host"), (500, 96, 2, 0.06, 2, "host"), (1000, 128, 1, 0.06, 3, "host"),
         (100, 64, 3, 0.08, 4, "res_host"), (200, 48, 2, 0.10, 5, "res_host"))
PINNED = (200, 64, 2, 0.08, 6, "host")  # the round trip over pinned ingestion matrices


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def no_jax() -> bool:
    """True while neither JAX nor a module of the JAX package `nanorq_tpu` is loaded."""
    return not any(m.split(".")[0] in ("jax", "jaxlib", "nanorq_tpu") for m in sys.modules)


def drive(K: int, T: int, Z: int, loss: float, seed: int, backend: str, pinned: bool = False) -> dict:
    """One object of Z blocks of K symbols, encoded with numpy, decoded by
    the port's Decoder (on the CPU; with `pinned`, each block's ingestion
    matrix is a card's pinned `host_matrix`) through `backend`."""
    from nanorq_tpu_torch.codec.api import Decoder, Encoder
    from nanorq_tpu_torch.codec.oti import make_tag
    from nanorq_tpu_torch.io.ioctx import MemoryIO
    from nanorq_tpu_torch.parallel.mesh import host_matrix
    from nanorq_tpu_torch.precode.schedule import replay_numpy
    from nanorq_tpu_torch.precode.solver import solve_encoder
    from nanorq_tpu_torch.rfc.params import params_init
    from nanorq_tpu_torch.rfc.tuples import lt_indices

    rng = np.random.default_rng(seed)
    F = K * T * Z
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=1, Z=Z, device="cpu")
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")
    out = np.zeros(F, np.uint8)
    io = MemoryIO(out)
    for sbn in range(dec.num_blocks):
        Kb = dec.block_symbols(sbn)
        src = data[sbn * K * T : (sbn + 1) * K * T].reshape(Kb, T)
        P = params_init(Kb)
        S = solve_encoder(P)  # the numpy encode: the encoder schedule's op tape replayed on the host
        check(S is not None, f"encoder solve failed K={Kb}")
        D = np.zeros((S.n_rows, T), np.uint8)
        D[:Kb] = src
        C = replay_numpy(D, S)
        gaps = np.nonzero(rng.random(Kb) < loss)[0]
        nrep = gaps.size + 3
        rep_isis = (np.arange(Kb, Kb + nrep) + (P.Kp - Kb)).astype(np.uint32)
        idx, valid = lt_indices(rep_isis, P)
        rep = np.zeros((nrep, T), np.uint8)
        for r in range(nrep):
            for c in idx[r][valid[r]]:
                rep[r] ^= C[c]
        if pinned:
            rows = dec._d_rows()
            dec._block(sbn).D = host_matrix(rows, rows, T, "cuda")
        keep = np.setdiff1d(np.arange(Kb), gaps)
        dec.add_symbols(src[keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(rep, [make_tag(sbn, int(e)) for e in range(Kb, Kb + nrep)], io)
        if pinned:
            check(torch.from_numpy(dec._block(sbn).D).is_pinned(), "the ingestion matrix is not pinned")
    check(dec.repair_all(io, backend=backend), f"repair_all({backend}) failed")
    check(np.array_equal(out, data), f"round-trip bytes differ ({backend})")
    case = {"K": K, "T": T, "Z": Z, "loss": loss, "backend": backend, "pinned": pinned}
    print("OK " + json.dumps(case), flush=True)
    return case


def card_reason() -> str | None:
    """None where a child process (under this one's preload and options)
    initializes CUDA and pins memory; else why not."""
    probe = "import torch; assert torch.cuda.is_available(), 'torch sees no CUDA device'; " \
            "torch.empty(1, pin_memory=True); torch.ones(1, device='cuda').sum().item()"
    try:
        r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return "CUDA did not initialize within 300 s"
    if r.returncode == 0:
        return None
    lines = r.stderr.strip().splitlines() or [""]
    said = next((ln for ln in lines if re.search(r"ERROR|Error|error|ABORTING|Sanitizer", ln)), lines[-1])
    return f"CUDA does not initialize here (exit code {r.returncode}): {said.strip()[:300]}"


def main() -> dict:
    check(no_jax(), "JAX or the JAX package is loaded before the round trips ran")
    from nanorq_tpu_torch.native import native_available

    check(native_available(), "the port's native library is unavailable (did its build fail?)")
    cases = [drive(*c) for c in CASES]
    reason = card_reason()
    if reason is None:
        cases.append(drive(*PINNED, pinned=True))
    else:
        print(f"the pinned case did not run: {reason}", flush=True)
    check(no_jax(), "a codec path loaded JAX or the JAX package")
    line = {"tool": "asan_drive", "cases": len(cases), "bit_exact": True, "pinned_case": reason or "ran",
            "sanitize": os.environ.get("NANORQ_NATIVE_SANITIZE", ""),
            "preload": os.path.basename(os.environ.get("LD_PRELOAD", "")),
            "asan_options": os.environ.get("ASAN_OPTIONS", "")}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
