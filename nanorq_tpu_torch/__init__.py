"""nanorq_tpu_torch: the RaptorQ (RFC 6330) codec on PyTorch and CUDA.

The device half of `nanorq_tpu` (structured precode replay, LT combine,
dense-W decode) rewritten on torch tensors, with hand-written CUDA kernels
(`csrc/`) for the three payload kernels: row gather-XOR, GF(2) matmul and
GF(256) matmul.  The host half -- RFC tables, the precode solver, the
`DeviceSchedule`/`WSchedule` compilers, the native C++ solver and the I/O --
is imported from `nanorq_tpu` unchanged; none of it loads JAX, and neither
does this package.

Every device-touching function takes an explicit `device`: a CPU tensor runs
the plain torch versions (`ops/gfmat.py`), a CUDA tensor runs the kernels.
"""

__version__ = "0.1.0"
