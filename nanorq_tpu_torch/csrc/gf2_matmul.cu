// K2 gf2_matmul: out_b[r, :] (^)= XOR_{c : bit(r, c) = 1} X_b[c, :]  for b < nb
//
// Replaces the TPU kernel gf2_matmul_pallas (nanorq_tpu/ops/pallas_kernels.py,
// gf2_matmul_pallas with its bodies _gf2_kernel / _gf2_kernel_1k), which
// unpacks X into 8 bit planes and runs int8 MXU matmuls with an int32
// accumulator, reduced mod 2 and repacked.
//
// The bit matrix stays packed little-endian, [m, pitch] bytes with bit c of
// row r at byte c/8, bit c%8 -- how the schedules store the chunk inverses,
// Wut and the decode W.  The body is the four-Russians form of the shared
// core (gf2_core.cuh): per group of 4 columns a shared-memory table of the
// 15 XOR combinations of their X rows, one lookup and 4 XORs per row, group
// and 16-byte lane; cp.async double-buffered tiles; split k with atomicXor to
// fill the card at the decode widths; a grid-z block axis for the batched W
// decode.  What bounds it on the H100: the table lookups and XORs on the CUDA
// cores and shared memory, and at the wide encode shapes the bytes of X and
// out (PERF.md gives each main-path shape's bound).
#include "gf2_core.cuh"

// nb blocks b of bits uint8 [m, pitch] at bits + b*sA (pitch >= ceil(k/8),
// pitch, sA and the base multiples of 16), X uint8 [k, t] at X + b*sX and out
// uint8 [m, t] at out + b*sO (strides in bytes); k >= 1.
extern "C" int nrq_gf2_matmul(int64_t nb, const void* bits, int64_t m, int64_t k, int64_t pitch, int64_t sA,
                              const void* X, int64_t t, int64_t sX, void* out, int64_t sO, int accumulate,
                              void* stream) {
  return nrq::core::launch_core<false>(nb, static_cast<const uint8_t*>(bits), m, pitch, sA,
                                       static_cast<const uint8_t*>(X), k, t, sX, static_cast<uint8_t*>(out),
                                       sO, accumulate, static_cast<cudaStream_t>(stream));
}
