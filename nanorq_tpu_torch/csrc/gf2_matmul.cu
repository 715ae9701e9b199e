// K2 gf2_matmul: out[r, :] (^)= XOR_{c : bit(r, c) = 1} X[c, :]
//
// Replaces the TPU kernel gf2_matmul_pallas (nanorq_tpu/ops/pallas_kernels.py,
// gf2_matmul_pallas with its bodies _gf2_kernel / _gf2_kernel_1k), which
// unpacks X into 8 bit planes and runs int8 MXU matmuls with an int32
// accumulator, reduced mod 2 and repacked.
//
// Here the bit matrix stays packed little-endian, [m, pitch] bytes with bit c
// of row r at byte c/8, bit c%8 -- exactly how the schedules store the chunk
// inverses, Wut and the decode W -- and is never unpacked in device memory.
// What bounds it on the H100: for the codec's shapes (m, k <= a few thousand,
// t up to ~256 KB) each block re-reads X once per tile of RM output rows, so
// it moves about (m/RM)*k*t bytes through L2 and does up to m*k*t/16 16-byte
// XORs.  Design: a block owns RM output rows times a span of 16-byte lanes;
// each thread keeps its RM accumulators in registers, loads X[c] for its lane
// once per c and XORs it into every row whose bit is set.  The bits of the
// RM rows are staged in shared memory as 32-bit words, one k-tile at a time;
// every thread of the block tests the same bit, so the branch never diverges.
// An int8 tensor-core form or Four-Russians tables may replace this later,
// chosen by measurement.
#include "common.cuh"

namespace nrq {

constexpr int GF2_RM = 16;   // output rows per block
constexpr int GF2_KT = 512;  // k columns staged per tile

template <typename V>
__global__ void gf2_matmul_kernel(const uint8_t* __restrict__ bits, int64_t m, int64_t k,
                                  int64_t pitch, const V* __restrict__ X, int64_t lanes,
                                  V* __restrict__ out, int accumulate) {
  __shared__ uint32_t sb[GF2_RM][GF2_KT / 32];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * GF2_RM;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const bool active = col < lanes;
  V acc[GF2_RM];
#pragma unroll
  for (int r = 0; r < GF2_RM; ++r) acc[r] = vzero<V>();

  for (int64_t k0 = 0; k0 < k; k0 += GF2_KT) {
    __syncthreads();  // the previous tile's bits are no longer read
    for (int e = threadIdx.x; e < GF2_RM * (GF2_KT / 32); e += blockDim.x) {
      const int r = e / (GF2_KT / 32), wd = e % (GF2_KT / 32);
      const int64_t row = r0 + r;
      uint32_t word = 0;
      if (row < m) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int64_t byte = k0 / 8 + wd * 4 + b;
          if (byte * 8 < k) word |= static_cast<uint32_t>(bits[row * pitch + byte]) << (8 * b);
        }
      }
      sb[r][wd] = word;
    }
    __syncthreads();
    const int kn = static_cast<int>(k - k0 < GF2_KT ? k - k0 : GF2_KT);
    if (active) {
      const V* xc = X + k0 * lanes + col;
#pragma unroll 4
      for (int c = 0; c < kn; ++c) {
        const V x = xc[static_cast<int64_t>(c) * lanes];
#pragma unroll
        for (int r = 0; r < GF2_RM; ++r)
          if ((sb[r][c >> 5] >> (c & 31)) & 1u) acc[r] = vxor(acc[r], x);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < GF2_RM; ++r) {
    const int64_t row = r0 + r;
    if (row < m) {
      V* o = out + row * lanes + col;
      *o = accumulate ? vxor(*o, acc[r]) : acc[r];
    }
  }
}

template <typename V>
static cudaError_t launch_gf2(const uint8_t* bits, int64_t m, int64_t k, int64_t pitch,
                              const void* X, int64_t lanes, void* out, int accumulate,
                              cudaStream_t stream) {
  const int bx = lane_threads(lanes);
  const int64_t gx = (m + GF2_RM - 1) / GF2_RM;
  const int64_t gy = (lanes + bx - 1) / bx;
  if (gy > 65535 || gx > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gf2_matmul_kernel<V><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), bx, 0,
                         stream>>>(bits, m, k, pitch, static_cast<const V*>(X), lanes,
                                   static_cast<V*>(out), accumulate);
  return cudaGetLastError();
}

}  // namespace nrq

// bits uint8 [m, pitch] (pitch >= ceil(k/8)), X uint8 [k, t], out uint8 [m, t].
extern "C" int nrq_gf2_matmul(const void* bits, int64_t m, int64_t k, int64_t pitch,
                              const void* X, int64_t t, void* out, int accumulate,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bits);
  if (t % 16 == 0 && nrq::aligned16(X) && nrq::aligned16(out))
    return nrq::launch_gf2<uint4>(b, m, k, pitch, X, t / 16, out, accumulate, s);
  return nrq::launch_gf2<uint8_t>(b, m, k, pitch, X, t, out, accumulate, s);
}
