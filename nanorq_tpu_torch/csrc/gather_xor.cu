// K1 gather_xor: out[i, :] (^)= XOR_k src[idx[i, k], :]
//
// Replaces the TPU kernel gather_xor_pallas (nanorq_tpu/ops/pallas_kernels.py,
// gather_xor_pallas with its body _gather_kernel_factory), which starts R*w
// row-tile DMAs into VMEM and XOR-reduces them on the VPU.
//
// What bounds it on the H100: device-memory bytes.  It reads n*w*t bytes of
// randomly chosen source rows and writes n*t; there is one XOR per byte read,
// far below the card's compute.  Design: one thread owns one 16-byte lane of
// one output row and walks that row's w indices, so every source row read is
// a fully coalesced run of 16-byte loads across the warp, and the indices
// are loaded once per thread from L1 (all lanes of a row read the same
// address, a broadcast).  Four indices are resolved before their loads are
// started, to keep several independent row reads in flight per thread.
// An index outside [0, S) is an error: the kernel reads nothing for it and
// sets the caller's device flag *err, which the wrapper reads (and clears) in
// its checked mode; the codec's sentinel indices point at an all-zero row of
// src, inside [0, S).
// With `accumulate` the result is XORed into out instead of stored.
#include "common.cuh"

namespace nrq {

template <typename V>
__device__ __forceinline__ V load_row(const V* __restrict__ src, int32_t r, int64_t S,
                                      int64_t lanes, int64_t col, int* err) {
  if (r >= 0 && r < S) return src[static_cast<int64_t>(r) * lanes + col];
  *err = 1;  // every writer stores the same value, so the race is benign
  return vzero<V>();
}

template <typename V>
__global__ void gather_xor_kernel(const V* __restrict__ src, int64_t S, int64_t lanes,
                                  const int32_t* __restrict__ idx, int64_t n, int64_t w,
                                  V* __restrict__ out, int accumulate, int* err) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (row >= n || col >= lanes) return;
  const int32_t* ix = idx + row * w;
  V acc = accumulate ? out[row * lanes + col] : vzero<V>();
  int64_t j = 0;
  for (; j + 4 <= w; j += 4) {
    const int32_t r0 = ix[j], r1 = ix[j + 1], r2 = ix[j + 2], r3 = ix[j + 3];
    const V v0 = load_row(src, r0, S, lanes, col, err);
    const V v1 = load_row(src, r1, S, lanes, col, err);
    const V v2 = load_row(src, r2, S, lanes, col, err);
    const V v3 = load_row(src, r3, S, lanes, col, err);
    acc = vxor(acc, vxor(vxor(v0, v1), vxor(v2, v3)));
  }
  for (; j < w; ++j) acc = vxor(acc, load_row(src, ix[j], S, lanes, col, err));
  out[row * lanes + col] = acc;
}

template <typename V>
static cudaError_t launch_gather(const void* src, int64_t S, int64_t lanes, const int32_t* idx,
                          int64_t n, int64_t w, void* out, int accumulate, int* err,
                          cudaStream_t stream) {
  const int bx = lane_threads(lanes);
  const int by = 256 / bx;
  const int64_t gy = (lanes + bx - 1) / bx;
  const int64_t gx = (n + by - 1) / by;
  if (gy > 65535 || gx > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gather_xor_kernel<V><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                         dim3(bx, by), 0, stream>>>(
      static_cast<const V*>(src), S, lanes, idx, n, w, static_cast<V*>(out), accumulate, err);
  return cudaGetLastError();
}

}  // namespace nrq

// src uint8 [S, t], idx int32 [n, w], out uint8 [n, t]; all contiguous.
// err: one device int32, set to 1 when an index lies outside [0, S).
extern "C" int nrq_gather_xor(const void* src, int64_t S, int64_t t, const void* idx,
                              int64_t n, int64_t w, void* out, int accumulate,
                              void* err, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int* e = static_cast<int*>(err);
  if (t % 16 == 0 && nrq::aligned16(src) && nrq::aligned16(out))
    return nrq::launch_gather<uint4>(src, S, t / 16, ix, n, w, out, accumulate, e, s);
  return nrq::launch_gather<uint8_t>(src, S, t, ix, n, w, out, accumulate, e, s);
}
