// Shared helpers of the payload kernels.
//
// Every kernel works on byte rows of width t, contiguous, in "lanes": a
// 16-byte uint4 when t % 16 == 0 and the base pointers are 16-byte aligned
// (the codec's T = 1280 and every multiple of it), else a single byte.  The
// host entry points pick the lane type, launch on the caller's stream,
// allocate nothing and return cudaGetLastError().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nrq {

__device__ __forceinline__ uint4 vxor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint8_t vxor(uint8_t a, uint8_t b) { return a ^ b; }

template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ uint4 vzero<uint4>() { return make_uint4(0, 0, 0, 0); }
template <> __device__ __forceinline__ uint8_t vzero<uint8_t>() { return 0; }

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Threads along the row (lanes) for a row of `lanes` lanes: a multiple of
// 32, at most 128.
inline int lane_threads(int64_t lanes) {
  int64_t w = (lanes + 31) / 32 * 32;
  return static_cast<int>(w < 128 ? w : 128);
}

}  // namespace nrq
