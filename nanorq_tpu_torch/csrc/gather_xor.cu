// K1 gather_xor: out[o(i), :] (^)= XOR_k src[idx[i, k], :],  o(i) = rows ? rows[i] : i
//
// Replaces the TPU kernel gather_xor_pallas (nanorq_tpu/ops/pallas_kernels.py:290,
// body _gather_kernel_factory), which starts R*w row-tile DMAs into VMEM and
// XOR-reduces them on the VPU.
//
// What bounds it on the H100: device-memory bytes.  It reads the distinct
// source rows its indices name and writes n output rows (reads them too when
// it accumulates); one XOR per byte read is far below the card's compute.  To
// run at the memory rate the card needs ~2-3 MB of loads in flight, and few
// instructions per byte.  The design:
//  - a 1-D grid of tiles, each blockDim.y rows by blockDim.x * U 16-byte lanes,
//    with no cap but 2^31 tiles;
//  - each thread owns U = 2 lanes of one row, blockDim.x apart, so each of
//    its loads is one coalesced 16-byte run across the warp, and it keeps G
//    indices x 2 lanes of loads in flight: at width 1, G = 1 and 32
//    registers, so 8 blocks of 256 threads fit an SM (more threads in flight
//    beat more loads per thread there); wider, G = 4;
//  - a warp lies within one row: each lane loads and checks one of the row's
//    indices, once, and turns it into a 64-bit row offset that the warp
//    shares by shuffles;
//  - the order of the tiles: at width 1 consecutive tiles walk one row's
//    column chunks, so each row is read and written as one sequential run
//    (faster in DRAM than chunks of many rows at once); wider, consecutive
//    tiles take the same column chunk of consecutive row blocks, so the tiles
//    resident at one time read one column chunk of the source and a source
//    row read by many output rows is found in L2;
//  - `rows` names each result's output row: a placement into a larger buffer
//    is folded into the gather (the rows are distinct, so no atomics);
//  - with `zero_ok`, index S reads as a zero row and costs no load; every
//    other index outside [0, S), and an output row outside [0, n_out), sets
//    the caller's device flag *err and is not read or written;
//  - at width 1 the loads and stores are marked streaming (__ldcs/__stcs):
//    each row is read once; wider, plain (the hint costs a source row that
//    other output rows read again from L2).
// Ragged widths (t % 16 != 0, or an unaligned base) take one byte per lane.
#include "common.cuh"

namespace nrq {

template <bool EF, typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (EF) return __ldcs(p);
  else return __ldg(p);
}

template <bool EF, typename V>
__device__ __forceinline__ void store(V* p, V v) {
  if constexpr (EF) __stcs(p, v);
  else *p = v;
}

constexpr int U = 2;  // lanes per thread

template <typename V, int G>
__global__ void __launch_bounds__(256, G == 1 ? 8 : 1)
gather_xor_kernel(const V* __restrict__ src, int64_t S, int64_t lanes,
                  const int32_t* __restrict__ idx, int64_t n, int w,
                  const int32_t* __restrict__ rows, int64_t n_out, V* __restrict__ out,
                  int accumulate, int zero_ok, int64_t row_blocks, int64_t chunks, int* err) {
  constexpr bool EF = G == 1;  // streaming hints at width 1
  const int64_t tile = blockIdx.x;
  const int64_t rb = G == 1 ? tile / chunks : tile % row_blocks;
  const int64_t cc = G == 1 ? tile % chunks : tile / row_blocks;
  const int64_t i = rb * blockDim.y + threadIdx.y;
  if (i >= n) return;  // the whole warp: it lies within one row
  const int64_t col = cc * blockDim.x * U + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int64_t orow = i;
  if (rows) {
    orow = rows[i];
    if (orow < 0 || orow >= n_out) {  // the whole warp again
      *err = 1;
      return;
    }
  }
  V* o = out + orow * lanes;
  V acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t c = col + static_cast<int64_t>(u) * blockDim.x;
    acc[u] = (accumulate && c < lanes) ? o[c] : vzero<V>();
  }
  const int32_t* ix = idx + i * w;
  for (int j0 = 0; j0 < w; j0 += 32) {
    // lane l resolves index j0 + l: its row offset, or -1 (a zero row, an
    // index past the row's last)
    long long off = -1;
    if (j0 + lane < w) {
      const int32_t r = ix[j0 + lane];
      if (r >= 0 && r < S) off = static_cast<long long>(r) * lanes;
      else if (!(zero_ok && r == S)) *err = 1;
    }
    const int m = min(32, w - j0);
    for (int j = 0; j < m; j += G) {  // j + G <= 32: G divides 32
      long long offs[G];
#pragma unroll
      for (int g = 0; g < G; ++g) offs[g] = __shfl_sync(0xffffffffu, off, j + g);
      V v[G][U];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t c = col + static_cast<int64_t>(u) * blockDim.x;
          v[g][u] = (offs[g] >= 0 && c < lanes) ? load<EF>(src + offs[g] + c) : vzero<V>();
        }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u] = vxor(acc[u], v[g][u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t c = col + static_cast<int64_t>(u) * blockDim.x;
    if (c < lanes) store<EF>(o + c, acc[u]);
  }
}

template <typename V, int G>
static cudaError_t launch_gather(const void* src, int64_t S, int64_t lanes, const int32_t* idx,
                                 int64_t n, int64_t w, const int32_t* rows, int64_t n_out,
                                 void* out, int accumulate, int zero_ok, int* err,
                                 cudaStream_t stream) {
  // threads along a row: enough for its lanes at U each, a multiple of 32, at most 256
  const int64_t per = (lanes + U - 1) / U;
  const int bx = static_cast<int>(per >= 256 ? 256 : (per + 31) / 32 * 32);
  const int by = 256 / bx;
  const int64_t row_blocks = (n + by - 1) / by;
  const int64_t chunks = (lanes + static_cast<int64_t>(bx) * U - 1) / (static_cast<int64_t>(bx) * U);
  if (w > 0x7fffffff || row_blocks * chunks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(row_blocks * chunks)), block(bx, by);
  gather_xor_kernel<V, G><<<grid, block, 0, stream>>>(
      static_cast<const V*>(src), S, lanes, idx, n, static_cast<int>(w), rows, n_out,
      static_cast<V*>(out), accumulate, zero_ok, row_blocks, chunks, err);
  return cudaGetLastError();
}

template <typename V>
static cudaError_t launch_width(const void* src, int64_t S, int64_t lanes, const int32_t* idx,
                                int64_t n, int64_t w, const int32_t* rows, int64_t n_out,
                                void* out, int accumulate, int zero_ok, int* err,
                                cudaStream_t stream) {
  if (w <= 1)
    return launch_gather<V, 1>(src, S, lanes, idx, n, w, rows, n_out, out, accumulate, zero_ok,
                               err, stream);
  return launch_gather<V, 4>(src, S, lanes, idx, n, w, rows, n_out, out, accumulate, zero_ok,
                             err, stream);
}

}  // namespace nrq

// src uint8 [S, t], idx int32 [n, w], out uint8 [n_out, t]; all contiguous.
// rows: int32 [n] distinct output rows, or null for out row i (then n_out = n).
// accumulate: XOR into out instead of storing.  zero_ok: index S reads as a
// zero row.
// err: one device int32, set to 1 on an index outside [0, S) (S allowed with
// zero_ok) or an output row outside [0, n_out).
extern "C" int nrq_gather_xor(const void* src, int64_t S, int64_t t, const void* idx, int64_t n,
                              int64_t w, const void* rows, int64_t n_out, void* out,
                              int accumulate, int zero_ok, void* err, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const int32_t* rw = static_cast<const int32_t*>(rows);
  int* e = static_cast<int*>(err);
  if (t % 16 == 0 && nrq::aligned16(src) && nrq::aligned16(out))
    return nrq::launch_width<uint4>(src, S, t / 16, ix, n, w, rw, n_out, out, accumulate, zero_ok,
                                    e, s);
  return nrq::launch_width<uint8_t>(src, S, t, ix, n, w, rw, n_out, out, accumulate, zero_ok, e, s);
}
