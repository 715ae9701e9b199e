// The GF(2) product core shared by K2 (gf2_matmul.cu) and K3 (gf256_matmul.cu).
//
// Computes, for each block b of a grid-z batch, out_b (^)= A_b (x)GF(2) Y_b
// where A_b is a bit matrix packed little-endian along its columns (row i,
// column j at byte j/8, bit j%8; row pitch a multiple of 16 bytes) and Y_b is
// read from a byte matrix X_b [kx, t] in one of two ways:
//
//   K2 (G256 = false): A is [m, >= kx] bits and Y = X: bit (r, c) selects
//       X row c:  out[r][col] = XOR_{c : bit(r,c)} X[c][col].
//   K3 (G256 = true): A is the GF(256) matrix M itself, [m, kx] bytes read
//       as [m, 8kx] bits, and Y row 8c+q = alpha^q (x) X[c]:
//       out[r] = XOR_{c,q : bit q of M[r][c]} alpha^q (x) X[c].
//
// The TPU kernels do K2 and K3 as int8 matmuls over 0/1 bit planes with an
// int32 accumulator (nanorq_tpu/ops/pallas_kernels.py, _gf2_kernel and
// companion_bits_planar / _gf256_kernel).  On Hopper that formulation
// (mma.sync m16n8k32 s8 over bits expanded in registers) stayed issue-bound
// expanding bits, and a branch-free masked XOR on the CUDA cores beat it;
// both lost to the four-Russians form kept here (PERF.md).
//
// Four-Russians: per group of 4 Y rows of a stage, the block tabulates their
// 15 nonzero XOR combinations (each thread one group x one 16-byte lane; K3's
// rows are alpha^q (x) X[c], q one nibble of c's coefficient bits, made with
// xtime on the lane), then each output row takes one table entry per group,
// picked by its 4 bits: a shared-memory lookup and 4 32-bit XORs per 4
// columns and 16 bytes.  What bounds it on this card: the table lookups
// (16 bytes of shared memory per row, group and lane) and the XORs on the
// CUDA cores; at the wide encode shapes the bytes of X and out come close.
// Around it:
//   - a block owns a row tile [BMA rows] and a run of column tiles of BT
//     bytes, streamed one (column tile, k tile) item after another with the
//     next item's copies in flight, so short products (k of one or two
//     tiles) still overlap copies with compute; grid x walks row tiles
//     fastest, so concurrent blocks share X columns in L2;
//   - grid y splits k: when row and column tiles alone give fewer than
//     FILL_BLOCKS blocks (the narrow decode widths), each split takes a range
//     of k tiles and XORs its partial product into the zeroed output with
//     atomicXor on 32-bit words (XOR is associative and commutative, so any
//     order is bit-exact);
//   - grid z is the block axis (byte strides sA, sX, sO);
//   - X and A tiles are staged into shared memory with cp.async, two stages;
//   - a k tile whose A bits are all zero is skipped (the schedules' padding);
//   - the epilogue stages the packed tile in shared memory and writes it out
//     in 16-byte units (bytes when t % 16 != 0).
#pragma once

#include "common.cuh"

namespace nrq {
namespace core {

constexpr int THREADS = 128;
constexpr int64_t FILL_BLOCKS = 4 * 132;  // two waves of two blocks on each of 132 SMs

// BMA: A rows (= output rows) per block; BT: output bytes per row per block;
// KB: A columns (bits) per stage, one 32-bit word of each A row.
template <bool G256> struct Tile {
  static constexpr int BMA = 64, BT = 256, KB = 32;
  static constexpr int XR = G256 ? KB / 8 : KB;  // X rows per stage
  static constexpr int X_BYTES = XR * BT;
  static constexpr int STAGE = X_BYTES + 4 * BMA;
  static constexpr int OUT = BMA * BT;
  // per group of 4 Y rows of the stage, its 15 nonzero XOR combinations
  // ([KB/4][15][BT] bytes); the output tile shares its space
  static constexpr int TABLE = (KB / 4) * 15 * BT;
  static constexpr int SMEM = 2 * STAGE + (TABLE > OUT ? TABLE : OUT);
  static_assert(X_BYTES % 16 == 0 && STAGE % 16 == 0, "stages must keep 16-byte alignment");
  static_assert(THREADS == (KB / 4) * 16 && BMA == (THREADS / 16) * 8 && BT == 16 * 16,
                "a thread owns one group (table build) or 8 rows (lookups) of one 16-byte lane");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, of which the first src_bytes are copied and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// alpha (x) each of the 16 bytes, over GF(256) with polynomial 0x11D
__device__ __forceinline__ uint32_t xtime(uint32_t w) {
  const uint32_t hi = (w >> 7) & 0x01010101u;
  return ((w & 0x7f7f7f7fu) << 1) ^ (hi * 0x1du);
}
__device__ __forceinline__ uint4 xtime(uint4 v) {
  return make_uint4(xtime(v.x), xtime(v.y), xtime(v.z), xtime(v.w));
}

// mode: 0 store, 1 XOR into out, 2 atomicXor into out (split k).  A block
// owns row tile rt and column tiles [cg*cpb, (cg+1)*cpb) of grid x = (rt, cg),
// and k tiles [y*per_split, ..) of its split; it walks its (column tile, k
// tile) items in order with the next item's copies in flight, and writes a
// column tile out after its last k tile.
template <bool G256, int VEC>
__global__ void __launch_bounds__(THREADS)
    gf_core_kernel(const uint8_t* __restrict__ A, int64_t MA, int64_t pitch, int64_t sA,
                   const uint8_t* __restrict__ X, int64_t kx, int64_t t, int64_t sX,
                   uint8_t* __restrict__ out, int64_t sO, int64_t row_tiles,
                   int64_t col_tiles, int64_t cpb, int64_t ktiles, int64_t per_split, int mode) {
  using TL = Tile<G256>;
  constexpr int BT = TL::BT, XR = TL::XR, KB = TL::KB, BMA = TL::BMA, LN = BT / 16;
  __shared__ __align__(16) uint8_t smem[TL::SMEM];
  uint8_t* os = smem + 2 * TL::STAGE;  // the table, then the output tile

  const int tid = threadIdx.x;
  // thread = 8 rows (rg*8 ..) x one 16-byte lane; in the table build, group
  // rg of the stage's 4-row groups x the same lane
  const int lane16 = tid & 15, rg = tid >> 4;
  const int64_t rt = blockIdx.x % row_tiles, cg = blockIdx.x / row_tiles;
  const int64_t row0 = rt * BMA;
  const int64_t ct0 = cg * cpb, nct = ct0 + cpb < col_tiles ? cpb : col_tiles - ct0;
  A += blockIdx.z * sA;
  X += blockIdx.z * sX;
  out += blockIdx.z * sO;
  const int64_t kt0 = blockIdx.y * per_split;
  const int64_t kt1 = kt0 + per_split < ktiles ? kt0 + per_split : ktiles;
  const int nk = static_cast<int>(kt1 - kt0);  // >= 1: the launcher leaves no split empty
  const int64_t items = nct * nk;

  auto load = [&](int buf, int64_t item) {
    uint8_t* xs = smem + buf * TL::STAGE;
    uint32_t* as = reinterpret_cast<uint32_t*>(xs + TL::X_BYTES);
    const int64_t kt = kt0 + item % nk, col0 = (ct0 + item / nk) * BT;
    const int64_t xr0 = kt * XR;
    if constexpr (VEC == 16) {
      for (int e = tid; e < XR * LN; e += THREADS) {
        const int r = e / LN, ch = e % LN;
        const int64_t gr = xr0 + r, gc = col0 + ch * 16;
        const bool ok = gr < kx && gc < t;
        cp_async16(xs + r * BT + ch * 16, ok ? X + gr * t + gc : X, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < XR * BT; e += THREADS) {
        const int r = e / BT, c = e % BT;
        const int64_t gr = xr0 + r, gc = col0 + c;
        xs[r * BT + c] = (gr < kx && gc < t) ? X[gr * t + gc] : 0;
      }
    }
    const int64_t gb = kt * (KB / 8);
    for (int r = tid; r < BMA; r += THREADS) {
      const int64_t gr = row0 + r;
      const bool ok = gr < MA && gb < pitch;
      cp_async4(as + r, ok ? A + gr * pitch + gb : A, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  uint32_t acc[8][4];  // rows rg*8 + r, one 16-byte lane
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0;

  if (items > 0) load(0, 0);
  for (int64_t it = 0; it < items; ++it) {
    if (it + 1 < items) {
      load((it + 1) & 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const uint8_t* xs = smem + (it & 1) * TL::STAGE;
    const uint32_t* as = reinterpret_cast<const uint32_t*>(xs + TL::X_BYTES);
    // a k tile whose A bits are all zero adds nothing: the block skips it
    // (each thread checks the A words it copied; the barrier ORs them)
    uint32_t nz = 0;
    for (int r = tid; r < BMA; r += THREADS) nz |= as[r];
    if (__syncthreads_or(nz != 0)) {
      uint4* tab = reinterpret_cast<uint4*>(os);
      {
        // K2: group rg is X rows 4rg .. 4rg+3.  K3: group rg is nibble rg%2
        // of X row rg/2's coefficients: alpha^(4*(rg%2) + j) (x) X[rg/2], j < 4
        uint4 c[16];
        if constexpr (!G256) {
          const uint4* xv = reinterpret_cast<const uint4*>(xs) + rg * 4 * LN + lane16;
          c[1] = xv[0], c[2] = xv[LN], c[4] = xv[2 * LN], c[8] = xv[3 * LN];
        } else {
          uint4 y = reinterpret_cast<const uint4*>(xs)[(rg >> 1) * LN + lane16];
          if (rg & 1) y = xtime(xtime(xtime(xtime(y))));
          c[1] = y, c[2] = xtime(y), c[4] = xtime(c[2]), c[8] = xtime(c[4]);
        }
        c[3] = vxor(c[1], c[2]);
#pragma unroll
        for (int j = 5; j < 8; ++j) c[j] = vxor(c[4], c[j - 4]);
#pragma unroll
        for (int j = 9; j < 16; ++j) c[j] = vxor(c[8], c[j - 8]);
        uint4* tg = tab + rg * 15 * LN + lane16;
#pragma unroll
        for (int j = 1; j < 16; ++j) tg[(j - 1) * LN] = c[j];
      }
      uint32_t wb[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) wb[r] = as[rg * 8 + r];
      __syncthreads();
      const uint4* tl = tab + lane16;
#pragma unroll
      for (int gq = 0; gq < KB / 4; ++gq) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const uint32_t idx = (wb[r] >> (4 * gq)) & 15u;
          if (idx) {
            const uint4 v = tl[(gq * 15 + static_cast<int>(idx) - 1) * LN];
            acc[r][0] ^= v.x;
            acc[r][1] ^= v.y;
            acc[r][2] ^= v.z;
            acc[r][3] ^= v.w;
          }
        }
      }
    }
    __syncthreads();
    if (it % nk != nk - 1) continue;

    // the column tile is done: stage it in os [BMA][BT], then write it out
    uint4* ov = reinterpret_cast<uint4*>(os);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      ov[(rg * 8 + r) * LN + lane16] = make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0;
    }
    __syncthreads();

    const int64_t col0 = (ct0 + it / nk) * BT;
    if constexpr (VEC == 16) {
      for (int e = tid; e < BMA * LN; e += THREADS) {
        const int r = e / LN, ch = e % LN;
        const int64_t gr = row0 + r, gc = col0 + ch * 16;
        if (gr >= MA || gc >= t) continue;
        const uint4 v = ov[e];
        uint4* o = reinterpret_cast<uint4*>(out + gr * t + gc);
        if (mode == 0) {
          *o = v;
        } else if (mode == 1) {
          *o = vxor(*o, v);
        } else {
          unsigned* ow = reinterpret_cast<unsigned*>(o);
          if (v.x) atomicXor(ow, v.x);
          if (v.y) atomicXor(ow + 1, v.y);
          if (v.z) atomicXor(ow + 2, v.z);
          if (v.w) atomicXor(ow + 3, v.w);
        }
      }
    } else {
      for (int e = tid; e < BMA * BT; e += THREADS) {
        const int r = e / BT, c = e % BT;
        const int64_t gr = row0 + r, gc = col0 + c;
        if (gr >= MA || gc >= t) continue;
        const uint8_t v = os[e];
        uint8_t* o = out + gr * t + gc;
        if (mode == 0) {
          *o = v;
        } else if (mode == 1) {
          *o ^= v;
        } else if (v) {  // the 32-bit word holding the byte; the other bytes XOR 0
          const uintptr_t p = reinterpret_cast<uintptr_t>(o);
          atomicXor(reinterpret_cast<unsigned*>(p & ~uintptr_t(3)), static_cast<unsigned>(v) << (8 * (p & 3)));
        }
      }
    }
    // the next table build into os comes after at least one more barrier
  }
}

// Launch one product over nb blocks.  kx: X rows; MA: A rows (= output
// rows).  A's pitch, base and block stride must be multiples of 16 bytes
// (the wrapper pads); kx must be at least 1 (the wrapper handles an empty
// contraction).  The rule: when row and column tiles give fewer than
// FILL_BLOCKS blocks, split k until they do; when they give more than
// 2 * FILL_BLOCKS, give each block a run of column tiles, so that about
// 2 * FILL_BLOCKS blocks stream their tiles with copies in flight.  Returns
// a CUDA error code.
template <bool G256>
cudaError_t launch_core(int64_t nb, const uint8_t* A, int64_t MA, int64_t pitch, int64_t sA,
                        const uint8_t* X, int64_t kx, int64_t t, int64_t sX, uint8_t* out,
                        int64_t sO, int accumulate, cudaStream_t stream) {
  using TL = Tile<G256>;
  if (nb <= 0 || MA <= 0 || t <= 0) return cudaSuccess;
  if (kx <= 0 || pitch % 16 || sA % 16 || reinterpret_cast<uintptr_t>(A) % 16) return cudaErrorInvalidValue;
  const int64_t row_tiles = (MA + TL::BMA - 1) / TL::BMA;
  const int64_t col_tiles = (t + TL::BT - 1) / TL::BT;
  const int64_t kbits = G256 ? 8 * kx : kx;
  const int64_t ktiles = (kbits + TL::KB - 1) / TL::KB;
  const int64_t base = row_tiles * col_tiles * nb;
  int64_t ksplit = base >= FILL_BLOCKS ? 1 : (FILL_BLOCKS + base - 1) / base;
  if (ksplit > ktiles) ksplit = ktiles;
  const int64_t per = (ktiles + ksplit - 1) / ksplit;
  ksplit = (ktiles + per - 1) / per;  // no split is left without a tile
  const int64_t cpb = base > 2 * FILL_BLOCKS ? (base + 2 * FILL_BLOCKS - 1) / (2 * FILL_BLOCKS) : 1;
  const int64_t col_groups = (col_tiles + cpb - 1) / cpb;
  const int64_t gx = row_tiles * col_groups;
  if (gx > 0x7fffffff || ksplit > 65535 || nb > 65535) return cudaErrorInvalidConfiguration;
  int mode = accumulate ? 1 : 0;
  if (ksplit > 1) {
    mode = 2;
    if (!accumulate) {  // bytes from out to the last row's end
      cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>((nb - 1) * sO + MA * t), stream);
      if (e != cudaSuccess) return e;
    }
  }
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(ksplit), static_cast<unsigned>(nb));
  const bool vec = t % 16 == 0 && sX % 16 == 0 && sO % 16 == 0 && aligned16(X) && aligned16(out);
  if (vec)
    gf_core_kernel<G256, 16><<<grid, THREADS, 0, stream>>>(A, MA, pitch, sA, X, kx, t, sX, out, sO,
                                                           row_tiles, col_tiles, cpb, ktiles, per, mode);
  else
    gf_core_kernel<G256, 1><<<grid, THREADS, 0, stream>>>(A, MA, pitch, sA, X, kx, t, sX, out, sO,
                                                          row_tiles, col_tiles, cpb, ktiles, per, mode);
  return cudaGetLastError();
}

}  // namespace core
}  // namespace nrq
