// K3 gf256_matmul: out_b[r, :] (^)= XOR_c M_b[r, c] (x) X_b[c, :]  over GF(256), poly 0x11D
//
// Replaces the TPU kernel gf256_matmul_pallas (nanorq_tpu/ops/pallas_kernels.py,
// gf256_matmul_pallas with its bodies _gf256_kernel / _gf256_kernel_1k and the
// host layouts companion_bits_planar / gf256_mb / companion_bits_blocked),
// which expands M into an [8m, 8k] companion-bit matrix and runs it as a
// GF(2) bit-plane matmul on the MXU.
//
// Two forms, one per shape by the wrapper's rule (ops/kernels.gf256_form):
//
// nrq_gf256_m4r, every shape but one kind: the companion-bit product on K2's
// four-Russians core (gf2_core.cuh).  M's bytes are read as bits (bit q of
// M[r][c] is A column 8c+q) against the rows alpha^q (x) X[c], which the
// block tabulates per nibble of coefficients (15 combinations of
// alpha^(4h+j) (x) X[c], j < 4, made with xtime on 16-byte lanes), so each
// row takes two table entries per coefficient and never multiplies, and M
// needs no companion expansion.  Bound: the lookups and XORs on the CUDA
// cores and shared memory, or the bytes at the wide encode shapes (PERF.md).
//
// nrq_gf256_logexp, a wide product (t >= 2**16) of at most 16 rows (the
// encoder's HDPC rows over a whole object): products from log/exp tables in
// shared memory (log[0] = 512 lands in the zero upper half of the 1024-entry
// exp table, so a zero byte needs no branch).  The four-Russians tables are
// built per block of 64 rows; with 10 rows they are not paid back, and
// log/exp, ~1.1 shared-memory lookups per byte product, is faster there.  A
// block owns RM rows x a span of 16-byte lanes; grid y also splits k in
// 32-column units when fewer than 264 blocks (two per SM) would run, XORing
// partial products with atomicXor.
#include "gf2_core.cuh"

namespace nrq {

constexpr int GF256_RM = 8;    // output rows per block
constexpr int GF256_KT = 256;  // k columns staged per tile
constexpr int GF256_KQ = 32;   // k columns per split unit
constexpr uint16_t GF256_ZERO = 0xffff;

__device__ __forceinline__ void byte_logs(uint4 x, const uint16_t* slog, uint16_t* l) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) l[i] = slog[(w[i >> 2] >> (8 * (i & 3))) & 0xff];
}
__device__ __forceinline__ void byte_logs(uint8_t x, const uint16_t* slog, uint16_t* l) {
  l[0] = slog[x];
}

__device__ __forceinline__ uint4 mul_logs(const uint16_t* l, uint16_t lc, const uint8_t* sexp,
                                          uint4) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = static_cast<uint32_t>(sexp[l[4 * q] + lc]) |
           static_cast<uint32_t>(sexp[l[4 * q + 1] + lc]) << 8 |
           static_cast<uint32_t>(sexp[l[4 * q + 2] + lc]) << 16 |
           static_cast<uint32_t>(sexp[l[4 * q + 3] + lc]) << 24;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint8_t mul_logs(const uint16_t* l, uint16_t lc, const uint8_t* sexp,
                                            uint8_t) {
  return sexp[l[0] + lc];
}

__device__ __forceinline__ void xor_out(uint4* o, uint4 v, int mode) {
  if (mode == 0) {
    *o = v;
  } else if (mode == 1) {
    *o = vxor(*o, v);
  } else {
    unsigned* w = reinterpret_cast<unsigned*>(o);
    if (v.x) atomicXor(w, v.x);
    if (v.y) atomicXor(w + 1, v.y);
    if (v.z) atomicXor(w + 2, v.z);
    if (v.w) atomicXor(w + 3, v.w);
  }
}
__device__ __forceinline__ void xor_out(uint8_t* o, uint8_t v, int mode) {
  if (mode == 0) {
    *o = v;
  } else if (mode == 1) {
    *o ^= v;
  } else if (v) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(o);
    atomicXor(reinterpret_cast<unsigned*>(p & ~uintptr_t(3)), static_cast<unsigned>(v) << (8 * (p & 3)));
  }
}

template <typename V>
__global__ void gf256_logexp_kernel(const uint8_t* __restrict__ M, int64_t m, int64_t k,
                                    const V* __restrict__ X, int64_t lanes, int64_t lane_blocks,
                                    int64_t kper, const uint16_t* __restrict__ log_tab,
                                    const uint8_t* __restrict__ exp_tab, V* __restrict__ out,
                                    int mode, int64_t sM, int64_t sX, int64_t sO) {
  constexpr int NB = sizeof(V);  // payload bytes per lane
  __shared__ uint16_t slog[256];
  __shared__ uint8_t sexp[1024];
  __shared__ uint16_t sm[GF256_RM][GF256_KT];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) slog[i] = log_tab[i];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) sexp[i] = exp_tab[i];
  M += blockIdx.z * sM;
  X += blockIdx.z * sX;
  out += blockIdx.z * sO;

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * GF256_RM;
  const int64_t ly = blockIdx.y % lane_blocks, split = blockIdx.y / lane_blocks;
  const int64_t col = ly * blockDim.x + threadIdx.x;
  const int64_t kb = split * kper, ke = kb + kper < k ? kb + kper : k;
  const bool active = col < lanes;
  V acc[GF256_RM];
#pragma unroll
  for (int r = 0; r < GF256_RM; ++r) acc[r] = vzero<V>();

  for (int64_t k0 = kb; k0 < ke; k0 += GF256_KT) {
    const int kn = static_cast<int>(ke - k0 < GF256_KT ? ke - k0 : GF256_KT);
    __syncthreads();  // tables loaded; the previous tile is no longer read
    for (int e = threadIdx.x; e < GF256_RM * GF256_KT; e += blockDim.x) {
      const int r = e / GF256_KT, c = e % GF256_KT;
      const int64_t row = r0 + r;
      const uint8_t coef = (row < m && c < kn) ? M[row * k + k0 + c] : 0;
      uint16_t lc = GF256_ZERO;
      if (coef) lc = slog[coef];
      sm[r][c] = lc;
    }
    __syncthreads();
    if (active) {
      const V* xc = X + k0 * lanes + col;
      for (int c = 0; c < kn; ++c) {
        uint16_t l[NB];
        byte_logs(xc[static_cast<int64_t>(c) * lanes], slog, l);
#pragma unroll
        for (int r = 0; r < GF256_RM; ++r) {
          const uint16_t lc = sm[r][c];
          if (lc != GF256_ZERO) acc[r] = vxor(acc[r], mul_logs(l, lc, sexp, V()));
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < GF256_RM; ++r) {
    const int64_t row = r0 + r;
    if (row < m) xor_out(out + row * lanes + col, acc[r], mode);
  }
}

template <typename V>
static cudaError_t launch_logexp(int64_t nb, const uint8_t* M, int64_t m, int64_t k, int64_t sM,
                                 const void* X, int64_t lanes, int64_t t, int64_t sX,
                                 const uint16_t* log_tab, const uint8_t* exp_tab, void* out,
                                 int64_t sO, int accumulate, cudaStream_t stream) {
  const int bx = lane_threads(lanes);
  const int64_t gx = (m + GF256_RM - 1) / GF256_RM;
  const int64_t lane_blocks = (lanes + bx - 1) / bx;
  const int64_t units = (k + GF256_KQ - 1) / GF256_KQ;
  const int64_t base = gx * lane_blocks * nb;
  constexpr int64_t fill = core::FILL_BLOCKS / 2;  // two waves of one block per SM: its own grid
  int64_t ksplit = base >= fill ? 1 : (fill + base - 1) / base;
  if (ksplit > units) ksplit = units;
  if (ksplit < 1) ksplit = 1;
  const int64_t kper = ((units + ksplit - 1) / ksplit) * GF256_KQ;
  if (kper) ksplit = (k + kper - 1) / kper;
  if (ksplit < 1) ksplit = 1;
  const int64_t gy = lane_blocks * ksplit;
  if (gy > 65535 || gx > 0x7fffffff || nb > 65535) return cudaErrorInvalidConfiguration;
  int mode = accumulate ? 1 : 0;
  if (ksplit > 1) {
    mode = 2;
    if (!accumulate) {
      cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>((nb - 1) * sO + m * t), stream);
      if (e != cudaSuccess) return e;
    }
  }
  gf256_logexp_kernel<V><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                                static_cast<unsigned>(nb)),
                           bx, 0, stream>>>(M, m, k, static_cast<const V*>(X), lanes, lane_blocks,
                                            kper ? kper : GF256_KQ, log_tab, exp_tab,
                                            static_cast<V*>(out), mode, sM,
                                            sX / static_cast<int64_t>(sizeof(V)),
                                            sO / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

}  // namespace nrq

// nb blocks b of M uint8 [m, pitch] at M + b*sM (pitch >= k, a multiple of
// 16, as are sM and the base), X uint8 [k, t] at X + b*sX and out uint8
// [m, t] at out + b*sO (strides in bytes); k >= 1.
extern "C" int nrq_gf256_m4r(int64_t nb, const void* M, int64_t m, int64_t k, int64_t pitch, int64_t sM,
                             const void* X, int64_t t, int64_t sX, void* out, int64_t sO, int accumulate,
                             void* stream) {
  return nrq::core::launch_core<true>(nb, static_cast<const uint8_t*>(M), m, pitch, sM,
                                      static_cast<const uint8_t*>(X), k, t, sX, static_cast<uint8_t*>(out),
                                      sO, accumulate, static_cast<cudaStream_t>(stream));
}

// M uint8 [m, k] at M + b*sM (bytes), X and out as above; log_tab uint16
// [256] (log_tab[0] = 512), exp_tab uint8 [1024] (alpha^i below 510, zero
// above).
extern "C" int nrq_gf256_logexp(int64_t nb, const void* M, int64_t m, int64_t k, int64_t sM,
                                const void* X, int64_t t, int64_t sX, const void* log_tab,
                                const void* exp_tab, void* out, int64_t sO, int accumulate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* Mb = static_cast<const uint8_t*>(M);
  const uint16_t* lt = static_cast<const uint16_t*>(log_tab);
  const uint8_t* et = static_cast<const uint8_t*>(exp_tab);
  if (nb <= 0 || m <= 0 || t <= 0) return cudaSuccess;
  if (t % 16 == 0 && sX % 16 == 0 && sO % 16 == 0 && nrq::aligned16(X) && nrq::aligned16(out))
    return nrq::launch_logexp<uint4>(nb, Mb, m, k, sM, X, t / 16, t, sX, lt, et, out, sO, accumulate, s);
  return nrq::launch_logexp<uint8_t>(nb, Mb, m, k, sM, X, t, t, sX, lt, et, out, sO, accumulate, s);
}
