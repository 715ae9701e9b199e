// K3 gf256_matmul: out[r, :] (^)= XOR_c M[r, c] (x) X[c, :]   over GF(256), poly 0x11D
//
// Replaces the TPU kernel gf256_matmul_pallas (nanorq_tpu/ops/pallas_kernels.py,
// gf256_matmul_pallas with its bodies _gf256_kernel / _gf256_kernel_1k and the
// host layouts companion_bits_planar / gf256_mb / companion_bits_blocked),
// which expands M into an [8m, 8k] companion-bit matrix and runs it as a
// GF(2) bit-plane matmul on the MXU.
//
// Here M stays a byte matrix -- no 64x companion expansion -- and products
// come from log/exp tables in shared memory, built by the caller from
// nanorq_tpu/gf256/tables.py: a (x) b = exp[log a + log b], with log[0] a
// sentinel (512) that lands in the zero upper half of the 1024-entry exp
// table, so a zero payload byte needs no branch.  What bounds it on the H100:
// shared-memory lookups, one per payload byte per nonzero coefficient
// (m*k*t in all); device memory moves (m/RM)*k*t bytes through L2.  Design:
// a block owns RM output rows times a span of 16-byte lanes; per column c
// each thread loads X[c] for its lane once, turns its 16 bytes into logs
// once, and reuses them for all RM rows (16 exp lookups per row).  The RM
// rows' coefficients are staged per k-tile in shared memory as logs, with
// zero coefficients flagged and skipped; every thread tests the same flag,
// so the branch never diverges.
// Grid z is a block axis: nb independent products M_b (x) X_b, each at its own
// byte offset (strides sM, sX, sO), in one launch -- the batched residual
// decode (the JAX package vmaps it, nanorq_tpu/ops/wpath.py _res_batch_jit).
// A 2-D call is nb = 1.
#include "common.cuh"

namespace nrq {

constexpr int GF256_RM = 8;    // output rows per block
constexpr int GF256_KT = 256;  // k columns staged per tile
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

template <typename V>
__global__ void gf256_matmul_kernel(const uint8_t* __restrict__ M, int64_t m, int64_t k,
                                    const V* __restrict__ X, int64_t lanes,
                                    const uint16_t* __restrict__ log_tab,
                                    const uint8_t* __restrict__ exp_tab, V* __restrict__ out,
                                    int accumulate, int64_t sM, int64_t sX, int64_t sO) {
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
  const int64_t col = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const bool active = col < lanes;
  V acc[GF256_RM];
#pragma unroll
  for (int r = 0; r < GF256_RM; ++r) acc[r] = vzero<V>();

  for (int64_t k0 = 0; k0 < k; k0 += GF256_KT) {
    const int kn = static_cast<int>(k - k0 < GF256_KT ? k - k0 : GF256_KT);
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
    if (row < m) {
      V* o = out + row * lanes + col;
      *o = accumulate ? vxor(*o, acc[r]) : acc[r];
    }
  }
}

template <typename V>
static cudaError_t launch_gf256(int64_t nb, const uint8_t* M, int64_t m, int64_t k, int64_t sM,
                                const void* X, int64_t lanes, int64_t sX,
                                const uint16_t* log_tab, const uint8_t* exp_tab, void* out,
                                int64_t sO, int accumulate, cudaStream_t stream) {
  const int bx = lane_threads(lanes);
  const int64_t gx = (m + GF256_RM - 1) / GF256_RM;
  const int64_t gy = (lanes + bx - 1) / bx;
  if (gy > 65535 || gx > 0x7fffffff || nb > 65535) return cudaErrorInvalidConfiguration;
  gf256_matmul_kernel<V><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                                static_cast<unsigned>(nb)),
                           bx, 0, stream>>>(M, m, k, static_cast<const V*>(X), lanes, log_tab,
                                            exp_tab, static_cast<V*>(out), accumulate, sM,
                                            sX / static_cast<int64_t>(sizeof(V)),
                                            sO / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

}  // namespace nrq

// nb blocks b of M uint8 [m, k] at M + b*sM, X uint8 [k, t] at X + b*sX and
// out uint8 [m, t] at out + b*sO (strides in bytes; each matrix contiguous);
// log_tab uint16 [256] (log_tab[0] = 512), exp_tab uint8 [1024] (alpha^i below
// 510, zero above).
extern "C" int nrq_gf256_matmul(int64_t nb, const void* M, int64_t m, int64_t k, int64_t sM,
                                const void* X, int64_t t, int64_t sX, const void* log_tab,
                                const void* exp_tab, void* out, int64_t sO, int accumulate,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* Mb = static_cast<const uint8_t*>(M);
  const uint16_t* lt = static_cast<const uint16_t*>(log_tab);
  const uint8_t* et = static_cast<const uint8_t*>(exp_tab);
  if (t % 16 == 0 && sX % 16 == 0 && sO % 16 == 0 && nrq::aligned16(X) && nrq::aligned16(out))
    return nrq::launch_gf256<uint4>(nb, Mb, m, k, sM, X, t / 16, sX, lt, et, out, sO, accumulate,
                                    s);
  return nrq::launch_gf256<uint8_t>(nb, Mb, m, k, sM, X, t, sX, lt, et, out, sO, accumulate, s);
}
