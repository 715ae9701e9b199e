// Gather probes P1-P3: out[i, :] = XOR_k src[idx[i, k], :], with the source
// rows staged into shared memory by asynchronous copies.
//
// Replaces the three TPU probe kernels of tools/, which start one DMA per
// (output row, slot) row tile into VMEM and differ only in how they wait:
// - gather_v1 (tools/gather_v2_probe.py, body _v1_factory);
// - gather_v2 (tools/gather_v2_probe.py, body _v2_factory);
// - gather_db (tools/gather_db_probe.py, body _db_factory).
// They compute K1's function (gather_xor.cu); K1 reads rows straight into
// registers, these stage them through shared memory first.
//
// What bounds them on the H100: device-memory bytes, as for K1 (n*w*t bytes
// of random source rows read, n*t written, one XOR per byte).  What the
// probes vary is the copy engine and the completion wait in front of the
// XOR.  TPU -> Hopper mapping:
//   pltpu.make_async_copy(...).start()  -> cp.async.bulk (one row tile, one
//                                          instruction) or cp.async (16 bytes
//                                          per thread)
//   DMA semaphore                        -> mbarrier in shared memory
//   v1 mode 0: waiter.wait() per copy    -> one mbarrier per copy, each
//                                          expecting its tile's bytes; every
//                                          thread waits on each in turn
//   v1 mode 1: semaphore_wait(R*w)       -> cp.async 16-byte copies by every
//                                          thread, each thread's copies
//                                          counted as one arrival
//                                          (cp.async.mbarrier.arrive.noinc);
//                                          one wait counted in arrivals
//   v1 mode 2: semaphore_wait(bytes)     -> cp.async.bulk per copy, one
//                                          mbarrier counted in bytes
//                                          (arrive.expect_tx); one wait
//   v2: skip sentinel, host cnt[i]       -> v1 mode 2 with no copy for a
//                                          sentinel slot, which reads as zero;
//                                          the device counts the slots too and
//                                          waits on its own count, flagging
//                                          *cnt_err when the host's differs
//                                          (a wrong cnt never hangs the card)
//   db: two VMEM slots, sequential grid  -> two shared-memory stages with one
//                                          mbarrier each; a block owns one
//                                          t-tile and sweeps its row blocks,
//                                          issuing step i's copies before it
//                                          reduces step i-1
//
// Tiles (the TPU's R in {8,16,32} x tw up to 40960 needs up to 10 MB of VMEM;
// a block has 227 KB):
// - R output rows per block, 1 <= R <= 32, chosen by the caller (default 8);
//   any n, the last row block is a tail;
// - tw bytes of each row per copy: the largest multiple of 16 with
//   R*w*tw <= 64 KB (v1, v2) or <= 32 KB per stage (db), capped at t; the last
//   t-tile is a tail;
// - R*w <= 1024 slots;
// - 256 threads; v1/v2 grid = (ceil(n/R), ceil(t/tw));
// - db grid = (ceil(t/tw), sweeps): the row blocks of a tile are split into
//   sweeps of at least 4 steps so that about 264 blocks (2 per SM) run.
// Bulk copies need 16-byte sizes and addresses: t % 16 == 0 and 16-byte
// aligned src and out, else the launch is refused (K1 takes ragged widths).
// An index outside [0, S) copies nothing, reads as zero and sets *err.
#include "common.cuh"

namespace nrq {
namespace probe {

constexpr int THREADS = 256;
constexpr int64_t STAGE_BYTES = 64 * 1024;
constexpr int64_t DB_STAGE_BYTES = 32 * 1024;
constexpr int MAX_R = 32;
constexpr int MAX_SLOTS = 1024;
constexpr int64_t DB_TARGET_BLOCKS = 264;
constexpr int64_t DB_MIN_STEPS = 4;
constexpr int32_t SKIP = -2;  // a sentinel slot: no copy, zero, not counted
constexpr int32_t BAD = -1;   // an index outside [0, S): no copy, zero, flagged

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// One arrival, and `bytes` more expected from copies that complete on `bar`.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// Generic-proxy accesses of shared memory before async-proxy writes after.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(saddr(dst)), "l"(src) : "memory");
}
// The executing thread's cp.async copies arrive on `bar` once they have landed.
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(saddr(bar)) : "memory");
}

// The indices of `nslots` slots (rows row0.. of idx) into shared memory:
// a sentinel becomes SKIP (when sentinel >= 0), an index outside [0, S) BAD.
__device__ __forceinline__ void load_indices(int32_t* sidx, const int32_t* __restrict__ idx,
                                             int64_t row0, int w, int nslots, int64_t S,
                                             int32_t sentinel, int* err) {
  const int32_t* ix = idx + row0 * w;
  for (int e = threadIdx.x; e < nslots; e += blockDim.x) {
    int32_t r = ix[e];
    if (sentinel >= 0 && r == sentinel) {
      r = SKIP;
    } else if (r < 0 || r >= S) {
      *err = 1;  // every writer stores the same value, so the race is benign
      r = BAD;
    }
    sidx[e] = r;
  }
}

// Warp 0: count the slots to copy, post their bytes on `bar` with this
// thread's arrival, then issue one bulk copy per slot.  Returns the number of
// slots that are not SKIP (the device's own count of v2).
__device__ __forceinline__ int issue_bulk(uint8_t* stage, const int32_t* sidx, int nslots,
                                          const uint8_t* __restrict__ src, int64_t t, int64_t col0,
                                          int tb, int tw, uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  int ncopy = 0, counted = 0;
  for (int b = 0; b < nslots; b += 32) {
    const int32_t r = b + lane < nslots ? sidx[b + lane] : SKIP;
    ncopy += __popc(__ballot_sync(0xffffffffu, r >= 0));
    counted += __popc(__ballot_sync(0xffffffffu, r != SKIP));
  }
  if (lane == 0) bar_expect(bar, static_cast<uint32_t>(ncopy) * tb);
  __syncwarp();
  for (int e = lane; e < nslots; e += 32) {
    const int32_t r = sidx[e];
    if (r >= 0) bulk_copy(stage + static_cast<int64_t>(e) * tw, src + r * t + col0, tb, bar);
  }
  return counted;
}

// XOR the w staged slots of each of `rows` rows into out (row0, col0 already
// applied to obase); slot e = r*w + k holds tb bytes at stage + e*tw.
__device__ __forceinline__ void reduce_rows(const uint8_t* stage, const int32_t* sidx, int rows,
                                            int w, int tw, int tb, uint8_t* __restrict__ obase,
                                            int64_t t) {
  const int lanes = tb / 16;
  for (int p = threadIdx.x; p < rows * lanes; p += blockDim.x) {
    const int r = p / lanes, c = p - r * lanes;
    uint4 acc = vzero<uint4>();
    for (int k = 0; k < w; ++k) {
      const int e = r * w + k;
      if (sidx[e] >= 0)
        acc = vxor(acc, *reinterpret_cast<const uint4*>(stage + static_cast<int64_t>(e) * tw + c * 16));
    }
    reinterpret_cast<uint4*>(obase + r * t)[c] = acc;
  }
}

__host__ __device__ __forceinline__ int64_t align8(int64_t x) { return (x + 7) / 8 * 8; }

// v1 (MODE 0, 1, 2) and v2 (V2): one row block x one t-tile per block.
template <int MODE, bool V2>
__global__ void __launch_bounds__(THREADS)
    gather_stage_kernel(const uint8_t* __restrict__ src, int64_t S, int64_t t,
                        const int32_t* __restrict__ idx, int64_t n, int w, int R, int tw,
                        const int32_t* __restrict__ cnt, int32_t sentinel,
                        uint8_t* __restrict__ out, int* err, int* cnt_err) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int slots = R * w;
  uint8_t* stage = smem;
  int32_t* sidx = reinterpret_cast<int32_t*>(smem + static_cast<int64_t>(slots) * tw);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + align8(static_cast<int64_t>(slots) * tw + 4 * slots));

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int rows = static_cast<int>(n - row0 < R ? n - row0 : R);
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * tw;
  const int tb = static_cast<int>(t - col0 < tw ? t - col0 : tw);
  const int nslots = rows * w;

  load_indices(sidx, idx, row0, w, nslots, S, V2 ? sentinel : -1, err);
  const int nbar = MODE == 0 ? nslots : 1;
  for (int b = threadIdx.x; b < nbar; b += blockDim.x)
    bar_init(&bars[b], MODE == 1 ? blockDim.x : 1);
  bar_init_fence();
  __syncthreads();

  if (MODE == 0) {
    if (threadIdx.x < 32) {
      for (int e = threadIdx.x; e < nslots; e += 32) {
        const int32_t r = sidx[e];
        if (r >= 0) {
          bar_expect(&bars[e], tb);
          bulk_copy(stage + static_cast<int64_t>(e) * tw, src + r * t + col0, tb, &bars[e]);
        }
      }
    }
    for (int e = 0; e < nslots; ++e)
      if (sidx[e] >= 0) bar_wait(&bars[e], 0);
  } else if (MODE == 1) {
    const int lanes = tb / 16;
    for (int q = threadIdx.x; q < nslots * lanes; q += blockDim.x) {
      const int e = q / lanes, c = q - e * lanes;
      const int32_t r = sidx[e];
      if (r >= 0) copy16(stage + static_cast<int64_t>(e) * tw + c * 16, src + r * t + col0 + c * 16);
    }
    copies_arrive(&bars[0]);
    bar_wait(&bars[0], 0);
  } else {
    if (threadIdx.x < 32) {
      const int counted = issue_bulk(stage, sidx, nslots, src, t, col0, tb, tw, &bars[0]);
      if (V2 && threadIdx.x == 0 && counted != cnt[blockIdx.x]) *cnt_err = 1;
    }
    bar_wait(&bars[0], 0);
  }
  reduce_rows(stage, sidx, rows, w, tw, tb, out + row0 * t + col0, t);
}

// db: one t-tile per block; the block sweeps row blocks [q0, q1) through two
// stages, issuing step q's copies before it reduces step q-1.
__global__ void __launch_bounds__(THREADS)
    gather_db_kernel(const uint8_t* __restrict__ src, int64_t S, int64_t t,
                     const int32_t* __restrict__ idx, int64_t n, int w, int R, int tw,
                     int64_t per, uint8_t* __restrict__ out, int* err) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int slots = R * w;
  const int64_t sbytes = static_cast<int64_t>(slots) * tw;
  uint8_t* stages[2] = {smem, smem + sbytes};
  int32_t* sidxs[2] = {reinterpret_cast<int32_t*>(smem + 2 * sbytes),
                       reinterpret_cast<int32_t*>(smem + 2 * sbytes) + slots};
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + align8(2 * sbytes + 8 * slots));

  const int64_t nsteps = (n + R - 1) / R;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * per;
  const int64_t q1 = q0 + per < nsteps ? q0 + per : nsteps;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * tw;
  const int tb = static_cast<int>(t - col0 < tw ? t - col0 : tw);

  if (threadIdx.x < 2) bar_init(&bars[threadIdx.x], 1);
  bar_init_fence();
  __syncthreads();
  for (int64_t q = q0; q <= q1; ++q) {
    if (q < q1) {  // issue step q into stage (q - q0) & 1
      const int s = static_cast<int>((q - q0) & 1);
      const int64_t row0 = q * R;
      const int nslots = static_cast<int>(n - row0 < R ? n - row0 : R) * w;
      load_indices(sidxs[s], idx, row0, w, nslots, S, -1, err);
      __syncthreads();
      if (threadIdx.x < 32) {
        fence_async_smem();
        issue_bulk(stages[s], sidxs[s], nslots, src, t, col0, tb, tw, &bars[s]);
      }
    }
    if (q > q0) {  // reduce step q - 1: the ((q-1-q0) >> 1)-th use of its stage
      const int64_t p = q - 1 - q0;
      const int s = static_cast<int>(p & 1);
      const int64_t row0 = (q - 1) * R;
      const int rows = static_cast<int>(n - row0 < R ? n - row0 : R);
      bar_wait(&bars[s], static_cast<uint32_t>((p >> 1) & 1));
      reduce_rows(stages[s], sidxs[s], rows, w, tw, tb, out + row0 * t + col0, t);
    }
    __syncthreads();  // stage and indices of step q - 1 are free for step q + 1
  }
}

static bool takes(const void* src, int64_t t, const void* idx, int64_t n, int64_t w, int R,
                  const void* out) {
  return src && idx && out && n > 0 && t > 0 && t % 16 == 0 && aligned16(src) &&
         aligned16(out) && R >= 1 && R <= MAX_R && w >= 1 && R * w <= MAX_SLOTS;
}

static int tile_width(int64_t t, int slots, int64_t budget) {
  const int64_t tw = budget / slots / 16 * 16;
  return static_cast<int>(tw < t ? tw : t);
}

template <typename K>
static cudaError_t launch(K kernel, dim3 grid, int64_t smem, cudaStream_t stream,
                          const uint8_t* src, int64_t S, int64_t t, const int32_t* idx, int64_t n,
                          int w, int R, int tw, const int32_t* cnt, int32_t sentinel, uint8_t* out,
                          int* err, int* cnt_err) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, stream>>>(src, S, t, idx, n, w, R, tw, cnt, sentinel, out, err,
                                          cnt_err);
  return cudaGetLastError();
}

static cudaError_t launch_stage(int mode, bool v2, const void* src, int64_t S, int64_t t,
                                const void* idx, int64_t n, int64_t w, int R, const void* cnt,
                                int32_t sentinel, void* out, void* err, void* cnt_err,
                                void* stream) {
  if (!takes(src, t, idx, n, w, R, out) || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  const int slots = R * static_cast<int>(w);
  const int tw = tile_width(t, slots, STAGE_BYTES);
  const int64_t gx = (n + R - 1) / R, gy = (t + tw - 1) / tw;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidConfiguration;
  const int nbar = mode == 0 ? slots : 1;
  const int64_t smem = align8(static_cast<int64_t>(slots) * tw + 4 * slots) + 8 * nbar;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const uint8_t*>(src);
  const auto* ip = static_cast<const int32_t*>(idx);
  const auto* cp = static_cast<const int32_t*>(cnt);
  auto* op = static_cast<uint8_t*>(out);
  auto* ep = static_cast<int*>(err);
  auto* cep = static_cast<int*>(cnt_err);
  const int wi = static_cast<int>(w);
  if (v2)
    return launch(gather_stage_kernel<2, true>, grid, smem, s, sp, S, t, ip, n, wi, R, tw, cp,
                  sentinel, op, ep, cep);
  if (mode == 0)
    return launch(gather_stage_kernel<0, false>, grid, smem, s, sp, S, t, ip, n, wi, R, tw, cp,
                  sentinel, op, ep, cep);
  if (mode == 1)
    return launch(gather_stage_kernel<1, false>, grid, smem, s, sp, S, t, ip, n, wi, R, tw, cp,
                  sentinel, op, ep, cep);
  return launch(gather_stage_kernel<2, false>, grid, smem, s, sp, S, t, ip, n, wi, R, tw, cp,
                sentinel, op, ep, cep);
}

}  // namespace probe
}  // namespace nrq

// All: src uint8 [S, t], idx int32 [n, w], out uint8 [n, t], contiguous,
// t % 16 == 0, src and out 16-byte aligned, 1 <= R <= 32, R*w <= 1024.
// err: one device int32, set to 1 when an index lies outside [0, S).
extern "C" int nrq_gather_v1(const void* src, int64_t S, int64_t t, const void* idx, int64_t n,
                             int64_t w, int mode, int R, void* out, void* err, void* stream) {
  return nrq::probe::launch_stage(mode, false, src, S, t, idx, n, w, R, nullptr, -1, out, err,
                                  nullptr, stream);
}

// cnt int32 [ceil(n/R)]: the host's count of non-sentinel slots per row
// block; cnt_err: one device int32, set to 1 where the device counts otherwise.
extern "C" int nrq_gather_v2(const void* src, int64_t S, int64_t t, const void* idx, int64_t n,
                             int64_t w, const void* cnt, int sentinel, int R, void* out, void* err,
                             void* cnt_err, void* stream) {
  if (!cnt || !cnt_err || sentinel < 0 || sentinel >= S) return cudaErrorInvalidValue;
  return nrq::probe::launch_stage(2, true, src, S, t, idx, n, w, R, cnt, sentinel, out, err,
                                  cnt_err, stream);
}

extern "C" int nrq_gather_db(const void* src, int64_t S, int64_t t, const void* idx, int64_t n,
                             int64_t w, int R, void* out, void* err, void* stream) {
  using namespace nrq::probe;
  if (!takes(src, t, idx, n, w, R, out)) return cudaErrorInvalidValue;
  const int slots = R * static_cast<int>(w);
  const int tw = tile_width(t, slots, DB_STAGE_BYTES);
  const int64_t tiles = (t + tw - 1) / tw, nsteps = (n + R - 1) / R;
  const int64_t want = (DB_TARGET_BLOCKS + tiles - 1) / tiles;  // sweeps per tile
  int64_t per = (nsteps + want - 1) / want;
  if (per < DB_MIN_STEPS) per = DB_MIN_STEPS;
  const int64_t sweeps = (nsteps + per - 1) / per;
  if (tiles > 0x7fffffff || sweeps > 65535) return cudaErrorInvalidConfiguration;
  const int64_t smem = align8(2 * static_cast<int64_t>(slots) * tw + 8 * slots) + 16;
  cudaError_t e = cudaFuncSetAttribute(gather_db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  gather_db_kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(sweeps)), THREADS,
                     smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), S, t, static_cast<const int32_t*>(idx), n,
      static_cast<int>(w), R, tw, per, static_cast<uint8_t*>(out), static_cast<int*>(err));
  return cudaGetLastError();
}
