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
// What bounds them on the H100: device-memory bytes, as for K1 (the distinct
// source rows read, n*t written, one XOR per byte); a wide gather reads its
// n*w*t gathered bytes from L2.  What the probes vary is the copy engine and
// the completion wait in front of the XOR.  TPU -> Hopper mapping:
//   pltpu.make_async_copy(...).start()  -> cp.async.bulk (one row tile, one
//                                          instruction) or cp.async (16 bytes
//                                          per thread)
//   DMA semaphore                        -> mbarrier in shared memory
//   v1 mode 0: waiter.wait() per copy    -> one mbarrier per copy, each
//                                          expecting its tile's bytes; a
//                                          consumer waits on the w of its row
//   v1 mode 1: semaphore_wait(R*w)       -> cp.async 16-byte copies by the
//                                          producer threads, each thread's
//                                          copies counted as one arrival
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
//   db: two VMEM slots, sequential grid  -> two shared-memory stages, a full
//                                          and an empty mbarrier each; a block
//                                          owns one t-tile and sweeps a run
//                                          of its row blocks in order: the
//                                          producer warp issues step i's
//                                          copies while the consumer warps
//                                          reduce step i-1
//
// v1 and v2 are one persistent pipeline (gather_stage_kernel):
// - a tile is the caller's R rows (1 <= R <= 32, default 8; the last row
//   block is a tail) by cw bytes of t (the last t-tile is a tail), and the
//   ring takes it in steps of rs rows (ring_plan states the rule for cw and
//   rs: a tile is one step where its copies stay at the least copy size or
//   above, else fewer rows per step rather than narrower copies).  At width 1
//   consecutive tiles walk one row block's column chunks (long runs in device
//   memory); wider, one column chunk's row blocks, so that the resident
//   blocks read one column chunk of the source and find in L2 a row that many
//   output rows read;
// - a 1-D grid of RING_BLOCKS_PER_SM blocks per SM; the tiles are dealt round
//   the blocks (block, block + blocks, ...), or, where a launch has few
//   tiles, its single steps, so that R sets the tails and v2's counts and
//   not how far a small launch spreads;
// - a ring of RING_NS stages of up to RING_STAGE bytes, a step each, each
//   with a "full" and an "empty" mbarrier whose phases both sides follow by
//   parity, set up once per block;
// - producers (one warp; four for mode 1, where a copy moves 16 bytes and
//   no more): a step's indices, loaded one step ahead so that their way from
//   device memory is off the chain, are classed (a row, SKIP, BAD) into the
//   stage's own strip, its bytes are posted and its copies issued, a lane per
//   slot, while the consumers reduce earlier steps; v2's count of a row block
//   is taken here, once, behind the copies of the block's first step;
// - consumers (eight warps): a warp per row, the rows dealt round over the
//   steps so that every warp works whatever rs is; a row's classes are read
//   once and shared by shuffles, no division in the loop, 16-byte stores from
//   registers; the warp then arrives on the stage's empty barrier;
// - width 1 has no register pass: one warp stores each landed slot straight
//   from its stage to out with a bulk store (evict-first in L2: the row is
//   written once), a SKIP or BAD slot from a strip of zeros, and releases the
//   stage once the store has read it.
// Measured and not kept (PERF.md): an output strip in shared memory drained by
// one bulk store per row, the copy engine's XOR into out
// (cp.reduce.async.bulk), a block's tiles in one run, evict-first loads.
//
// db is a warp-specialised two-stage sweep (gather_db_kernel; db_plan states
// the rule):
// - a block owns one t-tile of cw bytes and one sweep: a contiguous run of
//   `per` row blocks of that tile, taken in order, in steps of rs rows that
//   never cross a row block, through two stages of up to DB_STAGE bytes (48
//   KB: two stages, two blocks per SM).  cw and rs follow the ring's rule
//   (copies of the least size or more, else fewer rows per step), rs then
//   evened out over the row block's steps;
// - the grid is tiles x sweeps, the sweeps of one tile next to each other in
//   launch order, so that the resident blocks read few column chunks of the
//   source and find in L2 a row that many output rows read; a sweep is about
//   DB_SWEEP_STEPS steps, fewer where the launch would not fill the card (down
//   to one row block), so a small launch still spreads;
// - one producer warp, eight consumer warps, a "full" and an "empty" mbarrier
//   per stage, set up once per block and followed by parity.  The full
//   barrier is the stage's "armed" barrier: every consumer warp waits for it
//   in every step, whether it has a row there or not, so no warp runs a
//   phase ahead of a barrier it did not wait for;
// - the producer loads step q+1's indices before it waits for step q's stage,
//   classes step q's into the stage's strip, posts the bytes and issues one
//   bulk copy per slot, a lane per slot; the consumers reduce a row per warp
//   (reduce_row) and store 16 bytes a lane from registers;
// - width 1 takes the same register route, not the ring's bulk store from
//   the stage: one body, and the bulk-store route measured no faster than
//   loads and stores through registers (PERF.md).
// All three: R*w <= 1024 slots.  Bulk copies need 16-byte sizes and
// addresses: t % 16 == 0 and 16-byte aligned src and out, else the launch is
// refused (K1 takes ragged widths).  An index outside [0, S) copies nothing,
// reads as zero and sets *err.
#include "common.cuh"

namespace nrq {
namespace probe {

constexpr int MAX_R = 32;
constexpr int MAX_SLOTS = 1024;
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

// --- v1 and v2: a persistent ring of stages --------------------------------

constexpr int CONSUMER_WARPS = 8;  // a power of two: the rows are dealt round by a mask
constexpr int BULK_PRODUCER_WARPS = 1;   // modes 0 and 2, v2: one lane issues one bulk copy
// mode 1: a cp.async moves 16 bytes, so a 32 KB stage is 2048 of them; four
// warps issue them at 16 a thread, and leave the consumers their issue slots
constexpr int ASYNC_PRODUCER_WARPS = 4;
constexpr int ASYNC_PRODUCER_THREADS = ASYNC_PRODUCER_WARPS * 32;
constexpr int64_t SMEM_MAX = 232448;  // 227 KB: what one block may have

__host__ __device__ constexpr int producer_warps(int mode) {
  return mode == 1 ? ASYNC_PRODUCER_WARPS : BULK_PRODUCER_WARPS;
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
// Shared -> global under an L2 eviction policy, tracked by the executing
// thread's bulk groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::"l"(dst),
               "r"(saddr(src)), "r"(bytes), "l"(policy)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Until all but the executing thread's newest N bulk groups have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// One index as a slot's class: the row to copy, SKIP or BAD.
__device__ __forceinline__ int32_t classify(int32_t r, int64_t S, int32_t sentinel, int* err) {
  if (sentinel >= 0 && r == sentinel) return SKIP;
  if (r < 0 || r >= S) {
    *err = 1;  // every writer stores the same value, so the race is benign
    return BAD;
  }
  return r;
}

// What a launch of the ring is cut into (ring_plan below states the rule).
struct Ring {
  int64_t n, t, row_blocks, chunks;
  int64_t units;  // steps of the launch: tiles * spt (a tail row block leaves some empty)
  int w, R;
  int spt;  // steps of a tile: ceil(R / rs)
  int deal;  // steps a block takes in a row: spt (whole tiles) or 1
  int rs;   // rows of one step (one stage of the ring)
  int cw;   // bytes of one copy: the t-tile's width
  int sps;  // slots of one step: rs * w
  int ns;   // stages
  int strip_bytes;  // width 1: the strip of zeros, cw bytes
};

// q = x / d, r = x % d; in 32 bits where both fit (a 64-bit division is a
// call into a long routine).
__device__ __forceinline__ void divmod(int64_t x, int64_t d, int64_t& q, int64_t& r) {
  if (((x | d) >> 32) == 0) {
    const uint32_t xs = static_cast<uint32_t>(x), ds = static_cast<uint32_t>(d);
    q = xs / ds, r = xs % ds;
  } else {
    q = x / d, r = x % d;
  }
}

// The steps of this block in order, for the producer and the consumers
// alike.  The launch is g.units steps, tile after tile (a tile: a row block
// of R rows x a t-tile of cw bytes, in g.spt steps of rs rows); the block
// takes runs of g.deal steps, runs blockIdx.x, blockIdx.x + gridDim.x, ...:
// whole tiles, or single steps where the launch has few tiles, so that it
// still spreads over the card.  next() moves to the first or the
// next step that has rows; the producer's next() is on the chain from one
// step's copies to the next one's, so it divides nothing.
struct Step {
  int s = -1;                // the step's stage ...
  uint32_t ph = 0;           // ... and the parity of this use of it
  int64_t rb = 0, row0 = 0, col0 = 0;  // row block; first row and byte of the step
  int nrow = 0, cb = 0;      // rows and bytes of the step
  bool counts = false;       // the first step of a row block's first tile: v2's count is checked here
};

struct Steps : Step {
  const Ring& g;
  int64_t unit;           // the next step to look at: (b * dim + a) * g.spt + sub
  int64_t dim, a, b;      // dim: the extent of the tile coordinate that runs first
  int64_t jump, jump_a, jump_b;  // from a run's last step to the block's next run, and its parts
  int sub, jump_sub;
  int k = 0;              // steps taken of the current run of g.deal

  __device__ explicit Steps(const Ring& g_) : g(g_), unit(static_cast<int64_t>(blockIdx.x) * g_.deal) {
    dim = g.w == 1 ? g.chunks : g.row_blocks;
    int64_t tile, part;
    divmod(unit, g.spt, tile, part);
    sub = static_cast<int>(part);
    divmod(tile, dim, b, a);
    jump = (static_cast<int64_t>(gridDim.x) - 1) * g.deal + 1;
    divmod(jump, g.spt, tile, part);
    jump_sub = static_cast<int>(part);
    divmod(tile, dim, jump_b, jump_a);
  }
  __device__ bool next() {
    for (;; advance()) {
      if (unit >= g.units) return false;
      rb = g.w == 1 ? b : a;
      const int rows = static_cast<int>(g.n - rb * g.R < g.R ? g.n - rb * g.R : g.R);
      const int r0 = sub * g.rs;
      if (r0 >= rows) continue;  // a tail row block has fewer steps
      const int64_t cc = g.w == 1 ? a : b;
      row0 = rb * g.R + r0;
      nrow = rows - r0 < g.rs ? rows - r0 : g.rs;
      col0 = cc * g.cw;
      cb = static_cast<int>(g.t - col0 < g.cw ? g.t - col0 : g.cw);
      counts = sub == 0 && cc == 0;
      if (++s == g.ns) {
        s = 0;
        ph ^= 1;
      }
      advance();
      return true;
    }
  }
  // To the block's next step, with no division: the next of its run (a run
  // of g.spt is a tile, so it stays inside it), or the first of its next
  // run, each coordinate carrying into the next.
  __device__ void advance() {
    if (++k < g.deal) {
      ++unit, ++sub;
      return;
    }
    k = 0;
    unit += jump;
    sub += jump_sub;
    a += jump_a;
    b += jump_b;
    if (sub >= g.spt) sub -= g.spt, ++a;
    if (a >= dim) a -= dim, ++b;
  }
};

// One warp: dst[0, cb) = XOR over the row's w slots (slot k at slots + k*cw)
// of those whose class is a row.  Lane l holds the class of slot k0 + l and
// the warp shares it by shuffles; each lane keeps U 16-byte lanes, 512 bytes
// apart, so a warp's loads and stores are 512-byte runs.
__device__ __forceinline__ void reduce_row(const uint8_t* slots, const int32_t* cls, int w, int cw,
                                           int cb, uint8_t* dst, int lane) {
  constexpr int U = 4;
  for (int base = 0; base < cb; base += 512 * U) {
    const int c0 = base + lane * 16;
    uint4 acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = vzero<uint4>();
    for (int k0 = 0; k0 < w; k0 += 32) {
      const int32_t mine = k0 + lane < w ? cls[k0 + lane] : SKIP;
      const int m = w - k0 < 32 ? w - k0 : 32;
      for (int k = 0; k < m; ++k) {
        if (__shfl_sync(0xffffffffu, mine, k) < 0) continue;  // the whole warp
        const uint8_t* p = slots + static_cast<int64_t>(k0 + k) * cw + c0;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c0 + u * 512 < cb) acc[u] = vxor(acc[u], *reinterpret_cast<const uint4*>(p + u * 512));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u * 512 < cb) *reinterpret_cast<uint4*>(dst + c0 + u * 512) = acc[u];
  }
}

// v1 (MODE 0, 1, 2) and v2 (V2): see the header.
template <int MODE, bool V2>
__global__ void __launch_bounds__((CONSUMER_WARPS + producer_warps(MODE)) * 32)
    gather_stage_kernel(const uint8_t* __restrict__ src, int64_t S,
                        const int32_t* __restrict__ idx, const Ring g,
                        const int32_t* __restrict__ cnt, int32_t sentinel,
                        uint8_t* __restrict__ out, int* err, int* cnt_err) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int64_t stage_bytes = static_cast<int64_t>(g.sps) * g.cw;
  uint8_t* stages = smem;
  uint8_t* strip = smem + g.ns * stage_bytes;  // w == 1: zeros
  uint64_t* full = reinterpret_cast<uint64_t*>(strip + g.strip_bytes);
  uint64_t* empty = full + g.ns;
  uint64_t* slotbar = empty + g.ns;  // MODE 0: one per slot of every stage
  int32_t* sidx = reinterpret_cast<int32_t*>(slotbar + (MODE == 0 ? g.ns * g.sps : 0));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool copy_only = g.w == 1;  // a width-1 gather is a copy: no register pass
  const int64_t t = g.t;
  const int nbar = 2 * g.ns + (MODE == 0 ? g.ns * g.sps : 0);
  for (int b = tid; b < nbar; b += blockDim.x) {
    uint32_t count = 1;  // full: the producer's arrival; a slot's: its lane's
    if (b < g.ns && MODE == 1) count = ASYNC_PRODUCER_THREADS + 1;
    if (b >= g.ns && b < 2 * g.ns) count = copy_only ? 1 : CONSUMER_WARPS;  // empty
    bar_init(&full[b], count);
  }
  if (copy_only) {
    for (int i = tid * 16; i < g.strip_bytes; i += blockDim.x * 16)
      *reinterpret_cast<uint4*>(strip + i) = vzero<uint4>();
    fence_async_smem();  // bulk stores read the zeros
  }
  bar_init_fence();
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producers: a step's indices, its expected bytes, its copies.  The
    // indices of the step after are loaded (into registers, the first PF*32
    // or 128 of them) before this step's stage is waited for, so that their
    // way from device memory is not on the chain from one step to the next.
    Steps ahead(g);
    bool more = ahead.next();
    if constexpr (MODE == 1) {
      const int ptid = tid - CONSUMER_WARPS * 32, pw = ptid >> 5;
      int32_t pre = 0;
      if (more && ptid < ahead.nrow * g.w) pre = idx[ahead.row0 * g.w + ptid];
      while (more) {
        const Step st = ahead;
        const int32_t now = pre;
        more = ahead.next();
        if (more && ptid < ahead.nrow * g.w) pre = idx[ahead.row0 * g.w + ptid];
        const int s = st.s, cb = st.cb;
        bar_wait(&empty[s], st.ph ^ 1);
        const int nslots = st.nrow * g.w;
        const int32_t* ix = idx + st.row0 * g.w;
        int32_t* cls = sidx + s * g.sps;
        uint8_t* stage = stages + s * stage_bytes;
        for (int e = ptid; e < g.sps; e += ASYNC_PRODUCER_THREADS)
          cls[e] = e < nslots ? classify(e == ptid ? now : ix[e], S, -1, err) : SKIP;
        asm volatile("bar.sync 1, %0;" ::"n"(ASYNC_PRODUCER_THREADS) : "memory");
        if (ptid == 0) bar_arrive(&full[s]);  // publishes the classes
        const int lanes = cb >> 4;
        for (int e = pw; e < nslots; e += ASYNC_PRODUCER_WARPS) {
          const int32_t r = cls[e];
          if (r < 0) continue;
          const uint8_t* p = src + r * t + st.col0;
          uint8_t* d = stage + static_cast<int64_t>(e) * g.cw;
          for (int c = lane; c < lanes; c += 32) copy16(d + c * 16, p + c * 16);
        }
        copies_arrive(&full[s]);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
    } else {
      constexpr int PF = 4;
      int32_t pre[PF];
      auto prefetch = [&]() {
#pragma unroll
        for (int j = 0; j < PF; ++j) {
          const int e = j * 32 + lane;
          pre[j] = (more && e < ahead.nrow * g.w) ? idx[ahead.row0 * g.w + e] : 0;
        }
      };
      prefetch();
      while (more) {
        const Step st = ahead;
        int32_t now[PF];
#pragma unroll
        for (int j = 0; j < PF; ++j) now[j] = pre[j];
        more = ahead.next();
        prefetch();
        const int s = st.s, cb = st.cb;
        const int64_t col0 = st.col0;
        bar_wait(&empty[s], st.ph ^ 1);
        const int nslots = st.nrow * g.w;
        const int32_t* ix = idx + st.row0 * g.w;
        int32_t* cls = sidx + s * g.sps;
        uint8_t* stage = stages + s * stage_bytes;
        uint64_t* sb = slotbar + s * g.sps;
        int ncopy = 0;
        // slot e of the step, its index `raw` (unread past the step's slots)
        auto slot = [&](int e, int32_t raw) {
          const int32_t r = e < nslots ? classify(raw, S, V2 ? sentinel : -1, err) : SKIP;
          if (e < g.sps) cls[e] = r;
          if constexpr (MODE == 0) {
            if (e < g.sps) {  // every slot's barrier completes a phase in every step
              if (r >= 0) {
                bar_expect(&sb[e], cb);
                bulk_copy(stage + static_cast<int64_t>(e) * g.cw, src + r * t + col0, cb, &sb[e]);
              } else {
                bar_arrive(&sb[e]);
              }
            }
          } else {
            ncopy += __popc(__ballot_sync(0xffffffffu, r >= 0));
          }
        };
#pragma unroll
        for (int j = 0; j < PF; ++j)
          if (j * 32 < g.sps) slot(j * 32 + lane, now[j]);
        for (int b = PF * 32; b < g.sps; b += 32) slot(b + lane, b + lane < nslots ? ix[b + lane] : 0);
        if constexpr (MODE == 0) {
          // full: every slot's barrier is armed for this use.  A consumer
          // meets it before it waits for its own row's copies, so it is
          // never a whole phase ahead of a barrier it did not wait for.
          __syncwarp();
          if (lane == 0) bar_arrive(&full[s]);
        }
        if constexpr (MODE == 2) {
          __syncwarp();
          if (lane == 0) bar_expect(&full[s], static_cast<uint32_t>(ncopy) * cb);
          __syncwarp();
          for (int e = lane; e < nslots; e += 32) {
            const int32_t r = cls[e];
            if (r < 0) continue;
            bulk_copy(stage + static_cast<int64_t>(e) * g.cw, src + r * t + col0, cb, &full[s]);
          }
        }
        if (V2 && st.counts) {  // after the copies are on their way: the row block's own count
          const int64_t first = st.rb * g.R;
          const int slots = static_cast<int>(g.n - first < g.R ? g.n - first : g.R) * g.w;
          int counted = 0;
          for (int b = 0; b < slots; b += 32) {
            const bool is = b + lane < slots && idx[first * g.w + b + lane] != sentinel;
            counted += __popc(__ballot_sync(0xffffffffu, is));
          }
          if (lane == 0 && counted != cnt[st.rb]) *cnt_err = 1;
        }
      }
    }
  } else if (copy_only) {
    // ---- width 1: one warp stores each landed slot straight from its stage ----
    if (warp != 0) return;
    const uint64_t policy = evict_first_policy();  // a row is written once
    int prev = -1;
    Steps st(g);
    while (st.next()) {
      const int s = st.s;
      const int32_t* cls = sidx + s * g.sps;
      const uint8_t* stage = stages + s * stage_bytes;
      uint64_t* sb = slotbar + s * g.sps;
      bar_wait(&full[s], st.ph);
      for (int e = lane; e < st.nrow; e += 32) {
        if (MODE == 0) bar_wait(&sb[e], st.ph);
        const uint8_t* from = cls[e] >= 0 ? stage + static_cast<int64_t>(e) * g.cw : strip;
        if (MODE == 1) fence_async_smem();  // cp.async wrote through the generic proxy
        bulk_store(out + (st.row0 + e) * t + st.col0, from, st.cb, policy);
      }
      bulk_commit();
      if (prev >= 0) {  // the step before has been read out of its stage: release it
        bulk_wait_read<1>();
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[prev]);
      }
      prev = s;
    }
    bulk_wait_read<0>();
  } else {
    // ---- consumers: a warp per row, the rows dealt round over the steps ----
    int rot = 0;
    Steps st(g);
    while (st.next()) {
      const int s = st.s, cb = st.cb;
      const int32_t* cls = sidx + s * g.sps;
      const uint8_t* stage = stages + s * stage_bytes;
      uint64_t* sb = slotbar + s * g.sps;
      bar_wait(&full[s], st.ph);
      for (int r = (warp - rot) & (CONSUMER_WARPS - 1); r < st.nrow; r += CONSUMER_WARPS) {
        if (MODE == 0) {  // only this row's copies
          for (int k = lane; k < g.w; k += 32) bar_wait(&sb[r * g.w + k], st.ph);
          __syncwarp();
        }
        const uint8_t* slots = stage + static_cast<int64_t>(r) * g.w * g.cw;
        reduce_row(slots, cls + r * g.w, g.w, g.cw, cb, out + (st.row0 + r) * t + st.col0, lane);
      }
      rot = (rot + st.nrow) & (CONSUMER_WARPS - 1);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }
  }
}

// --- db: a two-stage sweep of one t-tile's row blocks ------------------------

constexpr int DB_STAGES = 2;
constexpr int DB_THREADS = (CONSUMER_WARPS + BULK_PRODUCER_WARPS) * 32;
constexpr int DB_BLOCKS_PER_SM = 2;

// What a launch of db is cut into (db_plan below states the rule).
struct Db {
  int64_t n, t;
  int64_t sweeps;  // sweeps of one t-tile; block b: tile b / sweeps, sweep b % sweeps
  int64_t per;     // row blocks of one sweep
  int w, R;
  int rs;   // rows of one step (one stage)
  int cw;   // bytes of one copy: the t-tile's width
  int sps;  // slots of one step: rs * w
};

// The steps of this block in order, for the producer and the consumers alike:
// the rows [sweep * per * R, (sweep + 1) * per * R) of the block's t-tile, rs
// at a time and never across a row block, through stages 0, 1, 0, ...; the
// divisions are done once, next() adds.
struct Sweep {
  int s = DB_STAGES - 1;     // the step's stage ...
  uint32_t ph = 1;           // ... and the parity of this use of it
  int64_t row0 = 0, col0;    // first row and byte of the step
  int nrow = 0, cb;          // rows and bytes of the step
  int64_t row, rb_end, end;  // the next step's first row; the end of its row block, of the sweep
  int R, rs;

  __device__ explicit Sweep(const Db& g) : R(g.R), rs(g.rs) {
    int64_t tile, sweep;
    divmod(blockIdx.x, g.sweeps, tile, sweep);
    col0 = tile * g.cw;
    cb = static_cast<int>(g.t - col0 < g.cw ? g.t - col0 : g.cw);
    row = sweep * g.per * g.R;
    end = row + g.per * g.R < g.n ? row + g.per * g.R : g.n;
    rb_end = row + g.R < end ? row + g.R : end;
  }
  __device__ bool next() {
    if (row >= end) return false;
    row0 = row;
    nrow = static_cast<int>(rb_end - row < rs ? rb_end - row : rs);
    row += nrow;
    if (row == rb_end) rb_end = rb_end + R < end ? rb_end + R : end;
    if (++s == DB_STAGES) {
      s = 0;
      ph ^= 1;
    }
    return true;
  }
};

__global__ void __launch_bounds__(DB_THREADS, DB_BLOCKS_PER_SM)
    gather_db_kernel(const uint8_t* __restrict__ src, int64_t S, const int32_t* __restrict__ idx,
                     const Db g, uint8_t* __restrict__ out, int* err) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int64_t stage_bytes = static_cast<int64_t>(g.sps) * g.cw;
  uint8_t* stages = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DB_STAGES * stage_bytes);
  uint64_t* empty = full + DB_STAGES;
  int32_t* sidx = reinterpret_cast<int32_t*>(empty + DB_STAGES);  // a strip of classes per stage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t t = g.t;
  // full: the producer's arrival and its copies' bytes; empty: every consumer warp
  if (tid < 2 * DB_STAGES) bar_init(&full[tid], tid < DB_STAGES ? 1 : CONSUMER_WARPS);
  bar_init_fence();
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer: the next step's indices go into registers (the first
    // PF*32 of them) before this step's stage is waited for, so that their
    // way from device memory is off the chain from one step's copies to the
    // next one's ----
    constexpr int PF = 4;
    Sweep ahead(g);
    bool more = ahead.next();
    int32_t pre[PF];
    auto prefetch = [&]() {
#pragma unroll
      for (int j = 0; j < PF; ++j) {
        const int e = j * 32 + lane;
        pre[j] = (more && e < ahead.nrow * g.w) ? idx[ahead.row0 * g.w + e] : 0;
      }
    };
    prefetch();
    while (more) {
      const int s = ahead.s, cb = ahead.cb, nslots = ahead.nrow * g.w;
      const uint32_t ph = ahead.ph;
      const int64_t col0 = ahead.col0;
      const int32_t* ix = idx + ahead.row0 * g.w;
      int32_t now[PF];
#pragma unroll
      for (int j = 0; j < PF; ++j) now[j] = pre[j];
      more = ahead.next();
      prefetch();
      bar_wait(&empty[s], ph ^ 1);
      int32_t* cls = sidx + s * g.sps;
      uint8_t* stage = stages + s * stage_bytes;
      int ncopy = 0;
      // slot e of the step, its index `raw` (unread past the step's slots)
      auto slot = [&](int e, int32_t raw) {
        const int32_t r = e < nslots ? classify(raw, S, -1, err) : SKIP;
        if (e < g.sps) cls[e] = r;
        ncopy += __popc(__ballot_sync(0xffffffffu, r >= 0));
      };
#pragma unroll
      for (int j = 0; j < PF; ++j)
        if (j * 32 < g.sps) slot(j * 32 + lane, now[j]);
      for (int b = PF * 32; b < g.sps; b += 32) slot(b + lane, b + lane < nslots ? ix[b + lane] : 0);
      __syncwarp();
      if (lane == 0) bar_expect(&full[s], static_cast<uint32_t>(ncopy) * cb);  // publishes the classes
      __syncwarp();
      for (int e = lane; e < nslots; e += 32) {
        const int32_t r = cls[e];
        if (r >= 0) bulk_copy(stage + static_cast<int64_t>(e) * g.cw, src + r * t + col0, cb, &full[s]);
      }
    }
  } else {
    // ---- consumers: a warp per row, the rows dealt round over the steps;
    // every warp meets every step's full barrier and releases its stage ----
    int rot = 0;
    Sweep st(g);
    while (st.next()) {
      const int s = st.s;
      const int32_t* cls = sidx + s * g.sps;
      const uint8_t* stage = stages + s * stage_bytes;
      bar_wait(&full[s], st.ph);
      for (int r = (warp - rot) & (CONSUMER_WARPS - 1); r < st.nrow; r += CONSUMER_WARPS)
        reduce_row(stage + static_cast<int64_t>(r) * g.w * g.cw, cls + r * g.w, g.w, g.cw, st.cb,
                   out + (st.row0 + r) * t + st.col0, lane);
      rot = (rot + st.nrow) & (CONSUMER_WARPS - 1);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }
  }
}

static bool takes(const void* src, int64_t t, const void* idx, int64_t n, int64_t w, int R,
                  const void* out) {
  return src && idx && out && n > 0 && t > 0 && t % 16 == 0 && aligned16(src) &&
         aligned16(out) && R >= 1 && R <= MAX_R && w >= 1 && R * w <= MAX_SLOTS;
}

// The ring's rule.  A tile is the caller's R rows by cw bytes of t; the ring
// takes it in steps of rs rows, one stage each:
// - cw = RING_STAGE / (R*w) bytes (16-byte units), so that a tile is one step;
// - but where that copy falls below the least copy (RING_COPY_1 at width 1,
//   RING_COPY_W wider), fewer rows per step rather than narrower copies:
//   cw = the least copy, or RING_STAGE / w where w of them do not fit a stage;
// - cw <= t;
// - rs = the rows of w copies that fit a stage, at most R.
// Blocks: RING_BLOCKS_PER_SM per SM.  Tiles are dealt round the blocks; a
// launch of fewer than RING_TILES_PER_BLOCK tiles a block deals single steps
// instead, whatever tile they belong to, so that R sets the tails and v2's
// counts and not how far a small launch spreads or how evenly (whole tiles
// are 5-9% faster where there are enough: a block then reads its tile's
// indices and source columns in turn).  Measured on the H100 (PERF.md): two
// blocks of three 32 KB stages beat one block of four (two producers share
// an SM's copy engine), 1 KB copies cost 1.4x and 512-byte ones 2.7x of 2 KB
// ones, and at width 1 nothing from 2 KB to 32 KB moved the time.
constexpr int RING_NS = 3;
constexpr int64_t RING_STAGE = 32 * 1024;
constexpr int64_t RING_COPY_1 = 4096, RING_COPY_W = 2048;
constexpr int RING_BLOCKS_PER_SM = 2;
constexpr int RING_TILES_PER_BLOCK = 4;

struct RingLaunch {
  Ring g;
  int64_t blocks, smem;
  int threads;
};

// cw and rs of the rule above, for stages of `stage` bytes (db's too).
static void copy_plan(int64_t stage, int64_t t, int w, int R, int64_t& cw, int64_t& rs) {
  const int64_t least = w == 1 ? RING_COPY_1 : RING_COPY_W;
  cw = stage / (static_cast<int64_t>(R) * w) / 16 * 16;
  if (cw < least) {
    cw = stage / w / 16 * 16;
    if (cw > least) cw = least;
  }
  if (cw > t) cw = t;
  rs = stage / (w * cw);
  if (rs > R) rs = R;
}

static RingLaunch ring_plan(int64_t t, int64_t n, int w, int R, int mode, int sms) {
  int64_t cw, rs;
  copy_plan(RING_STAGE, t, w, R, cw, rs);
  RingLaunch L;
  Ring& g = L.g;
  g.n = n;
  g.t = t;
  g.w = w;
  g.R = R;
  g.rs = static_cast<int>(rs);
  g.cw = static_cast<int>(cw);
  g.sps = g.rs * w;
  g.ns = RING_NS;
  g.spt = static_cast<int>((R + rs - 1) / rs);
  g.row_blocks = (n + R - 1) / R;
  g.chunks = (t + cw - 1) / cw;
  const int64_t tiles = g.row_blocks * g.chunks;
  g.units = tiles * g.spt;
  g.strip_bytes = w == 1 ? g.cw : 0;
  const int64_t cap = static_cast<int64_t>(RING_BLOCKS_PER_SM) * sms;
  g.deal = tiles >= RING_TILES_PER_BLOCK * cap ? g.spt : 1;
  const int64_t runs = g.units / g.deal;
  L.blocks = runs < cap ? runs : cap;
  L.threads = (CONSUMER_WARPS + producer_warps(mode)) * 32;
  const int64_t nbar = 2 * g.ns + (mode == 0 ? static_cast<int64_t>(g.ns) * g.sps : 0);
  L.smem = static_cast<int64_t>(g.ns) * g.sps * g.cw + g.strip_bytes + 8 * nbar +
           4 * static_cast<int64_t>(g.ns) * g.sps;
  return L;
}

// db's rule.  cw and rs as the ring's, for two stages of DB_STAGE bytes (two
// blocks per SM leave each about 113 KB), rs then evened out over the steps of
// a row block (R = 8 at three rows a stage: 3, 3, 2).  A block takes one
// t-tile and one sweep of `per` row blocks: about DB_SWEEP_STEPS steps, so
// that set-up and the first step's wait are paid back and yet many sweeps of
// one tile run side by side (the resident blocks then share few column chunks
// of the source, which stay in L2); fewer, down to one row block, where the
// launch would otherwise not give every SM its blocks.
constexpr int64_t DB_STAGE = 48 * 1024;
constexpr int DB_SWEEP_STEPS = 8;

struct DbLaunch {
  Db g;
  int64_t blocks, smem;
};

static DbLaunch db_plan(int64_t t, int64_t n, int w, int R, int sms, int64_t stage,
                        int sweep_steps) {
  int64_t cw, rs;
  copy_plan(stage, t, w, R, cw, rs);
  const int64_t spt = (R + rs - 1) / rs;  // steps of a row block
  rs = (R + spt - 1) / spt;
  const int64_t row_blocks = (n + R - 1) / R, tiles = (t + cw - 1) / cw;
  int64_t per = (sweep_steps + spt - 1) / spt;
  const int64_t spread = row_blocks * tiles / (static_cast<int64_t>(DB_BLOCKS_PER_SM) * sms);
  if (per > spread) per = spread;
  if (per < 1) per = 1;
  DbLaunch L;
  Db& g = L.g;
  g.n = n;
  g.t = t;
  g.w = w;
  g.R = R;
  g.rs = static_cast<int>(rs);
  g.cw = static_cast<int>(cw);
  g.sps = g.rs * w;
  g.per = per;
  g.sweeps = (row_blocks + per - 1) / per;
  L.blocks = tiles * g.sweeps;
  L.smem = DB_STAGES * static_cast<int64_t>(g.sps) * g.cw + 8 * 2 * DB_STAGES +
           4 * static_cast<int64_t>(DB_STAGES) * g.sps;
  return L;
}

static cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

static cudaError_t launch_db(const void* src, int64_t S, int64_t t, const void* idx, int64_t n,
                             int64_t w, int R, int64_t stage, int sweep_steps, void* out, void* err,
                             void* stream) {
  if (!takes(src, t, idx, n, w, R, out) || stage < 16 * w || stage > DB_STAGE || sweep_steps < 1)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return e;
  const DbLaunch L = db_plan(t, n, static_cast<int>(w), R, sms, stage, sweep_steps);
  if (L.blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(gather_db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(L.smem));
  if (e != cudaSuccess) return e;
  gather_db_kernel<<<static_cast<unsigned>(L.blocks), DB_THREADS, L.smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), S, static_cast<const int32_t*>(idx), L.g,
      static_cast<uint8_t*>(out), static_cast<int*>(err));
  return cudaGetLastError();
}

template <typename K>
static cudaError_t launch(K kernel, const RingLaunch& L, cudaStream_t stream, const uint8_t* src,
                          int64_t S, const int32_t* idx, const int32_t* cnt, int32_t sentinel,
                          uint8_t* out, int* err, int* cnt_err) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(L.blocks), L.threads, L.smem, stream>>>(src, S, idx, L.g, cnt,
                                                                         sentinel, out, err, cnt_err);
  return cudaGetLastError();
}

static cudaError_t launch_stage(int mode, bool v2, const void* src, int64_t S, int64_t t,
                                const void* idx, int64_t n, int64_t w, int R, const void* cnt,
                                int32_t sentinel, void* out, void* err, void* cnt_err,
                                void* stream) {
  if (!takes(src, t, idx, n, w, R, out) || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return e;
  const RingLaunch L = ring_plan(t, n, static_cast<int>(w), R, mode, sms);
  if (L.smem > SMEM_MAX) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const uint8_t*>(src);
  const auto* ip = static_cast<const int32_t*>(idx);
  const auto* cp = static_cast<const int32_t*>(cnt);
  auto* op = static_cast<uint8_t*>(out);
  auto* ep = static_cast<int*>(err);
  auto* cep = static_cast<int*>(cnt_err);
  if (v2) return launch(gather_stage_kernel<2, true>, L, s, sp, S, ip, cp, sentinel, op, ep, cep);
  if (mode == 0)
    return launch(gather_stage_kernel<0, false>, L, s, sp, S, ip, cp, sentinel, op, ep, cep);
  if (mode == 1)
    return launch(gather_stage_kernel<1, false>, L, s, sp, S, ip, cp, sentinel, op, ep, cep);
  return launch(gather_stage_kernel<2, false>, L, s, sp, S, ip, cp, sentinel, op, ep, cep);
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

// The ring's plan for a launch on a card of `sms` SMs, as eight numbers: rows
// per step, bytes per copy, stages, slots per step, steps, blocks, threads,
// shared-memory bytes (ops/kernels.probe_geometry states the same rule).
extern "C" int nrq_gather_stage_plan(int64_t t, int64_t n, int64_t w, int R, int mode, int sms,
                                     int64_t* plan) {
  const auto L = nrq::probe::ring_plan(t, n, static_cast<int>(w), R, mode, sms);
  const int64_t v[8] = {L.g.rs, L.g.cw, L.g.ns, L.g.sps, L.g.units, L.blocks, L.threads, L.smem};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}

extern "C" int nrq_gather_db(const void* src, int64_t S, int64_t t, const void* idx, int64_t n,
                             int64_t w, int R, void* out, void* err, void* stream) {
  using namespace nrq::probe;
  return launch_db(src, S, t, idx, n, w, R, DB_STAGE, DB_SWEEP_STEPS, out, err, stream);
}

// gather_db under another stage size (16 * w <= stage_bytes <= 48 KB) and sweep
// length than db_plan's own: what tools/gather_db_tune.py times.
extern "C" int nrq_gather_db_tuned(const void* src, int64_t S, int64_t t, const void* idx,
                                   int64_t n, int64_t w, int R, int64_t stage_bytes,
                                   int sweep_steps, void* out, void* err, void* stream) {
  return nrq::probe::launch_db(src, S, t, idx, n, w, R, stage_bytes, sweep_steps, out, err,
                               stream);
}

// db's plan for a launch on a card of `sms` SMs, as eight numbers: rows per
// step, bytes per copy, slots per step, row blocks per sweep, sweeps per
// t-tile, blocks, threads, shared-memory bytes (ops/kernels.db_geometry states
// the same rule); stage_bytes and sweep_steps 0: db_plan's own.
extern "C" int nrq_gather_db_plan(int64_t t, int64_t n, int64_t w, int R, int sms,
                                  int64_t stage_bytes, int sweep_steps, int64_t* plan) {
  using namespace nrq::probe;
  const auto L = db_plan(t, n, static_cast<int>(w), R, sms, stage_bytes ? stage_bytes : DB_STAGE,
                         sweep_steps ? sweep_steps : DB_SWEEP_STEPS);
  const int64_t v[8] = {L.g.rs, L.g.cw, L.g.sps, L.g.per, L.g.sweeps, L.blocks, DB_THREADS, L.smem};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}
