// Native host-side schedule solver for nanorq_tpu_torch (a copy of nanorq_tpu's).
//
// Replaces the Python _solve_core hot path (precode/solver.py): Gaussian
// elimination with inactivation over matrix *indices* — peel, triangle
// substitution applied to the dense inactive block, GF(2)/GF(256) dense
// solve, Schur pivot-block extraction and inversion.  Pure index/byte work;
// no payload bytes are touched (those run on the TPU).
//
// Reference analog: lib/precode.c:99-377 (precode_matrix_invert), re-designed
// to emit the structured-replay artifacts instead of an op stream.
//
// C ABI (ctypes): nrq_solve() returns an opaque handle with getters; the
// caller copies results into NumPy arrays and frees the handle.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <new>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

#include <sys/mman.h>

#if defined(__AVX2__) || defined(__SSSE3__) || defined(__SSE__)
#include <immintrin.h>  // __SSE__ alone: _mm_prefetch (prefetch_row)
#endif

namespace {

// NRQ_TIMING=1 in the environment prints per-phase solve timings to stderr.
struct PhaseTimer {
  bool on;
  struct timespec t0;
  PhaseTimer() : on(getenv("NRQ_TIMING") != nullptr) { clock_gettime(CLOCK_MONOTONIC, &t0); }
  void mark(const char* name) {
    if (!on) return;
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    fprintf(stderr, "nrq_solve %-10s %6.1f ms\n", name,
            (t1.tv_sec - t0.tv_sec) * 1e3 + (t1.tv_nsec - t0.tv_nsec) / 1e6);
    t0 = t1;
  }
};

uint8_t GF_MUL[256][256];
uint8_t OCT_INV[256];
// nibble decomposition: a (x) b = NIB_LO[b][a & 15] ^ NIB_HI[b][a >> 4]
alignas(32) uint8_t NIB_LO[256][16];
alignas(32) uint8_t NIB_HI[256][16];

struct TablesInit {
  TablesInit() {
    uint8_t exp_[510];
    int log_[256] = {0};
    int x = 1;
    for (int k = 0; k < 255; k++) {
      exp_[k] = (uint8_t)x;
      log_[x] = k;
      x <<= 1;
      if (x & 0x100) x ^= 0x11D;
    }
    for (int k = 255; k < 510; k++) exp_[k] = exp_[k - 255];
    memset(GF_MUL, 0, sizeof(GF_MUL));
    for (int a = 1; a < 256; a++)
      for (int b = 1; b < 256; b++) GF_MUL[a][b] = exp_[log_[a] + log_[b]];
    OCT_INV[0] = 0;
    for (int a = 1; a < 256; a++) OCT_INV[a] = exp_[255 - log_[a]];
    for (int b = 0; b < 256; b++)
      for (int n = 0; n < 16; n++) {
        NIB_LO[b][n] = GF_MUL[b][n];
        NIB_HI[b][n] = GF_MUL[b][n << 4];
      }
  }
} tables_init_;

#if defined(__GFNI__) && defined(__AVX512F__) && defined(__AVX512BW__)
// GFNI constant-multiply: beta (x) x over GF(2^8)/0x11D is GF(2)-linear in
// x, so it is one vgf2p8affineqb with the 8x8 bit matrix A_beta whose
// column j is beta (x) 2^j — 64 bytes per instruction vs the nibble-LUT
// path's 32 bytes per 4 ops.  The qword bit layout of the matrix operand is
// derived EMPIRICALLY at init (4 candidate row/column bit orders, verified
// against GF_MUL) so a convention mistake degrades to the LUT path instead
// of corrupting payloads.
uint64_t GF_AFF[256];
bool gfni_ok = false;

uint64_t build_aff(uint8_t beta, int rowrev, int colrev) {
  uint64_t q = 0;
  for (int r = 0; r < 8; r++) {  // result bit r
    uint8_t rowbits = 0;
    for (int j = 0; j < 8; j++)  // input bit j
      if ((GF_MUL[beta][1 << j] >> r) & 1) rowbits |= (uint8_t)(1 << (colrev ? 7 - j : j));
    q |= (uint64_t)rowbits << (8 * (rowrev ? 7 - r : r));
  }
  return q;
}

struct GfniInit {
  GfniInit() {
    if (!__builtin_cpu_supports("gfni")) return;
    for (int rr = 0; rr < 2 && !gfni_ok; rr++)
      for (int cr = 0; cr < 2 && !gfni_ok; cr++) {
        __m128i m = _mm_set1_epi64x((long long)build_aff(0x53, rr, cr));
        uint8_t in[16], outv[16];
        for (int t = 0; t < 16; t++) in[t] = (uint8_t)(t * 17 + 5);
        __m128i y = _mm_gf2p8affine_epi64_epi8(_mm_loadu_si128((const __m128i*)in), m, 0);
        _mm_storeu_si128((__m128i*)outv, y);
        bool match = true;
        for (int t = 0; t < 16; t++)
          if (outv[t] != GF_MUL[0x53][in[t]]) { match = false; break; }
        if (match) {
          for (int b = 0; b < 256; b++) GF_AFF[b] = build_aff((uint8_t)b, rr, cr);
          gfni_ok = true;
        }
      }
  }
} gfni_init_;  // must come after tables_init_ (reads GF_MUL)
#endif

inline void row_xor(uint8_t* dst, const uint8_t* src, int n) {
  for (int j = 0; j < n; j++) dst[j] ^= src[j];
}

// dst ^= beta (x) src: GFNI affine multiply when available (64 B/instr),
// else PSHUFB nibble-LUT vectorized (the oblas oaxpy trick)
inline void row_axpy(uint8_t* dst, const uint8_t* src, uint8_t beta, int n) {
  int j = 0;
#if defined(__GFNI__) && defined(__AVX512F__) && defined(__AVX512BW__)
  if (gfni_ok) {
    const __m512i A = _mm512_set1_epi64((long long)GF_AFF[beta]);
    for (; j + 64 <= n; j += 64) {
      __m512i x = _mm512_loadu_si512((const void*)(src + j));
      __m512i r = _mm512_gf2p8affine_epi64_epi8(x, A, 0);
      __m512i d = _mm512_loadu_si512((const void*)(dst + j));
      _mm512_storeu_si512((void*)(dst + j), _mm512_xor_si512(d, r));
    }
    if (j < n) {
      const __mmask64 k = (~0ull) >> (64 - (n - j));
      __m512i x = _mm512_maskz_loadu_epi8(k, src + j);
      __m512i r = _mm512_gf2p8affine_epi64_epi8(x, A, 0);
      __m512i d = _mm512_maskz_loadu_epi8(k, dst + j);
      _mm512_mask_storeu_epi8(dst + j, k, _mm512_xor_si512(d, r));
    }
    return;
  }
#endif
#if defined(__AVX2__)
  const __m256i lo_t = _mm256_broadcastsi128_si256(_mm_load_si128((const __m128i*)NIB_LO[beta]));
  const __m256i hi_t = _mm256_broadcastsi128_si256(_mm_load_si128((const __m128i*)NIB_HI[beta]));
  const __m256i mask = _mm256_set1_epi8(0x0f);
  for (; j + 32 <= n; j += 32) {
    __m256i x = _mm256_loadu_si256((const __m256i*)(src + j));
    __m256i lo = _mm256_and_si256(x, mask);
    __m256i hi = _mm256_and_si256(_mm256_srli_epi64(x, 4), mask);
    __m256i r = _mm256_xor_si256(_mm256_shuffle_epi8(lo_t, lo), _mm256_shuffle_epi8(hi_t, hi));
    __m256i d = _mm256_loadu_si256((const __m256i*)(dst + j));
    _mm256_storeu_si256((__m256i*)(dst + j), _mm256_xor_si256(d, r));
  }
#elif defined(__SSSE3__)
  const __m128i lo_t = _mm_load_si128((const __m128i*)NIB_LO[beta]);
  const __m128i hi_t = _mm_load_si128((const __m128i*)NIB_HI[beta]);
  const __m128i mask = _mm_set1_epi8(0x0f);
  for (; j + 16 <= n; j += 16) {
    __m128i x = _mm_loadu_si128((const __m128i*)(src + j));
    __m128i lo = _mm_and_si128(x, mask);
    __m128i hi = _mm_and_si128(_mm_srli_epi64(x, 4), mask);
    __m128i r = _mm_xor_si128(_mm_shuffle_epi8(lo_t, lo), _mm_shuffle_epi8(hi_t, hi));
    __m128i d = _mm_loadu_si128((const __m128i*)(dst + j));
    _mm_storeu_si128((__m128i*)(dst + j), _mm_xor_si128(d, r));
  }
#endif
  const uint8_t* mul = GF_MUL[beta];
  for (; j < n; j++) dst[j] ^= mul[src[j]];
}

struct Solver {
  // outputs
  std::vector<int32_t> piv_rows, piv_cols;
  std::vector<int32_t> u_cols;
  std::vector<int32_t> order;
  std::vector<uint8_t> uschur_sel;  // [u, u] row-major
  std::vector<uint8_t> vinv;        // [u, u] row-major
  // pre-extracted device-compiler edges (tri position space / u columns):
  // triangle dep edges (k, p<k) and inactive-entry edges (k, ucol) of the
  // pivot rows — the downstream compiler consumed these via a NumPy re-scan
  // of the CSR that cost more than the whole native solve at K'=50511
  std::vector<int32_t> tri_ek, tri_ep, ut_ek, ut_uc;
  int status = 1;                   // 0 ok, 1 rank-deficient
  int hdpc_used = 0;
};

}  // namespace

extern "C" {

// rows: CSR of the NB binary rows (LT then LDPC) over columns [0, L).
// hdpc: dense [H, L] HDPC rows of A (always provided; used only on demand).
void* nrq_solve(int32_t NB, int32_t L, int32_t W, int32_t S, int32_t H,
                const int32_t* row_ptr, const int32_t* row_cols,
                const uint8_t* hdpc) {
  const int M = NB + H;
  Solver* out = new Solver();
  PhaseTimer pt;

  // ---- column adjacency (transpose of the binary rows) ----
  const int64_t nnz = row_ptr[NB];
  std::vector<int32_t> col_cnt(L + 1, 0);
  for (int64_t e = 0; e < nnz; e++) col_cnt[row_cols[e] + 1]++;
  std::vector<int32_t> col_ptr(L + 1, 0);
  for (int c = 0; c < L; c++) col_ptr[c + 1] = col_ptr[c] + col_cnt[c + 1];
  std::vector<int32_t> col_rows(nnz);
  {
    std::vector<int32_t> cur(col_ptr.begin(), col_ptr.end() - 1);
    for (int r = 0; r < NB; r++)
      for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++)
        col_rows[cur[row_cols[e]]++] = r;
  }

  pt.mark("adj");
  // ---- phase 1: peel (greedy degree-1/2 selection, inactivation) ----
  // Per row, ONE 8-byte record: nv = nnz over active V columns (-1 once
  // used; int16 — LDPC rows reach ~200) and xs = XOR of the remaining
  // active V column ids.  remove_col touches exactly one cache line per
  // incident row, and a degree-1 row's surviving column IS xs — no row
  // rescan.  Only degree-2 picks scan their row (for the c1/c2 split).
  struct RowSt { int32_t xs; int16_t nv; int16_t _pad; };
  std::vector<RowSt> rs(NB, RowSt{0, 0, 0});
  for (int r = 0; r < NB; r++)
    for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++)
      if (row_cols[e] < W) { rs[r].nv++; rs[r].xs ^= row_cols[e]; }
  std::vector<uint8_t> col_active(L, 0);
  for (int c = 0; c < W; c++) col_active[c] = 1;
  std::vector<int32_t> bucket1, bucket2;
  bucket1.reserve(NB);
  bucket2.reserve(NB);
  for (int r = 0; r < NB; r++) {
    if (rs[r].nv == 1) bucket1.push_back(r);
    else if (rs[r].nv == 2) bucket2.push_back(r);
  }
  int n_active = W;
  std::vector<int32_t>& pr = out->piv_rows;
  std::vector<int32_t>& pc = out->piv_cols;
  std::vector<int32_t> inactivated;

  auto remove_col = [&](int c) {
    col_active[c] = 0;
    n_active--;
    for (int32_t e = col_ptr[c]; e < col_ptr[c + 1]; e++) {
      RowSt& q = rs[col_rows[e]];
      if (q.nv < 0) continue;  // used rows are never read again
      q.xs ^= c;
      int16_t z = --q.nv;
      if (z == 1) bucket1.push_back(col_rows[e]);
      else if (z == 2) bucket2.push_back(col_rows[e]);
    }
  };

  while (n_active > 0) {
    int r = -1;
    bool deg1 = true;
    while (!bucket1.empty()) {
      int cand = bucket1.back();
      bucket1.pop_back();
      if (rs[cand].nv == 1) { r = cand; break; }
    }
    if (r < 0) {
      deg1 = false;
      while (!bucket2.empty()) {
        int cand = bucket2.back();
        bucket2.pop_back();
        if (rs[cand].nv == 2) { r = cand; break; }
      }
    }
    if (r < 0) break;
    int c1 = -1, c2 = -1;
    if (deg1) {
      c1 = rs[r].xs;  // the single surviving active column
    } else {
      for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++) {
        int c = row_cols[e];
        if (col_active[c]) {
          if (c1 < 0) c1 = c;
          else { c2 = c; break; }
        }
      }
    }
    rs[r].nv = -1;
    pr.push_back(r);
    pc.push_back(c1);
    remove_col(c1);
    if (c2 >= 0) {
      inactivated.push_back(c2);
      remove_col(c2);
    }
  }

  pt.mark("peel");
  const int i = (int)pr.size();
  const int u = L - i;

  // inactive column order: leftover active, peel-inactivated, PI cols
  std::vector<int32_t>& uc = out->u_cols;
  uc.reserve(u);
  for (int c = 0; c < W; c++)
    if (col_active[c]) uc.push_back(c);
  for (int32_t c : inactivated) uc.push_back(c);
  for (int c = W; c < L; c++) uc.push_back(c);

  std::vector<int32_t> ucol_of(L, -1);
  for (int j = 0; j < u; j++) ucol_of[uc[j]] = j;
  std::vector<int32_t> pos_of_row(NB, INT32_MAX);
  for (int k = 0; k < i; k++) pos_of_row[pr[k]] = k;

  // ---- device-compiler edge lists over the pivot rows (one CSR scan) ----
  // Every column is EITHER a pivot column (code = pivot pos k >= 0) or an
  // inactive column (code = -1 - j): one merged lookup per entry.  A pivot
  // row can never contain a LATER pivot's column (it had degree <= 2 in
  // active columns when chosen, and those two became its own pivot /
  // an inactivation), so code < k distinguishes triangle deps exactly.
  {
    std::vector<int32_t> colcode(L);
    for (int j = 0; j < u; j++) colcode[uc[j]] = -1 - j;
    for (int k = 0; k < i; k++) colcode[pc[k]] = k;
    // Scan rows in CSR order (sequential reads; the pivot-order walk was
    // all cache misses), counting-sort the edges into ascending-k order —
    // nrq_heavy_closure requires tri_ek ascending; within one k any dep
    // order is valid (deps of a row are a set, application is XOR).
    std::vector<int32_t> tcnt((size_t)i + 1, 0), ucnt((size_t)i + 1, 0);
    for (int r = 0; r < NB; r++) {
      int k = pos_of_row[r];
      if (k == INT32_MAX) continue;
      for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++) {
        int v = colcode[row_cols[e]];
        if (v >= 0) { if (v < k) tcnt[k + 1]++; }
        else ucnt[k + 1]++;
      }
    }
    for (int k = 0; k < i; k++) { tcnt[k + 1] += tcnt[k]; ucnt[k + 1] += ucnt[k]; }
    out->tri_ek.resize(tcnt[i]);
    out->tri_ep.resize(tcnt[i]);
    out->ut_ek.resize(ucnt[i]);
    out->ut_uc.resize(ucnt[i]);
    for (int r = 0; r < NB; r++) {
      int k = pos_of_row[r];
      if (k == INT32_MAX) continue;
      int32_t tq = tcnt[k], uq = ucnt[k];
      for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++) {
        int v = colcode[row_cols[e]];
        if (v >= 0) {
          if (v < k) { out->tri_ek[tq] = k; out->tri_ep[tq] = v; tq++; }
        } else {
          out->ut_ek[uq] = k; out->ut_uc[uq] = -1 - v; uq++;
        }
      }
      tcnt[k] = tq;
      ucnt[k] = uq;
    }
  }

  pt.mark("edges");
  // ---- U: dense inactive block [M, u], bit-packed (64 cols per word).
  // The GF(2) phases (S1a/S1b/binary dense solve) run on words — 8x the
  // byte path; bytes are materialized only if the GF(256)/HDPC tail is
  // admitted (always for the encoder system, rarely for decode patterns).
  const int uw = (u + 63) >> 6;
  std::vector<uint64_t> Ub((size_t)M * uw, 0);
  auto Ubr = [&](int r) { return Ub.data() + (size_t)r * uw; };
  auto bit = [&](const uint64_t* row, int j) -> int { return (int)((row[j >> 6] >> (j & 63)) & 1); };
  for (int r = 0; r < NB; r++)
    for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++) {
      int j = ucol_of[row_cols[e]];
      if (j >= 0) Ubr(r)[j >> 6] |= 1ull << (j & 63);
    }
  auto wrow_xor = [&](uint64_t* dst, const uint64_t* src) {
    for (int w = 0; w < uw; w++) dst[w] ^= src[w];
  };

  pt.mark("ubuild");
  // ---- S1: triangle forward substitution applied to U, and elimination of
  // triangle cols from non-pivot binary rows, in ONE adjacency pass.  Pivot
  // row k's U-row is final by step k (it only receives updates at steps
  // k' < k), so using it as the source for both later pivot rows (p > k)
  // and non-pivot rows (p == INT32_MAX) inside the same scan is exact.
  for (int k = 0; k < i; k++) {
    int c = pc[k];
    const uint64_t* srcrow = Ubr(pr[k]);
    for (int32_t e = col_ptr[c]; e < col_ptr[c + 1]; e++) {
      int r = col_rows[e];
      if (pos_of_row[r] > k) wrow_xor(Ubr(r), srcrow);
    }
  }

  pt.mark("s1");
  // Ub is no longer modified below (the GF(2) dense phase runs on a compact
  // copy), so it doubles as the pre-dense Schur snapshot.

  // ---- dense solve: order, GF(2) first when enough binary rows ----
  std::vector<int32_t>& order = out->order;
  order.resize(M);
  {
    int p = 0;
    for (int k = 0; k < i; k++) order[p++] = pr[k];
    for (int r = 0; r < NB; r++)
      if (rs[r].nv >= 0) order[p++] = r;
    for (int h = 0; h < H; h++) order[p++] = NB + h;
  }

  int rank = i;
  const int nwin = M - H - i;  // dense-window candidate rows (non-pivot binary)
  std::vector<uint64_t> Cw;    // compact GE workspace, rows NEVER swapped
  std::vector<int32_t> winslot;  // order slot p (i <= p < M-H) -> Cw row
  if (M - H >= L && nwin > 0) {
    // GE runs on a CONTIGUOUS copy of the window rows (the candidates are
    // scattered through Ub by order[]; compaction turns the elimination
    // into streaming xors and leaves Ub pristine for the Schur snapshot).
    // Rows are bucketed by LEADING bit: every row with bit jc set has
    // leading bit exactly jc by the elimination invariant, so pivot search
    // is bucket[jc] — the per-column forward scan over all window rows
    // (O(u * nwin) strided touches) was this phase's dominant cost.
    Cw.resize((size_t)nwin * uw);
    for (int s = 0; s < nwin; s++)
      memcpy(Cw.data() + (size_t)s * uw, Ubr(order[i + s]), (size_t)uw * 8);
    auto Cr = [&](int s) { return Cw.data() + (size_t)s * uw; };
    std::vector<int32_t> bhead(u, -1), bnext(nwin, -1);
    auto push = [&](int s) {
      const uint64_t* row = Cr(s);
      for (int w = 0; w < uw; w++)
        if (row[w]) {
          int lb = w * 64 + __builtin_ctzll(row[w]);
          bnext[s] = bhead[lb];
          bhead[lb] = s;
          return;
        }
      // zero row: drops out of every bucket (stays a leftover)
    };
    for (int s = nwin - 1; s >= 0; s--) push(s);
    std::vector<int32_t> piv_of_col(u, -1);
    for (int jc = 0; jc < u; jc++) {
      int q = bhead[jc];
      if (q < 0) break;  // no row has bit jc -> GF(2) rank ends here
      piv_of_col[jc] = q;
      const uint64_t* piv = Cr(q);
      const int w0 = jc >> 6;
      for (int s = bnext[q]; s >= 0;) {
        int nx = bnext[s];
        uint64_t* rrow = Cr(s);
        for (int w = w0; w < uw; w++) rrow[w] ^= piv[w];
        push(s);  // re-bucket at its new (strictly later) leading bit
        s = nx;
      }
      rank = i + jc + 1;
    }
    // rebuild order[i..M-H): solved pivots in column order, then leftovers;
    // winslot keeps the order-slot -> Cw-row map for the byte views below
    std::vector<int32_t> neworder;
    neworder.reserve(nwin);
    winslot.reserve(nwin);
    std::vector<uint8_t> taken(nwin, 0);
    for (int jc = 0; jc < u && piv_of_col[jc] >= 0; jc++) {
      neworder.push_back(order[i + piv_of_col[jc]]);
      winslot.push_back(piv_of_col[jc]);
      taken[piv_of_col[jc]] = 1;
    }
    for (int s = 0; s < nwin; s++)
      if (!taken[s]) {
        neworder.push_back(order[i + s]);
        winslot.push_back(s);
      }
    for (int s = 0; s < nwin; s++) order[i + s] = neworder[s];
  }
  pt.mark("gf2dense");

  // byte views, materialized lazily for the GF(256)/HDPC tail.  Only the
  // dense window rows order[i..M) are ever touched as bytes: the GF(256)
  // elimination pivots/targets live there, and the HDPC-vs-triangle
  // elimination streams the (sparse, 2-3 bit) triangle rows from Ub.
  std::vector<uint8_t> U, U_pre;
  auto Urow = [&](int r) { return U.data() + (size_t)r * u; };

  if (rank < L) {
    out->hdpc_used = 1;
    // U: post-GF(2) state — compact workspace for window rows, pristine Ub
    // for rows the GF(2) phase never touched.  U_pre: pristine Ub everywhere
    // (the pre-dense Schur snapshot).
    U.assign((size_t)M * u, 0);
    U_pre.assign((size_t)M * u, 0);
    for (int p = i; p < M; p++) {
      int r = order[p];
      const uint64_t* pre = Ub.data() + (size_t)r * uw;
      const uint64_t* post =
          (p < M - H && !Cw.empty()) ? Cw.data() + (size_t)winslot[p - i] * uw : pre;
      uint8_t* drow = U.data() + (size_t)r * u;
      uint8_t* prow = U_pre.data() + (size_t)r * u;
      for (int j = 0; j < u; j++) {
        drow[j] = (uint8_t)((post[j >> 6] >> (j & 63)) & 1);
        prow[j] = (uint8_t)((pre[j >> 6] >> (j & 63)) & 1);
      }
    }
    // fill HDPC inactive block and eliminate vs triangle pivots:
    //   hrow_h ^= sum_k beta[h,k] (x) (T^-1 U_orig)[k]
    //          == sum_k gamma[h,k] * U_orig[k],  gamma^T = beta^T T^-1.
    // gamma comes from back-substitution over the *sparse original*
    // triangle (T entries are 0/1 -> plain XOR), then scatters against the
    // original 2-3 u-entries per triangle row — O(nnz * H) total,
    // independent of the S1a fill-in that made the dense formulation the
    // solve's dominant cost at large K'.
    for (int h = 0; h < H; h++) {
      uint8_t* hrow = Urow(NB + h);
      const uint8_t* ah = hdpc + (size_t)h * L;
      for (int j = 0; j < u; j++) hrow[j] = ah[uc[j]];
    }
    std::vector<uint8_t> gamma((size_t)i * H);
    for (int k = i - 1; k >= 0; k--) {
      uint8_t* g = gamma.data() + (size_t)k * H;
      for (int h = 0; h < H; h++) g[h] = hdpc[(size_t)h * L + pc[k]];
      int c = pc[k];
      for (int32_t e = col_ptr[c]; e < col_ptr[c + 1]; e++) {
        int p = pos_of_row[col_rows[e]];
        if (p > k && p < INT32_MAX) {
          const uint8_t* gp = gamma.data() + (size_t)p * H;
          for (int h = 0; h < H; h++) g[h] ^= gp[h];
        }
      }
    }
    for (int k = 0; k < i; k++) {
      const uint8_t* g = gamma.data() + (size_t)k * H;
      int r = pr[k];
      for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++) {
        int j = ucol_of[row_cols[e]];
        if (j < 0) continue;
        for (int h = 0; h < H; h++) Urow(NB + h)[j] ^= g[h];
      }
    }
    for (int h = 0; h < H; h++)
      memcpy(U_pre.data() + (size_t)(NB + h) * u, Urow(NB + h), u);
    // GF(256) elimination from position i over all rows
    for (int p = i; p < L; p++) {
      int jc = p - i;
      int q = -1;
      for (int s = p; s < M; s++)
        if (Urow(order[s])[jc]) { q = s; break; }
      if (q < 0) { out->status = 1; return out; }
      std::swap(order[p], order[q]);
      uint8_t* piv = Urow(order[p]);
      uint8_t b = piv[jc];
      if (b > 1) {
        const uint8_t* mul = GF_MUL[OCT_INV[b]];
        for (int j = 0; j < u; j++) piv[j] = mul[piv[j]];
      }
      for (int s = p + 1; s < M; s++) {
        uint8_t* rrow = Urow(order[s]);
        uint8_t beta = rrow[jc];
        if (beta) row_axpy(rrow, piv, beta, u);
      }
    }
  }

  pt.mark("dense");
  // ---- Schur pivot block + inverse ----
  out->uschur_sel.resize((size_t)u * u);
  if (out->hdpc_used) {
    for (int s = 0; s < u; s++)
      memcpy(out->uschur_sel.data() + (size_t)s * u,
             U_pre.data() + (size_t)order[i + s] * u, u);
  } else {
    for (int s = 0; s < u; s++) {
      const uint64_t* srow = Ub.data() + (size_t)order[i + s] * uw;
      uint8_t* drow = out->uschur_sel.data() + (size_t)s * u;
      for (int j = 0; j < u; j++) drow[j] = (uint8_t)((srow[j >> 6] >> (j & 63)) & 1);
    }
  }

  // invert [u, u]: GF(2) is a subfield, so a binary pivot block (no HDPC
  // pivots taken) has a binary inverse — bit-packed Gauss-Jordan on words,
  // ~8x the byte path; GF(256) byte Gauss-Jordan otherwise.
  if (!out->hdpc_used) {
    std::vector<uint64_t> Ab((size_t)u * uw, 0), Vb((size_t)u * uw, 0);
    for (int r = 0; r < u; r++) {
      // the pivot-block rows are already bit-packed in the pristine Ub
      memcpy(Ab.data() + (size_t)r * uw, Ub.data() + (size_t)order[i + r] * uw,
             (size_t)uw * 8);
      Vb[(size_t)r * uw + (r >> 6)] = 1ull << (r & 63);
    }
    for (int c = 0; c < u; c++) {
      int piv = -1;
      for (int r = c; r < u; r++)
        if ((Ab[(size_t)r * uw + (c >> 6)] >> (c & 63)) & 1) { piv = r; break; }
      if (piv < 0) { out->status = 1; return out; }  // cannot happen if solve ok
      if (piv != c)
        for (int w = 0; w < uw; w++) {
          std::swap(Ab[(size_t)c * uw + w], Ab[(size_t)piv * uw + w]);
          std::swap(Vb[(size_t)c * uw + w], Vb[(size_t)piv * uw + w]);
        }
      const uint64_t* pa = Ab.data() + (size_t)c * uw;
      const uint64_t* pv = Vb.data() + (size_t)c * uw;
      for (int r = 0; r < u; r++) {
        if (r == c) continue;
        if ((Ab[(size_t)r * uw + (c >> 6)] >> (c & 63)) & 1) {
          uint64_t* ra = Ab.data() + (size_t)r * uw;
          uint64_t* rv = Vb.data() + (size_t)r * uw;
          for (int w = 0; w < uw; w++) { ra[w] ^= pa[w]; rv[w] ^= pv[w]; }
        }
      }
    }
    out->vinv.assign((size_t)u * u, 0);
    for (int r = 0; r < u; r++) {
      const uint64_t* row = Vb.data() + (size_t)r * uw;
      uint8_t* dst = out->vinv.data() + (size_t)r * u;
      for (int j = 0; j < u; j++) dst[j] = (uint8_t)((row[j >> 6] >> (j & 63)) & 1);
    }
  } else {
    std::vector<uint8_t> A(out->uschur_sel);
    std::vector<uint8_t>& V = out->vinv;
    V.assign((size_t)u * u, 0);
    for (int d = 0; d < u; d++) V[(size_t)d * u + d] = 1;
    auto Ar = [&](int r) { return A.data() + (size_t)r * u; };
    auto Vr = [&](int r) { return V.data() + (size_t)r * u; };
    for (int c = 0; c < u; c++) {
      int piv = -1;
      for (int r = c; r < u; r++)
        if (Ar(r)[c]) { piv = r; break; }
      if (piv < 0) { out->status = 1; return out; }  // cannot happen if solve ok
      if (piv != c) {
        for (int j = 0; j < u; j++) std::swap(Ar(c)[j], Ar(piv)[j]);
        for (int j = 0; j < u; j++) std::swap(Vr(c)[j], Vr(piv)[j]);
      }
      uint8_t b = Ar(c)[c];
      if (b != 1) {
        const uint8_t* mul = GF_MUL[OCT_INV[b]];
        for (int j = 0; j < u; j++) Ar(c)[j] = mul[Ar(c)[j]];
        for (int j = 0; j < u; j++) Vr(c)[j] = mul[Vr(c)[j]];
      }
      for (int r = 0; r < u; r++) {
        if (r == c) continue;
        uint8_t beta = Ar(r)[c];
        if (beta) {
          row_axpy(Ar(r), Ar(c), beta, u);
          row_axpy(Vr(r), Vr(c), beta, u);
        }
      }
    }
  }

  pt.mark("schur");
  out->status = 0;
  return out;
}

int32_t nrq_status(void* h) { return ((Solver*)h)->status; }
int32_t nrq_hdpc_used(void* h) { return ((Solver*)h)->hdpc_used; }
int32_t nrq_i(void* h) { return (int32_t)((Solver*)h)->piv_rows.size(); }
int32_t nrq_u(void* h) { return (int32_t)((Solver*)h)->u_cols.size(); }
const int32_t* nrq_piv_rows(void* h) { return ((Solver*)h)->piv_rows.data(); }
const int32_t* nrq_piv_cols(void* h) { return ((Solver*)h)->piv_cols.data(); }
const int32_t* nrq_u_cols(void* h) { return ((Solver*)h)->u_cols.data(); }
const int32_t* nrq_order(void* h) { return ((Solver*)h)->order.data(); }
int64_t nrq_n_tri_edges(void* h) { return (int64_t)((Solver*)h)->tri_ek.size(); }
int64_t nrq_n_ut_edges(void* h) { return (int64_t)((Solver*)h)->ut_ek.size(); }
const int32_t* nrq_tri_ek(void* h) { return ((Solver*)h)->tri_ek.data(); }
const int32_t* nrq_tri_ep(void* h) { return ((Solver*)h)->tri_ep.data(); }
const int32_t* nrq_ut_ek(void* h) { return ((Solver*)h)->ut_ek.data(); }
const int32_t* nrq_ut_uc(void* h) { return ((Solver*)h)->ut_uc.data(); }
const uint8_t* nrq_uschur(void* h) { return ((Solver*)h)->uschur_sel.data(); }
const uint8_t* nrq_vinv(void* h) { return ((Solver*)h)->vinv.data(); }
void nrq_free(void* h) { delete (Solver*)h; }

// ---- GF(2) unit-lower-triangular chunk inversion (for compile_device) ----
// T: [n, CB, CB] row-major 0/1; inverted in place:
//   Tinv[r] = e_r ^ XOR_{c<r, T[r,c]=1} Tinv[c]
void nrq_tinv_chunks(uint8_t* T, int32_t n, int32_t CB) {
  std::vector<uint8_t> inv((size_t)CB * CB);
  for (int q = 0; q < n; q++) {
    uint8_t* Tq = T + (size_t)q * CB * CB;
    memset(inv.data(), 0, inv.size());
    for (int r = 0; r < CB; r++) {
      uint8_t* dst = inv.data() + (size_t)r * CB;
      dst[r] = 1;
      const uint8_t* trow = Tq + (size_t)r * CB;
      for (int c = 0; c < r; c++)
        if (trow[c]) row_xor(dst, inv.data() + (size_t)c * CB, CB);
    }
    memcpy(Tq, inv.data(), inv.size());
  }
}

// Invert + conjugate by an intra-chunk permutation in one pass:
//   out[r'][c'] = Tinv[order[r']][order[c']]   (out = P Tinv P^T)
// order: [n, CB] int32, new position -> old position within the chunk.
// Row gather is a memcpy; the column gather stays L1/L2-resident per row.
void nrq_tinv_conj_chunks(uint8_t* T, const int32_t* order, int32_t n, int32_t CB) {
  std::vector<uint8_t> inv((size_t)CB * CB);
  for (int q = 0; q < n; q++) {
    uint8_t* Tq = T + (size_t)q * CB * CB;
    const int32_t* ord = order + (size_t)q * CB;
    memset(inv.data(), 0, inv.size());
    for (int r = 0; r < CB; r++) {
      uint8_t* dst = inv.data() + (size_t)r * CB;
      dst[r] = 1;
      const uint8_t* trow = Tq + (size_t)r * CB;
      for (int c = 0; c < r; c++)
        if (trow[c]) row_xor(dst, inv.data() + (size_t)c * CB, CB);
    }
    for (int r = 0; r < CB; r++) {
      const uint8_t* src = inv.data() + (size_t)ord[r] * CB;
      uint8_t* dst = Tq + (size_t)r * CB;
      for (int c = 0; c < CB; c++) dst[c] = src[ord[c]];
    }
  }
}

// ---- CSR row splice (decode-pattern rows from cached encoder rows) ----
// Copies each output row's column set from either the base CSR (src[r] >= 0
// names the base row) or the next fresh row (src[r] < 0; fresh rows are
// consumed in output-row order).  out_ptr is precomputed by the caller; this
// is the pure memcpy pass (the NumPy repeat/scatter formulation of the same
// splice cost ~15 ms at K'=50511).
// Heavy-row classification for the canonical decode layout: a triangle
// position is heavy if its cross-chunk dep degree exceeds `thresh`, or
// (forward closure) if any of its deps is heavy — so moving every heavy
// position to the end of the pivot order keeps all dependencies backward.
// Edges must be ascending in ek (the tri_ek export order), so one forward
// pass reaches the fixpoint.
void nrq_heavy_closure(int64_t ne, const int32_t* ek, const int32_t* ep,
                       int32_t n, int32_t thresh, uint8_t* heavy) {
  std::vector<int32_t> deg(n, 0);
  for (int64_t e = 0; e < ne; e++) deg[ek[e]]++;
  for (int32_t k = 0; k < n; k++) heavy[k] = deg[k] > thresh;
  for (int64_t e = 0; e < ne; e++)
    if (heavy[ep[e]]) heavy[ek[e]] = 1;
}

// Zone rank for the closed (heavy + closure) positions: a greedy
// max-degree-first topological order of the closed subgraph (Kahn with a
// max-heap keyed by (degree, original position)).  This approximates a
// global degree-descending sort subject to dependencies, so the zone's
// positional degree profile — wide widths first, then a fast decay —
// concentrates across loss patterns instead of sawtoothing per dependency
// level.  zone_rank[k] = rank within the zone for closed k, -1 for light.
// Returns the closed count.
int32_t nrq_heavy_zone_order(int64_t ne, const int32_t* ek, const int32_t* ep,
                             int32_t n, int32_t thresh, uint8_t* heavy,
                             int32_t* zone_rank) {
  nrq_heavy_closure(ne, ek, ep, n, thresh, heavy);
  std::vector<int32_t> deg(n, 0);
  for (int64_t e = 0; e < ne; e++) deg[ek[e]]++;
  // closed-subgraph adjacency (dependents) + in-degrees
  std::vector<int32_t> indeg(n, 0);
  std::vector<int64_t> head(n, -1);  // per-dep linked list of closed edges
  std::vector<int64_t> nxt;
  std::vector<int32_t> dst;
  nxt.reserve(1024);
  dst.reserve(1024);
  for (int64_t e = 0; e < ne; e++) {
    if (heavy[ek[e]] && heavy[ep[e]]) {
      indeg[ek[e]]++;
      nxt.push_back(head[ep[e]]);
      dst.push_back(ek[e]);
      head[ep[e]] = (int64_t)dst.size() - 1;
    }
  }
  std::vector<int64_t> heap;  // (deg << 32) | (maxpos - k): max-degree first
  heap.reserve(1024);
  int32_t nclosed = 0;
  for (int32_t k = 0; k < n; k++) {
    zone_rank[k] = -1;
    if (heavy[k]) {
      nclosed++;
      if (indeg[k] == 0)
        heap.push_back(((int64_t)deg[k] << 32) | (uint32_t)(n - k));
    }
  }
  std::make_heap(heap.begin(), heap.end());
  int32_t r = 0;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end());
    int32_t k = n - (int32_t)(heap.back() & 0xFFFFFFFF);
    heap.pop_back();
    zone_rank[k] = r++;
    for (int64_t e = head[k]; e >= 0; e = nxt[e]) {
      int32_t d = dst[e];
      if (--indeg[d] == 0) {
        heap.push_back(((int64_t)deg[d] << 32) | (uint32_t)(n - d));
        std::push_heap(heap.begin(), heap.end());
      }
    }
  }
  return nclosed;  // == r: the closed subgraph is acyclic by construction
}

void nrq_splice_rows(int32_t n, const int64_t* base_ptr, const int32_t* base_cols,
                     const int64_t* src,
                     const int64_t* fresh_ptr, const int32_t* fresh_cols,
                     const int64_t* out_ptr, int32_t* out_cols) {
  int64_t fi = 0;
  for (int32_t r = 0; r < n; r++) {
    int64_t o = out_ptr[r];
    if (src[r] >= 0) {
      int64_t b0 = base_ptr[src[r]];
      memcpy(out_cols + o, base_cols + b0, (size_t)(base_ptr[src[r] + 1] - b0) * 4);
    } else {
      int64_t f0 = fresh_ptr[fi];
      memcpy(out_cols + o, fresh_cols + f0, (size_t)(fresh_ptr[fi + 1] - f0) * 4);
      fi++;
    }
  }
}

// ---- W-row solve: combination matrix rows W with W A = G ------------------
// Given the block factorization A = [[T, U], [B, V]] (T unit-lower-triangular
// over the i pivot positions, Schur complement S = V ^ B T^-1 U with
// precomputed S^-1), solve nrhs combination rows by transposed substitution:
//   a  = g1 T^-1        (back-substitution over positions, descending)
//   t2 = g2 ^ a U
//   w2 = t2 S^-1
//   w1 = (g1 ^ w2 B) T^-1
// All arrays are position-major [len, nrhs] so every edge application is one
// contiguous SIMD row XOR / axpy.  Byte-valued (GF(256)); for binary systems
// (hdpc_used == 0) every value stays in {0, 1}.
//
// This powers the dense-W device path: the recovered/encoded symbols become
// ONE GF(2)/GF(256) matmul W @ D on the MXU instead of the 2*ceil(L/CB)+4
// stage structured replay (see ops/wpath.py).  No reference analog — the
// reference replays its op schedule per symbol matrix (lib/precode.c:23-32).
void nrq_wsolve(int32_t nrhs, int32_t i, int32_t u, int32_t H, int32_t hdpc_used,
                int64_t n_tri, const int32_t* tri_ek, const int32_t* tri_ep,
                int64_t n_ut, const int32_t* ut_ek, const int32_t* ut_uc,
                int64_t n_bs, const int32_t* bs_sel, const int32_t* bs_pos,
                const uint8_t* hd_cols,  // [H, i] HDPC entries at pivot positions (or null)
                const int32_t* hd_sel,   // [u] sel slot -> HDPC row index, or -1 (or null)
                const uint8_t* vinv,     // [u, u] S^-1
                const uint8_t* g1,       // [i, nrhs]
                const uint8_t* g2,       // [u, nrhs]
                uint8_t* w1,             // out [i, nrhs]
                uint8_t* w2) {           // out [u, nrhs]
  const size_t R = (size_t)nrhs;
  PhaseTimer pt;
  // bucket triangle edges by their dep position p (incoming lists)
  std::vector<int64_t> tptr((size_t)i + 1, 0);
  for (int64_t e = 0; e < n_tri; e++) tptr[tri_ep[e] + 1]++;
  for (int32_t p = 0; p < i; p++) tptr[p + 1] += tptr[p];
  std::vector<int32_t> tsrc(n_tri);
  {
    std::vector<int64_t> cur(tptr.begin(), tptr.end() - 1);
    for (int64_t e = 0; e < n_tri; e++) tsrc[cur[tri_ep[e]]++] = tri_ek[e];
  }
  auto trisolve_T = [&](uint8_t* a) {  // in: rhs rows, out: a = rhs T^-1
    for (int32_t p = i - 1; p >= 0; p--) {
      uint8_t* dst = a + (size_t)p * R;
      for (int64_t e = tptr[p]; e < tptr[p + 1]; e++)
        row_xor(dst, a + (size_t)tsrc[e] * R, nrhs);
    }
  };

  pt.mark("ws_bucket");
  memcpy(w1, g1, (size_t)i * R);
  trisolve_T(w1);  // w1 holds a = g1 T^-1 for now
  pt.mark("ws_tri1");

  // t2 = g2 ^ a U  (ut edge (k, uc): t2[uc] ^= a[k])
  std::vector<uint8_t> t2((size_t)u * R);
  memcpy(t2.data(), g2, (size_t)u * R);
  for (int64_t e = 0; e < n_ut; e++)
    row_xor(t2.data() + (size_t)ut_uc[e] * R, w1 + (size_t)ut_ek[e] * R, nrhs);

  pt.mark("ws_ut");
  // w2 = t2 S^-1: w2[s] = XOR_c vinv[c][s] (x) t2[c]
  memset(w2, 0, (size_t)u * R);
  for (int32_t c = 0; c < u; c++) {
    const uint8_t* vrow = vinv + (size_t)c * u;
    const uint8_t* src = t2.data() + (size_t)c * R;
    for (int32_t s = 0; s < u; s++) {
      uint8_t b = vrow[s];
      if (!b) continue;
      uint8_t* dst = w2 + (size_t)s * R;
      if (b == 1) row_xor(dst, src, nrhs);
      else row_axpy(dst, src, b, nrhs);
    }
  }

  pt.mark("ws_vinv");
  // w1 = (g1 ^ w2 B) T^-1: binary sel rows via bs edges, HDPC rows dense
  memcpy(w1, g1, (size_t)i * R);
  for (int64_t e = 0; e < n_bs; e++)
    row_xor(w1 + (size_t)bs_pos[e] * R, w2 + (size_t)bs_sel[e] * R, nrhs);
  if (hdpc_used && hd_cols && hd_sel) {
    for (int32_t s = 0; s < u; s++) {
      int32_t h = hd_sel[s];
      if (h < 0) continue;
      const uint8_t* hrow = hd_cols + (size_t)h * i;
      const uint8_t* src = w2 + (size_t)s * R;
      for (int32_t p = 0; p < i; p++) {
        uint8_t b = hrow[p];
        if (!b) continue;
        uint8_t* dst = w1 + (size_t)p * R;
        if (b == 1) row_xor(dst, src, nrhs);
        else row_axpy(dst, src, b, nrhs);
      }
    }
  }
  pt.mark("ws_bsel");
  trisolve_T(w1);
  pt.mark("ws_tri2");
}

// Bit-packed variant for binary factorizations (no HDPC pivots): the rhs
// dimension is packed 64 combination rows per word, so every edge
// application is RW word XORs — 8x the byte path's density, and the output
// feeds a bit transpose instead of a byte scatter.  Layout: [len, RW]
// uint64, bit r of word w = combination row 64w + r.
void nrq_wsolve_gf2(int32_t nrhs_words, int32_t i, int32_t u,
                    int64_t n_tri, const int32_t* tri_ek, const int32_t* tri_ep,
                    int64_t n_ut, const int32_t* ut_ek, const int32_t* ut_uc,
                    int64_t n_bs, const int32_t* bs_sel, const int32_t* bs_pos,
                    const uint8_t* vinv,  // [u, u] 0/1
                    const uint64_t* g1,   // [i, RW]
                    const uint64_t* g2,   // [u, RW]
                    uint64_t* w1,         // out [i, RW]
                    uint64_t* w2) {       // out [u, RW]
  const int32_t RW = nrhs_words;
  PhaseTimer pt;
  std::vector<int64_t> tptr((size_t)i + 1, 0);
  for (int64_t e = 0; e < n_tri; e++) tptr[tri_ep[e] + 1]++;
  for (int32_t p = 0; p < i; p++) tptr[p + 1] += tptr[p];
  std::vector<int32_t> tsrc(n_tri);
  {
    std::vector<int64_t> cur(tptr.begin(), tptr.end() - 1);
    for (int64_t e = 0; e < n_tri; e++) tsrc[cur[tri_ep[e]]++] = tri_ek[e];
  }
  auto wxor = [&](uint64_t* dst, const uint64_t* src) {
    for (int32_t w = 0; w < RW; w++) dst[w] ^= src[w];
  };
  auto trisolve_T = [&](uint64_t* a) {
    for (int32_t p = i - 1; p >= 0; p--) {
      uint64_t* dst = a + (size_t)p * RW;
      for (int64_t e = tptr[p]; e < tptr[p + 1]; e++) wxor(dst, a + (size_t)tsrc[e] * RW);
    }
  };

  memcpy(w1, g1, (size_t)i * RW * 8);
  trisolve_T(w1);
  pt.mark("w2_tri1");

  std::vector<uint64_t> t2((size_t)u * RW);
  memcpy(t2.data(), g2, (size_t)u * RW * 8);
  for (int64_t e = 0; e < n_ut; e++)
    wxor(t2.data() + (size_t)ut_uc[e] * RW, w1 + (size_t)ut_ek[e] * RW);

  memset(w2, 0, (size_t)u * RW * 8);
  for (int32_t c = 0; c < u; c++) {
    const uint8_t* vrow = vinv + (size_t)c * u;
    const uint64_t* src = t2.data() + (size_t)c * RW;
    for (int32_t s = 0; s < u; s++)
      if (vrow[s]) wxor(w2 + (size_t)s * RW, src);
  }

  memcpy(w1, g1, (size_t)i * RW * 8);
  for (int64_t e = 0; e < n_bs; e++)
    wxor(w1 + (size_t)bs_pos[e] * RW, w2 + (size_t)bs_sel[e] * RW);
  trisolve_T(w1);
  pt.mark("w2_rest");
}

// 64x64-block bit transpose: dst bit [r, k] = src bit [k, r].
// src: [n, RW] uint64 (bit r of word w = row 64w + r of the transpose);
// dst: [nrhs, NW] uint64, NW = ceil(n/64).  Hacker's Delight 8x8 recursive
// doubling on each 64x64 tile.
static inline void t64(uint64_t* a) {
  // little-endian bit order (bit r of a[k] = element (k, r)): the classic
  // recursive-doubling swap with the shift direction flipped vs the
  // MSB-first Hacker's Delight formulation
  uint64_t m = 0x00000000FFFFFFFFull;
  for (int j = 32; j; j >>= 1, m ^= m << j) {
    for (int k = 0; k < 64; k = ((k | j) + 1) & ~j) {
      uint64_t t = ((a[k] >> j) ^ a[k | j]) & m;
      a[k] ^= t << j;
      a[k | j] ^= t;
    }
  }
}

void nrq_bit_transpose(int32_t n, int32_t nrhs, const uint64_t* src, uint64_t* dst) {
  const int32_t RW = (nrhs + 63) >> 6;
  const int32_t NW = (n + 63) >> 6;
  uint64_t tile[64];
  memset(dst, 0, (size_t)nrhs * NW * 8);
  for (int32_t kb = 0; kb < NW; kb++) {
    int32_t kmax = n - kb * 64 < 64 ? n - kb * 64 : 64;
    for (int32_t rb = 0; rb < RW; rb++) {
      for (int32_t k = 0; k < kmax; k++) tile[k] = src[(size_t)(kb * 64 + k) * RW + rb];
      for (int32_t k = kmax; k < 64; k++) tile[k] = 0;
      t64(tile);
      int32_t rmax = nrhs - rb * 64 < 64 ? nrhs - rb * 64 : 64;
      for (int32_t r = 0; r < rmax; r++) dst[(size_t)(rb * 64 + r) * NW + kb] = tile[r];
    }
  }
}

// Wut = T^-1 U_t over GF(2), columns (the u dimension) bit-packed 64 per
// word.  Forward substitution over the triangle's cross/in-chunk dep edges
// in pivot-position order: x[k] = U_t[k] ^ XOR_{(k,p)} x[p], p < k.  Edges
// may arrive in any order; they are CSR-bucketed by receiving position
// first.  This folds the replay's stage-4 sparse gather and stage-5 second
// trisolve into one host-precomputed dense bit matrix (the device then runs
// x_a = z ^ Wut x_u as a single MXU matmul).
void nrq_wut_solve(int32_t i, int32_t WW,
                   int64_t n_tri, const int32_t* tri_ek, const int32_t* tri_ep,
                   int64_t n_ut, const int32_t* ut_ek, const int32_t* ut_uc,
                   uint64_t* x) {  // [i, WW], zero-initialized by caller
  for (int64_t e = 0; e < n_ut; e++)
    x[(size_t)ut_ek[e] * WW + (ut_uc[e] >> 6)] |= 1ull << (ut_uc[e] & 63);
  std::vector<int64_t> ptr((size_t)i + 1, 0);
  for (int64_t e = 0; e < n_tri; e++) ptr[tri_ek[e] + 1]++;
  for (int32_t k = 0; k < i; k++) ptr[k + 1] += ptr[k];
  std::vector<int32_t> src(n_tri);
  {
    std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
    for (int64_t e = 0; e < n_tri; e++) src[cur[tri_ek[e]]++] = tri_ep[e];
  }
  for (int32_t k = 0; k < i; k++) {
    uint64_t* dst = x + (size_t)k * WW;
    for (int64_t e = ptr[k]; e < ptr[k + 1]; e++) {
      const uint64_t* s = x + (size_t)src[e] * WW;
      for (int32_t w = 0; w < WW; w++) dst[w] ^= s[w];
    }
  }
}

// Transpose + column-scatter of a position-major solve result into W:
//   W[r, rows[k]] = src[k, r]   (W [nrhs, n_cols] pre-zeroed)
// Two passes: a cache-blocked transpose into a [nrhs, n] temp, then one
// streaming scatter per W row (source contiguous, targets L1-resident
// within the row).  A single-pass tiling revisits all of W per tile and
// cost ~50 ms at K'=10017; the NumPy `W[:, rows] = src.T` was ~80 ms.
void nrq_wscatter(int32_t nrhs, int32_t n, const int32_t* rows, int32_t n_cols,
                  const uint8_t* src, uint8_t* W) {
  const int TB = 64;
  PhaseTimer pt;
  std::vector<uint8_t> tr((size_t)nrhs * n);
  for (int32_t k0 = 0; k0 < n; k0 += TB)
    for (int32_t r0 = 0; r0 < nrhs; r0 += TB) {
      int32_t k1 = k0 + TB < n ? k0 + TB : n;
      int32_t r1 = r0 + TB < nrhs ? r0 + TB : nrhs;
      for (int32_t k = k0; k < k1; k++)
        for (int32_t r = r0; r < r1; r++) tr[(size_t)r * n + k] = src[(size_t)k * nrhs + r];
    }
  pt.mark("wsc_tr");
  for (int32_t r = 0; r < nrhs; r++) {
    const uint8_t* srow = tr.data() + (size_t)r * n;
    uint8_t* wrow = W + (size_t)r * n_cols;
    for (int32_t k = 0; k < n; k++) wrow[rows[k]] = srow[k];
  }
  pt.mark("wsc_sc");
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Triangle replay planner (native mirror of the hot part of
// precode/device_schedule.py compile_device): degree-sorted intra-chunk
// permutation, conjugated chunk inverses, the segment/staircase cost DP, and
// the per-segment prefix-range gather index tensors.  This is the decode
// host-prep hot path — a new plan is built per loss pattern.
// ---------------------------------------------------------------------------

namespace {

struct TriPlan {
  std::vector<int32_t> posmap;     // [Lpad] old position -> new position
  std::vector<uint8_t> tinv;       // [nchunks, CB, CB/8] conjugated inverses,
                                   // bit-packed little-endian (np.packbits layout)
  std::vector<int32_t> seg_meta;   // [nseg * 3] (q0, nq, nranges)
  std::vector<int32_t> range_meta; // [tot_ranges * 3] (a, b, w)
  std::vector<uint16_t> ix;        // flat gather tensors, segment/range order
  std::vector<int32_t> counts;     // [Lpad] cross-chunk degree, sorted basis
  int status = 0;                  // 1: a degree exceeded the width grid;
                                   // 2: pattern does not fit the fixed layout
};

// Shared preamble of nrq_tri_plan / nrq_tri_fill: cross-chunk degree count,
// intra-chunk stable degree sort (-> out->posmap + order), conjugated
// bit-packed chunk inverses (-> out->tinv), and cross edges bucketed by
// sorted receiving row (-> counts/starts/edep).  The two entry points must
// stay bit-identical here — compile_device asserts posmap equality between
// the warm-up (plan) and frozen-fill paths.
static void tri_preamble(TriPlan* out, int32_t Lpad, int32_t CB, int64_t nedges,
                         const int32_t* dep_k, const int32_t* dep_pos,
                         std::vector<int32_t>& counts,
                         std::vector<int64_t>& starts,
                         std::vector<int32_t>& edep,
                         PhaseTimer& pt, const char* tag_sort,
                         const char* tag_tinv) {
  const int nchunks = Lpad / CB;

  // cross-chunk degree per receiving position (original basis)
  std::vector<int32_t> deg(Lpad, 0);
  for (int64_t e = 0; e < nedges; e++) {
    int k = dep_k[e];
    if (dep_pos[e] < (k / CB) * CB) deg[k]++;
  }

  // intra-chunk order: positions by non-increasing cross degree
  // (stable: ties keep ascending local index)
  std::vector<int32_t> order((size_t)nchunks * CB);  // new local -> old local
  std::vector<int32_t> posmap(Lpad);
  {
    std::vector<std::pair<int32_t, int32_t>> keys(CB);  // (-deg, local)
    for (int q = 0; q < nchunks; q++) {
      for (int l = 0; l < CB; l++) keys[l] = {-deg[q * CB + l], l};
      std::stable_sort(keys.begin(), keys.end());
      int32_t* ord = order.data() + (size_t)q * CB;
      for (int r = 0; r < CB; r++) {
        ord[r] = keys[r].second;
        posmap[q * CB + keys[r].second] = q * CB + r;
      }
    }
  }
  out->posmap = std::move(posmap);
  pt.mark(tag_sort);

  // chunk inverses, computed directly in the conjugated (degree-sorted)
  // basis, bit-packed.  In-chunk edges are sparse (~2-3/row), and forward
  // substitution is valid in any topological order, so processing old-local
  // rows ascending gives P Tinv P^T without ever materializing a dense T or
  // a conjugation gather:
  //   inv[rank[l]] = e_rank[l] ^ XOR_{(l, p) in-chunk} inv[rank[p]]
  {
    const int cw = CB >> 6;  // 64-bit words per packed row (CB % 64 == 0)
    out->tinv.assign((size_t)nchunks * CB * (CB / 8), 0);
    // bucket in-chunk edges by receiving position (counting sort -> edges
    // of one chunk are grouped and ordered by old-local row)
    std::vector<int32_t> icnt(Lpad + 1, 0);
    for (int64_t e = 0; e < nedges; e++) {
      int k = dep_k[e];
      if (dep_pos[e] >= (k / CB) * CB) icnt[k + 1]++;
    }
    for (int r = 0; r < Lpad; r++) icnt[r + 1] += icnt[r];
    std::vector<int32_t> ideps(icnt[Lpad]);
    {
      std::vector<int32_t> cur(icnt.begin(), icnt.end() - 1);
      for (int64_t e = 0; e < nedges; e++) {
        int k = dep_k[e];
        if (dep_pos[e] >= (k / CB) * CB) ideps[cur[k]++] = dep_pos[e] - (k / CB) * CB;
      }
    }
    std::vector<int32_t> rank(CB);
    for (int q = 0; q < nchunks; q++) {
      const int32_t* ord = order.data() + (size_t)q * CB;
      for (int r = 0; r < CB; r++) rank[ord[r]] = r;
      uint64_t* inv = (uint64_t*)(out->tinv.data() + (size_t)q * CB * (CB / 8));
      for (int l = 0; l < CB; l++) {
        int r = rank[l];
        uint64_t* dst = inv + (size_t)r * cw;
        dst[r >> 6] |= 1ull << (r & 63);
        for (int32_t e = icnt[q * CB + l]; e < icnt[q * CB + l + 1]; e++) {
          const uint64_t* src = inv + (size_t)rank[ideps[e]] * cw;
          for (int w = 0; w < cw; w++) dst[w] ^= src[w];
        }
      }
    }
  }
  pt.mark(tag_tinv);

  // cross edges in the sorted basis, stably bucketed by receiving row
  counts.assign(Lpad, 0);
  const int32_t* pm = out->posmap.data();
  for (int64_t e = 0; e < nedges; e++) {
    int k = dep_k[e];
    if (dep_pos[e] < (k / CB) * CB) counts[pm[k]]++;
  }
  starts.assign(Lpad + 1, 0);
  for (int r = 0; r < Lpad; r++) starts[r + 1] = starts[r] + counts[r];
  edep.assign(starts[Lpad], 0);
  {
    std::vector<int64_t> cur(starts.begin(), starts.end() - 1);
    for (int64_t e = 0; e < nedges; e++) {
      int k = dep_k[e];
      if (dep_pos[e] >= (k / CB) * CB) continue;
      edep[cur[pm[k]]++] = pm[dep_pos[e]];
    }
  }
}

}  // namespace

extern "C" {

// dep_k / dep_pos: cross+in-chunk dep edges over triangle *positions*
// (dep_pos < dep_k < Lpad, positions beyond i have no edges).  cand:
// ascending candidate prefix boundaries, last == CB.  wgrid: ascending
// gather-width grid.  seg_lens: ascending segment-length grid.
void* nrq_tri_plan(int32_t Lpad, int32_t CB, int64_t nedges,
                   const int32_t* dep_k, const int32_t* dep_pos,
                   const int32_t* cand, int32_t nc,
                   const int32_t* wgrid, int32_t nw,
                   double range_penalty, double seg_penalty,
                   int32_t max_ranges, const int32_t* seg_lens, int32_t nsl) {
  TriPlan* out = new TriPlan();
  const int nchunks = Lpad / CB;
  PhaseTimer pt;

  std::vector<int32_t> counts;
  std::vector<int64_t> starts;
  std::vector<int32_t> edep;
  tri_preamble(out, Lpad, CB, nedges, dep_k, dep_pos, counts, starts, edep,
               pt, "tp_sort", "tp_tinv");

  // degs[q][l] = counts in the sorted basis (non-increasing per chunk);
  // nnz_row[q] = number of rows with any cross dep
  std::vector<int32_t> nnz_row(nchunks, 0);
  for (int q = 0; q < nchunks; q++) {
    int nz = 0;
    for (int l = 0; l < CB; l++)
      if (counts[q * CB + l]) nz = l + 1;
    nnz_row[q] = nz;
  }

  // ---- inner cost model shared by the window DP and backtracking ----
  // degs_cand[q][ci] = degree at local row cand[ci] (0 for cand == CB)
  std::vector<int32_t> degs_cand((size_t)nchunks * nc, 0);
  for (int q = 0; q < nchunks; q++)
    for (int ci = 0; ci < nc; ci++)
      if (cand[ci] < CB) degs_cand[(size_t)q * nc + ci] = counts[q * CB + cand[ci]];
  // padded range length model: the gather kernel pads its row count
  std::vector<double> pad_len((size_t)nc * nc, 0.0);
  for (int ii = 0; ii < nc; ii++)
    for (int j = 0; j < nc; j++) {
      double rl = (double)cand[j] - cand[ii];
      pad_len[(size_t)ii * nc + j] = rl <= 8 ? 8.0 : (rl <= 16 ? 16.0 : 32.0 * std::ceil(rl / 32.0));
    }
  const double INF = 1e30;

  // Preallocated inner-DP workspace + a memo keyed on the window's reduced
  // profile (wq, lastnz): the per-chunk optimum depends on nothing else, and
  // sparse-tail windows repeat profiles constantly (the allocations and
  // redundant DP sweeps here were ~40% of plan time at K'=50511).
  std::vector<int32_t> wq_ws(nc), run_ws(nc);
  std::vector<double> dpv_ws(nc), nxt_ws(nc);
  struct MemoV { double best; };
  std::unordered_map<std::string, MemoV> memo;
  std::string key_ws;
  key_ws.reserve(nc * sizeof(int32_t) + 4);

  // wq + lastnz for window [a, b) given its run vector
  auto make_wq = [&](const int32_t* run) {
    for (int ci = 0; ci < nc; ci++) {
      if (!run[ci]) { wq_ws[ci] = 0; continue; }
      int w = -1;
      for (int g = 0; g < nw; g++)
        if (wgrid[g] >= run[ci]) { w = wgrid[g]; break; }
      if (w < 0) { out->status = 1; w = wgrid[nw - 1]; }  // out-of-grid degree
      wq_ws[ci] = w;
    }
  };

  // per-chunk optimum for the current wq_ws/lastnz; if bk != nullptr,
  // records per-iteration argmin backpointers and the terminal (g, j)
  auto dp_sweep = [&](int lastnz, std::vector<int32_t>* bk, int* out_g, int* out_j) -> double {
    std::fill(dpv_ws.begin(), dpv_ws.end(), INF);
    dpv_ws[0] = 0.0;
    double best = INF;
    int bg = -1, bj = -1;
    for (int g = 0; g < max_ranges; g++) {
      bool changed = false;
      for (int j = 1; j < nc; j++) {
        double bv = INF;
        int bi = 0;
        for (int ii = 0; ii < j; ii++) {
          if (dpv_ws[ii] >= INF) continue;
          double v = dpv_ws[ii] + (wq_ws[ii] ? range_penalty : 0.0) + (double)wq_ws[ii] * pad_len[(size_t)ii * nc + j];
          if (v < bv) { bv = v; bi = ii; }
        }
        nxt_ws[j] = bv;
        if (bv < dpv_ws[j]) changed = true;
        if (bk) (*bk)[(size_t)g * nc + j] = bi;
      }
      nxt_ws[0] = INF;
      dpv_ws.swap(nxt_ws);
      for (int j = 0; j < nc; j++)
        if (cand[j] >= lastnz && dpv_ws[j] < best) { best = dpv_ws[j]; bg = g; bj = j; }
      if (!changed) break;  // fixed point: later iterations cannot improve
    }
    if (out_g) { *out_g = bg; *out_j = bj; }
    return best;
  };

  // full-window variant used only for backtracking the ~nseg chosen windows
  auto inner_cost_bt = [&](int a, int b, std::vector<int32_t>* bk, int* out_g, int* out_j) -> double {
    std::fill(run_ws.begin(), run_ws.end(), 0);
    int lastnz = 0;
    for (int q = a; q < b; q++) {
      const int32_t* dc = degs_cand.data() + (size_t)q * nc;
      for (int ci = 0; ci < nc; ci++)
        if (dc[ci] > run_ws[ci]) run_ws[ci] = dc[ci];
      if (nnz_row[q] > lastnz) lastnz = nnz_row[q];
    }
    make_wq(run_ws.data());
    double best = dp_sweep(lastnz, bk, out_g, out_j);
    if (best >= INF) {  // no deps at all in the window
      if (out_g) *out_g = -1;
      return 0.0;
    }
    return (double)(b - a) * best;
  };

  // ---- outer DP over chunk segments.  For one endpoint b the windows
  // [b-len, b) nest as len grows, so run/lastnz update incrementally
  // across the ascending seg_lens loop instead of rescanning each window.
  std::vector<double> dp(nchunks + 1, INF);
  std::vector<int32_t> back(nchunks + 1, -1);
  dp[0] = 0.0;
  for (int b = 1; b <= nchunks; b++) {
    std::fill(run_ws.begin(), run_ws.end(), 0);
    int lastnz = 0;
    int covered = b;  // run_ws covers chunks [covered, b)
    for (int si = 0; si < nsl; si++) {
      int len = seg_lens[si];
      if (len > b) break;
      int a = b - len;
      while (covered > a) {
        covered--;
        const int32_t* dc = degs_cand.data() + (size_t)covered * nc;
        for (int ci = 0; ci < nc; ci++)
          if (dc[ci] > run_ws[ci]) run_ws[ci] = dc[ci];
        if (nnz_row[covered] > lastnz) lastnz = nnz_row[covered];
      }
      if (dp[a] >= INF) continue;
      // branch-and-bound: window cost >= 0, so a start that cannot beat
      // the incumbent even with a free window is skipped outright
      if (dp[a] + seg_penalty >= dp[b]) continue;
      double per_chunk;
      if (!lastnz) {
        per_chunk = 0.0;  // empty window
      } else {
        make_wq(run_ws.data());
        key_ws.assign((const char*)wq_ws.data(), nc * sizeof(int32_t));
        key_ws.append((const char*)&lastnz, sizeof(lastnz));
        auto it = memo.find(key_ws);
        if (it != memo.end()) {
          per_chunk = it->second.best;
        } else {
          double best = dp_sweep(lastnz, nullptr, nullptr, nullptr);
          per_chunk = best >= INF ? 0.0 : best;
          memo.emplace(key_ws, MemoV{per_chunk});
        }
      }
      double v = dp[a] + (double)len * per_chunk + seg_penalty;
      if (v < dp[b]) { dp[b] = v; back[b] = a; }
    }
  }

  pt.mark("tp_dp");
  std::vector<std::pair<int, int>> merged;  // (a, b)
  for (int b = nchunks; b > 0; b = back[b]) merged.push_back({back[b], b});
  std::reverse(merged.begin(), merged.end());

  // ---- per-segment ranges + gather index tensors ----
  std::vector<int32_t> bkbuf((size_t)max_ranges * nc);
  for (auto [a, b] : merged) {
    int nq = b - a;
    int g = -1, j = -1;
    std::fill(bkbuf.begin(), bkbuf.end(), 0);
    inner_cost_bt(a, b, &bkbuf, &g, &j);
    // backtrack chosen boundaries (reverse order), recompute each range's wq
    std::vector<std::array<int32_t, 3>> bounds;  // (a_r, b_r, w)
    if (g >= 0) {
      std::vector<int32_t> run(nc, 0);
      for (int q = a; q < b; q++) {
        const int32_t* dc = degs_cand.data() + (size_t)q * nc;
        for (int ci = 0; ci < nc; ci++)
          if (dc[ci] > run[ci]) run[ci] = dc[ci];
      }
      while (g >= 0 && j > 0) {
        int ii = bkbuf[(size_t)g * nc + j];
        if (run[ii]) {
          int w = wgrid[nw - 1];
          for (int gi = 0; gi < nw; gi++)
            if (wgrid[gi] >= run[ii]) { w = wgrid[gi]; break; }
          bounds.push_back({cand[ii], cand[j], w});
        }
        j = ii;
        g--;
      }
      std::reverse(bounds.begin(), bounds.end());
    }
    out->seg_meta.push_back(a);
    out->seg_meta.push_back(nq);
    out->seg_meta.push_back((int32_t)bounds.size());
    for (auto& bd : bounds) {
      int a_r = bd[0], b_r = bd[1], w = bd[2];
      out->range_meta.push_back(a_r);
      out->range_meta.push_back(b_r);
      out->range_meta.push_back(w);
      size_t base = out->ix.size();
      out->ix.resize(base + (size_t)nq * (b_r - a_r) * w, (uint16_t)Lpad);
      for (int q = a; q < b; q++) {
        for (int l = a_r; l < b_r && l < CB; l++) {
          int64_t s0 = starts[q * CB + l];
          int n = counts[q * CB + l];
          uint16_t* dst = out->ix.data() + base
                          + (((size_t)(q - a) * (b_r - a_r)) + (l - a_r)) * w;
          for (int e = 0; e < n && e < w; e++) dst[e] = (uint16_t)edep[s0 + e];
        }
      }
    }
  }
  pt.mark("tp_fill");
  return out;
}

// Fixed-layout fill: the canonical-decode hot path.  Same sort/tinv/bucket
// pipeline as nrq_tri_plan but NO planning — the segment/range layout comes
// in as (seg_meta, range_meta) from the per-K' frozen layout, ranges may
// overlap (a row's deps split across covering ranges by cumulative width),
// and the pattern is validated against the layout (status=2 on misfit:
// a row degree above the total covering width, or a nonzero row beyond the
// covered prefix).  counts (sorted-basis degrees) are always exported so
// the caller can grow the envelope on misfit.
void* nrq_tri_fill(int32_t Lpad, int32_t CB, int64_t nedges,
                   const int32_t* dep_k, const int32_t* dep_pos,
                   const int32_t* seg_meta, int32_t nseg,
                   const int32_t* range_meta) {
  TriPlan* out = new TriPlan();
  PhaseTimer pt;

  std::vector<int64_t> starts;
  std::vector<int32_t> edep;
  tri_preamble(out, Lpad, CB, nedges, dep_k, dep_pos, out->counts, starts,
               edep, pt, "tf_sort", "tf_tinv");
  std::vector<int32_t>& counts = out->counts;
  pt.mark("tf_bucket");

  // ---- validate + fill the fixed layout ----
  out->seg_meta.assign(seg_meta, seg_meta + (size_t)nseg * 3);
  int64_t ix_total = 0;
  {
    int rmi = 0;
    for (int s = 0; s < nseg; s++) {
      int nq = seg_meta[s * 3 + 1], nr = seg_meta[s * 3 + 2];
      for (int r = 0; r < nr; r++, rmi++) {
        int a = range_meta[rmi * 3], b = range_meta[rmi * 3 + 1], w = range_meta[rmi * 3 + 2];
        ix_total += (int64_t)nq * (b - a) * w;
      }
    }
    out->range_meta.assign(range_meta, range_meta + (size_t)rmi * 3);
  }
  out->ix.assign(ix_total, (uint16_t)Lpad);  // sentinel = zero row of z
  {
    int64_t base = 0;
    int rmi = 0;
    std::vector<int64_t> rbase;
    std::vector<int32_t> tw(CB);
    for (int s = 0; s < nseg && out->status == 0; s++) {
      int q0 = seg_meta[s * 3], nq = seg_meta[s * 3 + 1], nr = seg_meta[s * 3 + 2];
      const int32_t* rm = range_meta + (size_t)rmi * 3;
      rbase.assign(nr, 0);
      std::fill(tw.begin(), tw.end(), 0);
      int cover = 0;
      for (int r = 0; r < nr; r++) {
        rbase[r] = base;
        int a = rm[r * 3], b = rm[r * 3 + 1], w = rm[r * 3 + 2];
        base += (int64_t)nq * (b - a) * w;
        for (int l = a; l < b; l++) tw[l] += w;
        if (b > cover) cover = b;
      }
      for (int q = q0; q < q0 + nq && out->status == 0; q++) {
        for (int l = 0; l < CB; l++) {
          int row = q * CB + l;
          int n = counts[row];
          if (!n) break;  // sorted: degrees are non-increasing within a chunk
          if (l >= cover || n > tw[l]) { out->status = 2; break; }
          int64_t s0 = starts[row];
          int taken = 0;
          for (int r = 0; r < nr && taken < n; r++) {
            int a = rm[r * 3], b = rm[r * 3 + 1], w = rm[r * 3 + 2];
            if (l < a || l >= b) continue;
            int take = n - taken < w ? n - taken : w;
            uint16_t* dst = out->ix.data() + rbase[r]
                            + ((size_t)(q - q0) * (b - a) + (l - a)) * w;
            for (int e = 0; e < take; e++) dst[e] = (uint16_t)edep[s0 + taken + e];
            taken += take;
          }
        }
      }
      rmi += nr;
    }
  }
  pt.mark("tf_fill");
  return out;
}

const int32_t* nrq_tp_counts(void* h) { return ((TriPlan*)h)->counts.data(); }

int32_t nrq_tp_status(void* h) { return ((TriPlan*)h)->status; }
const int32_t* nrq_tp_posmap(void* h) { return ((TriPlan*)h)->posmap.data(); }
const uint8_t* nrq_tp_tinv(void* h) { return ((TriPlan*)h)->tinv.data(); }
int32_t nrq_tp_nseg(void* h) { return (int32_t)(((TriPlan*)h)->seg_meta.size() / 3); }
const int32_t* nrq_tp_seg_meta(void* h) { return ((TriPlan*)h)->seg_meta.data(); }
int32_t nrq_tp_nranges(void* h) { return (int32_t)(((TriPlan*)h)->range_meta.size() / 3); }
const int32_t* nrq_tp_range_meta(void* h) { return ((TriPlan*)h)->range_meta.data(); }
const uint16_t* nrq_tp_ix(void* h) { return ((TriPlan*)h)->ix.data(); }
int64_t nrq_tp_ix_len(void* h) { return (int64_t)((TriPlan*)h)->ix.size(); }
void nrq_tp_free(void* h) { delete (TriPlan*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched host-side block repair — the adaptive runtime's CPU arm.
//
// When the host<->device link's per-op latency would dominate (fresh loss
// patterns, one-shot decodes, small blocks), shipping a per-pattern plan to
// the device loses to just doing the O(nnz * T) byte work here, next to the
// solver.  This fuses, per block: solve (nrq_solve above) + sparse
// substitution over the payload rows + LT combine of the gap symbols —
// the reference's nanorq_repair_block (lib/nanorq.c:591-630) as one native
// call batched over blocks, so no per-block Python or device round trips.
//
// Math (D rows are T-byte payloads; GF(2) throughout except where noted):
//   z  = T^-1 y           y_k = D[piv_rows[k]]; tri edges are ascending-k
//   rhs_s = D[sel_s] ^ (sel row's pivot-col entries) . z     (Schur RHS)
//     HDPC selected rows (overhead < H patterns): payload is zero and the
//     pivot-col coefficients are GF(256) bytes -> rhs_h = sum_k
//     hdpc[h][piv_cols[k]] (x) z_k via the nibble-LUT axpy
//   xu = vinv . rhs       (u x u inverse of the pristine Schur snapshot;
//                          binary or GF(256) to match the factorization)
//   xa = T^-1 (y ^ Ut xu) (ut edges = pivot rows' inactive entries)
//   C[piv_cols[k]] = xa_k, C[u_cols[j]] = xu_j
//   out_g = XOR C[cols of gap g's LT row]
// ---------------------------------------------------------------------------

namespace {

inline void rxor(uint8_t* __restrict dst, const uint8_t* __restrict src, int n) {
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    uint64_t a, b;
    memcpy(&a, dst + j, 8);
    memcpy(&b, src + j, 8);
    a ^= b;
    memcpy(dst + j, &a, 8);
  }
  for (; j < n; j++) dst[j] ^= src[j];
}

}  // namespace

namespace {

// Edge-loop prefetch: pull the row for edge e+PF_DIST toward L1 while edge
// e's XOR runs (the rxor of one 1+ KB row is long enough to hide most of an
// L3/DRAM miss at this distance).
constexpr size_t PF_DIST = 6;

// Prefetch only the HEAD of the row: the hardware stream prefetcher picks
// up the sequential tail once the first lines are touched, and issuing all
// T/64 (=20 at T=1280) prefetches per row measurably LOSES — standalone
// substitution microbench (scattered ascending-k XOR stream, this host):
// full-row 63.5 ms vs head-4 44.1 ms vs none 47.8 ms at I=50000 rows.
constexpr int PF_HEAD_LINES = 4;

inline void prefetch_row(const uint8_t* p, int n) {
#if defined(__SSE__) || defined(__AVX2__)
  int lim = PF_HEAD_LINES * 64 < n ? PF_HEAD_LINES * 64 : n;
  for (int off = 0; off < lim; off += 64)
    _mm_prefetch((const char*)p + off, _MM_HINT_T0);
#else
  (void)p;
  (void)n;
#endif
}

// Huge-page-backed grow-only scratch for the per-thread z buffer.  Stage 1
// reads rows SCATTERED over tens of MB; on 4 KB pages every row fetch is
// also a TLB miss (the buffer spans ~16k pages at K'=50000), which the
// head-line prefetch cannot hide.  2 MB pages cover the whole buffer with
// ~32 TLB entries — microbench of the fused sweep at I=50000: 41.2 ms on
// malloc'd 4 KB pages vs 27.8 ms under MADV_HUGEPAGE (THP is
// madvise-only on this host).  Contents are NOT preserved across resize
// (stage 1 fully rewrites z per block).
struct HugeBuf {
  uint8_t* p = nullptr;
  size_t cap = 0;
  HugeBuf() = default;
  HugeBuf(const HugeBuf&) = delete;
  HugeBuf& operator=(const HugeBuf&) = delete;
  ~HugeBuf() {
    if (p) munmap(p, cap);
  }
  uint8_t* data() { return p; }
  void resize(size_t n) {
    if (n <= cap) return;
    if (p) munmap(p, cap);
    const size_t huge = (size_t)2 << 20;
    size_t r = (n + huge - 1) & ~(huge - 1);
    void* m = mmap(nullptr, r, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (m == MAP_FAILED) {
      p = nullptr;
      cap = 0;
      throw std::bad_alloc();
    }
    p = (uint8_t*)m;
    cap = r;
#ifdef MADV_HUGEPAGE
    if (r >= huge) madvise(p, r, MADV_HUGEPAGE);
#endif
  }
};

struct StageClk {
  double* acc;  // [6] ms accumulators (solve, s1, s2, s3, s4, s5) or null
  struct timespec t0;
  explicit StageClk(double* a) : acc(a) {
    if (acc) clock_gettime(CLOCK_MONOTONIC, &t0);
  }
  void mark(int s) {
    if (!acc) return;
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    acc[s] += (t1.tv_sec - t0.tv_sec) * 1e3 + (t1.tv_nsec - t0.tv_nsec) / 1e6;
    t0 = t1;
  }
};

// One block's repair: solve + substitution + LT gap combine.  Payload rows
// are addressed through rowp[] (per-row pointers into the decoder's live
// ingestion state — zero-copy; rows are only ever READ).
void host_repair_block(
    int L, int W, int S, int H, int T, int NB,
    const int32_t* row_ptr, const int32_t* row_cols, const uint8_t* hdpc,
    const uint64_t* rowp, int ng, const int32_t* gptr, const int32_t* gcols,
    const uint64_t* outpp, int32_t* status,
    HugeBuf& z, std::vector<uint8_t>& rhs, std::vector<uint8_t>& xu,
    std::vector<uint8_t>& acc, std::vector<uint8_t>& m4r,
    std::vector<int32_t>& pivpos, std::vector<int32_t>& ucolof,
    std::vector<uint8_t>& need1, std::vector<uint64_t>& bbits,
    double* stage_ms = nullptr) {
  StageClk ck(stage_ms);
  *status = 3;
  void* h = nrq_solve(NB, L, W, S, H, row_ptr, row_cols, hdpc);
  ck.mark(0);
  Solver* sv = (Solver*)h;
  if (sv->status) {
    *status = 1;
    nrq_free(h);
    return;
  }
  const int i = (int)sv->piv_rows.size();
  const int u = L - i;
  auto ROW = [&](int r) { return (const uint8_t*)(uintptr_t)rowp[r]; };
  for (int c = 0; c < L; c++) pivpos[c] = -1, ucolof[c] = -1;
  for (int k = 0; k < i; k++) pivpos[sv->piv_cols[k]] = k;
  for (int j = 0; j < u; j++) ucolof[sv->u_cols[j]] = j;

  z.resize((size_t)std::max(i, 1) * T);
  rhs.resize((size_t)std::max(u, 1) * T);
  xu.resize((size_t)std::max(u, 1) * T);
  auto Z = [&](int k) { return z.data() + (size_t)k * T; };
  auto RHS = [&](int s) { return rhs.data() + (size_t)s * T; };
  auto XU = [&](int j) { return xu.data() + (size_t)j * T; };

  // Backward-slice pruning: z is only ever read in slices — stage 2 reads
  // it at the dense rows' pivot columns (all of z when an HDPC row is
  // selected: its coefficients are dense), stage 5 at the gap rows' LT
  // positions.  Mark the consumers, then one REVERSE pass over the
  // ascending-k edge list closes the set under the substitution
  // dependencies (edge (k,p) has p < k, so p's own incoming edges sit
  // earlier in the list).  The sweep then touches only the consumers'
  // ancestors; rows outside the set are never computed.
  const size_t nte = sv->tri_ek.size();
  if (stage_ms && getenv("NRQ_STRUCT"))
    fprintf(stderr,
            "host_repair_block: L=%d i=%d u=%d ng=%d nte=%zu nue=%zu\n", L, i,
            u, ng, nte, sv->ut_ek.size());
  need1.assign(i, 0);
  bool all1 = false;
  for (int s = 0; s < u; s++) {
    int r = sv->order[i + s];
    if (r >= NB) { all1 = true; break; }  // HDPC RHS reads every z row
    for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++) {
      int p = pivpos[row_cols[e]];
      if (p >= 0) need1[p] = 1;
    }
  }
  if (all1 && i) memset(need1.data(), 1, i);
  if (!all1)
    for (int g = 0; g < ng; g++)
      for (int32_t e = gptr[g]; e < gptr[g + 1]; e++) {
        int p = pivpos[gcols[e]];
        if (p >= 0) need1[p] = 1;
      }
  if (!all1)
    for (size_t e = nte; e-- > 0;)
      if (need1[sv->tri_ek[e]]) need1[sv->tri_ep[e]] = 1;

  if (stage_ms && getenv("NRQ_STRUCT")) {
    size_t nneed = 0, nexec = 0;
    for (int k = 0; k < i; k++) nneed += need1[k];
    for (size_t e = 0; e < nte; e++) nexec += need1[sv->tri_ek[e]];
    fprintf(stderr, "  s1: need %zu/%d rows, exec %zu/%zu edges\n", nneed, i,
            nexec, nte);
  }

  // stage 1: z = T^-1 y on the consumed slice (tri edges ascending in k,
  // so the edges of one destination row form a contiguous run).  Fuse the
  // row init into the edge sweep: initialize Z(k) from its payload row and
  // immediately XOR that run's sources while Z(k) is L1-hot — a separate
  // init pass writes every z row first and re-faults each one from DRAM
  // when its edges come around (z is tens of MB at large K').  Sources are
  // scattered over z, so prefetch a few edges ahead to hide the miss
  // behind the current XOR.
  {
    size_t e = 0;
    for (int k = 0; k < i; k++) {
      if (k + (int)PF_DIST < i && need1[k + PF_DIST])
        prefetch_row(ROW(sv->piv_rows[k + PF_DIST]), T);
      size_t e2 = e;
      while (e2 < nte && sv->tri_ek[e2] == k) e2++;
      if (need1[k]) {
        uint8_t* dst = Z(k);
        memcpy(dst, ROW(sv->piv_rows[k]), T);
        for (size_t q = e; q < e2; q++) {
          if (q + PF_DIST < nte && need1[sv->tri_ek[q + PF_DIST]])
            prefetch_row(Z(sv->tri_ep[q + PF_DIST]), T);
          rxor(dst, Z(sv->tri_ep[q]), T);
        }
      }
      e = e2;
    }
  }
  ck.mark(1);

  // stage 2: Schur RHS over the selected dense-pivot rows order[i..i+u)
  for (int s = 0; s < u; s++) {
    int r = sv->order[i + s];
    if (r >= NB) {  // HDPC constraint row: zero payload, GF(256) coeffs
      if (!sv->hdpc_used) { nrq_free(h); return; }
      const uint8_t* ah = hdpc + (size_t)(r - NB) * L;
      memset(RHS(s), 0, T);
      for (int k = 0; k < i; k++) {
        uint8_t beta = ah[sv->piv_cols[k]];
        if (beta) row_axpy(RHS(s), Z(k), beta, T);
      }
      continue;
    }
    memcpy(RHS(s), ROW(r), T);
    for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; e++) {
      int p = pivpos[row_cols[e]];
      if (p >= 0) rxor(RHS(s), Z(p), T);
    }
  }
  ck.mark(2);

  // stage 3: xu = vinv . rhs (binary inverse or GF(256), same loop)
  for (int j = 0; j < u; j++) {
    uint8_t* out = XU(j);
    memset(out, 0, T);
    const uint8_t* vrow = sv->vinv.data() + (size_t)j * u;
    for (int m = 0; m < u; m++) {
      uint8_t beta = vrow[m];
      if (beta == 1) rxor(out, RHS(m), T);
      else if (beta) row_axpy(out, RHS(m), beta, T);
    }
  }
  ck.mark(3);

  // stage 4: the u-block correction as BITS, not payloads.  The full
  // solution at pivot k is xa_k = z_k ^ delta_k with
  // delta = T^-1 (Ut xu) = sum_j (T^-1 ut_col_j) xu_j — the correction
  // lives in the span of the u xu rows, so instead of a second payload
  // substitution over y (i scattered row reads + nue + nte T-byte XORs),
  // propagate B = T^-1 Ut as i x u BITS through the same edges (word XORs,
  // ~KBs of traffic) and fold the xu rows in at stage 5 by parity.
  const size_t nue = sv->ut_ek.size();
  const int W64 = (u + 63) >> 6;
  bbits.assign((size_t)std::max(i, 1) * W64, 0);
  auto BB = [&](int k) { return bbits.data() + (size_t)k * W64; };
  for (size_t e = 0; e < nue; e++)
    BB(sv->ut_ek[e])[sv->ut_uc[e] >> 6] ^= 1ull << (sv->ut_uc[e] & 63);
  if (W64 == 1) {
    for (size_t e = 0; e < nte; e++) bbits[sv->tri_ek[e]] ^= bbits[sv->tri_ep[e]];
  } else {
    for (size_t e = 0; e < nte; e++) {
      uint64_t* bk = BB(sv->tri_ek[e]);
      const uint64_t* bp = BB(sv->tri_ep[e]);
      for (int w = 0; w < W64; w++) bk[w] ^= bp[w];
    }
  }
  ck.mark(4);

  // stage 5: gap outputs = XOR C[cols]; C[piv k] = z_k ^ delta_k,
  // C[u col j] = xu_j.  Per gap: XOR the stage-1 z rows, collect the
  // parity of the B-rows touched, then XOR the parity-selected xu rows —
  // xu is u x T (KBs): those reads stay cache-hot.  Accumulate in a hot
  // local row, then ONE copy to the per-ROW destination (callers may
  // point destinations straight into the decode output object;
  // XOR-accumulating into that far memory directly would re-read it per
  // neighbor).
  acc.resize(T);
  std::vector<uint64_t> par(W64);
  const int32_t ge_end = gptr[ng];
  // xu fold strategy: the per-gap parity vectors are DENSE (~u/2 set bits;
  // B = T^-1 Ut fills in), so folding xu rows directly costs ~ng*u/2 row
  // XORs — but those reads come from the u*T xu buffer, which is L2-hot.
  // "Four Russians" grouping (g bits per group, 2^g precomputed subset
  // rows each) cuts the fold count to ~ngrp per gap, but only pays when
  // the table ITSELF stays cache-resident: an 8-bit/group table at
  // u=355/T=1280 is ~15 MB of DRAM-streaming reads, measured SLOWER than
  // the hot popcount fold under multi-block thread contention.  So pick
  // the group size by modeled row-ops among the variants whose table fits
  // the per-thread budget, popcount fold included as g=0.
  const size_t m4r_budget =
      getenv("NRQ_M4R_BUDGET") ? strtoull(getenv("NRQ_M4R_BUDGET"), nullptr, 10)
                               : (size_t)2 << 20;
  int g_bits = 0;
  if (u >= 16 && ng > 0) {
    double best_ops = (double)ng * u * 0.5;  // g=0: expected popcount folds
    for (int g = 2; g <= 8; g <<= 1) {  // g must divide 64: no group may
                                        // straddle a par word boundary
      const int ngrp_g = (u + g - 1) / g;
      if ((size_t)ngrp_g * ((size_t)1 << g) * T > m4r_budget) continue;
      const double ops =
          (double)ngrp_g * (1 << g) + (double)ng * ngrp_g * (1.0 - 1.0 / (1 << g));
      if (ops < best_ops) best_ops = ops, g_bits = g;
    }
  }
  const int ngrp = g_bits ? (u + g_bits - 1) / g_bits : 0;
  if (g_bits) {
    const size_t ent = (size_t)1 << g_bits;
    m4r.resize((size_t)ngrp * ent * T);
    for (int grp = 0; grp < ngrp; grp++) {
      uint8_t* tb = m4r.data() + (size_t)grp * ent * T;
      memset(tb, 0, T);
      const int base = grp * g_bits, lim = std::min(g_bits, u - base);
      for (int m = 1; m < (1 << lim); m++) {
        uint8_t* dst = tb + (size_t)m * T;
        memcpy(dst, tb + (size_t)(m & (m - 1)) * T, T);
        rxor(dst, XU(base + __builtin_ctz(m)), T);
      }
    }
  }
  const uint64_t g_mask = g_bits ? (((uint64_t)1 << g_bits) - 1) : 0;
  size_t nfold = 0, nzread = 0;
  for (int g = 0; g < ng; g++) {
    uint8_t* o = acc.data();
    memset(o, 0, T);
    for (int w = 0; w < W64; w++) par[w] = 0;
    for (int32_t e = gptr[g]; e < gptr[g + 1]; e++) {
      // flat-distance prefetch across the whole gap edge stream (a
      // per-gap burst floods the load queue; a fixed edge distance
      // keeps exactly PF_DIST rows in flight)
      if (e + (int32_t)PF_DIST < ge_end) {
        int pn = pivpos[gcols[e + PF_DIST]];
        if (pn >= 0) prefetch_row(Z(pn), T);
      }
      int c = gcols[e];
      int p = pivpos[c];
      if (p >= 0) {
        rxor(o, Z(p), T);
        nzread++;
        const uint64_t* bp = BB(p);
        for (int w = 0; w < W64; w++) par[w] ^= bp[w];
      } else {
        par[ucolof[c] >> 6] ^= 1ull << (ucolof[c] & 63);
      }
    }
    if (g_bits) {
      for (int grp = 0; grp < ngrp; grp++) {  // grp == par bits [grp*g, +g)
        const int bit = grp * g_bits;
        uint64_t b = (par[bit >> 6] >> (bit & 63)) & g_mask;  // g divides 64
        if (b) {
          rxor(o, m4r.data() + (((size_t)grp << g_bits) + b) * T, T);
          nfold++;
        }
      }
    } else {
      for (int w = 0; w < W64; w++) {
        uint64_t m = par[w];
        while (m) {
          int j = (w << 6) + __builtin_ctzll(m);
          m &= m - 1;
          rxor(o, XU(j), T);
          nfold++;
        }
      }
    }
    memcpy((uint8_t*)(uintptr_t)outpp[g], o, T);
  }
  if (stage_ms && getenv("NRQ_STRUCT"))
    fprintf(stderr, "  s5: ng=%d zreads=%zu xu_folds=%zu\n", ng, nzread, nfold);
  ck.mark(5);
  *status = 0;
  nrq_free(h);
}

}  // namespace

extern "C" {

// Per-block arrays are concatenated; *_off give each block's start.  All
// blocks share (L, W, S, H, T) — one K' per call.  rowp_all holds per-block
// arrays of NB per-ROW payload pointers (zero-copy: sources point into the
// decoder's ingestion matrix, gap/overhead slots into the repair payloads,
// constraint/padding rows at a shared zero row); out_ptrs are raw addresses
// of per-block [ngaps, T] output matrices.
// statuses[b]: 0 ok, 1 rank-deficient, 3 internal inconsistency (never
// expected).  nthreads > 1 partitions blocks across that many threads
// (blocks are independent; the solver and tables are reentrant/read-only).
void nrq_host_repair(
    int32_t nb, int32_t L, int32_t W, int32_t S, int32_t H, int32_t T,
    const int32_t* NBs,
    const int64_t* rp_off, const int32_t* row_ptr_all,
    const int64_t* rc_off, const int32_t* row_cols_all,
    const uint8_t* hdpc,
    const int64_t* dp_off, const uint64_t* rowp_all,
    const int32_t* ngaps,
    const int64_t* gp_off, const int32_t* gap_ptr_all,
    const int64_t* gc_off, const int32_t* gap_cols_all,
    const uint64_t* out_ptrs,
    int32_t* statuses, int32_t nthreads) {
  const bool timing = getenv("NRQ_TIMING") != nullptr;
  double stage_ms[6] = {0, 0, 0, 0, 0, 0};
  auto run_range = [&](int b0, int b1) {
    HugeBuf z;
    std::vector<uint8_t> rhs, xu, acc, m4r, need1;
    std::vector<uint64_t> bbits;
    std::vector<int32_t> pivpos(L), ucolof(L);
    std::vector<uint64_t> outrp;
    for (int b = b0; b < b1; b++) {
      outrp.resize(std::max(ngaps[b], 1));
      for (int g = 0; g < ngaps[b]; g++)
        outrp[g] = out_ptrs[b] + (uint64_t)g * (uint64_t)T;
      host_repair_block(
          L, W, S, H, T, NBs[b],
          row_ptr_all + rp_off[b], row_cols_all + rc_off[b], hdpc,
          rowp_all + dp_off[b], ngaps[b], gap_ptr_all + gp_off[b],
          gap_cols_all + gc_off[b], outrp.data(),
          statuses + b, z, rhs, xu, acc, m4r, pivpos, ucolof, need1, bbits,
          (timing && b0 == 0) ? stage_ms : nullptr);
    }
  };
  int nt = std::min<int>(std::max<int>(nthreads, 1), nb);
  if (nt <= 1) {
    run_range(0, nb);
  } else {
    std::vector<std::thread> workers;
    workers.reserve(nt);
    for (int w = 0; w < nt; w++) {
      int b0 = (int)((int64_t)nb * w / nt), b1 = (int)((int64_t)nb * (w + 1) / nt);
      workers.emplace_back(run_range, b0, b1);
    }
    for (auto& t : workers) t.join();
  }
  if (timing)
    fprintf(stderr,
            "nrq_host_repair (thread 0): solve %.1f s1 %.1f s2 %.1f s3 %.1f "
            "s4 %.1f s5 %.1f ms\n",
            stage_ms[0], stage_ms[1], stage_ms[2], stage_ms[3], stage_ms[4],
            stage_ms[5]);
}

// ---------------------------------------------------------------------------
// RFC 6330 LT row generation (s5.3.5.1 PRNG, s5.3.5.2 degree, s5.3.5.3-4
// tuple + index expansion; parity with rfc/{rand,tuples}.py).  The normative
// tables are injected once via nrq_lt_init from the Python package so the
// constants have a single source of truth (rfc/_tabledata.py).
// ---------------------------------------------------------------------------

static uint32_t LT_V[4][256];
static uint32_t LT_F[64];
static int32_t LT_NF = 0;

static inline uint32_t lt_rnd(uint32_t y, uint32_t i, uint32_t m) {
  return (LT_V[0][(y + i) & 0xFF] ^ LT_V[1][((y >> 8) + i) & 0xFF] ^
          LT_V[2][((y >> 16) + i) & 0xFF] ^ LT_V[3][((y >> 24) + i) & 0xFF]) %
         m;
}

struct LtParams {
  uint32_t W, P1, Pv, J;  // Pv = P = L - W
};

// Writes ISI X's LT-row column indices (LT part then PI part) into out
// (MAX 33 entries); returns the count.  W prime => LT entries unique; the
// PI progression mod P1 (prime) cycles all residues so the d1 walk
// terminates.  Matches rfc/tuples.py lt_indices (reference lib/tuple.c +
// lib/params.c:47-65).
static int lt_row_gen(uint32_t X, const LtParams& p, int32_t* out) {
  uint32_t A = 53591u + p.J * 997u;
  if (!(A & 1)) A++;
  uint32_t y = 10267u * (p.J + 1) + X * A;  // uint32 wraparound intended
  uint32_t v = lt_rnd(y, 0, 1u << 20);
  uint32_t d = 0;
  while (d < (uint32_t)LT_NF && LT_F[d] <= v) d++;
  if (d > p.W - 2) d = p.W - 2;
  uint32_t a = 1 + lt_rnd(y, 1, p.W - 1);
  uint32_t b = lt_rnd(y, 2, p.W);
  uint32_t d1 = (d < 4) ? 2 + lt_rnd(X, 3, 2) : 2;
  uint32_t a1 = 1 + lt_rnd(X, 4, p.P1 - 1);
  uint32_t b1 = lt_rnd(X, 5, p.P1);
  int n = 0;
  for (uint32_t j = 0; j < d; j++) {
    out[n++] = (int32_t)b;
    b += a;
    if (b >= p.W) b -= p.W;
  }
  for (uint32_t got = 0; got < d1;) {
    if (b1 < p.Pv) {
      out[n++] = (int32_t)(p.W + b1);
      got++;
    }
    b1 += a1;
    if (b1 >= p.P1) b1 -= p.P1;
  }
  return n;
}

void nrq_lt_init(const uint32_t* V0, const uint32_t* V1, const uint32_t* V2,
                 const uint32_t* V3, const uint32_t* f, int32_t nf) {
  memcpy(LT_V[0], V0, sizeof(LT_V[0]));
  memcpy(LT_V[1], V1, sizeof(LT_V[1]));
  memcpy(LT_V[2], V2, sizeof(LT_V[2]));
  memcpy(LT_V[3], V3, sizeof(LT_V[3]));
  LT_NF = nf > 64 ? 64 : nf;
  memcpy(LT_F, f, sizeof(uint32_t) * LT_NF);
}

// Testing probe: one LT row for ISI X (returns count, fills out[<=33]).
int32_t nrq_lt_row(uint32_t X, int32_t W, int32_t P1, int32_t Pv, int32_t J,
                   int32_t* out) {
  LtParams p{(uint32_t)W, (uint32_t)P1, (uint32_t)Pv, (uint32_t)J};
  return lt_row_gen(X, p, out);
}

// Shared-base batched repair: like nrq_host_repair but the patched binary
// system is BUILT HERE per block from the K'-shared base CSR (Kp LT rows +
// S LDPC rows, loss-independent) plus each block's (gaps, repair ISIs) —
// the per-pattern prep that the Python layer used to do row by row.  Gap
// combine rows are the base LT rows of the gap ESIs read in place.
// Workspaces (system CSR, substitution buffers) are reused across a
// thread's blocks.  Requires a prior nrq_lt_init.
void nrq_host_repair2(
    int32_t nb, int32_t L, int32_t W, int32_t S, int32_t H, int32_t T,
    int32_t Kp, int32_t P1, int32_t Pv, int32_t J,
    const int64_t* base_ptr, const int32_t* base_cols,  // Kp + S rows
    const uint8_t* hdpc,
    const int32_t* novs,
    const int64_t* ri_off, const uint32_t* rep_isis_all,  // ng+ov per block
    const int64_t* dp_off, const uint64_t* rowp_all,
    const int32_t* ngaps, const int64_t* gaps_off, const int32_t* gaps_all,
    const int64_t* op_off, const uint64_t* out_rowp_all,  // ng per block
    int32_t* statuses, int32_t nthreads) {
  const bool timing = getenv("NRQ_TIMING") != nullptr;
  double stage_ms[6] = {0, 0, 0, 0, 0, 0};
  const LtParams lp{(uint32_t)W, (uint32_t)P1, (uint32_t)Pv, (uint32_t)J};
  auto run_range = [&](int b0, int b1) {
    HugeBuf z;
    std::vector<uint8_t> rhs, xu, acc, m4r, need1;
    std::vector<uint64_t> bbits;
    std::vector<int32_t> pivpos(L), ucolof(L);
    std::vector<int32_t> rptr, rcols, gptr, gcols;
    for (int b = b0; b < b1; b++) {
      const int ov = novs[b], ng = ngaps[b];
      const int NB = Kp + ov + S;
      const int32_t* gaps = gaps_all + gaps_off[b];
      const uint32_t* risis = rep_isis_all + ri_off[b];
      int32_t tmp[40];
      rptr.clear();
      rcols.clear();
      rptr.reserve(NB + 1);
      rptr.push_back(0);
      int gi = 0;
      for (int s = 0; s < Kp; s++) {
        if (gi < ng && gaps[gi] == s) {  // gap slot: repair ISI's LT row
          int n = lt_row_gen(risis[gi++], lp, tmp);
          rcols.insert(rcols.end(), tmp, tmp + n);
        } else {
          rcols.insert(rcols.end(), base_cols + base_ptr[s],
                       base_cols + base_ptr[s + 1]);
        }
        rptr.push_back((int32_t)rcols.size());
      }
      for (int s = 0; s < ov; s++) {  // overhead rows
        int n = lt_row_gen(risis[ng + s], lp, tmp);
        rcols.insert(rcols.end(), tmp, tmp + n);
        rptr.push_back((int32_t)rcols.size());
      }
      for (int s = Kp; s < Kp + S; s++) {  // LDPC rows
        rcols.insert(rcols.end(), base_cols + base_ptr[s],
                     base_cols + base_ptr[s + 1]);
        rptr.push_back((int32_t)rcols.size());
      }
      gptr.clear();
      gcols.clear();
      gptr.push_back(0);
      for (int g = 0; g < ng; g++) {  // gap ESIs are systematic: base rows
        int32_t r = gaps[g];
        gcols.insert(gcols.end(), base_cols + base_ptr[r],
                     base_cols + base_ptr[r + 1]);
        gptr.push_back((int32_t)gcols.size());
      }
      host_repair_block(L, W, S, H, T, NB, rptr.data(), rcols.data(), hdpc,
                        rowp_all + dp_off[b], ng, gptr.data(), gcols.data(),
                        out_rowp_all + op_off[b], statuses + b, z, rhs,
                        xu, acc, m4r, pivpos, ucolof, need1, bbits,
                        (timing && b0 == 0) ? stage_ms : nullptr);
    }
  };
  int nt = std::min<int>(std::max<int>(nthreads, 1), nb);
  if (nt <= 1) {
    run_range(0, nb);
  } else {
    std::vector<std::thread> workers;
    workers.reserve(nt);
    for (int w = 0; w < nt; w++) {
      int b0 = (int)((int64_t)nb * w / nt), b1 = (int)((int64_t)nb * (w + 1) / nt);
      workers.emplace_back(run_range, b0, b1);
    }
    for (auto& t : workers) t.join();
  }
  if (timing)
    fprintf(stderr,
            "nrq_host_repair2 (thread 0): solve %.1f s1 %.1f s2 %.1f s3 %.1f "
            "s4 %.1f s5 %.1f ms\n",
            stage_ms[0], stage_ms[1], stage_ms[2], stage_ms[3], stage_ms[4],
            stage_ms[5]);
}

// ---------------------------------------------------------------------------
// Residual decode arm: per-pattern left inverse of the tiny gap system.
//
// The residual arm (codec/api.py _repair_residual_batch) decodes a lossy
// block as  X = R (y ^ W D0)  against the CANONICAL (loss-independent)
// factorization: W holds the canonical combination rows of the received
// repair ISIs, G = W[:, gap columns] is the nr x g GF(256) system relating
// the unknown gap payloads X to the repair residuals, and R [g, nr] is a
// left inverse (R G = I_g) supported on g independent rows of G.  This
// routine computes R per block by Gauss-Jordan over GF(256) on the
// augmented [G | I_nr] (nibble-LUT row_axpy), batched over blocks.  A block
// whose G has column rank < g is rank-deficient — the same failure (and
// retry semantics) the patched-system solve would hit
// (reference precode_matrix_invert returning NULL, lib/precode.c:368-370).
// ---------------------------------------------------------------------------

namespace {

// One block: G [nr, g] row-major -> R [g, nr] row-major; 0 ok, 1 rank-def.
int res_rinv_block(int nr, int g, const uint8_t* G, uint8_t* R,
                   std::vector<uint8_t>& scratch) {
  const int w = g + nr;  // augmented width
  scratch.assign((size_t)nr * w, 0);
  auto A = [&](int r) { return scratch.data() + (size_t)r * w; };
  for (int r = 0; r < nr; r++) {
    memcpy(A(r), G + (size_t)r * g, g);
    A(r)[g + r] = 1;
  }
  for (int s = 0; s < g; s++) {
    int piv = -1;
    for (int r = s; r < nr; r++)
      if (A(r)[s]) { piv = r; break; }
    if (piv < 0) return 1;
    if (piv != s)
      for (int j = 0; j < w; j++) std::swap(A(s)[j], A(piv)[j]);
    uint8_t inv = OCT_INV[A(s)[s]];
    if (inv != 1) {
      const uint8_t* mul = GF_MUL[inv];
      uint8_t* row = A(s);
      for (int j = 0; j < w; j++) row[j] = mul[row[j]];
    }
    for (int r = 0; r < nr; r++) {
      if (r == s) continue;
      uint8_t beta = A(r)[s];
      if (!beta) continue;
      if (beta == 1) rxor(A(r), A(s), w);
      else row_axpy(A(r), A(s), beta, w);
    }
  }
  for (int s = 0; s < g; s++) memcpy(R + (size_t)s * nr, A(s) + g, nr);
  return 0;
}

// Pivot-restricted variant: find g row indices piv[] of G whose square
// submatrix S = G[piv, :] is invertible (greedy GE in row order), and
// return Rinv [g, g] = S^{-1}.  Then X = Rinv . resid[piv] — the caller
// only has to compute residuals for the g pivot rows instead of all nr,
// which shrinks the dominant W.D0 sweep by ~nr/g (~2x at 6% loss + 5%
// overhead).  0 ok, 1 rank-deficient.
int res_pivinv_block(int nr, int g, const uint8_t* G, int32_t* piv,
                     uint8_t* Rinv, std::vector<uint8_t>& scratch) {
  if (g == 0) return 0;
  // Stage 1: greedy row-order pivot hunt on a working copy of G.  Column s
  // eliminates only from the not-yet-taken rows (taken rows never re-enter).
  scratch.assign((size_t)nr * g, 0);
  auto A = [&](int r) { return scratch.data() + (size_t)r * g; };
  memcpy(scratch.data(), G, (size_t)nr * g);
  std::vector<uint8_t> taken(nr, 0);
  for (int s = 0; s < g; s++) {
    int p = -1;
    for (int r = 0; r < nr; r++)
      if (!taken[r] && A(r)[s]) { p = r; break; }
    if (p < 0) return 1;
    piv[s] = p;
    taken[p] = 1;
    // the pivot row is left unnormalized; row_r ^= (A(r)[s]/A(p)[s]) * row_p
    // zeroes column s of every remaining row exactly
    const uint8_t* mulp = GF_MUL[OCT_INV[A(p)[s]]];
    for (int r = 0; r < nr; r++) {
      if (taken[r] || !A(r)[s]) continue;
      uint8_t beta = mulp[A(r)[s]];
      if (beta == 1) rxor(A(r) + s, A(p) + s, g - s);
      else row_axpy(A(r) + s, A(p) + s, beta, g - s);
    }
  }
  // Stage 2: invert S = G[piv, :] (original rows) by Gauss-Jordan [S | I].
  const int w = 2 * g;
  scratch.assign((size_t)g * w, 0);
  auto B = [&](int r) { return scratch.data() + (size_t)r * w; };
  for (int r = 0; r < g; r++) {
    memcpy(B(r), G + (size_t)piv[r] * g, g);
    B(r)[g + r] = 1;
  }
  for (int s = 0; s < g; s++) {
    int p = -1;
    for (int r = s; r < g; r++)
      if (B(r)[s]) { p = r; break; }
    if (p < 0) return 1;  // cannot happen: S is invertible by construction
    if (p != s)
      for (int j = 0; j < w; j++) std::swap(B(s)[j], B(p)[j]);
    uint8_t inv = OCT_INV[B(s)[s]];
    if (inv != 1) {
      const uint8_t* mul = GF_MUL[inv];
      uint8_t* row = B(s);
      for (int j = 0; j < w; j++) row[j] = mul[row[j]];
    }
    for (int r = 0; r < g; r++) {
      if (r == s) continue;
      uint8_t beta = B(r)[s];
      if (!beta) continue;
      if (beta == 1) rxor(B(r), B(s), w);
      else row_axpy(B(r), B(s), beta, w);
    }
  }
  for (int s = 0; s < g; s++) memcpy(Rinv + (size_t)s * g, B(s) + g, g);
  return 0;
}

}  // namespace

// Per-block G matrices are concatenated (g_off elements into G_all); R_all
// receives the concatenated [g_b, nr_b] outputs at r_off.  statuses[b]:
// 0 ok, 1 rank-deficient.  nthreads > 1 partitions blocks (independent).
void nrq_res_rinv(int32_t nb, const int32_t* nrs, const int32_t* gs,
                  const int64_t* g_off, const uint8_t* G_all,
                  const int64_t* r_off, uint8_t* R_all,
                  int32_t* statuses, int32_t nthreads) {
  auto run_range = [&](int b0, int b1) {
    std::vector<uint8_t> scratch;
    for (int b = b0; b < b1; b++)
      statuses[b] = res_rinv_block(nrs[b], gs[b], G_all + g_off[b],
                                   R_all + r_off[b], scratch);
  };
  int nt = std::min<int>(std::max<int>(nthreads, 1), nb);
  if (nt <= 1) {
    run_range(0, nb);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int w = 0; w < nt; w++) {
    int b0 = (int)((int64_t)nb * w / nt), b1 = (int)((int64_t)nb * (w + 1) / nt);
    workers.emplace_back(run_range, b0, b1);
  }
  for (auto& t : workers) t.join();
}

// Host-native residual arm: repair WITHOUT a per-pattern system solve.
// Against the canonical (loss-independent, cached) factorization each
// received repair symbol satisfies y_r = w_r . D; splitting D into the
// received part D0 and the unknown gap rows X gives  resid = G X with
// G = W[:, gaps] and resid = y ^ W D0.  Only g independent rows are needed
// to solve for the g unknowns: res_pivinv_block picks pivot rows piv[] and
// inverts the square subsystem, so the payload sweep touches g rows, not
// all nr (~2x less axpy work at 6% loss + 5% overhead).  The sweep is
// column-outer over the received columns (each D0 row is read once from
// memory while the g resid rows stay cache-hot), then a tiny [g, g]
// combine into the per-row output destinations.  Beats the patched-system
// solve when g x Kp axpy work is smaller than peel + double substitution —
// i.e. at small K'.  d0p entries of 0 mark zero rows (gaps, padding,
// never-received) and are skipped.  statuses[b]: 0 ok, 1 rank-deficient
// (feed more symbols, retry).
void nrq_host_residual(
    int32_t nb, int32_t T, int32_t kc,
    const int32_t* nrs,
    const int32_t* ngaps, const int64_t* gaps_off, const int32_t* gaps_all,
    const int64_t* w_off, const uint8_t* W_all,
    const int64_t* dp_off, const uint64_t* d0p_all,
    const int64_t* yp_off, const uint64_t* yp_all,
    const int64_t* op_off, const uint64_t* out_rowp_all,
    int32_t* statuses, int32_t nthreads) {
  auto run_range = [&](int b0, int b1) {
    std::vector<uint8_t> G, Rinv, Wp, resid, acc, scratch;
    std::vector<int32_t> piv;
    for (int b = b0; b < b1; b++) {
      const int nr = nrs[b], g = ngaps[b];
      const int32_t* gaps = gaps_all + gaps_off[b];
      const uint8_t* W = W_all + w_off[b];
      const uint64_t* d0p = d0p_all + dp_off[b];
      const uint64_t* yp = yp_all + yp_off[b];
      const uint64_t* op = out_rowp_all + op_off[b];
      G.resize((size_t)nr * std::max(g, 1));
      for (int r = 0; r < nr; r++)
        for (int j = 0; j < g; j++)
          G[(size_t)r * g + j] = W[(size_t)r * kc + gaps[j]];
      piv.resize(std::max(g, 1));
      Rinv.resize((size_t)std::max(g, 1) * g);
      if ((statuses[b] =
               res_pivinv_block(nr, g, G.data(), piv.data(), Rinv.data(), scratch)))
        continue;
      // compact the g pivot rows of W and y; the sweep never reads the rest
      Wp.resize((size_t)std::max(g, 1) * kc);
      resid.resize((size_t)std::max(g, 1) * T);
      for (int r = 0; r < g; r++) {
        memcpy(Wp.data() + (size_t)r * kc, W + (size_t)piv[r] * kc, kc);
        memcpy(resid.data() + (size_t)r * T, (const uint8_t*)(uintptr_t)yp[piv[r]], T);
      }
      for (int c = 0; c < kc; c++) {
        const uint8_t* src = (const uint8_t*)(uintptr_t)d0p[c];
        if (!src) continue;
        for (int r = 0; r < g; r++) {
          uint8_t beta = Wp[(size_t)r * kc + c];
          if (!beta) continue;
          uint8_t* dst = resid.data() + (size_t)r * T;
          if (beta == 1) rxor(dst, src, T);
          else row_axpy(dst, src, beta, T);
        }
      }
      acc.resize(T);
      for (int j = 0; j < g; j++) {
        memset(acc.data(), 0, T);
        const uint8_t* rrow = Rinv.data() + (size_t)j * g;
        for (int r = 0; r < g; r++) {
          uint8_t beta = rrow[r];
          if (!beta) continue;
          const uint8_t* src = resid.data() + (size_t)r * T;
          if (beta == 1) rxor(acc.data(), src, T);
          else row_axpy(acc.data(), src, beta, T);
        }
        memcpy((uint8_t*)(uintptr_t)op[j], acc.data(), T);
      }
    }
  };
  int nt = std::min<int>(std::max<int>(nthreads, 1), nb);
  if (nt <= 1) {
    run_range(0, nb);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int w = 0; w < nt; w++) {
    int b0 = (int)((int64_t)nb * w / nt), b1 = (int)((int64_t)nb * (w + 1) / nt);
    workers.emplace_back(run_range, b0, b1);
  }
  for (auto& t : workers) t.join();
}

}  // extern "C"
