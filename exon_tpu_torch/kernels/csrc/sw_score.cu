// sw_score: best Smith-Waterman local-alignment score of each row.
//
// Replaces exon_tpu/ops/alignment.py sw_scores_vs_query (:43) and
// sw_scores_pairwise (:79), as alignment_scores (:125) and
// alignment_scores_pairwise (:111) call them: each row is padded into an
// [n, L] int32 matrix, at most 2048 bytes wide, and a lax.scan over the
// query's bytes carries H and a column maximum of that width. Scoring is
// rust-bio's as exon's alignment_score uses it: match +1, mismatch -1, a gap
// of length L costs -(1 + L), scores clamp at 0.
//
// Row r of the first column is aligned with the query (a literal: the query
// form) or with row r of a second column (the pairwise form). The whole row
// is aligned, however long: no padded matrix, no cap.
//
// Recurrences (Gotoh's, affine gaps), for query byte k and row byte j:
//   E(k,j) = max(H(k-1,j) - 2, E(k-1,j) - 1)
//   F(k,j) = max(H(k,j-1) - 2, F(k,j-1) - 1)
//   H(k,j) = max(0, H(k-1,j-1) + s(k,j), E(k,j), F(k,j))
// Every H, E and F of row byte j is kept plus j (Ĥ = H + j, the frame of
// its column): then F̂(k,j) = max(Ĥ(k,j-1) - 1, F̂(k,j-1)), one DPX add-max;
// Ê(k,j) = max(Ĥ(k-1,j) - 2, Ê(k-1,j) - 1), a subtract and an add-max;
// Ĥ(k,j) = max(Ĥ(k-1,j-1) + s'(k,j), max(j, Ê, F̂)) with s' = s + 1 (2 for
// a match, 0 for a mismatch), one clamped 3-way max (__vimax3_s32 against
// j, the clamp at 0 in this frame) and one add-max (__viaddmax_s32). The
// column's best is a 3-way max per two cells, less j once a column. So a
// cell is 5.5 int32 operations, four of them DPX, with s' from a query
// profile in shared memory (one 16-byte load per four cells, the load
// pipe's) in the query form, and a compare and select per cell in the
// pairwise form (7.5). chip_smoke.py (print_sw_sass) reads the column
// loop's instructions from the SASS.
//
// Bound on the H100: integer operations. Query F's first FASTQ chunk holds
// 377,963 reads x 150 bytes x a 13-byte query, 7.37e8 cells: at 5.5 int32
// operations a cell (SW_OPS_PER_CELL in chip_smoke.py), 0.24 ms at 16.7 T
// int32 operations/s. The bytes (a row read once, four bytes out) take
// ~0.02 ms.
//
// Design: one thread per row (Query F's 377,963 reads fill the card many
// times over). The query is cut into passes of W bytes, W a template
// width (8, 16 or 32) that the wrapper picks from the longest query, so no
// cell tests the query's length: a pass holds, in registers, Ĥ and F̂ of
// its W query bytes for the current row byte and walks the whole row once,
// two row bytes an iteration so that Ĥ's two register sets swap roles
// without a copy; the row is read as aligned 4-byte words, one load per
// four row bytes. A query past 32 bytes takes several passes of 32: each
// writes its bottom query byte's Ĥ and Ê for each row byte to an edge
// buffer that the next pass reads. Query bytes past the end of the last
// pass are padding that matches nothing (a 0 in the profile, a 256 in the
// pairwise form). That is exact: no real cell reads a padded one (E and
// the diagonal come from smaller k), and a padded cell's H is at most the
// largest real H it derives from (its diagonal scores -1, and E and F
// never exceed the H they extend, less one), so the row's best is the real
// cells' best. The integer max of the same cells is the same max as the
// JAX recurrence's, whatever the order, so the result is bit-exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int32_t kNeg = -(1 << 20);
constexpr int32_t kNoMatch = 256;  // a pairwise query byte past the end

// s' (2 for a match, 0 otherwise) of row byte c at the pass's W query
// bytes: from the pass's profile in shared memory (the query form) ...
template <int W>
struct ProfileScore {
  const int32_t* prof;  // [256][W]
  __device__ __forceinline__ void fill(int32_t c, int32_t (&s)[W]) const {
    const int4* pr = reinterpret_cast<const int4*>(prof + c * W);
#pragma unroll
    for (int u = 0; u < W / 4; ++u) {
      const int4 v = pr[u];
      s[4 * u] = v.x;
      s[4 * u + 1] = v.y;
      s[4 * u + 2] = v.z;
      s[4 * u + 3] = v.w;
    }
  }
};

// ... or from the pass's query bytes in registers (the pairwise form).
template <int W>
struct PairScore {
  int32_t q[W];
  __device__ __forceinline__ void fill(int32_t c, int32_t (&s)[W]) const {
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = c == q[k] ? 2 : 0;
  }
};

// One pass of W query bytes over the whole row a[0, na), from best, with
// the pass's scores. With kMulti, the pass reads the bottom Ĥ and Ê of the
// pass before from e unless it is the first, and writes its own unless it
// is the last.
template <int W, bool kMulti, class Score>
__device__ __forceinline__ int32_t row_pass(const uint8_t* a, int32_t na,
                                            const Score& score, int2* e,
                                            bool first, bool last,
                                            int32_t best) {
  // Ĥ of the column before (h) and of this one (g), swapped every column
  // by walking two columns an iteration, so no cell copies a register
  int32_t h[W], g[W], f[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    h[k] = -1;    // H(k, -1) = 0 in the frame of column -1
    f[k] = kNeg;
  }
  int32_t diag_edge = -1;  // Ĥ(i0 - 1, j - 1)
  // the row's bytes from aligned 4-byte words, low byte first
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 3);
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(a - mis);
  uint32_t x = na > 0 ? *wp >> (8 * mis) : 0u;
  int avail = 4 - mis;
  auto column = [&](int32_t j, const int32_t (&hin)[W], int32_t (&hout)[W]) {
    if (avail == 0) {
      x = *++wp;
      avail = 4;
    }
    const int32_t c = static_cast<int32_t>(x & 0xffu);
    x >>= 8;
    --avail;
    int32_t s[W];
    score.fill(c, s);
    int32_t hup = j, eup = kNeg;  // H(-1, j) = 0, E(-1, j) = -inf
    if constexpr (kMulti) {
      if (!first) {
        const int2 up = e[j];
        hup = up.x;
        eup = up.y;
      }
    }
    int32_t diag = diag_edge;
    diag_edge = hup;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int32_t ev = __viaddmax_s32(hup, -2, eup - 1);
      f[k] = __viaddmax_s32(hin[k], -1, f[k]);
      hup = hout[k] =
          __viaddmax_s32(diag, s[k], __vimax3_s32(j, ev, f[k]));
      diag = hin[k];
      eup = ev;
    }
    int32_t col = max(hout[0], hout[1]);
#pragma unroll
    for (int k = 2; k < W; k += 2) {
      col = __vimax3_s32(col, hout[k], hout[k + 1]);
    }
    best = __viaddmax_s32(col, -j, best);
    if constexpr (kMulti) {
      if (!last) e[j] = make_int2(hup, eup);
    }
  };
  int32_t j = 0;
#pragma unroll 1
  for (; j + 1 < na; j += 2) {
    column(j, h, g);
    column(j + 1, g, h);
  }
  if (j < na) column(j, h, g);
  return best;
}

// The query form: the block builds each pass's profile (s' of every byte
// value at each of the pass's W query bytes) in shared memory.
template <int W, bool kMulti>
__global__ void __launch_bounds__(kThreads)
sw_query_kernel(const uint8_t* __restrict__ a_vals,
                const int32_t* __restrict__ a_offs, int64_t n,
                const uint8_t* __restrict__ query, int32_t qlen,
                int2* __restrict__ edge, int32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t prof[256 * W];
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t a0 = 0;
  int32_t na = 0;  // rows past n walk no bytes but keep the block's syncs
  if (r < n) {
    a0 = a_offs[r];
    na = static_cast<int32_t>(a_offs[r + 1] - a0);
  }
  int32_t best = 0;
  for (int32_t i0 = 0; i0 < qlen; i0 += W) {
    __syncthreads();  // the previous pass is done with the profile
    for (int i = threadIdx.x; i < 256 * W; i += kThreads) {
      const int k = i % W;
      prof[i] = i0 + k < qlen && query[i0 + k] == i / W ? 2 : 0;
    }
    __syncthreads();
    best = row_pass<W, kMulti>(a_vals + a0, na, ProfileScore<W>{prof},
                               edge + a0, i0 == 0, i0 + W >= qlen, best);
  }
  if (r < n) out[r] = best;
}

// The pairwise form: row r of b is row r of a's query, its bytes in
// registers, a pass at a time.
template <int W, bool kMulti>
__global__ void __launch_bounds__(kThreads)
sw_pairwise_kernel(const uint8_t* __restrict__ a_vals,
                   const int32_t* __restrict__ a_offs, int64_t n,
                   const uint8_t* __restrict__ b_vals,
                   const int32_t* __restrict__ b_offs,
                   int2* __restrict__ edge, int32_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int64_t a0 = a_offs[r];
  const int32_t na = static_cast<int32_t>(a_offs[r + 1] - a0);
  const int64_t b0 = b_offs[r];
  const int32_t nb = static_cast<int32_t>(b_offs[r + 1] - b0);
  const uint8_t* b = b_vals + b0;
  int32_t best = 0;
  for (int32_t i0 = 0; i0 < nb; i0 += W) {
    PairScore<W> score;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      score.q[k] = i0 + k < nb ? b[i0 + k] : kNoMatch;
    }
    best = row_pass<W, kMulti>(a_vals + a0, na, score, edge + a0, i0 == 0,
                               i0 + W >= nb, best);
  }
  out[r] = best;
}

template <int W, bool kMulti>
void launch(const uint8_t* a_vals, const int32_t* a_offs, int64_t n,
            const uint8_t* b_vals, const int32_t* b_offs, int32_t qlen,
            int2* edge, int32_t* out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (b_offs == nullptr) {
    sw_query_kernel<W, kMulti><<<blocks, kThreads, 0, stream>>>(
        a_vals, a_offs, n, b_vals, qlen, edge, out);
  } else {
    sw_pairwise_kernel<W, kMulti><<<blocks, kThreads, 0, stream>>>(
        a_vals, a_offs, n, b_vals, b_offs, edge, out);
  }
}

}  // namespace

// a_vals uint8 and a_offs int32 [n + 1]: the rows. The query form: b_offs
// null and b_vals the query, qlen bytes; the pairwise form: b_offs int32
// [n + 1] and b_vals the partners. max_b is the longest query or partner:
// it picks the pass width, and past 32 bytes edge must hold 2 int32 per
// byte of a_vals. out int32 [n].
extern "C" int exon_sw_score(const void* a_vals, const void* a_offs,
                             int64_t n, const void* b_vals, const void* b_offs,
                             int32_t qlen, int32_t max_b, void* edge,
                             void* out, void* stream) {
  const auto* av = static_cast<const uint8_t*>(a_vals);
  const auto* ao = static_cast<const int32_t*>(a_offs);
  const auto* bv = static_cast<const uint8_t*>(b_vals);
  const auto* bo = static_cast<const int32_t*>(b_offs);
  auto* ed = static_cast<int2*>(edge);
  auto* o = static_cast<int32_t*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (max_b <= 8) {
    launch<8, false>(av, ao, n, bv, bo, qlen, ed, o, st);
  } else if (max_b <= 16) {
    launch<16, false>(av, ao, n, bv, bo, qlen, ed, o, st);
  } else if (max_b <= 32) {
    launch<32, false>(av, ao, n, bv, bo, qlen, ed, o, st);
  } else {
    launch<32, true>(av, ao, n, bv, bo, qlen, ed, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
