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
// Row r of the first column is aligned with the query (a literal, b_offs
// null: b_vals[0 .. qlen)) or with row r of a second column (b_offs given).
// The whole row is aligned, however long: no padded matrix, no cap.
//
// Bound on the H100: integer operations. This kernel issues 13 int32
// operations per DP cell (compare and select for the match score, the
// diagonal add and the clamp at 0, two subtracts and a max for each gap
// term, two maxima to combine, one for the running best); with Hopper's
// DPX add-max and clamped 3-way max and a query profile a cell needs 8.
// Query F's first FASTQ chunk holds about 377,000 reads x 150 bytes x a
// 13-byte query, 7.3e8 cells: 5.9e9 operations at 8 a cell, ~0.35 ms at
// 16.7 T int32 operations/s. The bytes (a row read once, four bytes out)
// take ~0.02 ms.
//
// Design: one thread per row. The query is cut into passes of K = 32 bytes;
// a pass holds, in registers, H and the row-gap term F of its K query bytes
// for the current row byte, walks the whole row once, and writes the
// bottom query byte's H and column-gap term E for each row byte to an edge
// buffer that the next pass reads (Gotoh's affine recurrences:
// E(i,j) = max(H(i-1,j) - 2, E(i-1,j) - 1), F(i,j) = max(H(i,j-1) - 2,
// F(i,j-1) - 1), H = max(0, H(i-1,j-1) + s, E, F)). A query of at most K
// bytes, like Query F's, makes one pass and touches no edge buffer. The
// integer max of the same cells is the same max as the JAX recurrence's,
// whatever the order, so the result is bit-exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int K = 32;
constexpr int32_t kNeg = -(1 << 20);

__global__ void sw_score_kernel(const uint8_t* __restrict__ a_vals,
                                const int32_t* __restrict__ a_offs, int64_t n,
                                const uint8_t* __restrict__ b_vals,
                                const int32_t* __restrict__ b_offs,
                                int32_t qlen, int2* __restrict__ edge,
                                int32_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int64_t a0 = a_offs[r];
  const int32_t na = static_cast<int32_t>(a_offs[r + 1] - a0);
  int64_t b0 = 0;
  int32_t nb = qlen;
  if (b_offs != nullptr) {
    b0 = b_offs[r];
    nb = static_cast<int32_t>(b_offs[r + 1] - b0);
  }
  const uint8_t* a = a_vals + a0;
  const uint8_t* b = b_vals + b0;
  int2* e = edge + a0;  // used only when the query takes two passes or more
  int32_t best = 0;
  for (int32_t i0 = 0; i0 < nb; i0 += K) {
    const int32_t kn = min(K, nb - i0);
    const bool first = i0 == 0;
    const bool last = i0 + K >= nb;
    uint8_t q[K];
    int32_t h[K], f[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      q[k] = k < kn ? b[i0 + k] : 0;
      h[k] = 0;
      f[k] = kNeg;
    }
    int32_t diag_edge = 0;  // H(i0 - 1, j - 1)
    for (int32_t j = 0; j < na; ++j) {
      const uint8_t c = a[j];
      const int2 up = first ? make_int2(0, kNeg) : e[j];
      int32_t hup = up.x, eup = up.y, diag = diag_edge;
      diag_edge = up.x;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= kn) break;
        const int32_t ev = max(hup - 2, eup - 1);
        const int32_t fv = max(h[k] - 2, f[k] - 1);
        const int32_t hv =
            max(max(diag + (c == q[k] ? 1 : -1), 0), max(ev, fv));
        diag = h[k];
        h[k] = hv;
        f[k] = fv;
        hup = hv;
        eup = ev;
        best = max(best, hv);
      }
      if (!last) e[j] = make_int2(hup, eup);
    }
  }
  out[r] = best;
}

}  // namespace

extern "C" int exon_sw_score(const void* a_vals, const void* a_offs,
                             int64_t n, const void* b_vals, const void* b_offs,
                             int32_t qlen, void* edge, void* out,
                             void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sw_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a_vals), static_cast<const int32_t*>(a_offs),
      n, static_cast<const uint8_t*>(b_vals),
      static_cast<const int32_t*>(b_offs), qlen, static_cast<int2*>(edge),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
