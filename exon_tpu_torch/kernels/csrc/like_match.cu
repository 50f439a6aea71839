// like_match: SQL LIKE / ILIKE per row over uint8 values + int32 offsets.
//
// Replaces exon_tpu/ops/strings.py like (:177) and everything it dispatches
// to: starts_with (:56), ends_with (:70), equals_literal (:92), contains
// (:97) and _like_general (:257). The JAX version evaluates each pattern
// chunk over the whole flat buffer (one compare pass per pattern byte, a
// per-byte row-id map and a segmented min per middle chunk).
//
// Bound on the H100: HBM bytes. Each row's bytes are read about once (a
// middle chunk re-reads at most its own length per candidate start, and
// those reads hit L1/L2), so a 52 MB batch reads ~52 MB: ~16 us at
// 3.35 TB/s. One thread per row makes neighbouring threads read distant
// rows; the caches absorb that at these row lengths, and a warp-per-row
// layout is later work.
//
// Design: the host tokenizes the pattern with tokenize_like (:125) and
// uploads one int32 tensor:
//   pat[0] = number of '%'-separated chunks c, pat[1] = case-insensitive flag,
//   pat[2 .. 2+c] = chunk boundaries into the tokens (c+1 entries),
//   pat[3+c ..]   = tokens: a byte value, or -1 for '_' (any one byte).
// Each thread runs _like_general's greedy match on its row: with one chunk
// the row must equal it; otherwise the first chunk is anchored at the row
// start, each middle chunk takes its leftmost match at or after the end of
// the previous one, and the last chunk is anchored at the row end and may
// not overlap what was matched before. Case folding is ASCII only, as in
// _upper_u8. The output is bool[n]; validity masking stays with the caller.
//
// Position mode (exon_like_find) replaces ops/strings.py _find_from (:229)
// as exon_tpu/ops/sqlfuncs.py fn_strpos (:231) calls it: a hit mask over
// the flat buffer, one compare pass per needle byte, and a segmented min
// per row. Here each thread scans its row for the leftmost start of one
// chunk (the pattern's only chunk, matched anywhere) and writes it relative
// to the row start, or -1: the same greedy search as a middle chunk of
// like_kernel, from the row start. Bound: HBM bytes, each row read up to
// the end of its first match (the whole row when there is none), its
// offsets in and an int32 out; 4 M 150-byte reads, ~0.6 GB a lane, ~0.2 ms
// at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t upper_u8(uint8_t c) {
  return (c >= 'a' && c <= 'z') ? static_cast<uint8_t>(c - 32) : c;
}

__device__ bool match_at(const uint8_t* __restrict__ values, int64_t pos,
                         int64_t end, const int32_t* __restrict__ tokens,
                         int32_t k, bool ci) {
  if (pos + k > end) return false;
  for (int32_t t = 0; t < k; ++t) {
    const int32_t tok = tokens[t];
    if (tok < 0) continue;
    const uint8_t b = values[pos + t];
    const uint8_t p = static_cast<uint8_t>(tok);
    if (ci ? (upper_u8(b) != upper_u8(p)) : (b != p)) return false;
  }
  return true;
}

__global__ void like_kernel(const int32_t* __restrict__ offsets,
                            const uint8_t* __restrict__ values, int64_t n,
                            const int32_t* __restrict__ pat,
                            bool* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int32_t nchunks = pat[0];
  const bool ci = pat[1] != 0;
  const int32_t* bounds = pat + 2;
  const int32_t* tokens = pat + 3 + nchunks;
  const int64_t start = offsets[r];
  const int64_t end = offsets[r + 1];
  bool ok;
  if (nchunks == 1) {
    const int32_t k = bounds[1] - bounds[0];
    ok = (end - start == k) &&
         match_at(values, start, end, tokens + bounds[0], k, ci);
  } else {
    ok = true;
    int64_t p = start;
    const int32_t k0 = bounds[1] - bounds[0];
    if (k0 > 0) {
      ok = match_at(values, p, end, tokens + bounds[0], k0, ci);
      p += k0;
    }
    for (int32_t c = 1; ok && c < nchunks - 1; ++c) {
      const int32_t k = bounds[c + 1] - bounds[c];
      if (k == 0) continue;
      const int32_t* chunk = tokens + bounds[c];
      bool found = false;
      for (int64_t q = p; q + k <= end; ++q) {
        if (match_at(values, q, end, chunk, k, ci)) {
          found = true;
          p = q + k;
          break;
        }
      }
      ok = found;
    }
    const int32_t kl = bounds[nchunks] - bounds[nchunks - 1];
    if (ok && kl > 0) {
      const int64_t anchor = end - kl;
      ok = anchor >= p &&
           match_at(values, anchor, end, tokens + bounds[nchunks - 1], kl, ci);
    }
  }
  out[r] = ok;
}

__global__ void find_kernel(const int32_t* __restrict__ offsets,
                            const uint8_t* __restrict__ values, int64_t n,
                            const int32_t* __restrict__ pat,
                            int32_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const bool ci = pat[1] != 0;
  const int32_t k = pat[3] - pat[2];
  const int32_t* chunk = pat + 4 + pat[2];
  const int64_t start = offsets[r];
  const int64_t end = offsets[r + 1];
  int32_t found = -1;
  for (int64_t q = start; q + k <= end; ++q) {
    if (match_at(values, q, end, chunk, k, ci)) {
      found = static_cast<int32_t>(q - start);
      break;
    }
  }
  out[r] = found;
}

}  // namespace

extern "C" int exon_like_find(const void* offsets, const void* values,
                              int64_t n, const void* pat, void* out,
                              void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  find_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const uint8_t*>(values), n,
      static_cast<const int32_t*>(pat), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_like_match(const void* offsets, const void* values,
                               int64_t n, const void* pat, void* out,
                               void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  like_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const uint8_t*>(values), n,
      static_cast<const int32_t*>(pat), static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}
