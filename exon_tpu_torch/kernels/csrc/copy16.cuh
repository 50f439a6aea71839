// copy16.cuh: byte runs assembled into aligned 16-byte output words, and
// the searches that find the row (or span) holding an output byte; shared
// by gather_var.cu, gather_spans.cu, string_eq.cu (load_run, low_bytes),
// parse_number.cu, count_bytes.cu and polya_tail.cu (load_word) and
// sort_keys.cu (load_run).
//
// A run of k source bytes at any alignment is read as the two aligned
// 16-byte words that cover it and funnel-shifted into place (load16), then
// moved to its place in the output word (place) or joined with another run
// by a byte mask (join). Only aligned words that hold a byte of the source
// are read: load_run falls back to byte loads within 16 bytes of its end,
// and load_word to byte loads for a word that reaches past either end.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace copy16 {

constexpr unsigned kFull = 0xffffffffu;

// The row holding output byte p, by the 32 lanes of a warp: the last row r
// in [0, m) with off[r] <= p, given off[0] <= p (off[m] is never read: rows
// past m are taken to start past p).
__device__ __forceinline__ int64_t warp_find_row(const int32_t* off,
                                                 int64_t m, int64_t p,
                                                 int lane) {
  int64_t lo = 0, hi = m;  // off[lo] <= p < off[hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + lane * step;
    const unsigned le = __ballot_sync(kFull, probe < hi && off[probe] <= p);
    lo += (31 - __clz(le)) * step;
    hi = min(lo + step, hi);
  }
  const unsigned le =
      __ballot_sync(kFull, lo + lane < hi && off[lo + lane] <= p);
  return lo + 31 - __clz(le);
}

// The last i in [0, hi) with off[i] <= p, given off[0] <= p: a binary
// search by halving steps, without a branch.
__device__ __forceinline__ int find_row(const int32_t* off, int hi,
                                        int64_t p) {
  int lo = 0;
  for (int step = hi > 1 ? 1 << (31 - __clz(hi - 1)) : 0; step > 0;
       step >>= 1) {
    if (lo + step < hi && off[lo + step] <= p) lo += step;
  }
  return lo;
}

// The 16 bytes at src, without a branch: from the aligned 16-byte word that
// holds src and the next one, which holds src[15] unless src is aligned
// (then the same word is read twice), shifted into place by 8, 4 and then
// 0-3 bytes.
__device__ __forceinline__ uint4 load16(const uint8_t* src) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const uint4* base = reinterpret_cast<const uint4*>(src - shift);
  const uint4 lo = base[0];
  const uint4 hi = base[shift != 0];
  const unsigned a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const bool by8 = shift & 8, by4 = shift & 4;
  unsigned b[6], c[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = by8 ? a[j + 2] : a[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) c[j] = by4 ? b[j + 1] : b[j];
  const unsigned r8 = 8u * (shift & 3);
  return make_uint4(__funnelshift_r(c[0], c[1], r8),
                    __funnelshift_r(c[1], c[2], r8),
                    __funnelshift_r(c[2], c[3], r8),
                    __funnelshift_r(c[3], c[4], r8));
}

// Word idx of a (0 below 0).
__device__ __forceinline__ unsigned pick(const unsigned (&a)[4], int idx) {
  return idx == 0 ? a[0] : idx == 1 ? a[1] : idx == 2 ? a[2]
                                            : idx == 3 ? a[3] : 0u;
}

// The mask of the low k bytes of a word (0 <= k <= 16).
__device__ __forceinline__ uint4 low_bytes(int k) {
  unsigned m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = k - 4 * j;
    m[j] = n >= 4 ? 0xffffffffu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
  }
  return make_uint4(m[0], m[1], m[2], m[3]);
}

// The low k bytes of v (1 <= k <= 16), moved up by `at` bytes (0 <= at <
// 16); the bytes moved past 16 are dropped.
__device__ __forceinline__ uint4 place(uint4 v, int k, int at) {
  const uint4 m = low_bytes(k);
  const unsigned a[4] = {v.x & m.x, v.y & m.y, v.z & m.z, v.w & m.w};
  const int q = at >> 2;
  const unsigned r8 = 8u * (at & 3);
  return make_uint4(__funnelshift_l(pick(a, -1 - q), pick(a, -q), r8),
                    __funnelshift_l(pick(a, -q), pick(a, 1 - q), r8),
                    __funnelshift_l(pick(a, 1 - q), pick(a, 2 - q), r8),
                    __funnelshift_l(pick(a, 2 - q), pick(a, 3 - q), r8));
}

// The low k bytes of a (1 <= k <= 16) and the rest of b's.
__device__ __forceinline__ uint4 join(uint4 a, uint4 b, int k) {
  const uint4 m = low_bytes(k);
  return make_uint4((a.x & m.x) | (b.x & ~m.x), (a.y & m.y) | (b.y & ~m.y),
                    (a.z & m.z) | (b.z & ~m.z), (a.w & m.w) | (b.w & ~m.w));
}

// The k bytes at src (k <= 16), byte by byte.
__device__ __forceinline__ uint4 load_bytes(const uint8_t* src, int k) {
  unsigned a[4] = {0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (t < k) a[t >> 2] |= static_cast<unsigned>(src[t]) << (8 * (t & 3));
  }
  return make_uint4(a[0], a[1], a[2], a[3]);
}

// The k bytes at values[s]: load16 when the 16 bytes from s lie inside
// values (of n_values bytes), else byte by byte.
__device__ __forceinline__ uint4 load_run(const uint8_t* __restrict__ values,
                                          int64_t n_values, int64_t s,
                                          int k) {
  return s + 16 <= n_values ? load16(values + s) : load_bytes(values + s, k);
}

// Aligned word w of values (n_values bytes), counted from the aligned word
// that holds values[0]: one 16-byte load when the word lies inside values,
// else its bytes inside values and zeros for the rest.
__device__ __forceinline__ uint4 load_word(const uint8_t* __restrict__ values,
                                           int64_t n_values, int64_t w) {
  const int64_t lo =
      16 * w - static_cast<int64_t>(reinterpret_cast<uintptr_t>(values) & 15);
  if (lo >= 0 && lo + 16 <= n_values) {
    return *reinterpret_cast<const uint4*>(values + lo);
  }
  unsigned a[4] = {0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (lo + t >= 0 && lo + t < n_values) {
      a[t >> 2] |= static_cast<unsigned>(values[lo + t]) << (8 * (t & 3));
    }
  }
  return make_uint4(a[0], a[1], a[2], a[3]);
}

// The n bytes of w (n <= 16) to out, one by one (a partial last word).
__device__ __forceinline__ void store_bytes(uint8_t* out, uint4 w, int n) {
  const unsigned a[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (t < n) out[t] = static_cast<uint8_t>(a[t >> 2] >> (8 * (t & 3)));
  }
}

}  // namespace copy16
