// string_eq: full byte equality of row pairs drawn from two var columns.
//
// Replaces exon_tpu/plan/expressions.py _string_col_eq (:763) and the two
// take_var gathers that feed it in exon_tpu/plan/join_exec.py _jit_emit
// (:264-277). The JAX version first copies both key columns into the
// join's output layout, then compares a 32-byte prefix (zero-padded) and
// the lengths: two relayouts of every output row's key bytes, and strings
// that share 32 bytes and a length compare equal.
//
// Bound on the H100: HBM bytes. Both indices, both rows' offset pairs and
// validity, the bytes of the pairs of equal length up to their first
// difference, and a bool out; a Query D batch of 131,072 pairs of ~38-byte
// names moves about 12.4 MB, 0.0037 ms at 3.35 TB/s.
//
// Design: a thread a pair, threads striding over pairs, both rows read in
// place (no gather into a new layout). The indices are read coalesced,
// then both rows' offsets and validity; a pair whose lengths differ, or
// that holds a NULL, reads no text. The text comes in steps of 64 bytes:
// all four 16-byte words of each row's step are loaded before any compare
// (copy16::load_run, which funnel-shifts a word to the row's own alignment
// and reads byte by byte within 16 bytes of the end of values), so a
// pair's loads are in flight together; bytes past the row's end are masked
// (copy16::low_bytes). The pass stops only between steps. A key of at most
// 16 bytes (an allele, a contig name) is one word a side, outside the step
// loop, which would issue the other three words' work predicated off. A
// lane group a pair was not taken: the keys of a join are short, and a
// group would repeat each pair's bookkeeping on every lane.

#include <cstdint>
#include <cuda_runtime.h>

#include "copy16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int kStepWords = 4;  // 64 bytes a row a step

__device__ __forceinline__ unsigned differ(uint4 a, uint4 b, int k) {
  const uint4 m = copy16::low_bytes(k);
  return ((a.x ^ b.x) & m.x) | ((a.y ^ b.y) & m.y) | ((a.z ^ b.z) & m.z) |
         ((a.w ^ b.w) & m.w);
}

__global__ void string_eq_kernel(const int32_t* __restrict__ a_off,
                                 const uint8_t* __restrict__ a_val,
                                 int64_t a_n,
                                 const bool* __restrict__ a_valid,
                                 const int32_t* __restrict__ ia,
                                 const int32_t* __restrict__ b_off,
                                 const uint8_t* __restrict__ b_val,
                                 int64_t b_n,
                                 const bool* __restrict__ b_valid,
                                 const int32_t* __restrict__ ib, int64_t m,
                                 bool* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < m; p += stride) {
    const int32_t ra = ia[p];
    const int32_t rb = ib[p];
    const int32_t sa = a_off[ra];
    const int32_t sb = b_off[rb];
    int32_t len = a_off[ra + 1] - sa;
    bool eq = a_valid[ra] && b_valid[rb] && len == b_off[rb + 1] - sb;
    if (eq && len <= 16) {
      // a short key (an allele, a contig name): one word a side
      eq = differ(copy16::load_run(a_val, a_n, sa, len),
                  copy16::load_run(b_val, b_n, sb, len), len) == 0;
      len = 0;
    }
    for (int32_t j = 0; eq && j < len; j += 16 * kStepWords) {
      uint4 wa[kStepWords], wb[kStepWords];
#pragma unroll
      for (int q = 0; q < kStepWords; ++q) {
        const int32_t k = min(16, len - j - 16 * q);
        if (k > 0) {
          wa[q] = copy16::load_run(a_val, a_n, sa + j + 16 * q, k);
          wb[q] = copy16::load_run(b_val, b_n, sb + j + 16 * q, k);
        }
      }
      unsigned d = 0;
#pragma unroll
      for (int q = 0; q < kStepWords; ++q) {
        const int32_t k = min(16, len - j - 16 * q);
        if (k > 0) d |= differ(wa[q], wb[q], k);
      }
      eq = d == 0;
    }
    out[p] = eq;
  }
}

}  // namespace

extern "C" int exon_string_eq(const void* a_off, const void* a_val,
                              int64_t a_n, const void* a_valid, const void* ia,
                              const void* b_off, const void* b_val,
                              int64_t b_n, const void* b_valid, const void* ib,
                              int64_t m, void* out, void* stream) {
  if (m == 0) return 0;
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  string_eq_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_off), static_cast<const uint8_t*>(a_val),
      a_n, static_cast<const bool*>(a_valid), static_cast<const int32_t*>(ia),
      static_cast<const int32_t*>(b_off), static_cast<const uint8_t*>(b_val),
      b_n, static_cast<const bool*>(b_valid), static_cast<const int32_t*>(ib),
      m, static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}
