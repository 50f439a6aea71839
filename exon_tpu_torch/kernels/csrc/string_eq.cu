// string_eq: full byte equality of row pairs drawn from two var columns.
//
// Replaces exon_tpu/plan/expressions.py _string_col_eq (:763) and the two
// take_var gathers that feed it in exon_tpu/plan/join_exec.py _jit_emit
// (:264-277). The JAX version first copies both key columns into the
// join's output layout, then compares a 32-byte prefix (zero-padded) and
// the lengths: two relayouts of every output row's key bytes, and strings
// that share 32 bytes and a length compare equal.
//
// Bound on the H100: HBM reads of the two rows of each pair plus 16 bytes
// of offsets and indices; a Query D batch of 131,072 pairs of ~38-byte
// names reads about 12 MB, some 4 us at 3.35 TB/s.
//
// Design: one thread per pair reads its two rows in place (no gather into
// a new layout), compares validity and length first and then every byte,
// stopping at the first difference. Threads stride over pairs. The rows a
// warp touches are scattered, so loads are not coalesced; for the short
// keys of a join that costs less than the gathers it replaces.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void string_eq_kernel(const int32_t* __restrict__ a_off,
                                 const uint8_t* __restrict__ a_val,
                                 const bool* __restrict__ a_valid,
                                 const int32_t* __restrict__ ia,
                                 const int32_t* __restrict__ b_off,
                                 const uint8_t* __restrict__ b_val,
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
    const int32_t len = a_off[ra + 1] - sa;
    bool eq = a_valid[ra] && b_valid[rb] && len == b_off[rb + 1] - sb;
    for (int32_t j = 0; eq && j < len; ++j) {
      eq = a_val[sa + j] == b_val[sb + j];
    }
    out[p] = eq;
  }
}

}  // namespace

extern "C" int exon_string_eq(const void* a_off, const void* a_val,
                              const void* a_valid, const void* ia,
                              const void* b_off, const void* b_val,
                              const void* b_valid, const void* ib, int64_t m,
                              void* out, void* stream) {
  if (m == 0) return 0;
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  string_eq_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_off), static_cast<const uint8_t*>(a_val),
      static_cast<const bool*>(a_valid), static_cast<const int32_t*>(ia),
      static_cast<const int32_t*>(b_off), static_cast<const uint8_t*>(b_val),
      static_cast<const bool*>(b_valid), static_cast<const int32_t*>(ib), m,
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}
