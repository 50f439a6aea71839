// polya_tail: per row, the length left once the trailing run of 'A'/'a' is
// stripped (0 for an empty or all-A row).
//
// Replaces the length computation of exon_tpu/udfs.py trim_polya (:131): a
// per-byte row id (ops/layout.py byte_row_ids :27), a per-byte "not A"
// position and a scatter-max of the last one into the rows. The caller
// turns the lengths into offsets (torch.cumsum) and copies the kept bytes
// with gather_spans, in place of the JAX relayout_values (layout.py:127).
//
// Bound on the H100: HBM bytes: the offset pair in and an int32 out per
// row, plus each row's bytes from its end back to its last non-A byte (one
// byte for most reads): ~3.4 MB for a 377,000-read chunk, ~1 us at
// 3.35 TB/s. The warp reads whole 32-byte windows, which the caches absorb.
//
// Design: one warp per row, warps striding over the rows. The warp reads
// the row backwards, 32 bytes a step (lane j the j-th byte from the step's
// end), ballots which lanes hold a byte that is not A, and stops at the
// first step with one: the lowest such lane is the last non-A byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

__global__ void polya_tail_kernel(const uint8_t* __restrict__ values,
                                  const int32_t* __restrict__ offsets,
                                  int64_t n, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t s = offsets[r];
    const int64_t e = offsets[r + 1];
    int64_t keep = 0;
    for (int64_t top = e - 1; top >= s; top -= 32) {
      const int64_t p = top - lane;
      const uint8_t b = p >= s ? values[p] : 'A';
      const unsigned ballot = __ballot_sync(0xffffffffu, b != 'A' && b != 'a');
      if (ballot != 0u) {
        keep = top - (__ffs(ballot) - 1) - s + 1;
        break;
      }
    }
    if (lane == 0) out[r] = static_cast<int32_t>(keep);
  }
}

}  // namespace

extern "C" int exon_polya_tail(const void* values, const void* offsets,
                               int64_t n, void* out, void* stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  polya_tail_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<const int32_t*>(offsets),
      n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
