// polya_tail: per row, the run of bytes of a byte class at one end of the
// row. From the end it writes the length left once the trailing run is
// stripped (0 for an empty row or one made only of class bytes); from the
// start, the length of the leading run (the whole row for one made only of
// class bytes).
//
// Replaces the length computation of exon_tpu/udfs.py trim_polya (:131): a
// per-byte row id (ops/layout.py byte_row_ids :27), a per-byte "not A"
// position and a scatter-max of the last one into the rows; with the class
// {'A', 'a'} from the end it is that function. With any trim set it is
// exon_tpu/ops/sqlfuncs.py _trim_counts (:178), whose scatter-min and
// scatter-max give a row's first and last byte outside the set: from the
// start the leading count, from the end the kept length, n - trailing
// count. A row made only of trim bytes empties from either side
// (rtrim('aa', 'a') = '', sqlfuncs.py:198). The caller turns lengths into
// offsets (torch.cumsum) and copies the kept bytes with gather_spans, in
// place of the JAX relayout (layout.py:127, sqlfuncs.py:96).
//
// Bound on the H100: HBM bytes: the offset pair in and an int32 out per
// row, plus each row's bytes from the scanned end to its first byte
// outside the class (one byte for most rows): ~3.4 MB for a 377,000-read
// chunk, ~1 us at 3.35 TB/s. The warp reads whole 32-byte windows, which
// the caches absorb.
//
// Design: one warp per row, warps striding over the rows; the class is a
// 256-bit mask held in four 64-bit registers. The warp reads the row from
// the chosen end, 32 bytes a step (lane j the j-th byte from the step's
// start, counting inwards), ballots which lanes hold a byte outside the
// class, and stops at the first step with one: its lowest such lane is the
// row's first (from the start) or last (from the end) byte outside the
// class.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

__device__ __forceinline__ bool member(uint64_t w0, uint64_t w1, uint64_t w2,
                                       uint64_t w3, uint8_t b) {
  const uint64_t w = b < 128 ? (b < 64 ? w0 : w1) : (b < 192 ? w2 : w3);
  return (w >> (b & 63)) & 1ull;
}

__global__ void polya_tail_kernel(const uint8_t* __restrict__ values,
                                  const int32_t* __restrict__ offsets,
                                  int64_t n, uint64_t w0, uint64_t w1,
                                  uint64_t w2, uint64_t w3, bool from_start,
                                  int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t s = offsets[r];
    const int64_t e = offsets[r + 1];
    int64_t result;
    if (from_start) {
      result = e - s;
      for (int64_t base = s; base < e; base += 32) {
        const int64_t p = base + lane;
        const bool other = p < e && !member(w0, w1, w2, w3, values[p]);
        const unsigned ballot = __ballot_sync(0xffffffffu, other);
        if (ballot != 0u) {
          result = base + (__ffs(ballot) - 1) - s;
          break;
        }
      }
    } else {
      result = 0;
      for (int64_t top = e - 1; top >= s; top -= 32) {
        const int64_t p = top - lane;
        const bool other = p >= s && !member(w0, w1, w2, w3, values[p]);
        const unsigned ballot = __ballot_sync(0xffffffffu, other);
        if (ballot != 0u) {
          result = top - (__ffs(ballot) - 1) - s + 1;
          break;
        }
      }
    }
    if (lane == 0) out[r] = static_cast<int32_t>(result);
  }
}

}  // namespace

extern "C" int exon_polya_tail(const void* values, const void* offsets,
                               int64_t n, uint64_t w0, uint64_t w1,
                               uint64_t w2, uint64_t w3, int32_t from_start,
                               void* out, void* stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  polya_tail_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<const int32_t*>(offsets),
      n, w0, w1, w2, w3, from_start != 0, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
