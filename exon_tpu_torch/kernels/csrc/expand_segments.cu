// expand_segments: join match ranges -> (probe row, build row) index pairs.
//
// Replaces exon_tpu/ops/layout.py expand_segments (:308) and the index
// arithmetic of exon_tpu/plan/join_exec.py _jit_emit (:246-251). The JAX
// version scatters a 1 at each segment end into an out_cap-long buffer,
// cumsums it into a row id per slot, and gathers starts[rid] and lo[rid]
// per slot: three passes over the output plus a scan.
//
// Bound on the H100: HBM writes, 8 bytes per output slot (two int32
// indices) plus 16 bytes read per probe row: about 166 k slots and 131 k
// rows for a Query C batch, some 3.4 MB, about 1 us at 3.35 TB/s, so the
// launch dominates.
//
// Design: the wrapper computes the exclusive prefix sum of the output
// counts (torch.cumsum). Here one warp owns one probe row: lane j writes
// slots base + j, base + j + 32, ... of that row, so a row's stores are
// contiguous and no per-slot search or scan is needed. Warps stride over
// rows, so any row count fits the grid. Build indices are clamped to
// n_build - 1, as the JAX code clips them, so a left join's unmatched slot
// points at a real row whose values are then nulled.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

__global__ void expand_segments_kernel(const int32_t* __restrict__ lo,
                                       const int32_t* __restrict__ counts_out,
                                       const int64_t* __restrict__ starts_out,
                                       int64_t n, int64_t last_build,
                                       int32_t* __restrict__ probe_idx,
                                       int32_t* __restrict__ build_idx) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int32_t cnt = counts_out[r];
    const int64_t base = starts_out[r];
    const int64_t first = lo[r];
    for (int32_t j = lane; j < cnt; j += 32) {
      const int64_t b = first + j;
      probe_idx[base + j] = static_cast<int32_t>(r);
      build_idx[base + j] = static_cast<int32_t>(b < last_build ? b
                                                                : last_build);
    }
  }
}

}  // namespace

extern "C" int exon_expand_segments(const void* lo, const void* counts_out,
                                    const void* starts_out, int64_t n,
                                    int64_t last_build, void* probe_idx,
                                    void* build_idx, void* stream) {
  if (n == 0) return 0;
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  expand_segments_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(counts_out),
      static_cast<const int64_t*>(starts_out), n, last_build,
      static_cast<int32_t*>(probe_idx), static_cast<int32_t*>(build_idx));
  return static_cast<int>(cudaGetLastError());
}
