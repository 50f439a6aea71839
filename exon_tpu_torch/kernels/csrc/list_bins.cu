// list_bins: per-row reductions over a List<Float64> column (K11b).
//
// Replaces exon_tpu/udfs.py contains_peak (:376) and bin_vectors (:389).
// The JAX functions expand a per-element row id (ops/layout.py
// byte_row_ids :27) and scatter into the rows: contains_peak a segment sum
// of |mz - peak| <= tol flags, bin_vectors a scatter-add of intensity into
// row * num_bins + floor((mz - min_mz) / bin_width), the bin cast to int32.
//
// Peak mode (exon_list_bins_peak): one warp per row, warps striding over
// the rows; lanes read neighbouring elements of the row and __any_sync
// ends the row at the first 32-element step that holds a hit. The result
// is ANDed with the row's validity, as in the JAX function. Bound: HBM
// bytes, the offsets and the elements read until each row's first hit,
// one bool written per row.
//
// Bins mode (exon_list_bins_bins): one thread per row adds the row's
// elements, in element order, into the row's own num_bins float64 sums
// (the output rows, zeroed by the wrapper), so no atomics are needed and
// the order of the additions is the CPU twin's. Intensity is read at the
// flat positions of mz (the JAX function's assumption that the two lists
// of a row have one length). The bin is decided in float64 before any
// cast: floor((mz - min_mz) / bin_width) must lie in [0, num_bins), so a
// NaN or an mz past the int32 range is dropped. Every row, NULL rows too,
// gets its num_bins entries. Bound: HBM bytes, both lists read once, the
// offsets, and n * num_bins * 8 bytes written. A thread's stores walk its
// own row, 8 * num_bins bytes from its neighbours': uncoalesced, and slow
// where rows are long (a later PR can give a row a warp and its bins
// shared memory).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

__global__ void peak_kernel(const double* __restrict__ values,
                            const int32_t* __restrict__ offsets,
                            const bool* __restrict__ validity, int64_t n,
                            double peak, double tol,
                            bool* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t s = offsets[r];
    const int64_t e = offsets[r + 1];
    bool found = false;
    for (int64_t base = s; base < e && !found; base += 32) {
      const int64_t p = base + lane;
      const bool hit = p < e && fabs(values[p] - peak) <= tol;
      found = __any_sync(0xffffffffu, hit);
    }
    if (lane == 0) out[r] = found && validity[r];
  }
}

__global__ void bins_kernel(const double* __restrict__ mz,
                            const double* __restrict__ intensity,
                            const int32_t* __restrict__ offsets, int64_t n,
                            double min_mz, double bin_width,
                            int32_t num_bins, double* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    double* row = out + r * num_bins;
    const int64_t e = offsets[r + 1];
    for (int64_t p = offsets[r]; p < e; ++p) {
      const double b = floor((mz[p] - min_mz) / bin_width);
      if (b >= 0.0 && b < static_cast<double>(num_bins)) {
        row[static_cast<int64_t>(b)] += intensity[p];
      }
    }
  }
}

}  // namespace

extern "C" int exon_list_bins_peak(const void* values, const void* offsets,
                                   const void* validity, int64_t n,
                                   double peak, double tol, void* out,
                                   void* stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  peak_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(values), static_cast<const int32_t*>(offsets),
      static_cast<const bool*>(validity), n, peak, tol,
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_list_bins_bins(const void* mz, const void* intensity,
                                   const void* offsets, int64_t n,
                                   double min_mz, double bin_width,
                                   int32_t num_bins, void* out,
                                   void* stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bins_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(mz), static_cast<const double*>(intensity),
      static_cast<const int32_t*>(offsets), n, min_mz, bin_width, num_bins,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
