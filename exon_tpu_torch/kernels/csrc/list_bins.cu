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
// Bins mode (exon_list_bins_bins): a block per row, blocks striding over
// the rows past a cap. Bound: HBM bytes, both lists read once, the offsets,
// and n * num_bins * 8 bytes written; the write dominates (P's 4,034 rows
// of 1,900 bins are 61 MB), so the design keeps every store coalesced and
// writes each output byte once. Intensity is read at the flat positions of
// mz (the JAX function's assumption that the two lists of a row have one
// length). The bin is decided in float64 before any cast: floor((mz -
// min_mz) / bin_width) must lie in [0, num_bins), so a NaN or an mz past
// the int32 range is dropped. Every row, NULL rows too, gets its num_bins
// entries. Two variants, chosen by the wrapper from num_bins:
//   shared (8 * num_bins fits the block's opt-in shared memory, 232,448 B
//     on the H100, so up to 29,056 bins): the block zeroes the row's sums in
//     dynamic shared memory, its threads stride the row's elements (mz and
//     intensity read coalesced, each once) and add each in-range intensity
//     into its bin with a shared-memory atomicAdd(double), then the block
//     writes the whole row, zero bins included, coalesced; the output is
//     never zero-filled apart.
//   global (more bins): the same walk, each addition an atomicAdd(double)
//     into the output row, which the wrapper zeroes for this variant only.
// Atomics add in an order that changes from run to run; the twin adds in
// element order, so the sums agree to rounding (relative 1e-12 for
// mzML's non-negative intensities), not bit for bit.

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

// Whether an m/z falls in a bin, and which.
__device__ __forceinline__ bool bin_of(double mz, double min_mz,
                                       double bin_width, int32_t num_bins,
                                       int64_t* bin) {
  const double b = floor((mz - min_mz) / bin_width);
  if (!(b >= 0.0 && b < static_cast<double>(num_bins))) return false;
  *bin = static_cast<int64_t>(b);
  return true;
}

__global__ void bins_shared_kernel(const double* __restrict__ mz,
                                   const double* __restrict__ intensity,
                                   const int32_t* __restrict__ offsets,
                                   int64_t n, double min_mz, double bin_width,
                                   int32_t num_bins, double* __restrict__ out) {
  extern __shared__ double sums[];
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    for (int32_t k = threadIdx.x; k < num_bins; k += kThreads) sums[k] = 0.0;
    __syncthreads();
    const int64_t e = offsets[r + 1];
    for (int64_t p = offsets[r] + threadIdx.x; p < e; p += kThreads) {
      int64_t b;
      if (bin_of(mz[p], min_mz, bin_width, num_bins, &b)) {
        atomicAdd(sums + b, intensity[p]);
      }
    }
    __syncthreads();
    double* row = out + r * num_bins;
    for (int32_t k = threadIdx.x; k < num_bins; k += kThreads) row[k] = sums[k];
    __syncthreads();  // the next row zeroes the sums
  }
}

__global__ void bins_global_kernel(const double* __restrict__ mz,
                                   const double* __restrict__ intensity,
                                   const int32_t* __restrict__ offsets,
                                   int64_t n, double min_mz, double bin_width,
                                   int32_t num_bins, double* __restrict__ out) {
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    double* row = out + r * num_bins;
    const int64_t e = offsets[r + 1];
    for (int64_t p = offsets[r] + threadIdx.x; p < e; p += kThreads) {
      int64_t b;
      if (bin_of(mz[p], min_mz, bin_width, num_bins, &b)) {
        atomicAdd(row + b, intensity[p]);
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

// shared != 0: the shared-memory variant (the wrapper checks that 8 *
// num_bins fits); otherwise the global one, into a zeroed out. Returns
// cudaGetLastError(), or the error of raising the kernel's shared-memory
// limit when the card refuses it.
extern "C" int exon_list_bins_bins(const void* mz, const void* intensity,
                                   const void* offsets, int64_t n,
                                   double min_mz, double bin_width,
                                   int32_t num_bins, int32_t shared, void* out,
                                   void* stream) {
  const unsigned blocks =
      static_cast<unsigned>(n < kMaxBlocks ? n : kMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* m = static_cast<const double*>(mz);
  const double* w = static_cast<const double*>(intensity);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  double* dst = static_cast<double*>(out);
  if (shared) {
    const size_t bytes = sizeof(double) * static_cast<size_t>(num_bins);
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          bins_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    bins_shared_kernel<<<blocks, kThreads, bytes, s>>>(
        m, w, o, n, min_mz, bin_width, num_bins, dst);
  } else {
    bins_global_kernel<<<blocks, kThreads, 0, s>>>(m, w, o, n, min_mz,
                                                   bin_width, num_bins, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
