// sort_keys: rows of the int64 ORDER BY key matrix for one sort key.
//
// Replaces exon_tpu/plan/physical.py sort_key_columns (:1372) with
// _to_sortable_i64 (:1486), _invert_key (:1499) and, for var-width keys,
// exon_tpu/ops/layout.py gather_prefix (:60). The JAX version gathers a
// [rows, 8 * nchunks] prefix matrix (one int32 index per byte) and folds it
// with eight shift-or passes per chunk, each a full [rows] int64 temporary.
//
// Bound on the H100: HBM writes of 8 bytes per row per key row, plus the
// key bytes read once: Query C's 1.5 M rows x 12 key rows write 144 MB,
// about 45 us at 3.35 TB/s.
//
// Design: one thread per row computes all of one key's rows (its validity
// row, then the value or each 8-byte big-endian chunk, zero past the row's
// end, sign bit flipped, inverted for DESC) and writes each to its row of
// the matrix, so a warp's stores are 32 consecutive int64 of one row. A
// var key's thread reads its row's bytes in order, once. Threads stride
// over rows. One launch per sort key; the wrapper zeroes the padding row.
//
// nulls mode: 0 default (ASC nulls last, DESC nulls first), 1 NULLS FIRST,
// 2 NULLS LAST. Value kinds: 0 int64, 1 int32, 2 float64, 3 float32,
// 4 uint8 or bool.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr uint64_t kSign = 1ull << 63;

__device__ __forceinline__ int64_t validity_key(bool valid, bool asc,
                                                int mode) {
  if (mode == 1) return valid ? 1 : 0;
  if (mode == 2) return valid ? 0 : 1;
  const int64_t vk = valid ? 0 : 1;
  return asc ? vk : -1 - vk;
}

__device__ __forceinline__ int64_t sortable_double(double f) {
  const int64_t bits = __double_as_longlong(f);
  const uint64_t flipped = bits < 0 ? ~static_cast<uint64_t>(bits)
                                    : static_cast<uint64_t>(bits) | kSign;
  return static_cast<int64_t>(flipped ^ kSign);
}

__global__ void sort_keys_fixed_kernel(const void* __restrict__ values,
                                       int kind,
                                       const bool* __restrict__ valid,
                                       int64_t n, bool asc, int mode,
                                       int64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    int64_t k;
    switch (kind) {
      case 0: k = static_cast<const int64_t*>(values)[r]; break;
      case 1: k = static_cast<const int32_t*>(values)[r]; break;
      case 2: k = sortable_double(static_cast<const double*>(values)[r]);
              break;
      case 3: k = sortable_double(static_cast<double>(
                  static_cast<const float*>(values)[r]));
              break;
      default: k = static_cast<const uint8_t*>(values)[r]; break;
    }
    out[r] = validity_key(valid[r], asc, mode);
    out[n + r] = asc ? k : -1 - k;
  }
}

__global__ void sort_keys_var_kernel(const int32_t* __restrict__ offsets,
                                     const uint8_t* __restrict__ values,
                                     const bool* __restrict__ valid,
                                     int64_t n, int nchunks, bool asc,
                                     int mode, int64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    const int32_t start = offsets[r];
    const int32_t len = offsets[r + 1] - start;
    out[r] = validity_key(valid[r], asc, mode);
    for (int c = 0; c < nchunks; ++c) {
      uint64_t k = 0;
      for (int t = 8 * c; t < 8 * c + 8; ++t) {
        const uint64_t b = t < len ? values[start + t] : 0;
        k = (k << 8) | b;
      }
      const int64_t s = static_cast<int64_t>(k ^ kSign);
      out[(1 + static_cast<int64_t>(c)) * n + r] = asc ? s : -1 - s;
    }
  }
}

int64_t grid(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

}  // namespace

extern "C" int exon_sort_keys_fixed(const void* values, int kind,
                                    const void* valid, int64_t n, int asc,
                                    int mode, void* out, void* stream) {
  if (n == 0) return 0;
  sort_keys_fixed_kernel<<<static_cast<unsigned>(grid(n)), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      values, kind, static_cast<const bool*>(valid), n, asc != 0, mode,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_sort_keys_var(const void* offsets, const void* values,
                                  const void* valid, int64_t n, int nchunks,
                                  int asc, int mode, void* out, void* stream) {
  if (n == 0) return 0;
  sort_keys_var_kernel<<<static_cast<unsigned>(grid(n)), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const uint8_t*>(values), static_cast<const bool*>(valid), n,
      nchunks, asc != 0, mode, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
