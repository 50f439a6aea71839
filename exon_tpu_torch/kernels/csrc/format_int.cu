// format_int: CAST of int64 rows to utf8 decimal text, exact-size output.
//
// Replaces exon_tpu/plan/expressions.py _cast_int_to_utf8 (:989). The JAX
// version counts each row's digits against a [n, 19] power table, scans
// the lengths into offsets, then fills a 20 * n byte buffer where every
// byte searchsorteds its row and divides out its digit. It also takes
// |INT64_MIN|, which overflows, and so writes garbage for that one value
// (ROADMAP Queue 3, F10); here it is "-9223372036854775808".
//
// Two passes around a torch.cumsum in the wrapper:
//   exon_format_int_lengths: one thread per row writes its byte length,
//     sign plus digits, 0 for a NULL row;
//   exon_format_int_write: one thread per row writes its sign and digits
//     at its offset, last digit first. The output holds exactly the
//     offsets' total.
//
// Bound on the H100: HBM bytes. Pass 1 reads 9 bytes a row and writes 4;
// pass 2 reads 9 + 4 and writes the text; for 3.4 M GFF coordinates of ~7
// digits about 100 MB, some 30 us at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ uint64_t magnitude(int64_t v) {
  return v < 0 ? 0ULL - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
}

__device__ __forceinline__ int32_t num_digits(uint64_t m) {
  int32_t d = 1;
  while (m >= 10) {
    m /= 10;
    ++d;
  }
  return d;
}

__global__ void format_int_lengths_kernel(const int64_t* __restrict__ vals,
                                          const bool* __restrict__ valid,
                                          int64_t n,
                                          int32_t* __restrict__ lens) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int64_t v = vals[i];
    lens[i] = valid[i] ? num_digits(magnitude(v)) + (v < 0 ? 1 : 0) : 0;
  }
}

__global__ void format_int_write_kernel(const int64_t* __restrict__ vals,
                                        const bool* __restrict__ valid,
                                        const int32_t* __restrict__ offsets,
                                        int64_t n, uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    if (!valid[i]) continue;
    const int64_t v = vals[i];
    uint64_t m = magnitude(v);
    const int32_t start = offsets[i];
    int32_t p = offsets[i + 1];
    do {
      out[--p] = static_cast<uint8_t>('0' + m % 10);
      m /= 10;
    } while (m != 0);
    if (v < 0) out[start] = '-';
  }
}

inline unsigned num_blocks(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" int exon_format_int_lengths(const void* vals, const void* valid,
                                       int64_t n, void* lens, void* stream) {
  if (n == 0) return 0;
  format_int_lengths_kernel<<<num_blocks(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const bool*>(valid), n,
      static_cast<int32_t*>(lens));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_format_int_write(const void* vals, const void* valid,
                                     const void* offsets, int64_t n, void* out,
                                     void* stream) {
  if (n == 0) return 0;
  format_int_write_kernel<<<num_blocks(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const bool*>(valid),
      static_cast<const int32_t*>(offsets), n, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
