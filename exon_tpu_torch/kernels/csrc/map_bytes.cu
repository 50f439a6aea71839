// map_bytes: every byte of a var-width column through a 256-entry table,
// each row optionally mirrored, with the offsets unchanged.
//
// Replaces exon_tpu/udfs.py reverse_complement (:87): a per-byte row id
// (ops/layout.py byte_row_ids :27), a mirror index starts + (ends - 1 - pos)
// per byte, a gather of the values at it and a gather through _COMPLEMENT.
// Without the mirror it is the byte map of ops/strings.py upper/lower
// (:44, :48), which the SQL functions will use.
//
// Bound on the H100: HBM bytes, each row's bytes read once and written
// once, plus its offset pair: ~2 bytes per base, a 56 MB chunk of reads in
// ~34 us at 3.35 TB/s.
//
// Design: one warp per row, warps striding over the rows, the table in
// shared memory. Lane j writes output bytes j, j + 32, ... of the row, so
// stores are neighbouring; with the mirror the lanes read neighbouring
// bytes in descending order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

__global__ void map_bytes_kernel(const uint8_t* __restrict__ values,
                                 const int32_t* __restrict__ offsets,
                                 int64_t n, const uint8_t* __restrict__ table,
                                 bool mirror, uint8_t* __restrict__ out) {
  __shared__ uint8_t map[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) map[i] = table[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t s = offsets[r];
    const int64_t e = offsets[r + 1];
    for (int64_t p = s + lane; p < e; p += 32) {
      out[p] = map[values[mirror ? s + (e - 1 - p) : p]];
    }
  }
}

}  // namespace

extern "C" int exon_map_bytes(const void* values, const void* offsets,
                              int64_t n, const void* table, int32_t mirror,
                              void* out, void* stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  map_bytes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<const int32_t*>(offsets),
      n, static_cast<const uint8_t*>(table), mirror != 0,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
