// map_bytes: every byte of a var-width column through a 256-entry table,
// each row optionally mirrored, with the offsets unchanged.
//
// Replaces exon_tpu/udfs.py reverse_complement (:87): a per-byte row id
// (ops/layout.py byte_row_ids :27), a mirror index starts + (ends - 1 - pos)
// per byte, a gather of the values at it and a gather through _COMPLEMENT.
// Without the mirror it is the byte map of ops/strings.py upper/lower
// (:44, :48) and of exon_tpu/ops/sqlfuncs.py fn_translate (:430, its table
// gather). In word-start mode it is sqlfuncs.py fn_initcap (:487): a byte
// at a word start (the row's first byte, or one after a byte that is not
// ASCII alphanumeric) maps through a second table (the upper-case fold),
// every other byte through the first (the lower-case fold).
//
// Bound on the H100: HBM bytes, each row's bytes read once and written
// once, plus its offset pair: ~2 bytes per base, a 56 MB chunk of reads in
// ~34 us at 3.35 TB/s.
//
// Design: one warp per row, warps striding over the rows, the table in
// shared memory. Lane j writes output bytes j, j + 32, ... of the row, so
// stores are neighbouring; with the mirror the lanes read neighbouring
// bytes in descending order. In word-start mode (mode 2) the table holds
// 512 entries, and each lane also reads the byte before its own (a
// neighbour's byte, from L1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

constexpr int kWordStart = 2;

__device__ __forceinline__ bool alnum(uint8_t c) {
  return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z') ||
         (c >= 'a' && c <= 'z');
}

__global__ void map_bytes_kernel(const uint8_t* __restrict__ values,
                                 const int32_t* __restrict__ offsets,
                                 int64_t n, const uint8_t* __restrict__ table,
                                 int32_t mode, uint8_t* __restrict__ out) {
  __shared__ uint8_t map[512];
  const int entries = mode == kWordStart ? 512 : 256;
  for (int i = threadIdx.x; i < entries; i += kThreads) map[i] = table[i];
  __syncthreads();
  const bool mirror = mode == 1;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t s = offsets[r];
    const int64_t e = offsets[r + 1];
    if (mode == kWordStart) {
      for (int64_t p = s + lane; p < e; p += 32) {
        const bool word_start = p == s || !alnum(values[p - 1]);
        out[p] = map[(word_start ? 256 : 0) + values[p]];
      }
      continue;
    }
    for (int64_t p = s + lane; p < e; p += 32) {
      out[p] = map[values[mirror ? s + (e - 1 - p) : p]];
    }
  }
}

}  // namespace

extern "C" int exon_map_bytes(const void* values, const void* offsets,
                              int64_t n, const void* table, int32_t mode,
                              void* out, void* stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  map_bytes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<const int32_t*>(offsets),
      n, static_cast<const uint8_t*>(table), mode, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
