// count_bytes: per row, the number of bytes that fall in a class of bytes.
//
// Replaces the per-row count of exon_tpu/udfs.py gc_content (:69): a
// per-byte class mask over the whole values buffer, a per-byte row id
// (ops/layout.py byte_row_ids :27) and a scatter-add into the rows
// (_per_row_count :59). gc_content's class is {G, C, g, c}; the float32
// divide by the row length stays with the caller.
//
// Bound on the H100: HBM bytes, each row's bytes read once, its offset pair
// read and an int32 count written: a 131,072-read BAM batch of 100 bp moves
// about 14 MB, ~4 us at 3.35 TB/s.
//
// Design: one warp per row, warps striding over the rows. The class comes
// in the launch's parameters as a 256-bit mask (four 64-bit words: no
// table to allocate or copy per call) and is spread into a 256-entry byte
// table in shared memory; lane j counts bytes j, j + 32, ... of the row
// (neighbouring lanes on neighbouring bytes), and a warp reduction sums the
// lanes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

__global__ void count_bytes_kernel(const uint8_t* __restrict__ values,
                                   const int32_t* __restrict__ offsets,
                                   int64_t n, ulonglong4 mask,
                                   int32_t* __restrict__ out) {
  __shared__ uint8_t cls[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    const unsigned long long w = i < 64    ? mask.x
                                 : i < 128 ? mask.y
                                 : i < 192 ? mask.z
                                           : mask.w;
    cls[i] = static_cast<uint8_t>((w >> (i & 63)) & 1ull);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t s = offsets[r];
    const int64_t e = offsets[r + 1];
    uint32_t cnt = 0;
    for (int64_t p = s + lane; p < e; p += 32) cnt += cls[values[p]];
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) out[r] = static_cast<int32_t>(cnt);
  }
}

}  // namespace

extern "C" int exon_count_bytes(const void* values, const void* offsets,
                                int64_t n, uint64_t m0, uint64_t m1,
                                uint64_t m2, uint64_t m3, void* out,
                                void* stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  count_bytes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<const int32_t*>(offsets),
      n, make_ulonglong4(m0, m1, m2, m3), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
