// line_index: the position of every '\n' in a chunk of text.
//
// Replaces the line structure of exon_tpu/ops/device_text.py:
// line_starts_mask (:37) and the per-byte line ids that record_structure
// (:92) and formats/fastq.py _device_decode (:102) build with cumsum and
// cummax over every byte. Here the line table is the newline positions
// alone: 4 bytes per line instead of a bool and an int32 per byte.
//
// Bound on the H100: HBM bytes. The function reads the n chunk bytes and
// writes 4 bytes per newline: a 128 MiB chunk of 60-byte FASTA lines moves
// about 0.14 GB, some 42 us at 3.35 TB/s (the kernel reads the chunk twice).
//
// Design: 256 threads per block and 16 bytes per thread (one 16-byte load),
// so a block covers 4096 bytes.
//   pass 1 (exon_line_count): each thread counts the newlines of its 16
//     bytes (__vcmpeq4 over four words); the block sums them into
//     block_counts[block].
//   between the passes the wrapper scans the block counts (torch.cumsum).
//   pass 2 (exon_line_scatter): each thread rebuilds its 16-bit newline
//     mask, the block takes an exclusive scan of its threads' counts (warp
//     shuffles, then the 8 warp totals in shared memory), and each thread
//     writes the positions of its newlines from block offset + its rank.
//     Only the matches are written.
// The last partial 16 bytes are read byte by byte. The wrapper passes a
// 16-byte-aligned chunk and launches nothing for an empty one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerThread = 16;
constexpr int64_t kBlockBytes = int64_t{kThreads} * kBytesPerThread;

// one bit per byte of src[base, base + 16) that is '\n'
__device__ __forceinline__ unsigned newline_mask(const uint8_t* __restrict__ src,
                                                 int64_t base, int64_t n) {
  unsigned mask = 0;
  if (base + kBytesPerThread <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + base);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      // 0xff in each byte lane equal to '\n'; keep one bit per lane
      const unsigned eq = __vcmpeq4(words[w], 0x0a0a0a0au);
      const unsigned bits = (eq & 1u) | ((eq >> 7) & 2u) | ((eq >> 14) & 4u) |
                            ((eq >> 21) & 8u);
      mask |= bits << (4 * w);
    }
  } else {
    for (int b = 0; b < kBytesPerThread && base + b < n; ++b) {
      if (src[base + b] == '\n') mask |= 1u << b;
    }
  }
  return mask;
}

__global__ void line_count_kernel(const uint8_t* __restrict__ src, int64_t n,
                                  int32_t* __restrict__ block_counts) {
  __shared__ int warp_counts[kWarps];
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) *
      kBytesPerThread;
  int c = __popc(newline_mask(src, base, n));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    block_counts[blockIdx.x] = total;
  }
}

__global__ void line_scatter_kernel(const uint8_t* __restrict__ src, int64_t n,
                                    const int32_t* __restrict__ block_offsets,
                                    int32_t* __restrict__ out) {
  __shared__ int warp_offsets[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) *
      kBytesPerThread;
  unsigned mask = newline_mask(src, base, n);
  const int c = __popc(mask);
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_offsets[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_offsets[w];
      warp_offsets[w] = run;
      run += t;
    }
  }
  __syncthreads();
  int64_t rank = static_cast<int64_t>(block_offsets[blockIdx.x]) +
                 warp_offsets[warp] + (incl - c);
  while (mask != 0u) {
    const int b = __ffs(mask) - 1;
    out[rank++] = static_cast<int32_t>(base + b);
    mask &= mask - 1u;
  }
}

inline unsigned num_blocks(int64_t n) {
  return static_cast<unsigned>((n + kBlockBytes - 1) / kBlockBytes);
}

}  // namespace

extern "C" int exon_line_count(const void* src, int64_t n, void* block_counts,
                               void* stream) {
  line_count_kernel<<<num_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), n, static_cast<int32_t*>(block_counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_line_scatter(const void* src, int64_t n,
                                 const void* block_offsets, void* out,
                                 void* stream) {
  line_scatter_kernel<<<num_blocks(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), n,
      static_cast<const int32_t*>(block_offsets), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
