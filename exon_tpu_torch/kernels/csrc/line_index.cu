// line_index: the position of every '\n' in a chunk of text.
//
// Replaces the line structure of exon_tpu/ops/device_text.py:
// line_starts_mask (:37) and the per-byte line ids that record_structure
// (:92) and formats/fastq.py _device_decode (:102) build with cumsum and
// cummax over every byte. Here the line table is the newline positions
// alone: 4 bytes per line instead of a bool and an int32 per byte.
//
// Bound on the H100: HBM bytes. The function reads the n chunk bytes once
// and writes 4 bytes per newline: a 128 MiB chunk of 60-byte FASTA lines
// moves about 0.14 GB, some 43 us at 3.35 TB/s.
//
// Design: one launch, a single pass with a decoupled look-back (Merrill and
// Garland, 2016) on the status words of lookback.cuh, as compact_mask.cu.
//   A block takes a tile of kTile = 16 KB by ticket. Each of its 256
//     threads loads 4 aligned 16-byte words of the tile, word j at
//     j * 4 KB + 16 * thread, so each warp load is 512 contiguous bytes, and
//     makes one bit a byte that is '\n' (bytes16.cuh eq16). The partial last
//     word of the chunk is read byte by byte.
//   The block scans the counts of its 1,024 words in order: the 4 counts of
//     a thread as 16-bit fields of one 64-bit word, a warp scan of those,
//     then the 8 warp totals.
//   Thread 0 publishes the tile's count (lookback.cuh kAggregate) and warp 0
//     looks back for the tile's prefix and publishes its inclusive one; the
//     threads meanwhile stage the tile's positions in shared memory in order
//     (up to kStage of them), and the block writes them to out[prefix, ...)
//     as one coalesced run. A tile of more than kStage newlines (lines under
//     4 bytes) writes from its registers instead.
//   Nothing is written at or past `cap`; the last tile writes the count.
//     The wrapper sizes `out` at n / 16 + 1 positions, reads the count, and
//     launches once more into an exact buffer when it exceeds that.
// The kernel reads a 16-byte-aligned chunk (the wrapper copies an unaligned
// one), allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

#include "bytes16.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 4;  // 16-byte words a thread
constexpr int64_t kTile = int64_t{kThreads} * kWords * 16;
constexpr int kStage = 4096;  // positions a tile stages in shared memory
constexpr unsigned kFull = 0xffffffffu;

// byte offset of the thread's word j in a tile
__device__ __forceinline__ int64_t word_at(int j) {
  return (int64_t{j} * kThreads + threadIdx.x) * 16;
}

// The thread's whole words of tile `tile` (zero where a word is partial or
// past n: newline_mask reads those bytes one by one).
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ src,
                                           int64_t n, int64_t tile,
                                           uint4 (&w)[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int64_t base = tile * kTile + word_at(j);
    w[j] = base + 16 <= n ? *reinterpret_cast<const uint4*>(src + base)
                          : make_uint4(0u, 0u, 0u, 0u);
  }
}

// one bit per byte of src[base, base + 16) that is '\n'
__device__ __forceinline__ unsigned newline_mask(
    const uint8_t* __restrict__ src, int64_t base, int64_t n,
    const uint4& w) {
  if (base + 16 <= n) return bytes16::eq16(w, bytes16::splat('\n'));
  unsigned mask = 0;
  for (int b = 0; b < 16 && base + b < n; ++b) {
    if (src[base + b] == '\n') mask |= 1u << b;
  }
  return mask;
}

__device__ __forceinline__ int field(unsigned long long packed, int j) {
  return static_cast<int>((packed >> (16 * j)) & 0xffffull);
}

__global__ void __launch_bounds__(kThreads)
line_index_kernel(const uint8_t* __restrict__ src, int64_t n,
                  unsigned long long* __restrict__ status,
                  unsigned long long* __restrict__ ticket,
                  unsigned long long ticket_base, unsigned long long epoch,
                  int64_t n_tiles, int32_t* __restrict__ out, int64_t cap,
                  int32_t* __restrict__ count) {
  __shared__ int32_t staged[kStage];
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ int64_t prefix_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = lookback::ticket(ticket, ticket_base);
  uint4 words[kWords];
  load_words(src, n, tile, words);
  const int64_t start = tile * kTile;
  unsigned masks[kWords];
  unsigned long long packed = 0;  // the words' counts, 16 bits each
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    masks[j] = newline_mask(src, start + word_at(j), n, words[j]);
    packed |= static_cast<unsigned long long>(__popc(masks[j])) << (16 * j);
  }
  // word (j, thread)'s rank in the tile: the counts of the words j' < j of
  // every thread, then of word j of the threads before it
  unsigned long long incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned long long s = warp_sums[w];
    before += w < warp ? s : 0ull;
    total += s;
  }
  const unsigned long long excl = before + incl - packed;
  int tile_count = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) tile_count += field(total, j);
  if (threadIdx.x == 0) {
    lookback::publish(status, tile,
                      lookback::word(epoch, tile == 0 ? lookback::kPrefix
                                                      : lookback::kAggregate,
                                     tile_count));
  }
  const bool stage = tile_count <= kStage;
  if (stage) {
    int run = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      int at = run + field(excl, j);
      const int32_t base = static_cast<int32_t>(start + word_at(j));
      for (unsigned m = masks[j]; m; m &= m - 1) {
        staged[at++] = base + __ffs(m) - 1;
      }
      run += field(total, j);
    }
  }
  if (warp == 0) {
    const int64_t prefix = lookback::exclusive_prefix(status, tile, 1, 0,
                                                      epoch, 32, lane, kFull);
    if (lane == 0) {
      if (tile > 0) {
        lookback::publish(status, tile,
                          lookback::word(epoch, lookback::kPrefix,
                                         prefix + tile_count));
      }
      prefix_s = prefix;
    }
  }
  __syncthreads();
  const int64_t prefix = prefix_s;
  if (stage) {
    for (int k = threadIdx.x; k < tile_count && prefix + k < cap;
         k += kThreads) {
      out[prefix + k] = staged[k];
    }
  } else {
    int64_t run = prefix;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      int64_t at = run + field(excl, j);
      const int64_t base = start + word_at(j);
      for (unsigned m = masks[j]; m && at < cap; m &= m - 1) {
        out[at++] = static_cast<int32_t>(base + __ffs(m) - 1);
      }
      run += field(total, j);
    }
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) {
    *count = static_cast<int32_t>(prefix + tile_count);
  }
}

}  // namespace

// status holds at least ceil(n / kTile) words of the workspace and ticket
// its counter; ticket_base is the number of tiles launched on them before
// and epoch this call's number, 1 to 2^30 - 1. src is 16-byte aligned, n > 0
// and < 2^31; out holds cap positions and count one int32.
extern "C" int exon_line_index(const void* src, int64_t n, void* status,
                               void* ticket, uint64_t ticket_base,
                               uint64_t epoch, void* out, int64_t cap,
                               void* count, void* stream) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  line_index_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), n,
      static_cast<unsigned long long*>(status),
      static_cast<unsigned long long*>(ticket), ticket_base, epoch, n_tiles,
      static_cast<int32_t*>(out), cap, static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}
