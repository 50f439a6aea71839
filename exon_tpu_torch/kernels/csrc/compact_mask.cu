// compact_mask: stable stream compaction of a bool mask into row indices.
//
// Replaces exon_tpu/ops/layout.py mask_to_indices (:75), which is
// jnp.nonzero(mask, size=cap, fill_value=cap): out[0:count) holds the
// selected row numbers in ascending order and out[count:n) holds n.
//
// Bound on the H100: HBM bytes, the n mask bytes read once and the 4n
// index bytes and the count written once; at 3.35 TB/s a 131,072-row batch
// needs 0.2 us and a FASTA chunk's 2.4 M line flags 3.6 us. At the first
// size a launch, not bandwidth, sets the time, so one call is one launch:
// no pass to count, no scan between passes, no fill.
//
// Design: a single pass with a decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
//   A block takes a tile of kTile = 4,096 rows, its number from the
//     ticket of lookback.cuh.
//   Each thread loads its 16 mask bytes as one uint4 (scalar loads for an
//     unaligned mask or the last tile) and keeps one bit a row; a warp scan
//     and a scan of the 8 warp totals give each thread its offset in the
//     tile, and the thread stages its selected row numbers in shared memory.
//   Thread 0 publishes the tile's count (flag kAggregate) in the tile's
//     status word, then warp 0 reads its predecessors' words 32 at a time,
//     from the nearest back, summing until a word holds an inclusive prefix
//     (flag kPrefix), and publishes the tile's own inclusive prefix.
//   The block then writes its staged rows to out[prefix, prefix + count),
//     coalesced. Its unselected rows, whose unselected ranks before the tile
//     number start - prefix, fill out[n - (start - prefix) - u, n - (start -
//     prefix)) with n: the n - count fill slots are written once each, from
//     the end, with no fill launch. The last tile writes the count.
// The status words, their epochs and the tickets are lookback.cuh's, in
// the workspace that kernels/_lookback.py keeps per (device, stream).
// The kernel allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr unsigned kFull = 0xffffffffu;

// One bit a row of the thread's kRowsPerThread rows from row0 (0 past n).
__device__ __forceinline__ unsigned row_bits(const uint8_t* __restrict__ mask,
                                            int64_t n, int64_t row0,
                                            bool aligned) {
  unsigned bits = 0;
  if (aligned && row0 + kRowsPerThread <= n) {
    const uint4 q = *reinterpret_cast<const uint4*>(mask + row0);
    const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        bits |= (((words[w] >> (8 * b)) & 0xffu) != 0u ? 1u : 0u)
                << (4 * w + b);
      }
    }
    return bits;
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (row0 + j < n && mask[row0 + j] != 0) bits |= 1u << j;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
compact_mask_kernel(const uint8_t* __restrict__ mask, int64_t n,
                    bool aligned, unsigned long long* __restrict__ status,
                    unsigned long long* __restrict__ ticket,
                    unsigned long long ticket_base, unsigned long long epoch,
                    int64_t n_tiles, int32_t* __restrict__ out,
                    int32_t* __restrict__ count) {
  __shared__ int32_t staged[kTile];
  __shared__ int32_t warp_sums[kWarps];
  __shared__ int32_t prefix_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = lookback::ticket(ticket, ticket_base);
  const int64_t start = tile * kTile;
  const unsigned bits =
      row_bits(mask, n, start + threadIdx.x * kRowsPerThread, aligned);
  // the thread's offset in the tile: a warp scan, then the warp totals
  const int mine = __popc(bits);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, tile_count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    tile_count += s;
  }
  if (threadIdx.x == 0) {
    lookback::publish(status, tile,
                      lookback::word(epoch, tile == 0 ? lookback::kPrefix
                                                      : lookback::kAggregate,
                                     tile_count));
  }
  // stage the selected rows in order
  int at = before + incl - mine;
  for (unsigned m = bits; m; m &= m - 1) {
    staged[at++] = static_cast<int32_t>(start + threadIdx.x * kRowsPerThread +
                                        __ffs(m) - 1);
  }
  // the decoupled look-back, by warp 0
  if (warp == 0) {
    const int32_t prefix = static_cast<int32_t>(lookback::exclusive_prefix(
        status, tile, 1, 0, epoch, 32, lane, kFull));
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
  const int32_t prefix = prefix_s;
  for (int k = threadIdx.x; k < tile_count; k += kThreads) {
    out[prefix + k] = staged[k];
  }
  const int64_t rows = n - start < kTile ? n - start : kTile;
  const int64_t unselected = rows - tile_count;
  const int64_t fill = n - (start - prefix) - unselected;
  for (int64_t k = threadIdx.x; k < unselected; k += kThreads) {
    out[fill + k] = static_cast<int32_t>(n);
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) *count = prefix + tile_count;
}

}  // namespace

// status holds at least ceil(n / kTile) words of the workspace and ticket
// its counter; ticket_base is the number of tiles launched on them before
// and epoch this call's number, 1 to 2^30 - 1. n must be > 0 and < 2^31.
extern "C" int exon_compact_mask(const void* mask, int64_t n, void* status,
                                 void* ticket, uint64_t ticket_base,
                                 uint64_t epoch, void* out, void* count,
                                 void* stream) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const bool aligned = (reinterpret_cast<uintptr_t>(mask) & 15u) == 0;
  compact_mask_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n, aligned,
      static_cast<unsigned long long*>(status),
      static_cast<unsigned long long*>(ticket), ticket_base, epoch, n_tiles,
      static_cast<int32_t*>(out), static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}
