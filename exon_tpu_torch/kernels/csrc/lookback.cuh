// lookback.cuh: the status words of a single-pass scan with a decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016), shared by compact_mask.cu, bucket_pack.cu,
// gather_var.cu, line_index.cu, format_int.cu and expand_segments.cu.
// text_records.cu keeps two counters in status words of this format (a
// word of an older epoch counts 0).
//
// A block takes its tile's number from an atomic ticket rather than
// blockIdx, so a tile only ever waits on tiles whose blocks already run and
// no grid deadlocks, even past the card's resident blocks. A scan may keep
// several columns of words (bucket_pack: one a destination); the word of
// column c of tile t is status[t * stride + c].
//
// A status word is 64 bits: the call's epoch (bits 34-63), a flag (bits
// 32-33: 0 while the word is another call's or not yet written, kAggregate
// for the tile's own sum, kPrefix for the inclusive sum of the tiles up to
// it) and the value (bits 0-31, unsigned, saturating at 2^32 - 1, so that a
// sum of 2^31 or more stays visible and never wraps). The wrapper keeps the
// words and the ticket counter in a workspace per (device, stream)
// (kernels/_lookback.py), numbers its calls (the epoch) and passes the
// ticket base (the tiles launched on the workspace before), so a word left
// by an earlier call is never read as this call's and the words need no
// clearing launch; it clears them when the epoch wraps or the workspace
// grows.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kPrefix = 2;
constexpr int64_t kSaturated = 0xffffffffll;

__device__ __forceinline__ unsigned long long word(unsigned long long epoch,
                                                   unsigned long long flag,
                                                   int64_t value) {
  const int64_t v = value < kSaturated ? value : kSaturated;
  return (epoch << 34) | (flag << 32) | static_cast<unsigned long long>(v);
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        int64_t at, unsigned long long w) {
  atomicExch(status + at, w);
}

// The flag of the word (0 while it is another call's or not yet written)
// and its value.
__device__ __forceinline__ unsigned long long read(
    const unsigned long long* status, int64_t at, unsigned long long epoch,
    int64_t* value) {
  const unsigned long long w =
      *reinterpret_cast<const volatile unsigned long long*>(status + at);
  if ((w >> 34) != epoch) return 0;
  *value = static_cast<int64_t>(w & 0xffffffffull);
  return (w >> 32) & 3ull;
}

// This block's tile, by ticket; every thread of the block calls it.
__device__ __forceinline__ int64_t ticket(unsigned long long* counter,
                                          unsigned long long base) {
  __shared__ int64_t tile_s;
  if (threadIdx.x == 0) {
    tile_s = static_cast<int64_t>(atomicAdd(counter, 1ull) - base);
  }
  __syncthreads();
  return tile_s;
}

// The exclusive prefix of column `column` at tile `tile`, found by a group
// of g lanes of one warp (g a power of two up to 32, the group's lanes
// `mask`, this lane `glane` in 0 .. g-1 of it), which read g predecessors a
// step from the nearest back and sum up to and including the nearest
// inclusive prefix. Every lane of the group returns the sum.
__device__ __forceinline__ int64_t exclusive_prefix(
    const unsigned long long* status, int64_t tile, int64_t stride,
    int64_t column, unsigned long long epoch, int g, int glane,
    unsigned mask) {
  const int first = __ffs(mask) - 1;
  int64_t prefix = 0;
  for (int64_t top = tile - 1; top >= 0; top -= g) {
    const int64_t pred = top - glane;
    int64_t value = 0;
    unsigned long long flag = kPrefix;  // before tile 0: a prefix of 0
    if (pred >= 0) {
      do {
        flag = read(status, pred * stride + column, epoch, &value);
      } while (flag == 0);
    }
    const unsigned prefixes =
        (__ballot_sync(mask, flag == kPrefix) & mask) >> first;
    const int stop = prefixes ? __ffs(prefixes) - 1 : g - 1;
    int64_t part = glane <= stop ? value : 0;
    for (int d = g >> 1; d > 0; d >>= 1) {
      part += __shfl_xor_sync(mask, part, d);
    }
    prefix += part;
    if (prefixes) break;
  }
  return prefix;
}

}  // namespace lookback
