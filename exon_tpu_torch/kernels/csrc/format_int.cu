// format_int: CAST of int64 rows to utf8 decimal text, exact-size output.
//
// Replaces exon_tpu/plan/expressions.py _cast_int_to_utf8 (:989). The JAX
// version counts each row's digits against a [n, 19] power table, scans
// the lengths into offsets, then fills a 20 * n byte buffer where every
// byte searchsorteds its row and divides out its digit. It also takes
// |INT64_MIN|, which overflows, and so writes garbage for that one value
// (ROADMAP Queue 3, F10); here it is "-9223372036854775808". The output
// holds exactly offsets[n] bytes: a var-width column's values end at its
// last offset, which plan/physical.py _cat_columns relies on.
//
// Bound on the H100: HBM bytes. 9 bytes a row in (value and validity),
// 4 bytes of offsets and the text out: one 131,072-row batch of GFF starts
// moves about 2.7 MB, some 0.8 us at 3.35 TB/s.
//
// Design: two launches around the wrapper's one host read of the total.
//   format_int_offsets_kernel is a single pass with a decoupled look-back
//     (Merrill and Garland, 2016) on the status words of lookback.cuh, as
//     line_index.cu. A block takes a tile of kTile rows by ticket; each of
//     its threads takes kRows rows, row j at j * kThreads + thread, so each
//     warp load is coalesced, and finds each row's length (sign and digits,
//     0 when NULL) by compares with the powers of ten, with no division.
//     The block scans the lengths in row order (a thread's as 16-bit fields
//     of one 64-bit word, a warp scan, then the warp totals), warp 0 looks
//     back for the tile's prefix, and every thread writes its rows'
//     offsets[r + 1]; the first tile writes offsets[0] = 0. offsets[n], the
//     total, is written by the last tile once its prefix is known.
//   format_int_write_kernel: a block takes 256 rows at a time, a thread a
//     row (a NULL row is the empty one: the pass reads no validity), and
//     writes each row's sign and digits, last first, two digits
//     at a time from a 100-entry pair table, into the block's text staged
//     in shared memory; a magnitude below 2^32 divides by 100 in 32 bits (a
//     multiply-high), a larger one in 64 bits until it fits. The block then
//     writes its text out in aligned 16-byte words, the two partial words
//     it shares with its neighbours byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows a thread of the offsets pass
constexpr int64_t kTile = int64_t{kThreads} * kRows;
constexpr int64_t kMaxBlocks = 132 * 32;
// a write block's text: 20 bytes a row at most, after up to 15 bytes of
// alignment
constexpr int kStage = kThreads * 20 + 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t magnitude(int64_t v) {
  return v < 0 ? 0ULL - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
}

// The decimal digits of m: one plus the powers 10^1 .. 10^18 it reaches
// (|INT64_MIN| = 9.2e18 has 19), compared in 32 bits below 2^32.
__device__ __forceinline__ int num_digits(uint64_t m) {
  int d = 1;
  if (m >> 32 == 0) {
    const uint32_t m32 = static_cast<uint32_t>(m);
    uint32_t p = 10;
#pragma unroll
    for (int k = 1; k <= 9; ++k, p *= 10) d += m32 >= p;
    return d;
  }
  uint64_t p = 10;
#pragma unroll
  for (int k = 1; k <= 18; ++k, p *= 10) d += m >= p;
  return d;
}

__device__ __forceinline__ int field(unsigned long long packed, int j) {
  return static_cast<int>((packed >> (16 * j)) & 0xffffull);
}

__global__ void __launch_bounds__(kThreads)
format_int_offsets_kernel(const int64_t* __restrict__ vals,
                          const bool* __restrict__ valid, int64_t n,
                          unsigned long long* __restrict__ status,
                          unsigned long long* __restrict__ ticket,
                          unsigned long long ticket_base,
                          unsigned long long epoch,
                          int32_t* __restrict__ offsets) {
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ int64_t prefix_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = lookback::ticket(ticket, ticket_base);
  const int64_t start = tile * kTile;
  unsigned long long packed = 0;  // the rows' lengths, 16 bits each
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int64_t r = start + j * kThreads + threadIdx.x;
    // both loads issued before either is used
    const bool ok = r < n && valid[r];
    const int64_t v = r < n ? vals[r] : 0;
    const int len = ok ? num_digits(magnitude(v)) + (v < 0 ? 1 : 0) : 0;
    packed |= static_cast<unsigned long long>(len) << (16 * j);
  }
  // row (j, thread)'s place in the tile: the lengths of the rows j' < j of
  // every thread, then of row j of the threads before it
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
  int tile_bytes = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) tile_bytes += field(total, j);
  if (threadIdx.x == 0) {
    lookback::publish(status, tile,
                      lookback::word(epoch, tile == 0 ? lookback::kPrefix
                                                      : lookback::kAggregate,
                                     tile_bytes));
  }
  if (warp == 0) {
    const int64_t prefix = lookback::exclusive_prefix(status, tile, 1, 0,
                                                      epoch, 32, lane, kFull);
    if (lane == 0) {
      if (tile > 0) {
        lookback::publish(status, tile,
                          lookback::word(epoch, lookback::kPrefix,
                                         prefix + tile_bytes));
      }
      prefix_s = prefix;
    }
  }
  __syncthreads();
  int64_t run = prefix_s;
  if (tile == 0 && threadIdx.x == 0) offsets[0] = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int64_t r = start + j * kThreads + threadIdx.x;
    if (r < n) {
      offsets[r + 1] = static_cast<int32_t>(run + field(excl, j) +
                                            field(packed, j));
    }
    run += field(total, j);
  }
}

__global__ void __launch_bounds__(kThreads)
format_int_write_kernel(const int64_t* __restrict__ vals,
                        const int32_t* __restrict__ offsets, int64_t n,
                        uint8_t* __restrict__ out) {
  __shared__ uint8_t pairs[200];  // "00" .. "99"
  // a block's text, from its first offset rounded down to 16 bytes
  __shared__ alignas(16) uint8_t stage[kStage];
  for (int t = threadIdx.x; t < 100; t += kThreads) {
    pairs[2 * t] = static_cast<uint8_t>('0' + t / 10);
    pairs[2 * t + 1] = static_cast<uint8_t>('0' + t % 10);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads; b0 < n;
       b0 += stride) {
    const int64_t i = b0 + threadIdx.x;
    const int64_t b1 = b0 + kThreads < n ? b0 + kThreads : n;
    const int32_t lo = offsets[b0], hi = offsets[b1];
    const int32_t a0 = lo & ~15;
    const bool live = i < n;
    const int64_t v = live ? vals[i] : 0;
    // a NULL row is empty, a valid one is not: no validity to read
    const bool ok = live && offsets[i + 1] > offsets[i];
    int32_t p = live ? offsets[i + 1] - a0 : 0;
    __syncthreads();  // the pair table, and the last block's copy, done
    if (ok) {
      uint64_t m = magnitude(v);
      while (m >> 32 != 0) {
        const uint64_t q = m / 100;
        const int d = static_cast<int>(m - q * 100);
        stage[--p] = pairs[2 * d + 1];
        stage[--p] = pairs[2 * d];
        m = q;
      }
      uint32_t x = static_cast<uint32_t>(m);
      while (x >= 100) {
        const uint32_t q = x / 100;
        const int d = static_cast<int>(x - q * 100);
        stage[--p] = pairs[2 * d + 1];
        stage[--p] = pairs[2 * d];
        x = q;
      }
      if (x >= 10) {
        stage[--p] = pairs[2 * x + 1];
        stage[--p] = pairs[2 * x];
      } else {
        stage[--p] = static_cast<uint8_t>('0' + x);
      }
      if (v < 0) stage[--p] = '-';
    }
    __syncthreads();
    // the block's bytes [lo, hi) out in aligned 16-byte words; the partial
    // words at either end, which neighbouring blocks share, byte by byte
    // (in int64: a word's end passes int32 near a total of 2^31 bytes)
    for (int64_t w = a0 + 16 * static_cast<int64_t>(threadIdx.x); w < hi;
         w += 16 * kThreads) {
      if (w >= lo && w + 16 <= hi) {
        *reinterpret_cast<uint4*>(out + w) =
            *reinterpret_cast<const uint4*>(stage + (w - a0));
      } else {
        for (int64_t q = w < lo ? lo : w; q < w + 16 && q < hi; ++q) {
          out[q] = stage[q - a0];
        }
      }
    }
  }
}

}  // namespace

// status holds at least ceil(n / kTile) words of the workspace and ticket
// its counter; ticket_base is the number of tiles launched on them before
// and epoch this call's number, 1 to 2^30 - 1. offsets holds n + 1 int32;
// 20 n < 2^31.
extern "C" int exon_format_int_offsets(const void* vals, const void* valid,
                                       int64_t n, void* status, void* ticket,
                                       uint64_t ticket_base, uint64_t epoch,
                                       void* offsets, void* stream) {
  if (n == 0) return 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  format_int_offsets_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const bool*>(valid), n,
      static_cast<unsigned long long*>(status),
      static_cast<unsigned long long*>(ticket), ticket_base, epoch,
      static_cast<int32_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// out holds offsets[n] bytes and is 16-byte aligned.
extern "C" int exon_format_int_write(const void* vals, const void* offsets,
                                     int64_t n, void* out, void* stream) {
  if (n == 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  format_int_write_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const int32_t*>(offsets),
      n, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
