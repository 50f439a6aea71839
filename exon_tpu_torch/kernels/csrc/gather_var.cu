// gather_var: var-width row gather (uint8 values + int32 offsets).
//
// Replaces exon_tpu/ops/layout.py take_offsets (:111) + relayout_values
// (:127) + byte_row_ids (:27), as take_var (:149) uses them. The JAX version
// builds a per-byte row-id map (scatter + cumsum over every output byte) and
// then gathers every byte through it.
//
// Bound on the H100: HBM bytes, the taken bytes read once and written once
// plus 16 bytes of indices, offsets and new offsets a row: A's half batch
// (26 MB taken) needs 16 us at 3.35 TB/s, a join's 131,072 read names
// (4.8 MB) 3.5 us. A call is two launches and one host read of the total,
// which sizes the output: no per-byte map, no torch op between them.
//
// gather_offsets_kernel: a single pass with a decoupled look-back
//   (lookback.cuh). A block takes a tile of kTile = 1,024 taken rows by
//   ticket, 4 a thread; each thread reads its rows' indices and their
//   source offset pairs, and a warp scan and a scan of the warp totals, in
//   int64, give each row its place in the tile. The tile publishes its byte
//   count, warp 0 looks back for the bytes of the tiles before it and
//   publishes the tile's inclusive prefix; each row then writes its new
//   offset and its source start (a scratch array the copy reads), and marks
//   each copy block whose first output byte it holds (block_row, for the
//   first `marks` blocks). The last tile writes the total as int64. Status
//   words saturate at 2^32 - 1, so a total of 2^31 bytes or more is seen
//   (and refused by the wrapper) and never wraps.
// gather_copy_kernel: the output in 16-byte words, balanced over bytes, not
//   rows, so 37-byte names and 680-byte sequences run alike. A block takes
//   kBlockBytes = 4 KB of output; the marks name the rows holding its first
//   byte and the next block's (past the marks, and for the last block, a
//   32-way search of the new offsets by one warp finds them), and the block
//   stages those rows' new offsets and source starts in shared memory (past
//   kStage rows it reads them in place). Each thread then takes one word
//   (neighbouring threads, neighbouring words), finds the row of its first
//   byte by a binary search of the staged offsets and, when the word lies
//   inside the row, assembles it from the two aligned 16-byte source words
//   that cover it, funnel-shifted by the source's offset from 16-byte
//   alignment (copy16.cuh's load16, shared with gather_spans.cu; source and
//   destination alignments differ by row), into one aligned 16-byte store. A
//   word across one row edge is two runs, the end of one row and the start of
//   the next, the second loaded from as many bytes before its start as the
//   first run holds, so that both line up with the output and a byte mask
//   joins them (join), both loads issued together. A word across more edges
//   (rows under 16 bytes), near the end of values or at the output's end takes
//   its runs one by one (edge_word; byte loads within 16 bytes of the end of
//   values). Only aligned words that hold a byte of values are read.
// The kernels allocate nothing and do not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

#include "copy16.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kWordsPerThread = 1;
constexpr int64_t kBlockBytes = 16 * kThreads * kWordsPerThread;
constexpr int kStage = 2048;
using namespace copy16;

__global__ void __launch_bounds__(kThreads)
gather_offsets_kernel(const int32_t* __restrict__ src_offsets,
                      const int32_t* __restrict__ indices, int64_t m,
                      unsigned long long* __restrict__ status,
                      unsigned long long* __restrict__ ticket,
                      unsigned long long ticket_base,
                      unsigned long long epoch, int64_t n_tiles,
                      int32_t* __restrict__ new_off,
                      int32_t* __restrict__ starts,
                      int32_t* __restrict__ block_row, int64_t marks,
                      int64_t* __restrict__ total) {
  __shared__ int64_t warp_sums[kWarps];
  __shared__ int64_t prefix_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = lookback::ticket(ticket, ticket_base);
  const int64_t row0 = tile * kTile + threadIdx.x * kRowsPerThread;
  int32_t start[kRowsPerThread];
  int64_t len[kRowsPerThread];
  int64_t mine = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    start[j] = 0;
    len[j] = 0;
    if (row0 + j < m) {
      const int32_t s = indices[row0 + j];
      start[j] = src_offsets[s];
      len[j] = static_cast<int64_t>(src_offsets[s + 1]) - start[j];
    }
    mine += len[j];
  }
  int64_t incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int64_t before = 0, tile_bytes = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int64_t s = warp_sums[w];
    before += w < warp ? s : 0;
    tile_bytes += s;
  }
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
  const int64_t prefix = prefix_s;
  int64_t run = prefix + before + incl - mine;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (row0 + j >= m) break;
    // the copy blocks whose first byte lies in this row
    for (int64_t b = (run + kBlockBytes - 1) / kBlockBytes;
         b < marks && b * kBlockBytes < run + len[j]; ++b) {
      block_row[b] = static_cast<int32_t>(row0 + j);
    }
    run += len[j];
    new_off[row0 + j + 1] = static_cast<int32_t>(run);
    starts[row0 + j] = start[j];
  }
  if (tile == 0 && threadIdx.x == 0) new_off[0] = 0;
  if (tile == n_tiles - 1 && threadIdx.x == 0) *total = prefix + tile_bytes;
}

// A word the copy does not take in two runs: its bytes row by row from the
// staged row i holding byte p, one run at a time (load_run), each moved
// into place; the output's last word is stored bytewise.
__device__ __forceinline__ void edge_word(const uint8_t* __restrict__ values,
                                          int64_t n_values, const int32_t* off,
                                          const int32_t* src, int i,
                                          int64_t p, int64_t last,
                                          uint8_t* __restrict__ out) {
  const int n = static_cast<int>(min(static_cast<int64_t>(16), last + 1 - p));
  int64_t row_start = off[i];
  int64_t row_end = off[i + 1];
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int filled = 0; filled < n;) {
    while (p + filled >= row_end) {
      ++i;
      row_start = row_end;
      row_end = off[i + 1];
    }
    const int k = static_cast<int>(min(static_cast<int64_t>(n - filled),
                                       row_end - (p + filled)));
    const uint4 w = place(load_run(values, n_values,
                                   src[i] + (p + filled - row_start), k),
                          k, filled);
    acc = make_uint4(acc.x | w.x, acc.y | w.y, acc.z | w.z, acc.w | w.w);
    filled += k;
  }
  if (n == 16) {
    *reinterpret_cast<uint4*>(out + p) = acc;
    return;
  }
  store_bytes(out + p, acc, n);
}

__global__ void __launch_bounds__(kThreads)
gather_copy_kernel(const uint8_t* __restrict__ values, int64_t n_values,
                   const int32_t* __restrict__ new_off,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ block_row, int64_t marks,
                   int64_t m, int64_t total, uint8_t* __restrict__ out) {
  __shared__ int32_t staged_off[kStage + 1];
  __shared__ int32_t staged_start[kStage];
  __shared__ int64_t rows_s[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t block = blockIdx.x;
  const int64_t first = block * kBlockBytes;
  const int64_t last = min(first + kBlockBytes, total) - 1;
  // the rows holding the block's first byte and the next block's: marked
  // by the offsets pass, else searched (the last block: its last byte's)
  const bool find_first = block >= marks;
  const bool find_last = block + 1 >= marks || last + 1 == total;
  if (threadIdx.x == 0) {
    if (!find_first) rows_s[0] = block_row[block];
    if (!find_last) rows_s[1] = block_row[block + 1];
  }
  if (warp == 0 && find_first) {
    const int64_t r = warp_find_row(new_off, m, first, lane);
    if (lane == 0) rows_s[0] = r;
  }
  if (warp == 1 && find_last) {
    const int64_t r = warp_find_row(new_off, m, last, lane);
    if (lane == 0) rows_s[1] = r;
  }
  __syncthreads();
  const int64_t r0 = rows_s[0];
  const int64_t rows = rows_s[1] - r0 + 1;
  const int32_t* off = new_off + r0;
  const int32_t* src = starts + r0;
  if (rows <= kStage) {
    for (int i = threadIdx.x; i <= rows; i += kThreads) {
      staged_off[i] = off[i];
      if (i < rows) staged_start[i] = src[i];
    }
    __syncthreads();
    off = staged_off;
    src = staged_start;
  }
  // each word as up to two runs of source bytes: the whole word inside a
  // row (k1 = 16), or the end of one row and the start of the next; words
  // of more rows, near the end of values and the output's last go slow
  int64_t p[kWordsPerThread], s1[kWordsPerThread], s2[kWordsPerThread];
  int row[kWordsPerThread], k1[kWordsPerThread], k2[kWordsPerThread];
  bool fast[kWordsPerThread];
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    p[k] = first + 16 * (k * kThreads + threadIdx.x);
    fast[k] = false;
    row[k] = k1[k] = k2[k] = 0;
    s1[k] = s2[k] = 0;
    if (p[k] + 16 > last + 1) continue;
    int i = find_row(off, static_cast<int>(rows), p[k]);
    row[k] = i;
    int64_t row_end = off[i + 1];
    k1[k] = static_cast<int>(min(static_cast<int64_t>(16), row_end - p[k]));
    s1[k] = src[i] + (p[k] - off[i]);
    if (k1[k] < 16) {
      while (p[k] + k1[k] >= row_end) row_end = off[++i + 1];
      k2[k] = static_cast<int>(
          min(static_cast<int64_t>(16 - k1[k]), row_end - (p[k] + k1[k])));
      s2[k] = src[i] + (p[k] + k1[k] - off[i]);
    }
    // the second run is loaded from k1 bytes before it, so that both
    // words line up with the output and a byte mask joins them
    s2[k] -= k1[k];
    fast[k] = k1[k] + k2[k] == 16 && s1[k] + 16 <= n_values &&
              (k2[k] == 0 || s2[k] >= 0);
  }
  // every word's loads, issued together
  uint4 v1[kWordsPerThread], v2[kWordsPerThread];
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    v1[k] = v2[k] = make_uint4(0, 0, 0, 0);
    if (fast[k]) {
      v1[k] = load16(values + s1[k]);
      if (k2[k] > 0) v2[k] = load16(values + s2[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    if (fast[k]) {
      *reinterpret_cast<uint4*>(out + p[k]) = join(v1[k], v2[k], k1[k]);
    } else if (p[k] <= last) {
      edge_word(values, n_values, off, src,
                p[k] + 16 > last + 1 ? find_row(off, static_cast<int>(rows),
                                                p[k])
                                     : row[k],
                p[k], last, out);
    }
  }
}

}  // namespace

// Pass 1: indices int32 [m] (m > 0) into src_offsets int32; status holds at
// least ceil(m / kTile) words of the workspace and ticket its counter;
// ticket_base is the number of tiles launched on them before and epoch this
// call's number, 1 to 2^30 - 1. Writes new_off int32 [m + 1], starts int32
// [m], block_row int32 [marks] (the row holding each copy block's first
// byte, for the blocks that start before the total) and total int64 [1]
// (2^32 - 1 or more when it saturated).
extern "C" int exon_gather_var_offsets(const void* src_offsets,
                                       const void* indices, int64_t m,
                                       void* status, void* ticket,
                                       uint64_t ticket_base, uint64_t epoch,
                                       void* new_off, void* starts,
                                       void* block_row, int64_t marks,
                                       void* total, void* stream) {
  const int64_t n_tiles = (m + kTile - 1) / kTile;
  gather_offsets_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_offsets),
      static_cast<const int32_t*>(indices), m,
      static_cast<unsigned long long*>(status),
      static_cast<unsigned long long*>(ticket), ticket_base, epoch, n_tiles,
      static_cast<int32_t*>(new_off), static_cast<int32_t*>(starts),
      static_cast<int32_t*>(block_row), marks, static_cast<int64_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2, after pass 1 on the same stream: the total output bytes (0 <
// total < 2^31) into out, 16-byte aligned; values holds n_values bytes.
extern "C" int exon_gather_var_copy(const void* values, int64_t n_values,
                                    const void* new_off,
                                    const void* starts, const void* block_row,
                                    int64_t marks, int64_t m, int64_t total,
                                    void* out, void* stream) {
  const int64_t blocks = (total + kBlockBytes - 1) / kBlockBytes;
  gather_copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), n_values,
      static_cast<const int32_t*>(new_off),
      static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(block_row), marks, m, total,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
