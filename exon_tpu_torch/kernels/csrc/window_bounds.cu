// window_bounds: partition and peer-group bounds of a window's sorted rows.
//
// Replaces the boundary part of exon_tpu/plan/window_exec.py _window_column
// (:123-149). The JAX version builds seg_new and peer_new from neighbour
// compares of a 64-bit partition hash and of each order key, cumsums them
// into ids and runs four scatter-min/max passes over an n-long buffer
// (seg_start, seg_end, peer_first, peer_last), then gathers each back per
// row: about a dozen passes over n.
//
// Input: the sorted int64 key matrix [rows, n] (partition rows first, then
// order rows; every byte of a string key in its 8-byte chunks), the number
// of partition rows. Output: int32 [4, n] = seg_start, seg_end,
// peer_first, peer_last of every sorted row.
//
// Bound on the H100: the key matrix read once and the four outputs written
// once: Query L's 1,008,303 rows x 4 key rows read (32 MB) and 16 MB
// written, about 14 us at 3.35 TB/s. This design also writes and reads a
// flags byte a row (2 MB at L), about 50 MB moved in all.
//
// Design. A start is the max-scan of (row starts a group ? row : none), an
// end the min-scan from the right of (next row starts a group, or the
// row is the last ? row : none). The first design gave each thread 8
// consecutive rows, so a warp's load touched 32 rows 64 bytes apart, read
// each key row twice per row (k[r] and k[r - 1]), stored its four outputs
// 32 bytes apart across a warp, and took three launches: the tiles, one
// block that scanned the tiles' carries, and a pass that read and rewrote
// all four outputs to apply them. Here, two launches and no apply pass:
//  - bounds_starts_kernel takes tiles of kTile rows by ticket from the
//    left. Consecutive lanes take consecutive rows (a warp loads 32
//    consecutive int64 of a key row), and a row's predecessor comes from
//    the lane before by a shuffle (lane 0 loads it). The flags (bit 0 a
//    partition start, bit 1 a peer start) go to shared memory and, a byte
//    a row, to device memory for the second pass; each thread then scans 8
//    consecutive rows' flags in registers, and a block scan across threads
//    completes the tile. The look-back is its own, not lookback.cuh's sum:
//    starts are increasing row numbers, so a tile with a start publishes
//    its last start at once as its inclusive prefix (flag kPrefix), and a
//    tile without one publishes kAggregate and looks back to the nearest
//    tile that has published a prefix, whose value is the max of all
//    before it; it then publishes that value as its own prefix. A tile
//    whose first row starts a group of a kind needs no look-back for it.
//  - bounds_ends_kernel takes tiles by ticket from the right (tile =
//    tiles - 1 - ticket), so a tile only waits on tiles to its right that
//    already run: no deadlock. It reads the flags bytes (8 a thread, one
//    8-byte load), marks each row whose next row starts a group (the last
//    row always), scans from the right in registers and across the block,
//    and looks to the right the same way for rows after the tile's last
//    end. The last tile always has an end.
//  Both passes write their two outputs through shared memory, so a warp
//  stores 32 consecutive int32 of each. The status words are lookback.cuh's
//  (epoch, flag, value) words, two a tile, in the workspace of
//  kernels/_lookback.py: the passes take consecutive epochs and tickets of
//  one call there, so no word needs clearing, and one ctypes call launches
//  both.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

// 128 threads of 8 rows: 985 tiles at L, about 7.5 a multiprocessor in
// one wave (tiles of 2,048 rows left 3.7 a multiprocessor, and the last
// wave's imbalance showed)
constexpr int kThreads = 128;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // window_bounds.py TILE_ROWS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The value of the nearest tile on the side `dir` (-1 left, +1 right) of
// `tile` that has published an inclusive prefix in column `col`, read by
// the 32 lanes of a warp 32 tiles a step; every lane returns it. One
// exists among the `tiles` tiles: tile 0 on the left and the last tile on
// the right always publish a prefix at once. Lanes past either end read
// nothing.
__device__ __forceinline__ int32_t nearest_prefix(
    const unsigned long long* status, int64_t tile, int64_t tiles, int dir,
    int col, unsigned long long epoch, int lane) {
  for (int64_t top = tile + dir;; top += 32 * dir) {
    const int64_t t = top + dir * lane;
    int64_t value = 0;
    unsigned long long flag = 0;
    if (t >= 0 && t < tiles) {
      do {
        flag = lookback::read(status, t * 2 + col, epoch, &value);
      } while (flag == 0);
    }
    const unsigned prefixes = __ballot_sync(kFull, flag == lookback::kPrefix);
    if (prefixes) {
      return static_cast<int32_t>(
          __shfl_sync(kFull, value, __ffs(prefixes) - 1));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bounds_starts_kernel(const int64_t* __restrict__ keys, int rows, int n_part,
                     int64_t n, unsigned long long* __restrict__ status,
                     unsigned long long* __restrict__ ticket,
                     unsigned long long ticket_base, unsigned long long epoch,
                     int32_t* __restrict__ out, uint8_t* __restrict__ flags) {
  __shared__ __align__(16) uint8_t s_flag[kTile];
  __shared__ __align__(16) int32_t s_out[2][kTile];
  __shared__ int32_t s_warp[2][kWarps];
  __shared__ int32_t s_prefix[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = lookback::ticket(ticket, ticket_base);
  const int64_t t0 = tile * kTile;
  int f[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) f[j] = 0;
  for (int c = 0; c < rows; ++c) {
    const int64_t* k = keys + static_cast<int64_t>(c) * n;
    const int bit = c < n_part ? 3 : 2;
    int64_t v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t r = t0 + j * kThreads + threadIdx.x;
      v[j] = r < n ? k[r] : 0;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t r = t0 + j * kThreads + threadIdx.x;
      int64_t prev = __shfl_up_sync(kFull, v[j], 1);
      if (lane == 0) prev = r > 0 && r < n ? k[r - 1] : v[j];
      if (r < n && prev != v[j]) f[j] |= bit;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = t0 + j * kThreads + threadIdx.x;
    s_flag[j * kThreads + threadIdx.x] =
        static_cast<uint8_t>(r == 0 ? 3 : f[j]);
  }
  __syncthreads();
  // this thread's 8 consecutive rows
  const int64_t r0 = t0 + kItems * threadIdx.x;
  const unsigned long long fw =
      reinterpret_cast<const unsigned long long*>(s_flag)[threadIdx.x];
  if (r0 + kItems <= n) {
    // flags is 256-byte aligned and r0 a multiple of 8
    *reinterpret_cast<unsigned long long*>(flags + r0) = fw;
  } else {
    for (int i = 0; i < kItems && r0 + i < n; ++i) {
      flags[r0 + i] = static_cast<uint8_t>(fw >> (8 * i));
    }
  }
  int32_t seg[kItems], peer[kItems];
  int32_t a = -1, b = -1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int fl = static_cast<int>(fw >> (8 * i)) & 3;
    const int32_t r = static_cast<int32_t>(r0 + i);
    if (fl & 1) a = r;
    if (fl & 2) b = r;
    seg[i] = a;
    peer[i] = b;
  }
  // exclusive max-scan of the threads' last starts across the block
  int32_t xa = a, xb = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t ya = __shfl_up_sync(kFull, xa, d);
    const int32_t yb = __shfl_up_sync(kFull, xb, d);
    if (lane >= d) {
      xa = max(xa, ya);
      xb = max(xb, yb);
    }
  }
  int32_t ea = __shfl_up_sync(kFull, xa, 1);
  int32_t eb = __shfl_up_sync(kFull, xb, 1);
  if (lane == 0) ea = eb = -1;
  if (lane == 31) {
    s_warp[0][warp] = xa;
    s_warp[1][warp] = xb;
  }
  __syncthreads();
  int32_t all_a = -1, all_b = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      ea = max(ea, s_warp[0][w]);
      eb = max(eb, s_warp[1][w]);
    }
    all_a = max(all_a, s_warp[0][w]);
    all_b = max(all_b, s_warp[1][w]);
  }
  if (threadIdx.x == 0) {
    lookback::publish(status, tile * 2,
                      all_a >= 0 ? lookback::word(epoch, lookback::kPrefix,
                                                  all_a)
                                 : lookback::word(epoch,
                                                  lookback::kAggregate, 0));
    lookback::publish(status, tile * 2 + 1,
                      all_b >= 0 ? lookback::word(epoch, lookback::kPrefix,
                                                  all_b)
                                 : lookback::word(epoch,
                                                  lookback::kAggregate, 0));
  }
  if (warp == 0) {
    // rows before the tile's first start of a kind take the nearest
    // earlier prefix (tile 0's row 0 starts both kinds)
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      int32_t pre = -1;
      if (!(s_flag[0] & (1 << col))) {
        pre = nearest_prefix(status, tile, tile + 1, -1, col, epoch, lane);
        if (lane == 0 && (col == 0 ? all_a : all_b) < 0) {
          lookback::publish(status, tile * 2 + col,
                            lookback::word(epoch, lookback::kPrefix, pre));
        }
      }
      if (lane == 0) s_prefix[col] = pre;
    }
  }
  __syncthreads();
  ea = max(ea, s_prefix[0]);
  eb = max(eb, s_prefix[1]);
  int32_t sa[kItems], sb[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    sa[i] = max(ea, seg[i]);
    sb[i] = max(eb, peer[i]);
  }
  int4* da = reinterpret_cast<int4*>(&s_out[0][kItems * threadIdx.x]);
  int4* db = reinterpret_cast<int4*>(&s_out[1][kItems * threadIdx.x]);
  da[0] = make_int4(sa[0], sa[1], sa[2], sa[3]);
  da[1] = make_int4(sa[4], sa[5], sa[6], sa[7]);
  db[0] = make_int4(sb[0], sb[1], sb[2], sb[3]);
  db[1] = make_int4(sb[4], sb[5], sb[6], sb[7]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int64_t r = t0 + i;
    if (r < n) {
      out[r] = s_out[0][i];
      out[2 * n + r] = s_out[1][i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bounds_ends_kernel(const uint8_t* __restrict__ flags, int64_t n,
                   int64_t tiles, unsigned long long* __restrict__ status,
                   unsigned long long* __restrict__ ticket,
                   unsigned long long ticket_base, unsigned long long epoch,
                   int32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t s_out[2][kTile];
  __shared__ int32_t s_warp[2][kWarps];
  __shared__ int32_t s_prefix[2];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = tiles - 1 - lookback::ticket(ticket, ticket_base);
  const int64_t t0 = tile * kTile;
  const int64_t r0 = t0 + kItems * threadIdx.x;
  unsigned long long fw = 0;
  if (r0 + kItems <= n) {
    fw = *reinterpret_cast<const unsigned long long*>(flags + r0);
  } else {
    for (int i = 0; i < kItems && r0 + i < n; ++i) {
      fw |= static_cast<unsigned long long>(flags[r0 + i]) << (8 * i);
    }
  }
  // the flags of the row after this thread's last: the next lane's first,
  // or for lane 31 a load (past the last row: both kinds, so that row n - 1
  // ends both groups)
  int next = __shfl_down_sync(kFull, static_cast<int>(fw & 0xff), 1);
  if (lane == 31) next = r0 + kItems < n ? flags[r0 + kItems] : 3;
  int32_t seg[kItems], peer[kItems];
  int32_t a = INT32_MAX, b = INT32_MAX;
#pragma unroll
  for (int i = kItems - 1; i >= 0; --i) {
    const int64_t r = r0 + i;
    const int fl = i + 1 < kItems
                       ? static_cast<int>(fw >> (8 * (i + 1))) & 3
                       : next;
    // a row past n is none; row n - 1 ends both kinds
    const int e = r < n ? (r == n - 1 ? 3 : fl) : 0;
    if (e & 1) a = static_cast<int32_t>(r);
    if (e & 2) b = static_cast<int32_t>(r);
    seg[i] = a;
    peer[i] = b;
  }
  if (threadIdx.x == kThreads - 1) s_last = (seg[kItems - 1] == r0 + kItems
                                              - 1) | ((peer[kItems - 1] ==
                                                       r0 + kItems - 1) << 1);
  // exclusive min-scan from the right of the threads' first ends
  int32_t xa = a, xb = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t ya = __shfl_down_sync(kFull, xa, d);
    const int32_t yb = __shfl_down_sync(kFull, xb, d);
    if (lane + d < 32) {
      xa = min(xa, ya);
      xb = min(xb, yb);
    }
  }
  int32_t ea = __shfl_down_sync(kFull, xa, 1);
  int32_t eb = __shfl_down_sync(kFull, xb, 1);
  if (lane == 31) ea = eb = INT32_MAX;
  if (lane == 0) {
    s_warp[0][warp] = xa;
    s_warp[1][warp] = xb;
  }
  __syncthreads();
  int32_t all_a = INT32_MAX, all_b = INT32_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w > warp) {
      ea = min(ea, s_warp[0][w]);
      eb = min(eb, s_warp[1][w]);
    }
    all_a = min(all_a, s_warp[0][w]);
    all_b = min(all_b, s_warp[1][w]);
  }
  if (threadIdx.x == 0) {
    lookback::publish(status, tile * 2,
                      all_a < INT32_MAX
                          ? lookback::word(epoch, lookback::kPrefix, all_a)
                          : lookback::word(epoch, lookback::kAggregate, 0));
    lookback::publish(status, tile * 2 + 1,
                      all_b < INT32_MAX
                          ? lookback::word(epoch, lookback::kPrefix, all_b)
                          : lookback::word(epoch, lookback::kAggregate, 0));
  }
  if (warp == 0) {
    // rows after the tile's last end of a kind take the nearest later
    // prefix (the last tile's last row ends both kinds)
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      int32_t pre = INT32_MAX;
      if (!(s_last & (1 << col)) && tile + 1 < tiles) {
        pre = nearest_prefix(status, tile, tiles, 1, col, epoch, lane);
        if (lane == 0 && (col == 0 ? all_a : all_b) == INT32_MAX) {
          lookback::publish(status, tile * 2 + col,
                            lookback::word(epoch, lookback::kPrefix, pre));
        }
      }
      if (lane == 0) s_prefix[col] = pre;
    }
  }
  __syncthreads();
  ea = min(ea, s_prefix[0]);
  eb = min(eb, s_prefix[1]);
  int32_t sa[kItems], sb[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    sa[i] = min(ea, seg[i]);
    sb[i] = min(eb, peer[i]);
  }
  int4* da = reinterpret_cast<int4*>(&s_out[0][kItems * threadIdx.x]);
  int4* db = reinterpret_cast<int4*>(&s_out[1][kItems * threadIdx.x]);
  da[0] = make_int4(sa[0], sa[1], sa[2], sa[3]);
  da[1] = make_int4(sa[4], sa[5], sa[6], sa[7]);
  db[0] = make_int4(sb[0], sb[1], sb[2], sb[3]);
  db[1] = make_int4(sb[4], sb[5], sb[6], sb[7]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int64_t r = t0 + i;
    if (r < n) {
      out[n + r] = s_out[0][i];
      out[3 * n + r] = s_out[1][i];
    }
  }
}

}  // namespace

// status holds at least 2 * ceil(n / kTile) words of the workspace and
// ticket its counter; ticket_base is the number of tiles launched on them
// before, and the two passes take the epochs epoch and epoch + 1 (1 to
// 2^30 - 1; kernels/_lookback.py reserves both) and the tickets after
// ticket_base, the ends pass after the starts pass's tiles. out holds
// int32 [4, n], flags n bytes, both 256-byte aligned.
extern "C" int exon_window_bounds(const void* keys, int rows, int n_part,
                                  int64_t n, void* status, void* ticket,
                                  uint64_t ticket_base, uint64_t epoch,
                                  void* out, void* flags, void* stream) {
  if (n == 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<unsigned long long*>(status);
  auto* tk = static_cast<unsigned long long*>(ticket);
  auto* o = static_cast<int32_t*>(out);
  auto* f = static_cast<uint8_t*>(flags);
  bounds_starts_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const int64_t*>(keys), rows, n_part, n, st, tk,
      ticket_base, epoch, o, f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bounds_ends_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      f, n, tiles, st, tk, ticket_base + tiles, epoch + 1, o);
  return static_cast<int>(cudaGetLastError());
}
