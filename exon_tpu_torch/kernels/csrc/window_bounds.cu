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
// written, about 14 us at 3.35 TB/s.
//
// Design: a start is the max-scan of (flag ? row : 0), an end the min-scan
// from the right of (next row starts ? row : n). Pass 1: one block per tile
// of kThreads * kItems rows; each thread computes the flags of its kItems
// consecutive rows (and of the row after them), scans them in registers,
// and a block scan over the threads (warp shuffles, warp totals in shared
// memory) completes the tile; each tile's total goes to a carry array.
// Pass 2 (one block) turns the carries into exclusive scans across tiles,
// pass 3 applies them. A single tile needs pass 1 alone.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// bit 0: the row starts a partition, bit 1: it starts a peer group. Rows
// are ordered partition keys first, so the first row that differs decides.
__device__ __forceinline__ int row_flags(const int64_t* __restrict__ keys,
                                         int rows, int n_part, int64_t n,
                                         int64_t r) {
  if (r == 0 || r >= n) return 3;
  for (int c = 0; c < rows; ++c) {
    const int64_t* k = keys + static_cast<int64_t>(c) * n;
    if (k[r] != k[r - 1]) return c < n_part ? 3 : 2;
  }
  return 0;
}

template <bool kMax>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return kMax ? max(a, b) : min(a, b);
}

// Exclusive scan of one value per thread over the block, from the left
// (kReverse false) or from the right; also the block's total. Both must be
// called by every thread of the block.
template <bool kMax, bool kReverse>
__device__ int32_t block_scan(int32_t v, int32_t* sh, int32_t* total) {
  const int32_t ident = kMax ? INT32_MIN : INT32_MAX;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = kReverse ? __shfl_down_sync(0xffffffffu, x, d)
                               : __shfl_up_sync(0xffffffffu, x, d);
    if (kReverse ? lane + d < 32 : lane >= d) x = op<kMax>(x, y);
  }
  int32_t excl = kReverse ? __shfl_down_sync(0xffffffffu, x, 1)
                          : __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == (kReverse ? 31 : 0)) excl = ident;
  if (lane == (kReverse ? 0 : 31)) sh[warp] = x;
  __syncthreads();
  int32_t across = ident;
  int32_t all = ident;
  for (int w = 0; w < kWarps; ++w) {
    all = op<kMax>(all, sh[w]);
    if (kReverse ? w > warp : w < warp) across = op<kMax>(across, sh[w]);
  }
  __syncthreads();
  *total = all;
  return op<kMax>(across, excl);
}

__global__ void tile_kernel(const int64_t* __restrict__ keys, int rows,
                            int n_part, int64_t n, int32_t* __restrict__ out,
                            int32_t* __restrict__ carry, int64_t tiles) {
  __shared__ int32_t sh[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       static_cast<int64_t>(threadIdx.x) * kItems;
  int f[kItems + 1];
#pragma unroll
  for (int j = 0; j <= kItems; ++j) f[j] = row_flags(keys, rows, n_part, n,
                                                     base + j);
  int32_t seg_s[kItems], peer_s[kItems], seg_e[kItems], peer_e[kItems];
  int32_t a = INT32_MIN, b = INT32_MIN;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int32_t r = static_cast<int32_t>(base + j);
    if (f[j] & 1) a = r;
    if (f[j] & 2) b = r;
    seg_s[j] = a;
    peer_s[j] = b;
  }
  int32_t c = INT32_MAX, d = INT32_MAX;
#pragma unroll
  for (int j = kItems - 1; j >= 0; --j) {
    const int32_t r = static_cast<int32_t>(base + j);
    if (f[j + 1] & 1) c = r;
    if (f[j + 1] & 2) d = r;
    seg_e[j] = c;
    peer_e[j] = d;
  }
  int32_t t0, t1, t2, t3;
  const int32_t pa = block_scan<true, false>(a, sh, &t0);
  const int32_t pb = block_scan<true, false>(b, sh, &t1);
  const int32_t sc = block_scan<false, true>(c, sh, &t2);
  const int32_t sd = block_scan<false, true>(d, sh, &t3);
  if (threadIdx.x == 0) {
    carry[blockIdx.x] = t0;
    carry[tiles + blockIdx.x] = t1;
    carry[2 * tiles + blockIdx.x] = t2;
    carry[3 * tiles + blockIdx.x] = t3;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + j;
    if (r >= n) break;
    out[r] = max(pa, seg_s[j]);
    out[n + r] = min(sc, seg_e[j]);
    out[2 * n + r] = max(pb, peer_s[j]);
    out[3 * n + r] = min(sd, peer_e[j]);
  }
}

// One block: each carry row becomes the exclusive scan of the tiles'
// totals (starts from the left by max, ends from the right by min).
__global__ void carry_kernel(int32_t* __restrict__ carry, int64_t tiles) {
  __shared__ int32_t sh[kWarps];
  for (int row = 0; row < 4; ++row) {
    int32_t* c = carry + row * tiles;
    const bool starts = row < 2;
    int32_t running = starts ? INT32_MIN : INT32_MAX;
    for (int64_t c0 = 0; c0 < tiles; c0 += kThreads) {
      int32_t total;
      if (starts) {
        const int64_t i = c0 + threadIdx.x;
        const int32_t v = i < tiles ? c[i] : INT32_MIN;
        const int32_t e = block_scan<true, false>(v, sh, &total);
        if (i < tiles) c[i] = max(running, e);
        running = max(running, total);
      } else {
        const int64_t i = tiles - 1 - c0 - threadIdx.x;
        const int32_t v = i >= 0 ? c[i] : INT32_MAX;
        // thread order runs right to left here, so a left scan of the
        // threads is a scan from the right of the tiles
        const int32_t e = block_scan<false, false>(v, sh, &total);
        if (i >= 0) c[i] = min(running, e);
        running = min(running, total);
      }
    }
  }
}

__global__ void apply_kernel(int32_t* __restrict__ out,
                             const int32_t* __restrict__ carry, int64_t n,
                             int64_t tiles) {
  const int64_t tile = blockIdx.x;
  const int32_t cs = carry[tile], cp = carry[tiles + tile];
  const int32_t ce = carry[2 * tiles + tile], cl = carry[3 * tiles + tile];
  const int64_t stop = (tile + 1) * kTile;
  const int64_t end = stop < n ? stop : n;
  for (int64_t r = tile * kTile + threadIdx.x; r < end; r += kThreads) {
    out[r] = max(out[r], cs);
    out[n + r] = min(out[n + r], ce);
    out[2 * n + r] = max(out[2 * n + r], cp);
    out[3 * n + r] = min(out[3 * n + r], cl);
  }
}

}  // namespace

extern "C" int exon_window_bounds(const void* keys, int rows, int n_part,
                                  int64_t n, void* out, void* carry,
                                  void* stream) {
  if (n == 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const int64_t*>(keys), rows, n_part, n,
      static_cast<int32_t*>(out), static_cast<int32_t*>(carry), tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  carry_kernel<<<1, kThreads, 0, s>>>(static_cast<int32_t*>(carry), tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(carry), n,
      tiles);
  return static_cast<int>(cudaGetLastError());
}
