// expand_segments: per-row slot counts -> their offsets, the total, and the
// (probe row, build row) index pair of every slot.
//
// Replaces exon_tpu/ops/layout.py expand_segments (:308) and the index
// arithmetic of exon_tpu/plan/join_exec.py _jit_emit (:246-251). The JAX
// version scans the counts into offsets, scatters a 1 at each segment end
// into an out_cap-long buffer, cumsums it into a row id per slot, and
// gathers starts[rid] and lo[rid] per slot: three passes over the output
// plus two scans.
//
// Bound on the H100: HBM bytes. The counts and lo in (8 bytes a row), the
// offsets out (8 bytes a row), a probe and a build index a slot out (8
// bytes): C's probe batch, 131,072 rows and ~166,968 slots, moves ~3.4 MB,
// about 1 us at 3.35 TB/s.
//
// Design: two launches around the wrapper's one host read of the total.
//   expand_offsets_kernel is a single pass with a decoupled look-back
//     (Merrill and Garland, 2016) on the status words of lookback.cuh. A
//     block takes a tile of kTile rows by ticket, a thread four neighbouring
//     rows (one 16-byte load), scans the thread sums, publishes the tile's
//     sum, and warp 0 looks back for the tile's prefix. Each thread writes
//     its rows' exclusive offsets (two 16-byte stores); the last tile writes
//     offsets[n], the total. The tile's offsets stay in shared memory, and
//     for every output tile of kSlots slots whose first slot falls in this
//     tile's slots, the row holding that slot is written to first_row: the
//     block's threads take every kThreads-th of those output tiles, find
//     the first one's row by a binary search and each next one by
//     galloping on from the last, so a row of many slots (an entry for each
//     output tile it crosses) costs a probe an entry.
//   expand_write_kernel is balanced over output slots, not rows: block b
//     owns slots [b kSlots, (b + 1) kSlots), reads its first row from
//     first_row[b] and its last from first_row[b + 1], and stages the
//     offsets and lo of those rows in shared memory, each thread's loads
//     issued before its stores. A thread takes four neighbouring slots,
//     finds the first one's row by a binary search of the staged offsets,
//     in the manner of a merge path, walks on for the other three, and
//     writes both indices as 16-byte stores. Where rows of no slot make the
//     block's rows more than kStageRows, it stages every stride-th row's
//     offset instead, and a slot's row is searched within its stride in
//     device memory: no block walks a long run of empty rows. Build indices
//     are clamped to n_build - 1, as the JAX code clips them, so a left
//     join's unmatched slot points at a real row whose values are then
//     nulled.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows a thread of the offsets pass
constexpr int kTile = kThreads * kRows;
// slots a write block owns, four a thread (expand_segments.py's SLOT_TILE)
constexpr int64_t kSlots = 4 * kThreads;
// rows a write block stages at a time
constexpr int kStageRows = 2048;
constexpr int kStageIters = kStageRows / kThreads;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
expand_offsets_kernel(const int32_t* __restrict__ counts, int64_t n,
                      unsigned long long* __restrict__ status,
                      unsigned long long* __restrict__ ticket,
                      unsigned long long ticket_base,
                      unsigned long long epoch, int64_t* __restrict__ offsets,
                      int32_t* __restrict__ first_row, int64_t max_tiles) {
  __shared__ long long warp_sums[kWarps];
  __shared__ int64_t prefix_s;
  // the tile's exclusive offsets, then its end
  __shared__ int64_t starts[kTile + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = lookback::ticket(ticket, ticket_base);
  const int64_t start = tile * kTile;
  const int64_t r0 = start + kRows * threadIdx.x;
  int64_t c[kRows];
  if (r0 + kRows <= n &&
      (reinterpret_cast<uintptr_t>(counts + r0) & 15) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(counts + r0);
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) c[j] = r0 + j < n ? counts[r0 + j] : 0;
  }
  const long long mine = c[0] + c[1] + c[2] + c[3];
  long long incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  long long before = 0, tile_sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const long long s = warp_sums[w];
    before += w < warp ? s : 0;
    tile_sum += s;
  }
  if (threadIdx.x == 0) {
    lookback::publish(status, tile,
                      lookback::word(epoch, tile == 0 ? lookback::kPrefix
                                                      : lookback::kAggregate,
                                     tile_sum));
  }
  if (warp == 0) {
    const int64_t prefix = lookback::exclusive_prefix(status, tile, 1, 0,
                                                      epoch, 32, lane, kFull);
    if (lane == 0) {
      if (tile > 0) {
        lookback::publish(status, tile,
                          lookback::word(epoch, lookback::kPrefix,
                                         prefix + tile_sum));
      }
      prefix_s = prefix;
    }
  }
  __syncthreads();
  const int64_t prefix = prefix_s;
  int64_t o[kRows];
  int64_t run = prefix + before + incl - mine;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    o[j] = run;
    starts[kRows * threadIdx.x + j] = run;
    run += c[j];
  }
  if (r0 + kRows <= n) {
    // offsets is 256-byte aligned and r0 a multiple of 4: 32 bytes
    longlong2* dst = reinterpret_cast<longlong2*>(offsets + r0);
    dst[0] = make_longlong2(o[0], o[1]);
    dst[1] = make_longlong2(o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (r0 + j < n) offsets[r0 + j] = o[j];
    }
  }
  const int64_t end = prefix + tile_sum;
  if (threadIdx.x == 0) {
    starts[kTile] = end;
    if (start + kTile >= n) offsets[n] = end;
  }
  __syncthreads();
  // the output tiles whose first slot lies in [prefix, end), strided over
  // the threads: a thread finds its first tile's row by a binary search and
  // each next one by galloping on from the last (a row of many slots, which
  // crosses many tiles, is found at once)
  if (end > prefix) {
    const int64_t t_first = (prefix + kSlots - 1) / kSlots;
    int64_t t_last = (end - 1) / kSlots;
    if (t_last >= max_tiles) t_last = max_tiles - 1;
    int row = -1;
    for (int64_t t = t_first + threadIdx.x; t <= t_last; t += kThreads) {
      const int64_t k = t * kSlots;
      // the last row whose offset is <= k: rows of no slot share their
      // offset with the next row, so this is the row holding slot k
      int a, b;  // starts[a] <= k < starts[b] (starts[kTile] = end > k)
      if (row < 0) {
        a = 0;
        b = kTile;
      } else {
        a = row;
        int step = 1;
        b = row + 1;
        while (starts[b] <= k) {
          a = b;
          step <<= 1;
          b = a + step < kTile ? a + step : kTile;
        }
      }
      while (b - a > 1) {
        const int mid = (a + b) >> 1;
        if (starts[mid] <= k) a = mid; else b = mid;
      }
      row = a;
      first_row[t] = static_cast<int32_t>(start + row);
    }
  }
}

// The last index in [0, m) whose staged offset is <= k.
__device__ __forceinline__ int sample_of(const int64_t* s_off, int m,
                                         int64_t k) {
  int a = 0, b = m;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (s_off[mid] <= k) a = mid + 1; else b = mid;
  }
  return a - 1;
}

// The last row in [a, b) whose offset is <= k (offsets[a] <= k).
__device__ __forceinline__ int64_t row_in(const int64_t* offsets, int64_t a,
                                          int64_t b, int64_t k) {
  while (b - a > 1) {
    const int64_t mid = (a + b) >> 1;
    if (offsets[mid] <= k) a = mid; else b = mid;
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
expand_write_kernel(const int32_t* __restrict__ lo,
                    const int64_t* __restrict__ offsets,
                    const int32_t* __restrict__ first_row, int64_t n,
                    int64_t total, int64_t last_build,
                    int32_t* __restrict__ probe_idx,
                    int32_t* __restrict__ build_idx) {
  __shared__ int64_t s_off[kStageRows + 1];
  __shared__ int32_t s_lo[kStageRows];
  const int64_t n_tiles = (total + kSlots - 1) / kSlots;
  const int64_t b = blockIdx.x;
  const int64_t k0 = b * kSlots;
  const int64_t k1 = k0 + kSlots < total ? k0 + kSlots : total;
  // the rows [c, r_end) hold the block's slots
  const int64_t c = first_row[b];
  const int64_t r_end = b + 1 < n_tiles ? first_row[b + 1] + 1 : n;
  // stage every stride-th row's offset (stride 1, and lo too, unless rows
  // of no slot make the range longer than the stage), each thread's loads
  // issued before its stores
  const int64_t stride = (r_end - c + kStageRows - 1) / kStageRows;
  const int m = static_cast<int>((r_end - c + stride - 1) / stride);
  int64_t o[kStageIters];
  int32_t l[kStageIters];
#pragma unroll
  for (int q = 0; q < kStageIters; ++q) {
    const int i = threadIdx.x + q * kThreads;
    if (i < m) {
      o[q] = offsets[c + i * stride];
      if (stride == 1) l[q] = lo[c + i];
    }
  }
  const int64_t end_off = threadIdx.x == 0 ? offsets[r_end] : 0;
#pragma unroll
  for (int q = 0; q < kStageIters; ++q) {
    const int i = threadIdx.x + q * kThreads;
    if (i < m) {
      s_off[i] = o[q];
      if (stride == 1) s_lo[i] = l[q];
    }
  }
  if (threadIdx.x == 0) s_off[m] = end_off;
  __syncthreads();
  const int64_t g = k0 + 4 * threadIdx.x;  // this thread's four slots
  if (stride == 1 && g + 4 <= k1) {
    int r = sample_of(s_off, m, g);
    int p[4], q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t k = g + j;
      while (s_off[r + 1] <= k) ++r;
      const int64_t bi = s_lo[r] + (k - s_off[r]);
      p[j] = static_cast<int32_t>(c + r);
      q[j] = static_cast<int32_t>(bi < last_build ? bi : last_build);
    }
    // probe_idx and build_idx are 256-byte aligned and g a multiple of 4
    *reinterpret_cast<int4*>(probe_idx + g) = make_int4(p[0], p[1], p[2],
                                                        p[3]);
    *reinterpret_cast<int4*>(build_idx + g) = make_int4(q[0], q[1], q[2],
                                                        q[3]);
    return;
  }
  for (int64_t k = g; k < g + 4 && k < k1; ++k) {
    const int i = sample_of(s_off, m, k);
    int64_t row, off, first;
    if (stride == 1) {
      row = c + i;
      off = s_off[i];
      first = s_lo[i];
    } else {  // the last row of the sample's stride with an offset <= k
      const int64_t a = c + i * stride;
      row = row_in(offsets, a, a + stride < r_end ? a + stride : r_end, k);
      off = offsets[row];
      first = lo[row];
    }
    const int64_t bi = first + (k - off);
    probe_idx[k] = static_cast<int32_t>(row);
    build_idx[k] = static_cast<int32_t>(bi < last_build ? bi : last_build);
  }
}

}  // namespace

// status holds at least ceil(n / kTile) words of the workspace and ticket
// its counter; ticket_base is the number of tiles launched on them before
// and epoch this call's number, 1 to 2^30 - 1. offsets holds n + 1 int64,
// first_row max_tiles int32 (an entry for each kSlots slots of a total
// below 2^31).
extern "C" int exon_expand_offsets(const void* counts, int64_t n,
                                   void* status, void* ticket,
                                   uint64_t ticket_base, uint64_t epoch,
                                   void* offsets, void* first_row,
                                   int64_t max_tiles, void* stream) {
  if (n == 0) return 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  expand_offsets_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), n,
      static_cast<unsigned long long*>(status),
      static_cast<unsigned long long*>(ticket), ticket_base, epoch,
      static_cast<int64_t*>(offsets), static_cast<int32_t*>(first_row),
      max_tiles);
  return static_cast<int>(cudaGetLastError());
}

// total = offsets[n], 1 to 2^31 - 1; probe_idx and build_idx hold total
// int32 each, 16-byte aligned.
extern "C" int exon_expand_write(const void* lo, const void* offsets,
                                 const void* first_row, int64_t n,
                                 int64_t total, int64_t last_build,
                                 void* probe_idx, void* build_idx,
                                 void* stream) {
  if (total <= 0) return 0;
  const int64_t blocks = (total + kSlots - 1) / kSlots;
  expand_write_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lo), static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(first_row), n, total, last_build,
      static_cast<int32_t*>(probe_idx), static_cast<int32_t*>(build_idx));
  return static_cast<int>(cudaGetLastError());
}
