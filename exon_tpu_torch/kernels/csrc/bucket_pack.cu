// bucket_pack: a stable counting sort of rows into per-destination buckets,
// with the scatter of every column in its own body.
//
// Replaces the two device programs at the head of the JAX package's
// hash-partition shuffle: parallel/shuffle.py partition_ids (:39), the murmur
// fmix32 finalizer of each int64 key's low 32 bits modulo the partition
// count, and bucketize (:53), a stable argsort of the destinations, their
// true counts, each row's position within its destination and the scatter of
// every column into [n_parts, bucket_cap] buffers, dropping masked rows and
// rows past bucket_cap (the counts are taken before anything is dropped, so
// the caller sees an overflow) and leaving zero in empty slots.
//
// Bound on the H100: HBM bytes. Each live row reads its key (or its
// destination) and its mask once and its columns once, and writes its
// columns once plus its destination and rank; a shuffle of a few hundred
// thousand group rows moves tens of MB, tens of microseconds at 3.35 TB/s,
// so at the aggregate's sizes the launches, not the bytes, set the time.
//
// Design: a counting sort, no comparison sort. The rows are cut into warp
// tiles of kTileRows consecutive rows, one warp each, walked 32 rows at a
// time in row order.
//   pass 1 (bucket_hist_kernel): each row's destination (fmix32 of the key,
//     or the given one; a masked row or one outside [0, n_parts) gets
//     n_parts and takes no slot), written to dest[n]; the lanes that share
//     a destination find each other with __match_any_sync and the lowest of
//     them adds their number to hist[d, tile] with one atomicAdd.
//   between the passes the wrapper scans hist along the tiles (torch.cumsum),
//     so that base[d, t] is the number of rows of destination d in earlier
//     tiles, and sums it into the true counts[d].
//   pass 2 (bucket_scatter_kernel): each warp walks its tile again in the
//     same order; the lowest lane of each destination group takes the
//     group's place with an atomicAdd on base[d, t] (only this warp touches
//     that entry, and the add's returned value orders the chunks), and each
//     lane's rank is that place plus the number of its peers below it
//     (__popc of the match mask under its lane), which is the row's stable
//     rank within its destination, as the JAX package's stable argsort
//     gives it. A row whose rank is below bucket_cap copies each of its
//     columns' row bytes to slot d * bucket_cap + rank, in 8-, 4- or 1-byte
//     words as the row width allows.
// The output buffers are zeroed by the wrapper; the kernel allocates nothing
// and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 32-row chunks in a warp tile: a warp walks its tile in order, so short
// tiles keep enough warps in flight for a few thousand rows
constexpr int kChunks = 2;
constexpr int kTileRows = 32 * kChunks;
constexpr int kMaxCols = 17;                // 16 columns and the keys

struct Cols {
  int32_t n_cols;
  const uint8_t* src[kMaxCols];
  uint8_t* dst[kMaxCols];
  int64_t row_bytes[kMaxCols];
};

__device__ __forceinline__ int32_t destination(const int64_t* keys,
                                               const int32_t* dest_in,
                                               const uint8_t* mask,
                                               int32_t n_parts, int64_t row) {
  if (mask != nullptr && mask[row] == 0) return n_parts;
  if (dest_in != nullptr) {
    const int32_t d = dest_in[row];
    return (d < 0 || d >= n_parts) ? n_parts : d;
  }
  uint32_t h = static_cast<uint32_t>(static_cast<uint64_t>(keys[row]));
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return static_cast<int32_t>(h % static_cast<uint32_t>(n_parts));
}

__global__ void bucket_hist_kernel(int64_t n, const int64_t* __restrict__ keys,
                                   const int32_t* __restrict__ dest_in,
                                   const uint8_t* __restrict__ mask,
                                   int32_t n_parts, int64_t n_tiles,
                                   int32_t* __restrict__ dest,
                                   int32_t* __restrict__ hist) {
  const int64_t tile =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < kChunks; ++c) {
    const int64_t row = tile * kTileRows + c * 32 + lane;
    const int32_t d =
        row < n ? destination(keys, dest_in, mask, n_parts, row) : n_parts;
    if (row < n) dest[row] = d;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < n_parts && lane == __ffs(peers) - 1) {
      atomicAdd(hist + static_cast<int64_t>(d) * n_tiles + tile,
                __popc(peers));
    }
  }
}

__device__ __forceinline__ void copy_row(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ dst,
                                         int64_t bytes) {
  if ((bytes & 7) == 0) {
    const uint64_t* s = reinterpret_cast<const uint64_t*>(src);
    uint64_t* d = reinterpret_cast<uint64_t*>(dst);
    for (int64_t i = 0; i < (bytes >> 3); ++i) d[i] = s[i];
  } else if ((bytes & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int64_t i = 0; i < (bytes >> 2); ++i) d[i] = s[i];
  } else {
    for (int64_t i = 0; i < bytes; ++i) dst[i] = src[i];
  }
}

__global__ void bucket_scatter_kernel(int64_t n,
                                      const int32_t* __restrict__ dest,
                                      int32_t n_parts, int64_t n_tiles,
                                      int32_t* __restrict__ base,
                                      int64_t bucket_cap, Cols cols,
                                      int32_t* __restrict__ rank_out) {
  const int64_t tile =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < kChunks; ++c) {
    const int64_t row = tile * kTileRows + c * 32 + lane;
    const int32_t d = row < n ? dest[row] : n_parts;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    int32_t place = 0;
    if (d < n_parts && lane == leader) {
      place = atomicAdd(base + static_cast<int64_t>(d) * n_tiles + tile,
                        __popc(peers));
    }
    place = __shfl_sync(0xffffffffu, place, leader);
    if (row >= n) continue;
    if (d >= n_parts) {
      rank_out[row] = -1;
      continue;
    }
    const int64_t rank = static_cast<int64_t>(place) + __popc(peers & below);
    rank_out[row] = static_cast<int32_t>(rank);
    if (rank >= bucket_cap) continue;
    const int64_t slot = static_cast<int64_t>(d) * bucket_cap + rank;
    for (int32_t k = 0; k < cols.n_cols; ++k) {
      const int64_t w = cols.row_bytes[k];
      copy_row(cols.src[k] + row * w, cols.dst[k] + slot * w, w);
    }
  }
}

}  // namespace

// keys (int64 [n]) or dest_in (int32 [n]) names the destinations; the other
// is null. mask (uint8 [n]) may be null. srcs/dsts/row_bytes are host
// arrays of n_cols entries; every other pointer is device memory: dest
// int32 [n] and hist int32 [n_parts, n_tiles] (zeroed) for pass 1; base
// int32 [n_parts, n_tiles] (hist scanned along the tiles, modified in
// place) and rank_out int32 [n] for pass 2. Returns cudaGetLastError(), or
// -1 for more than kMaxCols columns.
extern "C" int exon_bucket_hist(int64_t n, const void* keys,
                                const void* dest_in, const void* mask,
                                int32_t n_parts, void* dest, void* hist,
                                void* stream) {
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  const unsigned blocks = static_cast<unsigned>((n_tiles + kWarps - 1) / kWarps);
  bucket_hist_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int64_t*>(keys),
      static_cast<const int32_t*>(dest_in), static_cast<const uint8_t*>(mask),
      n_parts, n_tiles, static_cast<int32_t*>(dest),
      static_cast<int32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_bucket_scatter(int64_t n, const void* dest,
                                   int32_t n_parts, void* base,
                                   int64_t bucket_cap, int32_t n_cols,
                                   const uint64_t* srcs, const uint64_t* dsts,
                                   const int64_t* row_bytes, void* rank_out,
                                   void* stream) {
  if (n_cols > kMaxCols) return -1;
  Cols cols{};
  cols.n_cols = n_cols;
  for (int32_t k = 0; k < n_cols; ++k) {
    cols.src[k] = reinterpret_cast<const uint8_t*>(srcs[k]);
    cols.dst[k] = reinterpret_cast<uint8_t*>(dsts[k]);
    cols.row_bytes[k] = row_bytes[k];
  }
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  const unsigned blocks = static_cast<unsigned>((n_tiles + kWarps - 1) / kWarps);
  bucket_scatter_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int32_t*>(dest), n_parts, n_tiles,
      static_cast<int32_t*>(base), bucket_cap, cols,
      static_cast<int32_t*>(rank_out));
  return static_cast<int>(cudaGetLastError());
}
