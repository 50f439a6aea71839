// bucket_pack: a stable counting sort of rows into per-destination buckets,
// with the scatter of every column and the zeros of the empty slots.
//
// Replaces the two device programs at the head of the JAX package's
// hash-partition shuffle: parallel/shuffle.py partition_ids (:39), the murmur
// fmix32 finalizer of each int64 key's low 32 bits modulo the partition
// count, and bucketize (:51), a stable argsort of the destinations, their
// true counts, each row's position within its destination and the scatter of
// every column into [n_parts, bucket_cap] buffers, dropping masked rows and
// rows past bucket_cap (the counts are taken before anything is dropped, so
// the caller sees an overflow) and leaving zero in empty slots.
//
// Bound on the H100: HBM bytes. Each row reads its key (or its destination)
// and its mask once and its columns once, and writes its destination and
// rank; the buckets are written once, rows and zeros; a shuffle of a few
// hundred thousand group rows moves tens of MB, tens of microseconds at
// 3.35 TB/s, so at the aggregate's sizes the launches, not the bytes, set
// the time. A call is two launches whatever its column count, with no
// torch op between them: the rank pass, then the move pass.
//
// bucket_rank_kernel: a single pass with a decoupled look-back per
//   destination (lookback.cuh; Onesweep's radix pass with n_parts digits).
//   A block takes a tile of warps x kWarpRows consecutive rows by ticket;
//   each warp walks its kWarpRows rows 32 at a time, in order. A row's
//   destination is fmix32 of its key, or the given one (a masked row or one
//   outside [0, n_parts) gets n_parts and takes no slot). The lanes that
//   share a destination find each other with __match_any_sync; the lowest
//   of them adds their number to the warp's counter of that destination in
//   shared memory, so each row knows its rank among the warp's rows. A scan
//   of the counters across the warps gives each warp its offset and the
//   tile its count per destination, which the tile publishes in its status
//   words (a row of words a destination, [n_parts, n_tiles], so that a
//   look-back reads neighbouring words). Groups of lanes (32 for up
//   to warps destinations, fewer, down to one, for more) then look back,
//   each for one destination at a time, and publish the tile's inclusive
//   prefixes. A row's rank is the tile's prefix of its destination plus its
//   warp's offset plus its rank in the warp: its stable rank within its
//   destination, as the JAX package's stable argsort gives it, also past
//   bucket_cap. The last tile writes the counts. Shared memory holds
//   (warps + 2) x n_parts int32 counters; the wrapper takes fewer warps for
//   many destinations (down to one warp: up to 19,285 destinations).
// bucket_move_kernel: one flat grid-stride pass over two kinds of items,
//   after the counts are known, kUnroll items a thread at a time with
//   their loads issued together. A scatter item is one word of one row of
//   one column (16, 8, 4, 2 or 1 bytes, the widest that the row width and
//   both addresses allow, so no column is copied to align it); neighbouring
//   threads read neighbouring words, and a row whose rank is below
//   bucket_cap stores its word in slot dest * bucket_cap + rank. A zero
//   item is 16 bytes of a column's bucket buffer: the bytes of the slots at
//   ranks min(count, bucket_cap) .. bucket_cap - 1 of each destination are
//   stored as zeros (one uint4 store inside an empty run, bytes at its
//   edges), the other bytes left to the scatter.
// The kernels allocate nothing and do not synchronise; the wrapper
// allocates the buckets unfilled (the move pass writes every slot).

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kChunks = 8;                 // 32-row chunks a warp walks
constexpr int kWarpRows = 32 * kChunks;
constexpr int kMaxCols = 17;               // 16 columns and the keys
// dynamic shared memory: the H100's 232,448 opt-in bytes a block, less
// room for the static ticket
constexpr int kSharedMax = 232448 - 1024;
constexpr int kMoveThreads = 256;
constexpr int kUnroll = 4;                 // move items a thread at a time
constexpr int64_t kMaxMoveBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;

struct Move {
  int32_t n_cols;
  int64_t cap;
  const uint8_t* src[kMaxCols];
  uint8_t* dst[kMaxCols];
  int64_t row_bytes[kMaxCols];
  int32_t word[kMaxCols];       // bytes a scatter item moves
  int64_t words[kMaxCols];      // scatter items a row
  int64_t end[2 * kMaxCols];    // item ends: column k's scatter items
                                // (2k), then its zero words (2k + 1)
};

__device__ __forceinline__ int32_t destination(const int64_t* keys,
                                               const int32_t* dest_in,
                                               const uint8_t* mask,
                                               int32_t n_parts, int64_t row) {
  // every load first, so that a warp's chunks load together
  const uint8_t keep = mask != nullptr ? mask[row] : 1;
  const int32_t given = dest_in != nullptr ? dest_in[row] : 0;
  const int64_t key = keys != nullptr ? keys[row] : 0;
  if (keep == 0) return n_parts;
  if (dest_in != nullptr) {
    return (given < 0 || given >= n_parts) ? n_parts : given;
  }
  uint32_t h = static_cast<uint32_t>(static_cast<uint64_t>(key));
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return static_cast<int32_t>(h % static_cast<uint32_t>(n_parts));
}

__global__ void __launch_bounds__(kMaxWarps * 32)
bucket_rank_kernel(int64_t n, const int64_t* __restrict__ keys,
                   const int32_t* __restrict__ dest_in,
                   const uint8_t* __restrict__ mask, int32_t n_parts,
                   int group, unsigned long long* __restrict__ status,
                   unsigned long long* __restrict__ ticket,
                   unsigned long long ticket_base, unsigned long long epoch,
                   int64_t n_tiles, int32_t* __restrict__ dest_out,
                   int32_t* __restrict__ rank_out,
                   int32_t* __restrict__ counts) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* total = smem + warps * n_parts;   // the tile's rows a destination
  int32_t* prefix = total + n_parts;         // and those of earlier tiles
  for (int i = threadIdx.x; i < warps * n_parts; i += blockDim.x) smem[i] = 0;
  const int64_t tile = lookback::ticket(ticket, ticket_base);
  int32_t* mine = smem + warp * n_parts;
  const int64_t row0 = (tile * warps + warp) * kWarpRows;
  int32_t d[kChunks], pre[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t row = row0 + c * 32 + lane;
    d[c] = row < n ? destination(keys, dest_in, mask, n_parts, row) : n_parts;
  }
  // each row's rank among the warp's rows of its destination
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned peers = __match_any_sync(kFull, d[c]);
    const int leader = __ffs(peers) - 1;
    int32_t before = 0;
    if (lane == leader && d[c] < n_parts) {
      before = mine[d[c]];
      mine[d[c]] = before + __popc(peers);
    }
    pre[c] = __shfl_sync(kFull, before, leader) + __popc(peers & below);
    __syncwarp();
  }
  __syncthreads();
  // the warps' offsets and the tile's count, published, per destination
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
    int32_t run = 0;
    for (int w = 0; w < warps; ++w) {
      const int32_t c = smem[w * n_parts + p];
      smem[w * n_parts + p] = run;
      run += c;
    }
    total[p] = run;
    lookback::publish(status, p * n_tiles + tile,
                      lookback::word(epoch, tile == 0 ? lookback::kPrefix
                                                      : lookback::kAggregate,
                                     run));
  }
  __syncthreads();
  // the look-back: groups of `group` lanes, one destination at a time
  const int glane = lane & (group - 1);
  const unsigned gmask =
      group == 32 ? kFull : ((1u << group) - 1u) << (lane & ~(group - 1));
  const int groups = blockDim.x / group;
  for (int p = threadIdx.x / group; p < n_parts; p += groups) {
    const int64_t before = lookback::exclusive_prefix(
        status, tile, 1, p * n_tiles, epoch, group, glane, gmask);
    if (glane == 0) {
      if (tile > 0) {
        lookback::publish(status, p * n_tiles + tile,
                          lookback::word(epoch, lookback::kPrefix,
                                         before + total[p]));
      }
      prefix[p] = static_cast<int32_t>(before);
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t row = row0 + c * 32 + lane;
    if (row >= n) continue;
    dest_out[row] = d[c];
    rank_out[row] = d[c] < n_parts ? prefix[d[c]] + mine[d[c]] + pre[c] : -1;
  }
  if (tile == n_tiles - 1) {
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
      counts[p] = prefix[p] + total[p];
    }
  }
}

// a / b with 32-bit division where both fit
__device__ __forceinline__ int64_t quotient(int64_t a, int64_t b) {
  if (((a | b) >> 32) == 0) {
    return static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
  }
  return a / b;
}

__device__ __forceinline__ uint4 load_word(const uint8_t* p, int w) {
  switch (w) {
    case 16: return *reinterpret_cast<const uint4*>(p);
    case 8: {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      return make_uint4(v.x, v.y, 0, 0);
    }
    case 4: return make_uint4(*reinterpret_cast<const uint32_t*>(p), 0, 0, 0);
    case 2: return make_uint4(*reinterpret_cast<const uint16_t*>(p), 0, 0, 0);
    default: return make_uint4(*p, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_word(uint8_t* p, int w, uint4 v) {
  switch (w) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.x; break;
    case 2:
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v.x);
      break;
    default: *p = static_cast<uint8_t>(v.x);
  }
}

// The empty slots' bytes of the 16-byte word at byte b0 of a bucket buffer
// of `bytes` bytes: destination d's bucket is bytes [d * per, (d + 1) *
// per), its first min(counts[d], cap) * row_bytes filled by the scatter.
__device__ __forceinline__ void zero_word(uint8_t* __restrict__ buf,
                                          int64_t bytes, int64_t b0,
                                          int64_t per, int64_t cap,
                                          int64_t row_bytes,
                                          const int32_t* __restrict__ counts) {
  int64_t d = quotient(b0, per);
  int64_t in = b0 - d * per;
  int64_t filled = min(static_cast<int64_t>(counts[d]), cap) * row_bytes;
  if (in + 16 <= per && b0 + 16 <= bytes) {
    if (in >= filled) {
      *reinterpret_cast<uint4*>(buf + b0) = make_uint4(0, 0, 0, 0);
      return;
    }
    if (in + 16 <= filled) return;
  }
  for (int t = 0; t < 16 && b0 + t < bytes; ++t, ++in) {
    if (in == per) {
      ++d;
      in = 0;
      filled = min(static_cast<int64_t>(counts[d]), cap) * row_bytes;
    }
    if (in >= filled) buf[b0 + t] = 0;
  }
}

__global__ void __launch_bounds__(kMoveThreads)
bucket_move_kernel(const int32_t* __restrict__ dest,
                   const int32_t* __restrict__ rank,
                   const int32_t* __restrict__ counts, int32_t n_parts,
                   const __grid_constant__ Move mv) {
  const int64_t items = mv.end[2 * mv.n_cols - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kMoveThreads;
  int seg = 0;
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * kMoveThreads +
                       threadIdx.x;
       first < items; first += kUnroll * stride) {
    int k[kUnroll];
    int64_t row[kUnroll], at[kUnroll];
    int32_t r[kUnroll], d[kUnroll];
    // the items: zero words are stored at once, scatter items read their
    // rows' ranks and destinations
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = first + u * stride;
      r[u] = -1;
      k[u] = 0;
      row[u] = at[u] = d[u] = 0;
      if (i >= items) continue;
      while (i >= mv.end[seg]) ++seg;
      k[u] = seg >> 1;
      const int64_t local = i - (seg > 0 ? mv.end[seg - 1] : 0);
      const int64_t rb = mv.row_bytes[k[u]];
      if (seg & 1) {
        zero_word(mv.dst[k[u]], n_parts * mv.cap * rb, 16 * local,
                  mv.cap * rb, mv.cap, rb, counts);
        continue;
      }
      row[u] = quotient(local, mv.words[k[u]]);
      at[u] = (local - row[u] * mv.words[k[u]]) * mv.word[k[u]];
      r[u] = rank[row[u]];
      d[u] = dest[row[u]];
    }
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] >= 0 && r[u] < mv.cap) {
        v[u] = load_word(mv.src[k[u]] + row[u] * mv.row_bytes[k[u]] + at[u],
                         mv.word[k[u]]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] >= 0 && r[u] < mv.cap) {
        const int64_t slot = static_cast<int64_t>(d[u]) * mv.cap + r[u];
        store_word(mv.dst[k[u]] + slot * mv.row_bytes[k[u]] + at[u],
                   mv.word[k[u]], v[u]);
      }
    }
  }
}

}  // namespace

// keys (int64 [n]) or dest_in (int32 [n]) names the destinations; the other
// is null. mask (uint8 [n]) may be null. warps (1-8) sets the tile, warps x
// kWarpRows rows, and the shared memory, (warps + 2) x n_parts int32, at
// most kSharedMax. status holds at least n_parts x n_tiles words of the
// workspace and ticket its counter; ticket_base is the number of tiles
// launched on them before and epoch this call's number, 1 to 2^30 - 1.
// Writes dest and rank (int32 [n]) and counts (int32 [n_parts]). n > 0.
// Returns cudaGetLastError(), or -1 for shared memory past kSharedMax.
extern "C" int exon_bucket_rank(int64_t n, const void* keys,
                                const void* dest_in, const void* mask,
                                int32_t n_parts, int32_t warps, void* status,
                                void* ticket, uint64_t ticket_base,
                                uint64_t epoch, void* dest, void* rank,
                                void* counts, void* stream) {
  const int64_t smem = static_cast<int64_t>(warps + 2) * n_parts * 4;
  if (warps < 1 || warps > kMaxWarps || smem > kSharedMax) return -1;
  static int64_t opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = kSharedMax;
  }
  int group = 32;
  while (group > 1 && warps * 32 / group < n_parts) group >>= 1;
  const int64_t tile_rows = static_cast<int64_t>(warps) * kWarpRows;
  const int64_t n_tiles = (n + tile_rows - 1) / tile_rows;
  bucket_rank_kernel<<<static_cast<unsigned>(n_tiles), warps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int64_t*>(keys),
      static_cast<const int32_t*>(dest_in), static_cast<const uint8_t*>(mask),
      n_parts, group, static_cast<unsigned long long*>(status),
      static_cast<unsigned long long*>(ticket), ticket_base, epoch, n_tiles,
      static_cast<int32_t*>(dest), static_cast<int32_t*>(rank),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// After exon_bucket_rank on the same stream: cols is a host array of
// n_cols x 3 int64, per column its source rows' address, its bucket
// buffer's address ([n_parts, cap] rows, 16-byte aligned) and its row width
// in bytes. Scatters the rows whose rank is below cap and zeroes the empty
// slots. Returns cudaGetLastError(), or -1 for more than kMaxCols columns.
extern "C" int exon_bucket_move(int64_t n, const void* dest, const void* rank,
                                const void* counts, int32_t n_parts,
                                int64_t cap, int32_t n_cols,
                                const int64_t* cols, void* stream) {
  if (n_cols > kMaxCols) return -1;
  if (n_cols == 0 || cap == 0) return 0;
  Move mv{};
  mv.n_cols = n_cols;
  mv.cap = cap;
  int64_t items = 0;
  for (int32_t k = 0; k < n_cols; ++k) {
    const int64_t src = cols[3 * k], dst = cols[3 * k + 1];
    const int64_t rb = cols[3 * k + 2];
    int w = 16;
    while (w > 1 && (rb % w != 0 || src % w != 0 || dst % w != 0)) w >>= 1;
    mv.src[k] = reinterpret_cast<const uint8_t*>(src);
    mv.dst[k] = reinterpret_cast<uint8_t*>(dst);
    mv.row_bytes[k] = rb;
    mv.word[k] = w;
    mv.words[k] = rb / w;
    items += n * mv.words[k];
    mv.end[2 * k] = items;
    items += (n_parts * cap * rb + 15) / 16;
    mv.end[2 * k + 1] = items;
  }
  if (items == 0) return 0;
  const int64_t per_block = kUnroll * kMoveThreads;
  int64_t blocks = (items + per_block - 1) / per_block;
  if (blocks > kMaxMoveBlocks) blocks = kMaxMoveBlocks;
  bucket_move_kernel<<<static_cast<unsigned>(blocks), kMoveThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(rank),
      static_cast<const int32_t*>(counts), n_parts, mv);
  return static_cast<int>(cudaGetLastError());
}
