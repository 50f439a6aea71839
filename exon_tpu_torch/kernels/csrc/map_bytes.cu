// map_bytes: every byte of a var-width column through a 256-entry table,
// each row optionally mirrored, with the offsets unchanged.
//
// Replaces exon_tpu/udfs.py reverse_complement (:87): a per-byte row id
// (ops/layout.py byte_row_ids :27), a mirror index starts + (ends - 1 - pos)
// per byte, a gather of the values at it and a gather through _COMPLEMENT.
// Without the mirror it is the byte map of ops/strings.py upper/lower
// (:44, :48) and of exon_tpu/ops/sqlfuncs.py fn_translate (:430, its table
// gather). In word-start mode it is sqlfuncs.py fn_initcap (:487): a byte
// at a word start (the row's first byte, or one after a byte that is not
// ASCII alphanumeric) maps through a second table (the upper-case fold),
// every other byte through the first (the lower-case fold).
//
// Bound on the H100: HBM bytes, each row's bytes read once and written
// once, plus its offset pair: ~2 bytes per base, a 56 MB chunk of reads in
// ~34 us at 3.35 TB/s.
//
// Every mode is one launch that writes every byte of the output: the rows'
// bytes, and zeros in [0, offsets[0]) and [offsets[n], total). The rows of
// a column cover [offsets[0], offsets[n]) exactly (the offsets are
// monotone), so no zero fill runs beside the kernel. The output buffer is
// the wrapper's own, 16-byte aligned; the values may be a view at any
// offset. Positions are int: the offsets are int32, and the entry point
// refuses a buffer of 2^31 - 16 bytes or more in the row modes.
//
// Table mode (map_table_kernel) needs no rows: one launch reads the two
// offsets from device memory (no host read) and maps the whole buffer in a
// grid-stride loop of 16-byte (uint4) loads and stores, through the
// 256-byte table in shared memory; 16-byte chunks wholly outside the range
// are stored as zeros without a load. Bytes below 128 sit in 32 distinct
// banks, so ASCII text reads the table without bank conflicts. A scalar
// head and tail bring the output to 16-byte alignment; where the values
// are not aligned alike (a view at an odd offset), each thread loads the
// two aligned uint4 that cover its 16 bytes and funnel-shifts them into
// place. Bound: HBM bytes, the buffer read once (its range) and written
// once.
//
// The design before this one ran both row modes as a warp a row and a byte
// a lane, after a zero fill of the whole output (two launches a call).
// Five designs were timed beside it at H's reads and J's descriptions
// (PERF.md, PR 24); these two won, one a mode:
//   Mirror (mirror_kernel): a group of kGroup = 8 lanes a row. The row's
//     aligned 16-byte output words go to its lanes, kGroupWords a lane
//     loaded before any is stored: output bytes p .. p + 15 come from source
//     bytes s + e - 16 - p .. s + e - 1 - p, one 16-byte load (copy16::load16:
//     the two aligned words that cover it, funnel-shifted), reversed by
//     __byte_perm(x, 0, 0x0123) a 32-bit lane and mapped byte by byte
//     through the table in shared memory. The bytes of the row's partial
//     first and last words, which it may share with its neighbours, are
//     stored one by one. Groups stride over the rows. A 150-byte read is
//     one step of 8 lanes: 4 rows a warp in flight, where a warp a row left
//     23 of its lanes idle and a byte a lane moved 5 bytes a step.
//   Word start (word_start_kernel): flat over 16-byte output words, no
//     byte moves. A block takes a tile of kTileWords words a thread (8 KB),
//     each word one 16-byte load at its own place and the byte before it,
//     loaded at the block's start. A byte's word-start bit is its
//     predecessor's non-alphanumeric test (SWAR: 0x80 a byte, on the word
//     shifted up one byte) or'd with the tile's row starts, which the block
//     marks once in a 16-bit mask a word (shared memory, atomicOr): it finds
//     the row of its first byte by a 512-ary search of the offsets (two
//     probes a thread, one round up to ~390,000 rows, issued with the
//     words' loads), then reads the offsets from there, 1,024 a round,
//     until one passes the tile. At J's ~23-byte descriptions a warp a row
//     left most lanes idle.
//   Both write the zeros outside [offsets[0], offsets[n]) in the same
//     launch: the mirror kernel's whole grid first, a word a thread; the
//     word-start kernel as part of its words.
//
// Widen and narrow (exon_map_bytes_widen, exon_map_bytes_narrow) are K11b's
// byte-to-list maps, with the offsets unchanged, so they run elementwise
// over the flat buffer with no row bounds. Widen replaces exon_tpu/udfs.py
// integer_encode_dna (:106, DNA_CODE[values]), integer_encoding (:340, a
// 256-entry int64 table), quality_score_string_to_list (:115, b - 33) and
// the FASTA encodings of exon_tpu/formats/fasta_device.py:99-104: each
// uint8 byte goes through a 256-entry int64 table and is stored as int8
// (out_width 1) or int64 (out_width 8). Narrow replaces
// quality_score_list_to_string (:122): an int64 score x becomes the byte
// (int32(x) + 33) & 0xFF, the wrap of the JAX casts. Bound: HBM bytes, 1
// read and 1 or 8 written per element (widen), 8 read and 1 written
// (narrow).
//   Widen to int8 (widen8_kernel) takes 16 input bytes a thread (load16,
//     odd views funnel-shifted), looks each up in a 256-byte copy of the
//     table's low bytes in shared memory and stores one 16-byte word, two
//     words a thread a pass with both loads before either store; the grid
//     is the blocks resident at once, so the table is staged once a block.
//     The design before this one made a one-byte load and a one-byte store
//     an element through the 2 KB int64 table, with the width a branch in
//     the loop.
//   Widen to int64 (widen64_kernel) and narrow: a grid-stride loop, one
//   element a thread per step, neighbouring threads on neighbouring
//   elements (69-82 % of the bound at O's chunk; two input bytes a thread
//   into one 16-byte store was timed beside it and was no faster).

#include <cstdint>
#include <cuda_runtime.h>

#include "copy16.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(kThreads == 256, "map_table_kernel loads its table a thread a byte");
constexpr int64_t kMaxBlocks = 132 * 64;

constexpr int kTable = 0;
constexpr int kMirror = 1;
constexpr int kWordStart = 2;

constexpr int kGroup = 8;       // lanes a row of mirror_kernel
constexpr int kGroupWords = 2;  // words a lane of mirror_kernel loads a pass
constexpr int kTileWords = 2;   // output words a thread of word_start_kernel
constexpr int kWindow = 3 * kThreads;      // rows a search leaves at most
constexpr int kStartsRound = 4 * kThreads;  // row starts read a round

// 0x80 in each byte of x that lies in [a, b] (a >= 1, b <= 127), by SWAR
// with no carry between bytes: a byte's low 7 bits plus 0x80 - a reach
// 0x80 exactly when they are >= a, plus 0x7f - b exactly when > b.
__device__ __forceinline__ unsigned in_range4(unsigned x, unsigned a,
                                              unsigned b) {
  const unsigned t = x & 0x7f7f7f7fu;
  const unsigned ge = t + 0x01010101u * (0x80u - a);
  const unsigned le = ~(t + 0x01010101u * (0x7fu - b));
  return ge & le & ~x & 0x80808080u;
}

// 0x80 in each byte of x that is ASCII alphanumeric.
__device__ __forceinline__ unsigned alnum4(unsigned x) {
  return in_range4(x, '0', '9') | in_range4(x | 0x20202020u, 'a', 'z');
}

// The 16 bytes of v in reverse order.
__device__ __forceinline__ uint4 reversed(uint4 v) {
  return make_uint4(__byte_perm(v.w, 0, 0x0123), __byte_perm(v.z, 0, 0x0123),
                    __byte_perm(v.y, 0, 0x0123), __byte_perm(v.x, 0, 0x0123));
}

__device__ __forceinline__ unsigned map4(const uint8_t* map, unsigned w) {
  return static_cast<unsigned>(map[w & 0xffu]) |
         static_cast<unsigned>(map[(w >> 8) & 0xffu]) << 8 |
         static_cast<unsigned>(map[(w >> 16) & 0xffu]) << 16 |
         static_cast<unsigned>(map[w >> 24]) << 24;
}

__device__ __forceinline__ uint4 map16(const uint8_t* map, uint4 v) {
  return make_uint4(map4(map, v.x), map4(map, v.y), map4(map, v.z),
                    map4(map, v.w));
}

// Zeros in the words of out (total bytes) outside [lo, hi), a word a thread
// of the grid: the words holding a byte below lo, then those holding one at
// or past hi, each writing only its bytes outside [lo, hi).
__device__ __forceinline__ void zero_outside(int lo, int hi, int total,
                                             uint8_t* __restrict__ out) {
  const int zl = (lo + 15) >> 4;
  const int zh = hi >> 4;
  const int nz = zl + ((total + 15) >> 4) - zh;
  for (int64_t z = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       z < nz; z += static_cast<int64_t>(gridDim.x) * kThreads) {
    const bool below = z < zl;
    const int p = 16 * static_cast<int>(below ? z : zh + z - zl);
    const int from = below ? p : max(p, hi);
    const int to = below ? min(p + 16, lo) : min(p + 16, total);
    if (from == p && to == p + 16) {
      *reinterpret_cast<uint4*>(out + p) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int q = from; q < to; ++q) out[q] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    mirror_kernel(const uint8_t* __restrict__ values, int total,
                  const int32_t* __restrict__ offsets, int64_t n,
                  const uint8_t* __restrict__ table,
                  uint8_t* __restrict__ out) {
  __shared__ uint8_t map[256];
  const uint8_t entry = table[threadIdx.x];
  const int gl = static_cast<int>(threadIdx.x % kGroup);
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (kThreads / kGroup);
  const int64_t group0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
  // the first row's offsets go out with the table's byte
  int s = group0 < n ? offsets[group0] : 0;
  int e = group0 < n ? offsets[group0 + 1] : 0;
  const int lo = offsets[0];
  const int hi = offsets[n];
  map[threadIdx.x] = entry;
  __syncthreads();
  zero_outside(lo, hi, total, out);
  for (int64_t r = group0; r < n; r += groups) {
    if (r != group0) {
      s = offsets[r];
      e = offsets[r + 1];
    }
    // the row's whole aligned words [c0, c1); the bytes around them alone
    const int c0 = min((s + 15) & ~15, e);
    const int c1 = max(e & ~15, c0);
    for (int q = s + gl; q < c0; q += kGroup) {
      out[q] = map[values[s + e - 1 - q]];
    }
    for (int q = c1 + gl; q < e; q += kGroup) {
      out[q] = map[values[s + e - 1 - q]];
    }
    for (int p = c0 + 16 * gl; p < c1; p += 16 * kGroup * kGroupWords) {
      uint4 v[kGroupWords];
#pragma unroll
      for (int u = 0; u < kGroupWords; ++u) {
        const int pu = p + 16 * kGroup * u;
        v[u] = pu < c1 ? copy16::load16(values + (s + e - 16 - pu))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kGroupWords; ++u) {
        const int pu = p + 16 * kGroup * u;
        if (pu < c1) {
          *reinterpret_cast<uint4*>(out + pu) = map16(map, reversed(v[u]));
        }
      }
    }
  }
}

// A window of at most kWindow rows, starting at the returned lo, that
// holds the row of byte q (the first row, where q < offsets[0]), given q <
// offsets[n]: each round probes 512 evenly spaced offsets, two a thread,
// and counts those <= q. Every thread of the block calls it and gets the
// same lo (offsets[lo] <= max(q, offsets[0])).
__device__ __forceinline__ int64_t block_find_window(
    const int32_t* __restrict__ offsets, int64_t n, int64_t q) {
  int64_t lo = 0, hi = n;  // offsets[lo] <= q, the row in [lo, hi)
  while (hi - lo > kWindow) {
    const int64_t step = (hi - lo + 2 * kThreads - 1) / (2 * kThreads);
    const int64_t p0 = lo + static_cast<int64_t>(threadIdx.x) * step;
    const int64_t p1 = p0 + kThreads * step;
    const bool le0 = p0 < hi && offsets[p0] <= q;
    const bool le1 = p1 < hi && offsets[p1] <= q;
    const int le = __syncthreads_count(le0) + __syncthreads_count(le1);
    lo += static_cast<int64_t>(max(le, 1) - 1) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

// The word-start map of the 16 bytes v at p .. p + 15, whose byte before
// is `before`, with a row starting at each p + k of bit k of `starts`;
// bytes k outside [k_lo, k_hi) are 0.
__device__ __forceinline__ uint4 word_start_map(const uint8_t* map, uint4 v,
                                                unsigned before,
                                                unsigned starts, int k_lo,
                                                int k_hi) {
  // 0x80 where the byte before is not alphanumeric
  const unsigned na[4] = {~alnum4(v.x << 8 | before),
                          ~alnum4(__funnelshift_l(v.x, v.y, 8)),
                          ~alnum4(__funnelshift_l(v.y, v.z, 8)),
                          ~alnum4(__funnelshift_l(v.z, v.w, 8))};
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned a[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int sh = 8 * (k & 3);
    const unsigned at = ((na[k >> 2] >> (sh + 7)) | (starts >> k)) & 1u;
    const unsigned m = map[((w[k >> 2] >> sh) & 0xffu) | at << 8];
    if (k >= k_lo && k < k_hi) a[k >> 2] |= m << sh;
  }
  return make_uint4(a[0], a[1], a[2], a[3]);
}

// At most 32 registers a thread (8 blocks an SM), so that J's 853 tiles
// are resident at once.
__global__ void __launch_bounds__(kThreads, 8)
    word_start_kernel(const uint8_t* __restrict__ values, int total,
                      const int32_t* __restrict__ offsets, int64_t n,
                      const uint8_t* __restrict__ table,
                      uint8_t* __restrict__ out) {
  constexpr int kWords = kTileWords * kThreads;
  constexpr int kTile = 16 * kWords;
  constexpr int kRound = kStartsRound / kThreads;
  __shared__ uint8_t map[512];
  // the row starts in each word of the tile (bit k: byte k)
  __shared__ unsigned starts[kWords];
  const int t0 = static_cast<int>(blockIdx.x) * kTile;
  const uint8_t entry[2] = {table[threadIdx.x], table[threadIdx.x + kThreads]};
  uint4 v[kTileWords];
  unsigned before[kTileWords];
#pragma unroll
  for (int j = 0; j < kTileWords; ++j) {
    const int p = t0 + 16 * (threadIdx.x + j * kThreads);
    v[j] = p + 16 <= total ? copy16::load16(values + p)
           : p < total ? copy16::load_bytes(values + p, total - p)
                       : make_uint4(0u, 0u, 0u, 0u);
    before[j] = p > 0 && p < total ? values[p - 1] : 0u;
    starts[threadIdx.x + j * kThreads] = 0u;
  }
  // the window of the tile's first row, searched beside the loads above
  int64_t r0 = block_find_window(offsets, n, t0);
  const int lo = offsets[0];
  const int hi = offsets[n];
  // the tile's bytes in rows: [a, b)
  const int a = max(t0, lo);
  const int b = min(min(t0 + kTile, total), hi);
  __syncthreads();  // the masks cleared
  if (a < b) {
    // the row starts from there on, kStartsRound a round, until one
    // reaches b
    for (;; r0 += kStartsRound) {
      int row_start[kRound];
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int64_t r = r0 + threadIdx.x + u * kThreads;
        row_start[u] = r < n ? offsets[r] : INT32_MAX;
      }
      bool past = false;
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int64_t q = static_cast<int64_t>(row_start[u]) - t0;
        if (q >= 0 && q < kTile) {
          atomicOr(&starts[q >> 4], 1u << (q & 15));
        }
        past |= row_start[u] >= b;
      }
      if (__syncthreads_or(past)) break;
    }
  }
  map[threadIdx.x] = entry[0];
  map[threadIdx.x + kThreads] = entry[1];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTileWords; ++j) {
    const int k = threadIdx.x + j * kThreads;
    const int p = t0 + 16 * k;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (lo < hi && p + 16 > lo && p < hi) {
      w = word_start_map(map, v[j], before[j], starts[k], lo > p ? lo - p : 0,
                         hi < p + 16 ? hi - p : 16);
    }
    if (p + 16 <= total) {
      *reinterpret_cast<uint4*>(out + p) = w;
    } else if (p < total) {
      copy16::store_bytes(out + p, w, total - p);
    }
  }
}

// Widen to int8: out[i] = low byte of table[values[i]], 16 bytes a thread
// a step (kWidenWords words loaded before any is stored), the last
// total % 16 by the first threads of the grid.
constexpr int kWidenWords = 2;

__global__ void __launch_bounds__(kThreads)
    widen8_kernel(const uint8_t* __restrict__ values, int64_t total,
                  const int64_t* __restrict__ table,
                  uint8_t* __restrict__ out) {
  __shared__ uint8_t map[256];
  map[threadIdx.x] = static_cast<uint8_t>(table[threadIdx.x]);
  __syncthreads();
  const int64_t words = total / 16;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  if (gid < total - 16 * words) {
    const int64_t p = 16 * words + gid;
    out[p] = map[values[p]];
  }
  for (int64_t c = gid; c < words; c += kWidenWords * stride) {
    uint4 v[kWidenWords];
#pragma unroll
    for (int u = 0; u < kWidenWords; ++u) {
      const int64_t cu = c + u * stride;
      v[u] = cu < words ? copy16::load16(values + 16 * cu)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kWidenWords; ++u) {
      const int64_t cu = c + u * stride;
      if (cu < words) {
        *reinterpret_cast<uint4*>(out + 16 * cu) =
            make_uint4(map4(map, v[u].x), map4(map, v[u].y),
                       map4(map, v[u].z), map4(map, v[u].w));
      }
    }
  }
}

__global__ void widen64_kernel(const uint8_t* __restrict__ values,
                               int64_t total,
                               const int64_t* __restrict__ table,
                               int64_t* __restrict__ out) {
  __shared__ int64_t map[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) map[i] = table[i];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    out[i] = map[values[i]];
  }
}

__global__ void narrow_kernel(const int64_t* __restrict__ values,
                              int64_t total, uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    // int64 -> int32 keeps the low word, as the JAX astype does
    const uint32_t low = static_cast<uint32_t>(values[i]);
    out[i] = static_cast<uint8_t>((low + 33u) & 0xFFu);
  }
}

// Bytes shift .. shift + 15 of the 32 in a (little-endian words), shift =
// 4 * Q + r8 / 8.
template <int Q>
__device__ __forceinline__ uint4 funnel(const unsigned (&a)[8], unsigned r8) {
  return make_uint4(__funnelshift_r(a[Q], a[Q + 1], r8),
                    __funnelshift_r(a[Q + 1], a[Q + 2], r8),
                    __funnelshift_r(a[Q + 2], a[Q + 3], r8),
                    __funnelshift_r(a[Q + 3], a[Q + 4], r8));
}

// The 16 values bytes from p, where values + p lies shift bytes past a
// 16-byte boundary; only aligned words that hold a byte below total are
// read.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ values,
                                        int64_t total, int64_t p, int shift) {
  if (shift == 0) return *reinterpret_cast<const uint4*>(values + p);
  const uint4* base = reinterpret_cast<const uint4*>(values + p - shift);
  const uint4 lo = base[0];
  const uint4 hi = p - shift + 16 < total ? base[1] : make_uint4(0, 0, 0, 0);
  const unsigned a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const unsigned r8 = 8u * (shift & 3);
  switch (shift >> 2) {
    case 0: return funnel<0>(a, r8);
    case 1: return funnel<1>(a, r8);
    case 2: return funnel<2>(a, r8);
    default: return funnel<3>(a, r8);
  }
}

__device__ __forceinline__ unsigned map_word(const uint8_t* map, unsigned w,
                                             int64_t p, int64_t lo,
                                             int64_t hi, bool whole) {
  unsigned r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (whole || (p + k >= lo && p + k < hi)) {
      r |= static_cast<unsigned>(map[(w >> (8 * k)) & 0xffu]) << (8 * k);
    }
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
map_table_kernel(const uint8_t* __restrict__ values, int64_t total,
                 const int32_t* __restrict__ offsets, int64_t n,
                 const uint8_t* __restrict__ table, int64_t head,
                 int32_t shift, uint8_t* __restrict__ out) {
  __shared__ uint8_t map[256];
  map[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const int64_t lo = offsets[0];
  const int64_t hi = offsets[n];
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t chunks = (total - head) / 16;
  const int64_t tail = head + 16 * chunks;
  // the scalar head and tail, each under 16 bytes
  if (gid < head) out[gid] = gid >= lo && gid < hi ? map[values[gid]] : 0;
  if (gid < total - tail) {
    const int64_t p = tail + gid;
    out[p] = p >= lo && p < hi ? map[values[p]] : 0;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t c = gid; c < chunks; c += stride) {
    const int64_t p = head + 16 * c;
    uint4 r = make_uint4(0, 0, 0, 0);
    if (p + 16 > lo && p < hi) {
      const uint4 v = load16(values, total, p, shift);
      const bool whole = p >= lo && p + 16 <= hi;
      r.x = map_word(map, v.x, p, lo, hi, whole);
      r.y = map_word(map, v.y, p + 4, lo, hi, whole);
      r.z = map_word(map, v.z, p + 8, lo, hi, whole);
      r.w = map_word(map, v.w, p + 12, lo, hi, whole);
    }
    *reinterpret_cast<uint4*>(out + p) = r;
  }
}

int64_t flat_blocks(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// The blocks of widen8_kernel resident at once on the card.
int64_t widen8_blocks() {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, widen8_kernel,
                                                  kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  return static_cast<int64_t>(sm_count()) * per_sm;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// values uint8 [total] (total > 0, any alignment); table int64 [256]; out
// [total] of out_width bytes an element (1: int8, 8: int64), 16-byte
// aligned.
extern "C" int exon_map_bytes_widen(const void* values, int64_t total,
                                    const void* table, int32_t out_width,
                                    void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(values);
  const int64_t* t = static_cast<const int64_t*>(table);
  if (!aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (out_width == 1) {
    int64_t blocks = (total / 16 + kThreads - 1) / kThreads;
    const int64_t cap = widen8_blocks();
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    widen8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        v, total, t, static_cast<uint8_t*>(out));
  } else if (out_width == 8) {
    widen64_kernel<<<static_cast<unsigned>(flat_blocks(total)), kThreads, 0,
                     s>>>(v, total, t, static_cast<int64_t*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_map_bytes_narrow(const void* values, int64_t total,
                                     void* out, void* stream) {
  narrow_kernel<<<static_cast<unsigned>(flat_blocks(total)), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(values), total, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Every mode over the whole buffer of total bytes (total > 0): the rows'
// bytes of [offsets[0], offsets[n]) mapped (table 0, mirror 1, word start
// 2, whose table has 512 entries), 0 elsewhere. n may be 0; out is
// 16-byte aligned.
extern "C" int exon_map_bytes(const void* values, int64_t total,
                              const void* offsets, int64_t n,
                              const void* table, int32_t mode, void* out,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(values);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  const uint8_t* t = static_cast<const uint8_t*>(table);
  uint8_t* d = static_cast<uint8_t*>(out);
  if (!aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (mode == kTable) {
    const int32_t shift =
        static_cast<int32_t>(reinterpret_cast<uintptr_t>(values) & 15);
    int64_t blocks = flat_blocks(total / 16);
    if (blocks < 1) blocks = 1;
    map_table_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        v, total, o, n, t, 0, shift, d);
    return static_cast<int>(cudaGetLastError());
  }
  if (total > INT32_MAX - 16 * kTileWords * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tt = static_cast<int>(total);
  if (mode == kMirror) {
    int64_t blocks = (n + kThreads / kGroup - 1) / (kThreads / kGroup);
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    mirror_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        v, tt, o, n, t, d);
  } else if (mode == kWordStart) {
    constexpr int kTile = 16 * kTileWords * kThreads;
    word_start_kernel<<<static_cast<unsigned>((tt + kTile - 1) / kTile),
                        kThreads, 0, s>>>(v, tt, o, n, t, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
