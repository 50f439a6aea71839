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
// Design of the mirror and word-start modes: one warp per row, warps
// striding over the rows, the table in shared memory. Lane j writes output
// bytes j, j + 32, ... of the row, so stores are neighbouring; with the
// mirror the lanes read neighbouring bytes in descending order. In
// word-start mode (mode 2) the table holds 512 entries, and each lane also
// reads the byte before its own (a neighbour's byte, from L1).
//
// Table mode (exon_map_bytes_table) needs no rows: the offsets are
// monotone, so the bytes of the rows are exactly [offsets[0], offsets[n]),
// and every other byte of the output is 0. One launch reads the two
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
// Widen and narrow (exon_map_bytes_widen, exon_map_bytes_narrow) are K11b's
// byte-to-list maps, with the offsets unchanged, so they run elementwise
// over the flat buffer with no row bounds. Widen replaces exon_tpu/udfs.py
// integer_encode_dna (:106, DNA_CODE[values]), integer_encoding (:340, a
// 256-entry int64 table), quality_score_string_to_list (:115, b - 33) and
// the FASTA encodings of exon_tpu/formats/fasta_device.py:99-104: each
// uint8 byte goes through a 256-entry int64 table in shared memory (2 KB)
// and is stored as int8 (out_width 1) or int64 (out_width 8). Narrow
// replaces quality_score_list_to_string (:122): an int64 score x becomes
// the byte (int32(x) + 33) & 0xFF, the wrap of the JAX casts. Bound: HBM
// bytes, 1 read and 1 or 8 written per element (widen), 8 read and 1
// written (narrow). Design: a grid-stride loop, one element a thread per
// step, neighbouring threads on neighbouring elements.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
static_assert(kThreads == 256, "map_table_kernel loads its table a thread a byte");
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

constexpr int kWordStart = 2;

__device__ __forceinline__ bool alnum(uint8_t c) {
  return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z') ||
         (c >= 'a' && c <= 'z');
}

__global__ void map_bytes_kernel(const uint8_t* __restrict__ values,
                                 const int32_t* __restrict__ offsets,
                                 int64_t n, const uint8_t* __restrict__ table,
                                 int32_t mode, uint8_t* __restrict__ out) {
  __shared__ uint8_t map[512];
  const int entries = mode == kWordStart ? 512 : 256;
  for (int i = threadIdx.x; i < entries; i += kThreads) map[i] = table[i];
  __syncthreads();
  const bool mirror = mode == 1;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t s = offsets[r];
    const int64_t e = offsets[r + 1];
    if (mode == kWordStart) {
      for (int64_t p = s + lane; p < e; p += 32) {
        const bool word_start = p == s || !alnum(values[p - 1]);
        out[p] = map[(word_start ? 256 : 0) + values[p]];
      }
      continue;
    }
    for (int64_t p = s + lane; p < e; p += 32) {
      out[p] = map[values[mirror ? s + (e - 1 - p) : p]];
    }
  }
}

__global__ void widen_kernel(const uint8_t* __restrict__ values, int64_t total,
                             const int64_t* __restrict__ table,
                             int32_t out_width, void* __restrict__ out) {
  __shared__ int64_t map[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) map[i] = table[i];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int8_t* out8 = static_cast<int8_t*>(out);
  int64_t* out64 = static_cast<int64_t*>(out);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const int64_t v = map[values[i]];
    if (out_width == 1) {
      out8[i] = static_cast<int8_t>(v);
    } else {
      out64[i] = v;
    }
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

}  // namespace

extern "C" int exon_map_bytes_widen(const void* values, int64_t total,
                                    const void* table, int32_t out_width,
                                    void* out, void* stream) {
  widen_kernel<<<static_cast<unsigned>(flat_blocks(total)), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), total,
      static_cast<const int64_t*>(table), out_width, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_map_bytes_narrow(const void* values, int64_t total,
                                     void* out, void* stream) {
  narrow_kernel<<<static_cast<unsigned>(flat_blocks(total)), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(values), total, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Table mode over the whole buffer of total bytes: out[p] = table[values[p]]
// for offsets[0] <= p < offsets[n], 0 elsewhere. n may be 0.
extern "C" int exon_map_bytes_table(const void* values, int64_t total,
                                    const void* offsets, int64_t n,
                                    const void* table, void* out,
                                    void* stream) {
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  int64_t head = static_cast<int64_t>((16 - (o & 15)) & 15);
  if (head > total) head = total;
  const int32_t shift = static_cast<int32_t>(
      (reinterpret_cast<uintptr_t>(values) + head) & 15);
  int64_t blocks = flat_blocks((total - head) / 16);
  if (blocks < 1) blocks = 1;
  map_table_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), total,
      static_cast<const int32_t*>(offsets), n,
      static_cast<const uint8_t*>(table), head, shift,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_map_bytes(const void* values, const void* offsets,
                              int64_t n, const void* table, int32_t mode,
                              void* out, void* stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  map_bytes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<const int32_t*>(offsets),
      n, static_cast<const uint8_t*>(table), mode, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
