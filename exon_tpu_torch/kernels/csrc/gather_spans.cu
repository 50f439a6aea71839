// gather_spans: copy byte spans of a chunk to their output offsets, dropping
// up to two byte values.
//
// Replaces exon_tpu/ops/device_text.py compact (:57), as
// formats/fasta_device.py _phase2 (:107-120) and formats/fastq.py
// _device_decode (:123-142) use it: a cumsum over a per-byte keep mask and a
// scatter of every byte of the chunk, once per output column. Here only the
// bytes of the wanted spans are read, and each output byte is written once.
//
// Span r is src[starts[r], stops[r]); its kept bytes (those equal to neither
// drop_a nor drop_b: '\r' for every column, and '>' too for FASTA names;
// -1 drops nothing, as trim_polya's prefixes need) go to out[dst[r] ...].
// The wrapper computes dst as an exclusive scan (torch.cumsum) of the kept
// lengths that text_records counted, so dst ascends; starts need not, and
// spans may overlap.
//
// Bound on the H100: HBM bytes, the span bytes read and written once plus
// 12 bytes of span table per span: A's first chunk's sequence column
// (2,413,189 spans, 118,130,216 B) moves 265 MB, 0.079 ms at 3.35 TB/s.
//
// Design: the output in 16-byte words, tiled by 1 KB (two words a lane of a
// warp), after a memset and a marks pass: each span marks the first tile whose
// first byte lies in it (one store a span, however long), and a tile left
// unmarked starts in the span that holds the tile before it whole. The copy
// runs warps, not blocks, over tiles: each warp takes a run of consecutive
// tiles with no barrier across warps (so no warp waits for another's loads),
// carries the spans of the next tile's first byte from tile to tile (so only a
// run's first tile may search dst), and copies the next tile's span entries
// into shared memory ahead of time (cp.async). For a tile it stages its spans
// in the warp's own shared memory, a span a lane, classified: a span is plain
// when no dropped byte lies inside it, that is, when its length equals its
// kept length (dst[r + 1] - dst[r], or total - dst[m - 1]) once up to kTrim
// dropped bytes are trimmed from either end (the CRLF line's '\r', a name's
// leading '>'); then output byte o maps to src[start' + o - dst[r]]. Each lane
// finds its word's span by a binary search of the staged offsets; a word
// inside one plain span is two aligned 16-byte loads funnel-shifted into one
// 16-byte store (copy16.cuh's load16, any source alignment), a word across one
// span edge the same with a second run joined by a byte mask, on one path so
// the lanes stay together; other words (spans under 16 bytes, the output's
// end) take their runs one by one. A span with a dropped byte inside it (rare:
// a stray '\r', a '>' inside a name) is masked: only a tile that holds one
// places its kept bytes in the warp's shared memory by ballot and rank (16
// source bytes a lane, a warp scan of the counts) before its words are stored,
// and a word's masked runs are read from there. A tile of more than kStage
// spans (substr's short spans, a FASTA of tiny records) reads its spans in
// place. The kernels allocate nothing (the wrapper passes the marks) and do
// not synchronise.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "copy16.cuh"

namespace {

using namespace copy16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneWords = 2;  // words a lane of a tile
constexpr int kTileBytes = 16 * 32 * kLaneWords;  // a warp's tile
constexpr int kStage = 128;  // spans a warp stages; past it, read in place
constexpr int kTrim = 4;     // dropped bytes trimmed at either end of a span
constexpr int kBlocksPerSm = 6;  // 40 registers, none spilled

struct Drops {
  int32_t a, b;
  __device__ __forceinline__ bool has(int32_t x) const {
    return x == a || x == b;
  }
};

// A span's output bytes [d, e) and, when it is plain, the source byte of
// its first output byte (s); s = -1 for a masked span.
struct Span {
  int d, e, s;
  __device__ __forceinline__ bool masked() const { return s < 0 && e > d; }
};

struct Table {
  const uint8_t* src;
  int n_src;
  const int32_t* starts;
  const int32_t* stops;
  const int32_t* dst;
  int m, total;
  Drops drops;

  __device__ __forceinline__ int end(int r) const {
    return r + 1 < m ? dst[r + 1] : total;
  }

  // [lo, hi) with output [d, e) classified: plain once up to kTrim dropped
  // bytes are trimmed from either end and its length equals its kept
  // length, else masked
  __device__ __forceinline__ Span classify(int d, int e, int lo,
                                           int hi) const {
    const int kept = e - d;
#pragma unroll 1
    for (int k = 0; k < kTrim && hi - lo > kept && drops.has(src[lo]); ++k) {
      ++lo;
    }
#pragma unroll 1
    for (int k = 0; k < kTrim && hi - lo > kept && drops.has(src[hi - 1]);
         ++k) {
      --hi;
    }
    return Span{d, e, hi - lo == kept ? lo : -1};
  }

  __device__ __forceinline__ Span span(int r) const {
    return classify(dst[r], end(r), starts[r], stops[r]);
  }
};

// A tile's spans r0 + [0, rows) as staged in a warp's shared memory: dst
// (and dst[rows], the end of the last) and the plain start or -1.
struct Staged {
  const int32_t* dst;
  const int32_t* src;
  int rows;
  __device__ __forceinline__ int find(int from, int p) const {
    return from + find_row(dst + from, rows - from, p);
  }
  // the span holding byte o, given span i ends at o <= the tile's last
  __device__ __forceinline__ int next(int i, int o) const {
    return dst[i + 2] > o ? i + 1 : find(i + 1, o);
  }
  __device__ __forceinline__ Span span(int i) const {
    return Span{dst[i], dst[i + 1], src[i]};
  }
};

// The same spans read in place (a tile of more than kStage spans).
struct InPlace {
  const Table& t;
  int r0, rows;
  __device__ __forceinline__ int find(int from, int p) const {
    return from + find_row(t.dst + r0 + from, rows - from, p);
  }
  __device__ __forceinline__ int next(int i, int o) const {
    return find(i + 1, o);
  }
  __device__ __forceinline__ Span span(int i) const { return t.span(r0 + i); }
};

// Masked span r's kept bytes that fall in the tile [first, last], placed in
// buf (the tile's bytes) by one warp: 16 source bytes a lane, a keep mask
// and its popc, a warp scan of the counts for each byte's rank in the span.
__device__ __forceinline__ void place_masked(const Table& t, int r, int first,
                                             int last, uint8_t* buf,
                                             int lane) {
  const int d = t.dst[r];
  const int ka = max(first, d) - d;  // ranks in the span wanted here
  const int kb = min(last + 1, t.end(r)) - d;
  const int hi = t.stops[r];
  int rank = 0;
  for (int q = t.starts[r]; q < hi && rank < kb; q += 32 * 16) {
    const int b0 = q + 16 * lane;
    unsigned w[4] = {0, 0, 0, 0};
    unsigned keep = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (b0 + j < hi) {
        const unsigned x = t.src[b0 + j];
        w[j >> 2] |= x << (8 * (j & 3));
        if (!t.drops.has(static_cast<int32_t>(x))) keep |= 1u << j;
      }
    }
    const int cnt = __popc(keep);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    int k = rank + incl - cnt;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if ((keep >> j) & 1u) {
        if (k >= ka && k < kb) {
          buf[d + k - first] = static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3)));
        }
        ++k;
      }
    }
    rank += __shfl_sync(kFull, incl, 31);
  }
}

// The word at p (n <= 16 bytes, all in the tile), span i holding byte p.
// Inside one plain span: one load16 and one store; across one edge of two
// plain spans: two load16 joined by a byte mask, the second loaded from k1
// bytes before its start so that both line up with the output; else run by
// run, each run the rest of its span or of the word, from the source (a
// plain span) or from buf (a masked one); a partial word bytewise.
template <class Spans>
__device__ __forceinline__ void copy_word(const Table& t, const Spans& spans,
                                          int i, int p, int n, int first,
                                          const uint4* buf,
                                          uint8_t* __restrict__ out) {
  Span a = spans.span(i);
  {  // one path for both fast cases, so the lanes of a warp stay together
    const int k1 = min(16, a.e - p);
    const Span b =
        n == 16 && k1 < 16 ? spans.span(spans.next(i, p + k1)) : a;
    const int s1 = a.s + (p - a.d);
    const int s2 = k1 < 16 ? b.s + (p + k1 - b.d) - k1 : s1;
    if (n == 16 && a.s >= 0 && b.s >= 0 && s1 <= t.n_src - 16 && s2 >= 0 &&
        s2 <= t.n_src - 16 && (k1 == 16 || b.e - (p + k1) >= 16 - k1)) {
      const uint4 v1 = load16(t.src + s1);
      const uint4 v2 = k1 < 16 ? load16(t.src + s2) : v1;
      *reinterpret_cast<uint4*>(out + p) = join(v1, v2, k1);
      return;
    }
  }
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int filled = 0; filled < n;) {
    const int o = p + filled;
    if (o >= a.e) {  // the next span holding a byte (past empty ones)
      i = spans.find(i + 1, o);
      a = spans.span(i);
    }
    const int k = min(n - filled, a.e - o);
    uint4 w;
    if (a.s >= 0) {
      w = place(load_run(t.src, t.n_src, a.s + (o - a.d), k), k, filled);
    } else {  // the masked bytes [filled, filled + k) of the tile's word
      const uint4 b = buf[(p - first) >> 4];
      const uint4 hi = low_bytes(filled + k), lo = low_bytes(filled);
      w = make_uint4(b.x & hi.x & ~lo.x, b.y & hi.y & ~lo.y,
                     b.z & hi.z & ~lo.z, b.w & hi.w & ~lo.w);
    }
    acc = make_uint4(acc.x | w.x, acc.y | w.y, acc.z | w.z, acc.w | w.w);
    filled += k;
  }
  if (n == 16) {
    *reinterpret_cast<uint4*>(out + p) = acc;
  } else {
    store_bytes(out + p, acc, n);
  }
}

// A lane's words of a tile: word w at first + 16 * (lane + 32 * w).
template <class Spans>
__device__ __forceinline__ void copy_lane(const Table& t, const Spans& spans,
                                          int first, int last,
                                          const uint4* buf,
                                          uint8_t* __restrict__ out,
                                          int lane) {
#pragma unroll
  for (int w = 0; w < kLaneWords; ++w) {
    const int p = first + 16 * (lane + 32 * w);
    if (p <= last) {
      copy_word(t, spans, spans.find(0, p), p, min(16, last + 1 - p), first,
                buf, out);
    }
  }
}

// The masked spans among a tile's, in groups of 32: each lane checks one,
// and the warp places the kept bytes of each that is masked in buf.
template <class Spans>
__device__ __forceinline__ void place_all_masked(const Table& t,
                                                 const Spans& spans, int r0,
                                                 int first, int last,
                                                 uint8_t* buf, int lane) {
  for (int base = 0; base < spans.rows; base += 32) {
    const bool mine = base + lane < spans.rows &&
                      spans.span(base + lane).masked();
    for (unsigned todo = __ballot_sync(kFull, mine); todo; todo &= todo - 1) {
      place_masked(t, r0 + base + __ffs(todo) - 1, first, last, buf, lane);
    }
  }
}

// The table entries (dst, end, start, stop) of spans ra + lane for a tile of
// spans ra .. rb, copied into raw[4][32] asynchronously (cp.async) when the
// tile has 32 spans or fewer; one commit a call, whatever it copies.
__device__ __forceinline__ void prefetch(const Table& t, int32_t (*raw)[32],
                                         int ra, int rb, int lane) {
  const int r = ra + lane;
  if (rb - ra < 32 && r <= rb) {
    __pipeline_memcpy_async(&raw[0][lane], t.dst + r, 4);
    if (r + 1 < t.m) {
      __pipeline_memcpy_async(&raw[1][lane], t.dst + r + 1, 4);
    } else {
      raw[1][lane] = t.total;
    }
    __pipeline_memcpy_async(&raw[2][lane], t.starts + r, 4);
    __pipeline_memcpy_async(&raw[3][lane], t.stops + r, 4);
  }
  __pipeline_commit();
}

// Marks the first tile whose first byte lies in each span (at most one a
// span, so a span of any length costs one store), and in marks[n_tiles]
// the span holding the output's last byte. marks holds -1 elsewhere (the
// wrapper's memset): such a tile starts inside the span that holds the
// tile before it whole, the last span of that tile.
__global__ void __launch_bounds__(kThreads)
gather_spans_marks_kernel(Table t, int32_t* __restrict__ marks,
                          int n_tiles) {
  const int stride = gridDim.x * kThreads;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < t.m; r += stride) {
    const int d = t.dst[r], e = t.end(r);
    if (e <= d) continue;
    const int b = (d + kTileBytes - 1) / kTileBytes;
    if (b * kTileBytes < e) marks[b] = r;
    if (e == t.total) marks[n_tiles] = r;
  }
}

// A warp takes a run of consecutive tiles, with no barrier across warps.
// For each it stages the tile's spans in its own shared memory (classified,
// a span a lane; the entries loaded one tile ahead when 32 or fewer),
// places any masked span's bytes, and stores a word a lane.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gather_spans_kernel(Table t, const int32_t* __restrict__ marks, int n_tiles,
                    uint8_t* __restrict__ out) {
  __shared__ int32_t staged_dst[kWarps][kStage + 1];
  __shared__ int32_t staged_src[kWarps][kStage];
  __shared__ uint4 buf[kWarps][kTileBytes / 16];  // the masked spans' bytes
  __shared__ int32_t raw[kWarps][2][4][32];  // entries loaded a tile ahead
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = gridDim.x * kWarps;
  const int per = (n_tiles + n_warps - 1) / n_warps;
  const int begin = (blockIdx.x * kWarps + warp) * per;
  const int end = min(begin + per, n_tiles);
  if (begin >= end) return;
  int32_t* sdst = staged_dst[warp];
  int32_t* ssrc = staged_src[warp];
  uint8_t* bytes = reinterpret_cast<uint8_t*>(buf[warp]);
  // r0, r1: the spans of this tile's first and last byte (r1 the next
  // tile's first span, which may be one past; an unmarked tile starts in
  // the last span of the tile before, which holds that tile whole); r2 the
  // next tile's r1. Only a run's first tile may need a search.
  int r0 = marks[begin];
  if (r0 < 0) {
    r0 = static_cast<int>(warp_find_row(
        t.dst, t.m, static_cast<int64_t>(begin) * kTileBytes, lane));
  }
  int r1 = max(marks[begin + 1], r0);
  int r2 = begin + 1 < end ? max(marks[begin + 2], r1) : r1;
  prefetch(t, raw[warp][0], r0, r1, lane);
  for (int tile = begin; tile < end; ++tile) {
    // the next tile's entries and the mark after, loaded ahead
    const int (*cur)[32] = raw[warp][(tile - begin) & 1];
    prefetch(t, raw[warp][(tile - begin + 1) & 1], tile + 1 < end ? r1 : 0,
             tile + 1 < end ? r2 : -1, lane);
    const int r3 = tile + 2 < end ? max(marks[tile + 3], r2) : r2;
    __pipeline_wait_prior(1);
    const int first = tile * kTileBytes;
    const int last = min(first + kTileBytes, t.total) - 1;
    const int rows = r1 - r0 + 1;
    if (rows <= kStage) {
      bool masked = false;
      for (int base = 0; base < rows; base += 32) {
        const int i = base + lane;
        if (i < rows) {
          const Span sp = rows <= 32 ? t.classify(cur[0][i], cur[1][i],
                                                  cur[2][i], cur[3][i])
                                     : t.span(r0 + i);
          sdst[i] = sp.d;
          ssrc[i] = sp.s;
          if (i == rows - 1) sdst[rows] = sp.e;
          masked |= sp.masked();
        }
      }
      __syncwarp();
      const Staged spans{sdst, ssrc, rows};
      if (__any_sync(kFull, masked)) {
        place_all_masked(t, spans, r0, first, last, bytes, lane);
        __syncwarp();
      }
      copy_lane(t, spans, first, last, buf[warp], out, lane);
    } else {
      const InPlace spans{t, r0, rows};
      place_all_masked(t, spans, r0, first, last, bytes, lane);
      __syncwarp();
      copy_lane(t, spans, first, last, buf[warp], out, lane);
    }
    __syncwarp();  // the stage and buf are free for the next tile
    r0 = r1;
    r1 = r2;
    r2 = r3;
  }
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

}  // namespace

// src uint8 [n_src] (n_src < 2^31); starts, stops and dst int32 [m] (m >
// 0), dst the exclusive scan of the spans' kept lengths; total (> 0, <
// 2^31) kept bytes into out, 16-byte aligned. drop_a and drop_b are byte
// values (-1: none). marks is int32 scratch of ceil(total / 1024) + 1
// words. A memset of the marks and two launches: the marks, the copy.
extern "C" int exon_gather_spans(const void* src, int64_t n_src,
                                 const void* starts, const void* stops,
                                 const void* dst, int64_t m, int64_t total,
                                 int32_t drop_a, int32_t drop_b, void* marks,
                                 void* out, void* stream) {
  const Table t{static_cast<const uint8_t*>(src), static_cast<int>(n_src),
                static_cast<const int32_t*>(starts),
                static_cast<const int32_t*>(stops),
                static_cast<const int32_t*>(dst), static_cast<int>(m),
                static_cast<int>(total), Drops{drop_a, drop_b}};
  const int n_tiles = static_cast<int>((total + kTileBytes - 1) / kTileBytes);
  auto* st = static_cast<cudaStream_t>(stream);
  auto* mk = static_cast<int32_t*>(marks);
  const int64_t mark_blocks = min((m + kThreads - 1) / kThreads,
                                  static_cast<int64_t>(sm_count()) * 16);
  cudaMemsetAsync(mk, 0xff, sizeof(int32_t) * (n_tiles + 1), st);
  gather_spans_marks_kernel<<<static_cast<unsigned>(mark_blocks), kThreads,
                              0, st>>>(t, mk, n_tiles);
  const int blocks = min((n_tiles + kWarps - 1) / kWarps,
                         sm_count() * kBlocksPerSm);
  gather_spans_kernel<<<blocks, kThreads, 0, st>>>(
      t, mk, n_tiles, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
