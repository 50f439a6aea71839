// text_records: the per-line structure of a FASTA or FASTQ chunk.
//
// Replaces exon_tpu/ops/device_text.py record_structure (:92) and
// first_match_in_segment (:115), and the per-byte keep masks and
// segment_lengths (:78) of formats/fasta_device.py _phase1/_phase2 (:59,
// :85) and formats/fastq.py _device_decode (:102). The JAX version derives a
// record id, a "inside a header line" flag and a first-space position for
// every byte with cumsum and cummax passes; here a lane takes one line (a
// warp or warps, a long one) and writes a few numbers for it.
//
// Inputs: the chunk (n bytes), nl[k], the positions of its newlines (from
// line_index), and the line count L (k, or k + 1 when the chunk does not end
// in '\n'). Line i holds [start, end): start = i ? nl[i-1] + 1 : 0,
// end = i < k ? nl[i] : n. Per line the kernels write
//   start[i], end[i]   the line without its '\n';
//   is_hdr[i]          FASTA: the line starts with '>'; FASTQ: i % 4 == 0;
//   body[i]            0 for a header line, else its bytes that are not '\r';
// and, when want_hdr (0 on other lines):
//   split[i]           the first ' ' in [start + 1, end), or end;
//   name_len[i]        bytes of [start + 1, split) that are neither '\r' nor
//                      name_drop ('>' for FASTA, as the JAX name mask drops
//                      every '>'; '\r' for FASTQ);
//   desc_len[i]        bytes of [split + 1, end) that are not '\r'.
// *bad counts the FASTQ header lines whose first byte is not '@'.
//
// Bound on the H100: HBM bytes. Every chunk byte is read once (to count
// '\r'; without want_hdr a header line's first byte only) plus 4 bytes per
// newline, and 13 (or 25 with want_hdr) bytes are written per line: a
// 128 MiB chunk of 55-byte lines moves about 0.2 GB, some 61 us at
// 3.35 TB/s.
//
// Design: two launches, no allocation, no sync.
//   text_lines_kernel gives a warp 32 neighbouring lines, lane l line l:
//     each lane loads its line's span (two coalesced loads a warp), reads
//     the line's bytes in rounds of aligned 16-byte words, kWords = 2 a
//     round, and writes its outputs (coalesced stores). Each word is first
//     tested for a '\r' with the exact zero-byte test of three operations
//     a 32-bit lane; only a word that holds one makes its 16-bit mask
//     (bytes16.cuh eq16), clipped to the line's span. (Groups of 4-32 lanes
//     a line, each lane of a group repeating the line's bookkeeping, were
//     slower at every shape measured, PERF.md section 6.) A FASTA line's
//     first byte comes from its first word, so the '>' costs no load of its
//     own; a FASTQ header is known by its number. A header line is read by
//     its own lane a word at a time: the first word with a space bit gives
//     split, and the '\r' and name-drop masks count into the name before
//     it and the description after it. Only the chunk's last word, when
//     partial, is read byte by byte. Without want_hdr a header line reads
//     its first byte only.
//   A body line longer than kLongAt = 512 bytes is not read there: its
//     warp records its 16 KB pieces (the aligned 16 KB blocks of the chunk
//     it touches), a lane a piece, in a list the wrapper sizes at n / 16384 + 2 n / kLongAt + 2
//     entries, which the pieces cannot overflow, and its body starts as its
//     span. A header line past kLongAt bytes (rare in FASTA and FASTQ) is
//     read by its whole warp, 32 words at a time, in order, since split
//     orders its counts.
//   text_long_lines_kernel, a fixed grid, gives each recorded piece to a
//     whole warp, which counts its '\r' in 16-byte words, four loads a lane
//     in flight, and subtracts the count from the line's body with one
//     atomicAdd. So no thread scans a long line alone, and a chunk that is
//     one unwrapped chromosome is read by every warp of the grid. The same
//     launch writes *bad. Whether there are pieces is read on the device.
// The piece count and the bad-header count are two status words of the
// look-back workspace (lookback.cuh; kernels/_lookback.py), in its format:
// a word tagged with an older call's epoch reads as 0, so neither needs a
// clearing launch. Adding to one first lifts it to this call's epoch
// (atomicMax), then adds (atomicAdd). The wrapper passes a 16-byte-aligned
// chunk and null pointers for split/name_len/desc_len without want_hdr.

#include <cstdint>
#include <cuda_runtime.h>

#include "bytes16.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLongBlocks = 132 * 4;  // text_long_lines_kernel's grid
constexpr int kPiece = 16384;         // bytes of the chunk a piece spans
constexpr int kLoads = 4;             // words a lane loads at once there
constexpr int kWords = 2;             // words a lane a round of a line
constexpr int kLongAt = 512;          // bytes past which a line is long
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kCR4 = 0x0d0d0d0du;  // '\r' in every byte of a lane
constexpr unsigned kSpace4 = 0x20202020u;
// the status words of a call: pieces recorded, bad FASTQ headers
constexpr int kPiecesWord = 0;
constexpr int kBadWord = 1;

// The count before adding k to status word `at`, which first becomes this
// call's (a word of an older epoch counts 0).
__device__ __forceinline__ unsigned add_to_word(unsigned long long* status,
                                                int at,
                                                unsigned long long epoch,
                                                unsigned k) {
  atomicMax(status + at, lookback::word(epoch, lookback::kAggregate, 0));
  return static_cast<unsigned>(atomicAdd(status + at,
                                         static_cast<unsigned long long>(k)) &
                               0xffffffffull);
}

// The aligned 16-byte word at base (a multiple of 16, below n); the chunk's
// partial last word byte by byte, zero past n.
__device__ __forceinline__ uint4 load_word(const uint8_t* __restrict__ src,
                                           int base, int n) {
  if (static_cast<unsigned>(base) + 16u <= static_cast<unsigned>(n)) {
    return *reinterpret_cast<const uint4*>(src + base);
  }
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (base + b < n) {
      v[b >> 2] |= static_cast<unsigned>(src[base + b]) << (8 * (b & 3));
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Whether some byte of w equals rep's byte (rep in every byte): the exact
// zero-byte test of w ^ rep, three operations a 32-bit lane, which the
// common word (no '\r', no space) passes without making its bit mask.
__device__ __forceinline__ bool any_byte(const uint4& w, unsigned rep) {
  const unsigned v[4] = {w.x ^ rep, w.y ^ rep, w.z ^ rep, w.w ^ rep};
  unsigned t = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) t |= (v[j] - 0x01010101u) & ~v[j];
  return (t & 0x80808080u) != 0u;
}

// The 16-bit mask of w's bytes equal to rep's byte, or 0 when the fast test
// finds none.
__device__ __forceinline__ unsigned mask_of(const uint4& w, unsigned rep) {
  return any_byte(w, rep) ? bytes16::eq16(w, rep) : 0u;
}

// One bit a byte of [base, base + 16) that lies in [lo, hi).
__device__ __forceinline__ unsigned span16(int base, int lo, int hi) {
  const int a = min(max(lo - base, 0), 16);
  const int z = min(max(hi - base, 0), 16);
  return ((1u << z) - 1u) & ~((1u << a) - 1u);
}

// The bits of a word's byte positions below / above position rel of it.
__device__ __forceinline__ unsigned below(int rel) {
  return rel <= 0 ? 0u : (rel >= 16 ? 0xffffu : (1u << rel) - 1u);
}
__device__ __forceinline__ unsigned above(int rel) {
  return rel < 0 ? 0xffffu : (rel >= 15 ? 0u : (0xffffu << (rel + 1)) &
                                                  0xffffu);
}

// The byte at position at (0-15) of a word.
__device__ __forceinline__ int byte_of(const uint4& w, int at) {
  const unsigned v = at < 8 ? (at < 4 ? w.x : w.y) : (at < 12 ? w.z : w.w);
  return static_cast<int>((v >> (8 * (at & 3))) & 0xffu);
}

struct Out {
  int32_t* start;
  int32_t* end;
  uint8_t* is_hdr;
  int32_t* body;
  int32_t* split;  // null without want_hdr, as name_len and desc_len
  int32_t* name_len;
  int32_t* desc_len;
  int2* pieces;
};

// A header line's counts as its lane, or its warp, reads the words of
// [lo, e) in order: split, and the bytes kept in the name and the
// description.
struct Counts {
  int lo, e, split;
  int count;  // the name's
  int desc;
  bool found;
};

// A word of a header line: before the first space its bytes that are
// neither '\r' nor the name-drop byte count into the name, after it those
// that are not '\r' into the description; the warp's ballot finds the
// first space. Every lane of the warp calls it.
__device__ __forceinline__ void header_word(const uint4& word, int w,
                                            int last, unsigned drop_rep,
                                            Counts& c) {
  const int base = w << 4;
  const unsigned in = w <= last ? span16(base, c.lo, c.e) : 0u;
  const unsigned cr = in != 0u ? mask_of(word, kCR4) & in : 0u;
  if (c.found) {
    c.desc += __popc(in & ~cr);
    return;
  }
  const unsigned sp = in != 0u ? mask_of(word, kSpace4) & in : 0u;
  const unsigned drop =
      drop_rep == kCR4 ? cr : (in != 0u ? mask_of(word, drop_rep) & in : 0u);
  const unsigned name_keep = in & ~cr & ~drop;
  const unsigned lanes = __ballot_sync(kFull, sp != 0u);
  if (lanes == 0u) {
    c.count += __popc(name_keep);
    return;
  }
  // the first space: the lowest bit of the lowest lane that has one
  c.split = __shfl_sync(kFull, base + __ffs(static_cast<int>(sp)) - 1,
                        __ffs(static_cast<int>(lanes)) - 1);
  c.found = true;
  c.count += __popc(name_keep & below(c.split - base));
  c.desc += __popc(in & ~cr & above(c.split - base));
}

// A line's span [s, e), empty past the last line.
struct Span {
  int s, e;
};

__device__ __forceinline__ Span span_of(const int32_t* __restrict__ nl,
                                        int64_t i, int k, int n,
                                        int n_lines) {
  if (i >= n_lines) return Span{0, 0};
  return Span{i > 0 ? nl[i - 1] + 1 : 0, i < k ? nl[i] : n};
}

struct Lines {
  const uint8_t* src;
  const int32_t* nl;
  int n, k, n_lines;
  int fastq;
  unsigned drop_rep;
};

// A long body line's 16 KB pieces, recorded by the whole warp for
// text_long_lines_kernel: lane 0 takes their places in the list, each lane
// writes every 32nd.
__device__ __forceinline__ void record_pieces(int i, int s, int e, int lane,
                                              const Out& out,
                                              unsigned long long* status,
                                              unsigned long long epoch) {
  const int p0 = s / kPiece;
  const int np = (e - 1) / kPiece - p0 + 1;
  int at = 0;
  if (lane == 0) {
    at = static_cast<int>(add_to_word(status, kPiecesWord, epoch, np));
  }
  at = __shfl_sync(kFull, at, 0);
  for (int p = lane; p < np; p += 32) {
    out.pieces[at + p] = make_int2(i, p0 + p);
  }
}

// A short header line read by its own lane, a word at a time.
__device__ __forceinline__ void header_alone(const Lines& in, int e,
                                             Counts& c) {
  const int last = (e - 1) >> 4;
  for (int w = c.lo >> 4; c.lo < e && w <= last; ++w) {
    const int base = w << 4;
    const uint4 word = load_word(in.src, base, in.n);
    const unsigned inside = span16(base, c.lo, e);
    const unsigned cr = mask_of(word, kCR4) & inside;
    if (c.found) {
      c.desc += __popc(inside & ~cr);
      continue;
    }
    const unsigned sp = mask_of(word, kSpace4) & inside;
    const unsigned drop =
        in.drop_rep == kCR4 ? cr : mask_of(word, in.drop_rep) & inside;
    const unsigned name_keep = inside & ~cr & ~drop;
    if (sp == 0u) {
      c.count += __popc(name_keep);
      continue;
    }
    c.split = base + __ffs(static_cast<int>(sp)) - 1;
    c.found = true;
    c.count += __popc(name_keep & below(c.split - base));
    c.desc += __popc(inside & ~cr & above(c.split - base));
  }
}

// A long header line read by the whole warp, 32 words at a time.
__device__ __forceinline__ void header_together(const Lines& in, int e,
                                                int lane, Counts& c) {
  const int last = (e - 1) >> 4;
  for (int q = c.lo >> 4; q <= last; q += 32) {
    const int w = q + lane;
    const uint4 word = w <= last ? load_word(in.src, w << 4, in.n)
                                 : make_uint4(0u, 0u, 0u, 0u);
    header_word(word, w, last, in.drop_rep, c);
  }
  c.count = __reduce_add_sync(kFull, c.count);
  c.desc = __reduce_add_sync(kFull, c.desc);
}

// A warp takes 32 neighbouring lines, lane l line l of them: each lane
// loads its line's span, reads its words kWords at a time, keeps its
// counts and writes its outputs. A FASTA line's first byte comes from its
// first word: a header line is then left to its lane, which reads it
// alone (or with its warp, past kLongAt bytes), and a body line past
// kLongAt bytes has its pieces recorded by the warp.
__global__ void __launch_bounds__(kThreads)
text_lines_kernel(Lines in, Out out, unsigned long long* __restrict__ status,
                  unsigned long long epoch) {
  const bool want_hdr = out.split != nullptr;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int64_t i = int64_t{blockIdx.x} * kThreads + threadIdx.x;
  const bool live = i < in.n_lines;
  const Span mine = span_of(in.nl, i, in.k, in.n, in.n_lines);
  const int s = mine.s, e = mine.e;
  const bool role_hdr = in.fastq && i % 4 == 0;
  // a FASTQ header's first byte, for its '@'; a FASTA line's comes below
  int first = role_hdr && s < e ? in.src[s] : '\n';
  int cr = 0;  // this line's '\r' (a body line)
  bool long_body = false;  // its pieces go to text_long_lines_kernel
  if (live && s < e && !role_hdr) {
    const bool long_line = e - s > kLongAt;
    if (in.fastq && long_line) {
      long_body = true;
    } else {
      const int last = (e - 1) >> 4;
      const int w0 = s >> 4;
      for (int q = w0; q <= last; q += kWords) {
        uint4 words[kWords];
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          words[j] = q + j <= last ? load_word(in.src, (q + j) << 4, in.n)
                                   : make_uint4(0u, 0u, 0u, 0u);
        }
        if (!in.fastq && q == w0) {
          first = byte_of(words[0], s & 15);
          if (first == '>') break;  // a header: read below
          if (long_line) {
            long_body = true;
            break;
          }
        }
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          const unsigned m = q + j <= last ? mask_of(words[j], kCR4) : 0u;
          if (m != 0u) cr += __popc(m & span16((q + j) << 4, s, e));
        }
      }
    }
  }
  unsigned longs = __ballot_sync(kFull, long_body);
  while (longs != 0u) {
    const int m = __ffs(static_cast<int>(longs)) - 1;
    longs &= longs - 1u;
    record_pieces(static_cast<int>(i) - lane + m, __shfl_sync(kFull, s, m),
                  __shfl_sync(kFull, e, m), lane, out, status, epoch);
  }
  const bool hdr = live && (in.fastq ? role_hdr : first == '>');
  Counts c{s + 1, e, e, 0, 0, false};
  if (want_hdr) {
    // short headers by their lanes; a long one by the whole warp
    const bool alone = hdr && e - s <= kLongAt;
    if (alone) header_alone(in, e, c);
    unsigned long_hdrs = __ballot_sync(kFull, hdr && !alone);
    while (long_hdrs != 0u) {
      const int m = __ffs(static_cast<int>(long_hdrs)) - 1;
      long_hdrs &= long_hdrs - 1u;
      Counts h{__shfl_sync(kFull, c.lo, m), __shfl_sync(kFull, c.e, m),
               __shfl_sync(kFull, c.split, m), 0, 0, false};
      header_together(in, h.e, lane, h);
      if (lane == m) c = h;
    }
  }
  const int bad = __reduce_add_sync(
      kFull, in.fastq && hdr && first != '@' ? 1 : 0);
  if (bad != 0 && lane == 0) {
    add_to_word(status, kBadWord, epoch, static_cast<unsigned>(bad));
  }
  if (!live) return;
  out.start[i] = s;
  out.end[i] = e;
  out.is_hdr[i] = hdr;
  // a long line's '\r' come off in text_long_lines_kernel
  out.body[i] = hdr ? 0 : e - s - cr;
  if (!want_hdr) return;
  out.split[i] = hdr ? c.split : e;
  out.name_len[i] = hdr ? c.count : 0;
  out.desc_len[i] = hdr ? c.desc : 0;
}

__global__ void __launch_bounds__(kThreads)
text_long_lines_kernel(const uint8_t* __restrict__ src, int n,
                       const int32_t* __restrict__ nl, int k,
                       const int2* __restrict__ pieces,
                       const unsigned long long* __restrict__ status,
                       unsigned long long epoch, int32_t* __restrict__ body,
                       int32_t* __restrict__ bad) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t b = 0;
    lookback::read(status, kBadWord, epoch, &b);
    *bad = static_cast<int32_t>(b);
  }
  int64_t np = 0;  // stays 0 unless this call recorded pieces
  lookback::read(status, kPiecesWord, epoch, &np);
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int64_t warps = int64_t{gridDim.x} * (kThreads / 32);
  for (int64_t p = (int64_t{blockIdx.x} * kThreads + threadIdx.x) / 32;
       p < np; p += warps) {
    const int2 piece = pieces[p];
    const int s = piece.x > 0 ? nl[piece.x - 1] + 1 : 0;
    const int e = piece.x < k ? nl[piece.x] : n;
    const int lo = max(s, piece.y * kPiece);
    const int hi = static_cast<int>(
        min(int64_t{e}, (int64_t{piece.y} + 1) * kPiece));
    const int last = (hi - 1) >> 4;
    int count = 0;
    for (int w = (lo >> 4) + lane; w <= last; w += 32 * kLoads) {
      uint4 words[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int at = w + 32 * j;
        words[j] = at <= last ? load_word(src, at << 4, n)
                              : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const unsigned cr = mask_of(words[j], kCR4);
        if (cr != 0u) count += __popc(cr & span16((w + 32 * j) << 4, lo, hi));
      }
    }
    count = __reduce_add_sync(kFull, count);
    if (lane == 0 && count != 0) atomicAdd(body + piece.x, -count);
  }
}

}  // namespace

// pieces holds n / 16384 + 2 * (n / 512) + 2 int2 entries (kPiece,
// kLongAt); status holds the two status words of the look-back workspace
// and epoch is this call's number, 1 to 2^30 - 1. src is 16-byte aligned,
// n < 2^31, 0 < n_lines.
extern "C" int exon_text_records(const void* src, int64_t n, const void* nl,
                                 int64_t k, int64_t n_lines, int32_t fastq,
                                 int32_t name_drop, void* start, void* end,
                                 void* is_hdr, void* body, void* split,
                                 void* name_len, void* desc_len, void* bad,
                                 void* pieces, void* status, uint64_t epoch,
                                 void* stream) {
  const auto* s = static_cast<const uint8_t*>(src);
  const auto* l = static_cast<const int32_t*>(nl);
  auto* words = static_cast<unsigned long long*>(status);
  const auto st = static_cast<cudaStream_t>(stream);
  const Out out{static_cast<int32_t*>(start),    static_cast<int32_t*>(end),
                static_cast<uint8_t*>(is_hdr),   static_cast<int32_t*>(body),
                static_cast<int32_t*>(split),    static_cast<int32_t*>(name_len),
                static_cast<int32_t*>(desc_len), static_cast<int2*>(pieces)};
  // name_drop in every byte of a 32-bit lane (bytes16::splat, on the host)
  const unsigned drop = (static_cast<unsigned>(name_drop) & 0xffu) * 0x01010101u;
  const int n32 = static_cast<int>(n), k32 = static_cast<int>(k);
  const Lines in{s, l, n32, k32, static_cast<int>(n_lines), fastq, drop};
  const unsigned blocks =
      static_cast<unsigned>((n_lines + kThreads - 1) / kThreads);
  text_lines_kernel<<<blocks, kThreads, 0, st>>>(in, out, words, epoch);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  text_long_lines_kernel<<<kLongBlocks, kThreads, 0, st>>>(
      s, n32, l, k32, static_cast<const int2*>(pieces), words, epoch,
      static_cast<int32_t*>(body), static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}
