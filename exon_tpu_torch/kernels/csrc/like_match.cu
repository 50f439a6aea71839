// like_match: SQL LIKE / ILIKE per row over uint8 values + int32 offsets.
//
// Replaces exon_tpu/ops/strings.py like (:177) and everything it dispatches
// to: starts_with (:56), ends_with (:70), equals_literal (:92), contains
// (:97) and _like_general (:257). The JAX version evaluates each pattern
// chunk over the whole flat buffer (one compare pass per pattern byte, a
// per-byte row-id map and a segmented min per middle chunk).
//
// Position mode (exon_like_find) replaces ops/strings.py _find_from (:229)
// as exon_tpu/ops/sqlfuncs.py fn_strpos (:231) calls it: the leftmost start
// of one chunk in each row, relative to the row start, or -1.
//
// Bound on the H100: HBM bytes. A row is read up to the end of its first
// match of a middle chunk (all of it when there is none), with its two
// offsets and one output word: '%KK%' over a 52 MB batch ~10 us, strpos of a
// 13-byte adapter over 55 MB of reads ~17 us, at 3.35 TB/s.
//
// Design: a group of G = 4, 8, 16 or 32 lanes of a warp a row for a
// pattern with a middle chunk (or strpos), G picked by the wrapper from the
// mean row length so that one pass covers most rows; a lane a row (G = 1)
// for a pattern of anchored chunks alone.
//   The pattern comes by value, in the kernel's parameters (kInlineWords
//     int32 words, the layout of kernels/like_match.py encode_pattern), or,
//     when longer, from a device copy the wrapper keeps per pattern, and is
//     read in place (the whole warp reads one word at a time but for a
//     compare's tokens). No call uploads or synchronises.
//   A middle chunk and the position mode search the row in aligned 16-byte
//     words, kWords = 4 a lane a pass, loaded together: lane g holds words
//     g, g + G, g + 2G and g + 3G, so neighbouring lanes load neighbouring
//     words. Bytes outside [search start, row end) never count. For each
//     distinct byte value of the chunk's first 17 tokens each lane makes its
//     words' 16-bit equality masks (bytes16.cuh eq16), takes the next words'
//     from its neighbour (__shfl_sync) as bits 16-31, and ANDs the window
//     shifted by each offset the value holds into its words' candidate bits;
//     a '_' adds nothing. The last lane's last word only lends its bytes, so
//     a pass advances 4G - 1 words. The values run most offsets first and
//     the group stops once no lane has a candidate left. ILIKE folds each
//     word first (the wrapper folds the tokens).
//   The leftmost hit is the lowest bit of the lowest lane in the group's
//     ballot, every lane's first word before any second, and so on. A chunk
//     of more than 17 tokens checks its candidates in that order, the group
//     comparing the whole chunk with byte loads that hit L1. strpos and each
//     middle chunk stop at the first hit; the next middle chunk starts after
//     it (_like_general's greedy order).
//   The anchored first chunk, the anchored last chunk (which may not
//     overlap what came before) and a one-chunk equality are one compare of
//     the row's head or tail, the group's lanes taking every G-th token.
// Case folding is ASCII only, as in _upper_u8. The output is bool[n] (int32
// in position mode); validity masking stays with the caller.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <type_traits>

#include "bytes16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 17;          // tokens a two-word window tests
constexpr int kInlineWords = 256;    // pattern words passed by value
constexpr int kWords = 4;            // 16-byte words a lane a pass

struct Inline {
  int32_t words[kInlineWords];
};

// G lanes of a warp (G a power of two, blockDim a multiple of 32): its
// votes and shuffles name the group's lanes only (a lone lane needs none),
// and lanes are numbered from 0 within it.
template <int G>
struct Group {
  unsigned mask;  // the group's lanes in the warp
  int base;       // its first lane
  int rank;       // this lane's number in the group
  __device__ Group() {
    const int lane = static_cast<int>(threadIdx.x & 31u);
    base = lane & ~(G - 1);
    rank = lane - base;
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << base;
  }
  __device__ unsigned ballot(bool p) const {
    if constexpr (G == 1) return p ? 1u : 0u;
    return (__ballot_sync(mask, p) & mask) >> base;
  }
  __device__ bool any(bool p) const { return ballot(p) != 0u; }
  __device__ int shfl(int v, int src) const {
    if constexpr (G == 1) return v;
    return __shfl_sync(mask, v, src, G);
  }
  __device__ unsigned shfl_down(unsigned v, int d) const {
    if constexpr (G == 1) return v;
    return __shfl_down_sync(mask, v, d, G);
  }
};

// The encoded pattern (kernels/like_match.py encode_pattern): p[0] chunks
// c, p[1] the case-insensitive flag, then a record of 4 words a chunk (where
// its tokens start in p, their count, where its filter entries start, their
// count), then the tokens (a byte, folded under ILIKE, or -1 for '_'), then
// the filter entries: value | offsets << 8, offsets the bit set of the
// chunk's first 17 positions that hold the value. Every field of a chunk is
// one read from a fixed place.
struct Chunk {
  int32_t tok, k;     // where its k tokens start in the pattern
  int32_t flt, nflt;  // where its nflt filter entries start
};

struct Pattern {
  const int32_t* p;
  __device__ int32_t chunks() const { return p[0]; }
  __device__ bool ci() const { return p[1] != 0; }
  __device__ Chunk chunk(int c) const {
    const int32_t* r = p + 2 + 4 * c;
    return Chunk{r[0], r[1], r[2], r[3]};
  }
};

// Whether the k tokens match at byte q (q + k <= the row end); every lane of
// the group takes every G-th token.
template <int G>
__device__ __forceinline__ bool match_at(const uint8_t* __restrict__ values,
                                         int32_t q, const int32_t* tok,
                                         int32_t k, bool ci, Group<G> grp) {
  bool bad = false;
  for (int32_t t = grp.rank; t < k; t += G) {
    const int32_t c = tok[t];
    if (c < 0) continue;
    const uint8_t b = ci ? bytes16::fold1(values[q + t]) : values[q + t];
    bad |= b != static_cast<uint8_t>(c);
  }
  return !grp.any(bad);
}

// x clamped to +-2^30: an offset from a pass's first byte, in 32 bits.
__device__ __forceinline__ int rel32(int64_t x) {
  constexpr int64_t kLim = int64_t{1} << 30;
  return static_cast<int>(x < -kLim ? -kLim : (x > kLim ? kLim : x));
}

// The candidate starts of the 16 bytes at rel in a pass whose candidates
// run from lo to hi (exclusive), all relative to the pass's first byte.
__device__ __forceinline__ unsigned starts_in(int rel, int lo, int hi) {
  const int l = lo - rel > 0 ? lo - rel : 0;
  const int h = hi - rel < 16 ? hi - rel : 16;
  return h > l ? (0xffffu >> (16 - h)) & (0xffffu << l) : 0u;
}

// The 16 bytes at pass + rel, zero at or past lim (the row's end).
__device__ __forceinline__ uint4 load_word(const uint8_t* __restrict__ pass,
                                           int rel, int lim, bool ci) {
  if (rel >= lim) return make_uint4(0u, 0u, 0u, 0u);
  const uint4 w = *reinterpret_cast<const uint4*>(pass + rel);
  return ci ? bytes16::fold16(w) : w;
}

// The first byte of the aligned word that holds byte `from`.
__device__ __forceinline__ int64_t pass_start(const uint8_t* values,
                                              int64_t from) {
  return from -
         static_cast<int64_t>(reinterpret_cast<uintptr_t>(values + from) & 15u);
}

// The leftmost q >= from with q + k <= end where chunk `ch` matches, or -1.
// A pass holds kWords * G aligned words from the one that holds byte
// `from`, words g + iG (i < kWords) in lane g, loaded together. The next
// word of (g, i) is (g + 1, i), or (0, i + 1) for the last lane; the last
// lane's last word only lends its bytes, so a pass advances kWords * G - 1
// words. Offsets within a pass are 32-bit.
template <int G>
__device__ __forceinline__ int32_t find(const uint8_t* __restrict__ values,
                                        int32_t from, int32_t end,
                                        const int32_t* pat, Chunk ch, bool ci,
                                        Group<G> grp) {
  constexpr int kStep = 16 * (kWords * G - 1);
  const int32_t k = ch.k;
  if (k == 0) return from;
  const int32_t last = end - k;  // the last start that fits
  if (from > last) return -1;
  const int g = grp.rank;
  const int right = (g + 1) & (G - 1);
  for (int64_t it = pass_start(values, from);; it += kStep) {
    const uint8_t* pass = values + it;
    const int lo = rel32(from - it), hi = rel32(int64_t{last} + 1 - it);
    const int lim = rel32(end - it);
    uint4 w[kWords];
    unsigned m[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int rel = 16 * (g + i * G);
      w[i] = load_word(pass, rel, lim, ci);
      m[i] = i < kWords - 1 || g < G - 1 ? starts_in(rel, lo, hi) : 0u;
    }
    for (int32_t f = 0; f < ch.nflt; ++f) {
      unsigned any = 0;
#pragma unroll
      for (int i = 0; i < kWords; ++i) any |= m[i];
      if (!grp.any(any != 0u)) break;
      const int32_t e = pat[ch.flt + f];
      const unsigned rep = bytes16::splat(e & 0xff);
      // each word's window: its bytes, then the next word's (bits 16-31)
      unsigned win[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i) win[i] = bytes16::eq16(w[i], rep);
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const unsigned next =
            i < kWords - 1
                ? static_cast<unsigned>(grp.shfl(
                      static_cast<int>(g == 0 ? win[i + 1] : win[i]), right))
                : grp.shfl_down(win[i], 1);
        win[i] |= next << 16;
      }
      for (unsigned o = static_cast<unsigned>(e) >> 8; o; o &= o - 1u) {
        const int t = __ffs(o) - 1;
#pragma unroll
        for (int i = 0; i < kWords; ++i) m[i] &= win[i] >> t;
      }
    }
    // the candidates in order: every lane's word 0, then word 1, ...
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      for (;;) {
        const unsigned lanes = grp.ballot(m[i] != 0u);
        if (lanes == 0u) break;
        const int lead = __ffs(lanes) - 1;
        const int32_t q = static_cast<int32_t>(
            it + 16 * (lead + i * G) + grp.shfl(__ffs(m[i]) - 1, lead));
        if (k <= kWindow ||
            match_at<G>(values, q, pat + ch.tok, k, ci, grp)) {
          return q;
        }
        if (g == lead) m[i] &= m[i] - 1u;
      }
    }
    if (hi <= kStep) return -1;  // no start left past this pass
  }
}

// Whether row [start, end) matches the pattern (_like_general's greedy
// match); head and second are chunks 0 and 1, read ahead. A lone lane
// (G = 1) takes patterns of anchored chunks alone: exon_like_match refuses
// it any other.
template <int G>
__device__ __forceinline__ bool like_row(const uint8_t* __restrict__ values,
                                         int32_t start, int32_t end,
                                         Pattern pat, int32_t nchunks, bool ci,
                                         Chunk head, Chunk second,
                                         Group<G> grp) {
  if (nchunks == 1) {
    return end - start == head.k &&
           match_at<G>(values, start, pat.p + head.tok, head.k, ci, grp);
  }
  int32_t p = start;
  if (head.k > 0) {
    if (int64_t{start} + head.k > end ||
        !match_at<G>(values, start, pat.p + head.tok, head.k, ci, grp)) {
      return false;
    }
    p += head.k;
  }
  if constexpr (G > 1) {
    for (int32_t c = 1; c < nchunks - 1; ++c) {
      const Chunk ch = c == 1 ? second : pat.chunk(c);
      if (ch.k == 0) continue;
      const int32_t q = find<G>(values, p, end, pat.p, ch, ci, grp);
      if (q < 0) return false;
      p = q + ch.k;
    }
  }
  const Chunk tail = pat.chunk(nchunks - 1);
  return tail.k == 0 ||
         (int64_t{end} - tail.k >= p &&
          match_at<G>(values, end - tail.k, pat.p + tail.tok, tail.k, ci,
                      grp));
}

template <int G>
__global__ void __launch_bounds__(kThreads)
like_kernel(const int32_t* __restrict__ offsets,
            const uint8_t* __restrict__ values, int64_t n,
            const __grid_constant__ Inline inl, const int32_t* dev,
            bool* __restrict__ out) {
  const Pattern pat{dev != nullptr ? dev : inl.words};
  const Group<G> grp;
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (r >= n) return;
  // the pattern's fields, read while the offsets load
  const int32_t nchunks = pat.chunks();
  const bool ci = pat.ci();
  const Chunk head = pat.chunk(0), second = pat.chunk(nchunks > 1 ? 1 : 0);
  const bool ok = like_row<G>(values, offsets[r], offsets[r + 1], pat,
                              nchunks, ci, head, second, grp);
  if (grp.rank == 0) out[r] = ok;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
find_kernel(const int32_t* __restrict__ offsets,
            const uint8_t* __restrict__ values, int64_t n,
            const __grid_constant__ Inline inl, const int32_t* dev,
            int32_t* __restrict__ out) {
  const Pattern pat{dev != nullptr ? dev : inl.words};
  const Group<G> grp;
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (r >= n) return;
  const Chunk ch = pat.chunk(0);  // read while the offsets load
  const bool ci = pat.ci();
  const int32_t start = offsets[r];
  const int32_t q =
      find<G>(values, start, offsets[r + 1], pat.p, ch, ci, grp);
  if (grp.rank == 0) out[r] = q < 0 ? -1 : q - start;
}

// Calls f(std::integral_constant<int, G>{}) for the group width `group`
// (1, 4, 8, 16 or 32); false for any other.
template <typename F>
bool with_group(int32_t group, F&& f) {
  switch (group) {
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    case 16: f(std::integral_constant<int, 16>{}); return true;
    case 32: f(std::integral_constant<int, 32>{}); return true;
    default: return false;
  }
}

// The by-value copy of the pattern, unless it has a device copy; false when
// neither holds it.
bool by_value(const void* pat_host, int32_t words, const void* pat_dev,
              Inline* inl) {
  if (pat_dev != nullptr) return true;
  if (words > kInlineWords) return false;
  std::memcpy(inl->words, pat_host, sizeof(int32_t) * words);
  return true;
}

// Whether the encoded pattern has a middle chunk that is not empty.
bool searches(const int32_t* pat) {
  for (int32_t c = 1; c < pat[0] - 1; ++c) {
    if (pat[3 + 4 * c] > 0) return true;
  }
  return false;
}

unsigned num_blocks(int64_t n, int32_t group) {
  return static_cast<unsigned>((n * group + kThreads - 1) / kThreads);
}

}  // namespace

// pat_host holds the `words` int32 words of the encoded pattern (read
// before the call returns); when they exceed kInlineWords, pat_dev is a
// device copy of them, else null. group is the lanes a row (1 only for a
// pattern without a middle chunk to search). n must be > 0.
extern "C" int exon_like_match(const void* offsets, const void* values,
                               int64_t n, const void* pat_host, int32_t words,
                               const void* pat_dev, int32_t group, void* out,
                               void* stream) {
  Inline inl;
  if (!by_value(pat_host, words, pat_dev, &inl) ||
      (group == 1 && searches(static_cast<const int32_t*>(pat_host)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ok = with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    like_kernel<G><<<num_blocks(n, G), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const uint8_t*>(values), n, inl,
        static_cast<const int32_t*>(pat_dev), static_cast<bool*>(out));
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exon_like_find(const void* offsets, const void* values,
                              int64_t n, const void* pat_host, int32_t words,
                              const void* pat_dev, int32_t group, void* out,
                              void* stream) {
  Inline inl;
  if (!by_value(pat_host, words, pat_dev, &inl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ok = with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    find_kernel<G><<<num_blocks(n, G), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const uint8_t*>(values), n, inl,
        static_cast<const int32_t*>(pat_dev), static_cast<int32_t*>(out));
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
