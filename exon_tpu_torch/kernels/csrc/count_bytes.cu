// count_bytes: per row, the number of bytes that fall in a class of bytes,
// as an int32 count or, in share mode, as float32 count / length.
//
// Replaces the per-row count of exon_tpu/udfs.py gc_content (:69): a
// per-byte class mask over the whole values buffer, a per-byte row id
// (ops/layout.py byte_row_ids :27) and a scatter-add into the rows
// (_per_row_count :59); in share mode also gc_content's divide (:75),
// __fdiv_rn(__int2float_rn(count), __int2float_rn(length)) and 0 for an
// empty row, the IEEE float32 divide bit for bit whatever the build's math
// flags. gc_content's class is {G, C, g, c}; fn_translate's deletions use
// the count mode.
//
// Bound on the H100: HBM bytes, each row's bytes read once, its offsets
// read and a 4-byte result written: G's 131,072-read BAM batch of 100 bp
// moves 14.2 MB, ~4.2 us at 3.35 TB/s; the first FASTQ chunk's 377,963
// reads, 59.7 MB, ~17.8 us.
//
// The design before this one ran a warp a row with one byte a lane a load
// through a shared-memory byte table: one 32-byte sector in flight a warp,
// ~2 KB a resident SM, latency-bound at ~10 % of the bound. Now:
//   A thread takes a row, its two offsets read coalesced, and counts it in
//     passes of kWords = 4 aligned 16-byte words (copy16 load_word: only
//     words that hold a byte of the row are read; bytes outside
//     [offsets[r], offsets[r + 1]) are masked off, so a row never counts a
//     neighbour's bytes). A pass's loads all go out before any test: 64
//     bytes a thread. The grid is the occupancy API's resident blocks of
//     256 threads an SM (at the 52-61 registers a thread of the sm_90a
//     builds, 4 blocks: 1,024 threads, 64 KB in flight a resident SM,
//     past the ~30 KB the card's bandwidth needs at its latency), and its
//     blocks stride over the rows.
//   Bytes are tested in registers (byteclass.cuh): no table, no bank
//     conflicts; gc_content's {G, C, g, c} is one SWAR cube, about one
//     instruction a byte, and __popc counts a word's flags.
//   A row of more than kLaneWords = 32 words (past ~500 bytes) is left to
//     its whole warp after the thread rows, 32 lanes at 4 words each a
//     pass, summed by __reduce_add_sync, so a thread never walks a long
//     row while its warp waits. Widths of 2-32 lanes a row were timed
//     against a thread a row at G's batch and the FASTQ chunk: each lost.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <type_traits>

#include "byteclass.cuh"
#include "copy16.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWords = 4;       // words a thread loads a pass
constexpr int kLaneWords = 32;  // a thread's words at most; the warp's past

// The number of the row [s, e)'s bytes in aligned word w that are in the
// class.
template <int K>
__device__ __forceinline__ unsigned count_word(const byteclass::Class& cls,
                                               uint4 x, int64_t w, int shift,
                                               int64_t s, int64_t e) {
  const unsigned keep = byteclass::row_bits(16 * w - shift, s, e);
  return __popc(byteclass::bits16(byteclass::flags16<K>(cls, x)) & keep);
}

// The class bytes of the row [s, e) in its words w0, w0 + step, ... below
// w_end, kWords of them loaded a pass before any is tested.
template <int K>
__device__ __forceinline__ unsigned count_words(
    const uint8_t* __restrict__ values, int64_t n_values,
    const byteclass::Class& cls, int shift, int64_t s, int64_t e,
    int64_t w0, int64_t w_end, int step) {
  unsigned c = 0;
  for (; w0 < w_end; w0 += static_cast<int64_t>(kWords) * step) {
    uint4 x[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int64_t w = w0 + static_cast<int64_t>(u) * step;
      x[u] = w < w_end ? copy16::load_word(values, n_values, w)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      c += count_word<K>(cls, x[u], w0 + static_cast<int64_t>(u) * step,
                         shift, s, e);
    }
  }
  return c;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    count_bytes_kernel(const uint8_t* __restrict__ values, int64_t n_values,
                       const int32_t* __restrict__ offsets, int64_t n,
                       const byteclass::Class cls, bool share,
                       void* __restrict__ out) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(values) & 15);
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = base + threadIdx.x;
    const bool live = r < n;
    const int64_t s = live ? offsets[r] : 0;
    const int64_t e = live ? offsets[r + 1] : 0;
    const int64_t w0 = (shift + s) >> 4, w_end = (shift + e + 15) >> 4;
    const bool is_long = e > s && w_end - w0 > kLaneWords;
    unsigned c = e > s && !is_long
                     ? count_words<K>(values, n_values, cls, shift, s, e, w0,
                                      w_end, 1)
                     : 0u;
    // the long rows, each by the whole warp
    for (unsigned todo = __ballot_sync(kFull, is_long); todo != 0u;
         todo &= todo - 1u) {
      const int src = __ffs(todo) - 1;
      const int64_t ls = __shfl_sync(kFull, s, src);
      const int64_t le = __shfl_sync(kFull, e, src);
      const unsigned part = __reduce_add_sync(
          kFull, count_words<K>(values, n_values, cls, shift, ls, le,
                                ((shift + ls) >> 4) + lane,
                                (shift + le + 15) >> 4, 32));
      if (lane == src) c = part;
    }
    if (live) {
      if (share) {
        static_cast<float*>(out)[r] =
            e > s ? __fdiv_rn(__int2float_rn(static_cast<int>(c)),
                              __int2float_rn(static_cast<int>(e - s)))
                  : 0.0f;
      } else {
        static_cast<int32_t*>(out)[r] = static_cast<int32_t>(c);
      }
    }
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

// The blocks of count_bytes_kernel<K> resident at once on the card.
template <int K>
int64_t resident_blocks() {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, count_bytes_kernel<K>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  return static_cast<int64_t>(sm_count()) * per_sm;
}

// Calls f(integral_constant<K>) for a class test (1, 2, 4, 8 SWAR cubes,
// 0: the mask); false for any other.
template <typename F>
bool with_test(int32_t k, F&& f) {
  switch (k) {
    case 0: f(std::integral_constant<int, 0>{}); return true;
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    default: return false;
  }
}

}  // namespace

// values uint8 [n_values]; offsets int32 [n + 1] (n > 0) into values; cls
// the 96-byte byteclass::Class (read before the call returns), k its test
// (1, 2, 4 or 8 SWAR cubes, 0: the mask); out int32 [n] counts, or float32
// [n] shares when share is nonzero.
extern "C" int exon_count_bytes(const void* values, int64_t n_values,
                                const void* offsets, int64_t n,
                                const void* cls, int32_t k, int32_t share,
                                void* out, void* stream) {
  byteclass::Class c;
  std::memcpy(&c, cls, sizeof(c));
  const bool ok = with_test(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    int64_t blocks = (n + kThreads - 1) / kThreads;
    const int64_t cap = resident_blocks<K>();
    if (blocks > cap) blocks = cap;
    count_bytes_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(values), n_values,
        static_cast<const int32_t*>(offsets), n, c, share != 0, out);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
