// polya_tail: per row, the run of bytes of a byte class at one end of the
// row, or at both. From the end it writes the length left once the
// trailing run is stripped (0 for an empty row or one made only of class
// bytes); from the start, the length of the leading run (the whole row for
// one made only of class bytes); both writes the two in one launch.
//
// Replaces the length computation of exon_tpu/udfs.py trim_polya (:131): a
// per-byte row id (ops/layout.py byte_row_ids :27), a per-byte "not A"
// position and a scatter-max of the last one into the rows; with the class
// {'A', 'a'} from the end it is that function. With any trim set it is
// exon_tpu/ops/sqlfuncs.py _trim_counts (:178), whose scatter-min and
// scatter-max give a row's first and last byte outside the set: from the
// start the leading count, from the end the kept length, n - trailing
// count; trim takes both from one launch. A row made only of trim bytes
// empties from either side (rtrim('aa', 'a') = '', sqlfuncs.py:198). The
// caller turns lengths into offsets (torch.cumsum) and copies the kept
// bytes with gather_spans, in place of the JAX relayout (layout.py:127,
// sqlfuncs.py:96).
//
// Bound on the H100: HBM bytes: the offset pair in and an int32 out per
// row and end, plus each row's bytes from the scanned end to its first
// byte outside the class (one byte for most rows): ~3.4 MB for K's 377,963
// cut reads, ~1 us at 3.35 TB/s; 56.7 MB for the ACGT runs of the first
// FASTQ chunk's all-class reads, ~18 us.
//
// The design before this one ran a warp a row: the offsets' load, then a
// dependent 32-byte window, a ballot and a branch, each warp walking ~45
// rows in turn (~70x the bound at K), and an all-class row walked 32 bytes
// a step by each end's own launch. Now:
//   A block takes a tile of 256 consecutive rows, a thread a row, its two
//     offsets read coalesced. The thread loads the aligned 16-byte word
//     (copy16 load_word) that holds its row's scanned end, tests it in
//     registers (byteclass.cuh), masks off the bytes outside the row and
//     finds the run's end with __ffs (from the start) or __clz (from the
//     end): on the main path's rows one word settles nearly every row.
//   A run that reaches past that word goes on by its thread, kStepWords =
//     4 words a step, all loaded before any is tested, for up to 4 steps
//     (17 words in all, 272 bytes).
//   A longer run is handed to the warp: the rows still unsettled are
//     balloted, and each is walked by all 32 lanes, a word a lane, 512
//     bytes a step, the first hit the lowest lane's (a ballot). An
//     all-class row of 64 KB costs 128 warp steps.
//   Both ends: the leading run first; a row whose leading run is the whole
//     row has kept length 0 without a second walk, any other walks from its
//     end, so the offsets are read once and one launch answers both.
//   The grid is capped at 8 blocks of 256 threads an SM, twice what is
//     resident at once (the 47-61 registers a thread of the sm_90a builds
//     leave room for 4-5 blocks, 1,024-1,280 threads), and its blocks
//     stride over the tiles; the blocks past residency wait for a slot.
//     A grid of the resident blocks (the occupancy API's) and a block a
//     tile with no cap were timed beside it: all three within 3-5 % at
//     K's 'N' and {A, C} runs, none ahead in every run. A row settled by its end word has 16 bytes in flight,
//     16-20 KB a resident SM, below the ~30 KB the card's bandwidth needs
//     at its latency; a run past that word has 64 bytes a thread a step.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <type_traits>

#include "byteclass.cuh"
#include "copy16.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kStepWords = 4;   // words a thread loads a step after its first
constexpr int kThreadSteps = 4;  // such steps before the warp takes the row

enum Mode : int32_t { kEnd = 0, kStart = 1, kBoth = 2 };

struct Row {
  const uint8_t* values;
  int64_t n_values;
  int shift;  // values' address mod 16
  int64_t s, e;

  // The row's bytes in aligned word w (given as x) outside the class.
  template <int K>
  __device__ __forceinline__ unsigned others(const byteclass::Class& cls,
                                             uint4 x, int64_t w) const {
    return ~byteclass::bits16(byteclass::flags16<K>(cls, x)) &
           byteclass::row_bits(16 * w - shift, s, e);
  }
  template <int K>
  __device__ __forceinline__ unsigned others(const byteclass::Class& cls,
                                             int64_t w) const {
    return others<K>(cls, copy16::load_word(values, n_values, w), w);
  }
  __device__ __forceinline__ int64_t first_word() const {
    return (shift + s) >> 4;
  }
  __device__ __forceinline__ int64_t last_word() const {
    return (shift + e - 1) >> 4;
  }
};

// A walk's state: whether the row is settled, its result so far (its
// answer if the walk finds no byte outside the class), and the next word
// to test.
struct Walk {
  bool settled;
  int64_t result;
  int64_t w;
};

// Tests word x (word w of the row) for the walk, and settles it at the
// first (from the start) or last (from the end) byte outside the class, or
// when it has passed the row's other end.
template <int K, bool kFromStart>
__device__ __forceinline__ void test_word(const byteclass::Class& cls,
                                          const Row& row, uint4 x,
                                          Walk& walk) {
  const unsigned o = row.others<K>(cls, x, walk.w);
  if (o != 0u) {
    walk.result = kFromStart
                      ? 16 * walk.w - row.shift + (__ffs(o) - 1) - row.s
                      : 16 * walk.w - row.shift + (31 - __clz(o)) - row.s + 1;
    walk.settled = true;
  } else {
    walk.w += kFromStart ? 1 : -1;
    walk.settled =
        kFromStart ? walk.w > row.last_word() : walk.w < row.first_word();
  }
}

// The run from the start (kFromStart) or the end of the row; `none` is
// the answer when the row has no byte outside the class, and the answer of
// a lane that is not `live`. The thread tests the word at the row's end,
// then goes on kStepWords words a step, all loaded before any is tested,
// for kThreadSteps steps; the rows still unsettled are walked by the whole
// warp, 32 words a step. Every lane of the warp calls it.
template <int K, bool kFromStart>
__device__ __forceinline__ int64_t run(const byteclass::Class& cls,
                                       const Row& row, bool live,
                                       int64_t none, int lane) {
  Walk walk{!live || row.e <= row.s, none,
            kFromStart ? row.first_word() : row.last_word()};
  if (!walk.settled) {
    test_word<K, kFromStart>(
        cls, row, copy16::load_word(row.values, row.n_values, walk.w), walk);
  }
  for (int step = 0; !walk.settled && step < kThreadSteps; ++step) {
    uint4 x[kStepWords];
#pragma unroll
    for (int u = 0; u < kStepWords; ++u) {
      const int64_t w = walk.w + (kFromStart ? u : -u);
      const bool in = kFromStart ? w <= row.last_word() : w >= row.first_word();
      x[u] = in ? copy16::load_word(row.values, row.n_values, w)
                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kStepWords; ++u) {
      if (!walk.settled) test_word<K, kFromStart>(cls, row, x[u], walk);
    }
  }
  for (unsigned todo = __ballot_sync(kFull, !walk.settled); todo != 0u;
       todo &= todo - 1u) {
    const int src = __ffs(todo) - 1;
    Row r = row;
    r.s = __shfl_sync(kFull, row.s, src);
    r.e = __shfl_sync(kFull, row.e, src);
    const int64_t lo = r.first_word(), hi = r.last_word();
    int64_t found = __shfl_sync(kFull, walk.result, src);
    for (int64_t base = __shfl_sync(kFull, walk.w, src);
         kFromStart ? base <= hi : base >= lo; base += kFromStart ? 32 : -32) {
      const int64_t v = kFromStart ? base + lane : base - lane;
      const unsigned o =
          (kFromStart ? v <= hi : v >= lo) ? r.others<K>(cls, v) : 0u;
      const unsigned hit = __ballot_sync(kFull, o != 0u);
      if (hit != 0u) {
        const int64_t pos = kFromStart
                                ? 16 * v - r.shift + (__ffs(o) - 1) - r.s
                                : 16 * v - r.shift + (31 - __clz(o)) - r.s + 1;
        found = __shfl_sync(kFull, pos, __ffs(hit) - 1);
        break;
      }
    }
    if (lane == src) walk.result = found;
  }
  return walk.result;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    polya_tail_kernel(const uint8_t* __restrict__ values, int64_t n_values,
                      const int32_t* __restrict__ offsets, int64_t n,
                      const byteclass::Class cls, int32_t mode,
                      int32_t* __restrict__ out0,
                      int32_t* __restrict__ out1) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(values) & 15);
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = base + threadIdx.x;
    const bool live = r < n;
    const Row row{values, n_values, shift, live ? offsets[r] : 0,
                  live ? offsets[r + 1] : 0};
    const int64_t len = row.e - row.s;
    if (mode == kEnd) {
      const int64_t keep = run<K, false>(cls, row, live, 0, lane);
      if (live) out0[r] = static_cast<int32_t>(keep);
      continue;
    }
    const int64_t lead = run<K, true>(cls, row, live, len, lane);
    if (mode == kStart) {
      if (live) out0[r] = static_cast<int32_t>(lead);
      continue;
    }
    // a row whose leading run is all of it keeps nothing
    const int64_t keep = run<K, false>(cls, row, live && lead < len, 0, lane);
    if (live) {
      out0[r] = static_cast<int32_t>(lead);
      out1[r] = static_cast<int32_t>(keep);
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

// Calls f(integral_constant<K>) for a class test (1, 2, 4, 8 SWAR members,
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
// the 96-byte byteclass::Class (read before the call returns), k its test;
// mode 0 (from the end: kept lengths to out0), 1 (from the start: leading
// runs to out0) or 2 (both: leading runs to out0, kept lengths to out1);
// out0 and out1 int32 [n].
extern "C" int exon_polya_tail(const void* values, int64_t n_values,
                               const void* offsets, int64_t n,
                               const void* cls, int32_t k, int32_t mode,
                               void* out0, void* out1, void* stream) {
  if (mode < kEnd || mode > kBoth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  byteclass::Class c;
  std::memcpy(&c, cls, sizeof(c));
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const bool ok = with_test(k, [&](auto kk) {
    polya_tail_kernel<decltype(kk)::value>
        <<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(values), n_values,
            static_cast<const int32_t*>(offsets), n, c, mode,
            static_cast<int32_t*>(out0), static_cast<int32_t*>(out1));
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
