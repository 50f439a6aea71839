// window_frame: each row's window result, written back in input order.
//
// Replaces the per-function part of exon_tpu/plan/window_exec.py: the rank
// family of _window_column (:151-186), the value picks (:220-234),
// _window_shift (:438-453), _window_aggregate (:263-425) with _bsearch
// (:243) and the scatter to input order (:238-240). The JAX version runs
// each function as its own chain of gathers and selects over n (the RANGE
// search as ~21 full-width passes, min/max over a ~log2(n)-level sparse
// table), then scatters the result and its validity back.
//
// Input (sorted order): the bounds of window_bounds.cu (seg_start, seg_end,
// peer_first, peer_last), perm (sorted row -> input row), and as the mode
// needs: the values as 64-bit words (int64, or float64 bits) and their
// validity; the inclusive prefix arrays torch builds (valid count, sum in
// int64 or float64, dense-rank peer starts); for RANGE frames the sorted
// numeric ORDER BY key (negated for DESC) and its validity; for min/max
// over frames wider than LOOP_ROWS (window_frame.py), a sparse table torch builds (level k
// holds the min or max of 2^k rows). Output (input order): one 64-bit word
// (0 where NULL) and a validity byte a row.
//
// Bound on the H100: the columns the mode reads, each once, and the result
// and validity written once: for Query L's count over a RANGE frame, the
// key (8 B), its validity, perm (8 B), the four bounds (16 B) and the count
// prefix (8 B) a row in, 9 B a row out: ~50 B a row, 1,008,303 rows, about
// 15 us at 3.35 TB/s.
//
// Design: one thread per sorted row. The frame's first and last row come
// from the bounds (ROWS: offsets clipped to the partition; RANGE: a binary
// search over the partition's run of valid keys, found from the bounds of
// its NULL peer group; default: partition start to the last peer). Count,
// sum and avg are differences of the prefix arrays, so the kernel equals
// its twin bit for bit; min/max loop over a frame of at most LOOP_ROWS rows
// and read two sparse-table entries otherwise, with compares that keep a
// NaN as jnp.minimum/maximum do. The store is the scatter: out[perm[i]].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

// modes (then the aggregates); the functions of each mode, in the order of
// window_frame.py's RANK_FNS, PICK_FNS and AGG_FNS (the last rank function
// is ntile, the first pick first_value)
constexpr int kRank = 0, kShift = 1, kPick = 2;
constexpr int kRowNumber = 0, kRankFn = 1, kDenseRank = 2, kPercentRank = 3,
              kCumeDist = 4;
constexpr int kLast = 1, kNth = 2;
constexpr int kCount = 0, kSum = 1, kAvg = 2, kMax = 4;
// frames (the third is RANGE)
constexpr int kDefault = 0, kRows = 1;
// value and key kinds (the third key kind is float32)
constexpr int kInt64 = 0, kFloat64 = 1;

}  // namespace

// Field order must match WindowFrameArgs in window_frame.py.
struct WindowFrameArgs {
  const int32_t* seg_start;
  const int32_t* seg_end;
  const int32_t* peer_first;
  const int32_t* peer_last;
  const int64_t* perm;
  const int64_t* values;      // sorted 64-bit words
  const bool* valid;          // sorted validity of the values
  const int64_t* cnt;         // inclusive prefix count of valid values
  const int64_t* sum;         // inclusive prefix sum (int64 or double bits)
  const int64_t* dense;       // inclusive prefix count of peer starts
  const int64_t* table;       // sparse table [levels, n]
  const void* key;            // RANGE key, sorted, negated for DESC
  const bool* key_valid;
  int64_t* out;
  bool* out_valid;
  int64_t n;
  int64_t offset;             // lag/lead row shift, ntile k, nth_value n
  int64_t lo_off;
  int64_t hi_off;
  int64_t default_word;
  int32_t mode;
  int32_t fn;
  int32_t frame;
  int32_t lo_unbounded;
  int32_t hi_unbounded;
  int32_t value_kind;
  int32_t key_kind;
  int32_t levels;
  int32_t loop;               // min/max: loop over the frame, no table
  int32_t has_default;
};

namespace {

__device__ __forceinline__ int64_t as_word(double d) {
  return __double_as_longlong(d);
}

__device__ __forceinline__ double as_double(int64_t w) {
  return __longlong_as_double(w);
}

// min or max of two words of the value kind; a NaN wins, as in
// jnp.minimum/maximum
__device__ __forceinline__ int64_t extreme(int64_t a, int64_t b, bool is_max,
                                          int kind) {
  if (kind == kInt64) return is_max ? (a > b ? a : b) : (a < b ? a : b);
  const double x = as_double(a), y = as_double(b);
  if (x != x) return a;
  if (y != y) return b;
  return is_max ? (x > y ? a : b) : (x < y ? a : b);
}

__device__ __forceinline__ int64_t identity(bool is_max, int kind) {
  if (kind == kInt64) return is_max ? INT64_MIN : INT64_MAX;
  return as_word(is_max ? -__longlong_as_double(0x7ff0000000000000ll)
                        : __longlong_as_double(0x7ff0000000000000ll));
}

// smallest j in [lo, hi + 1) whose key is >= target (strict: > target)
template <typename K>
__device__ __forceinline__ int64_t search(const K* key, int64_t lo,
                                          int64_t hi, K target, bool strict) {
  int64_t a = lo, b = hi + 1;
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    const K v = key[mid];
    if (strict ? v <= target : v < target) a = mid + 1; else b = mid;
  }
  return a;
}

__device__ int64_t range_bound(const WindowFrameArgs& p, int64_t i,
                               int64_t lo, int64_t hi, bool upper) {
  const int64_t off = upper ? p.hi_off : p.lo_off;
  if (p.key_kind == kInt64) {
    const int64_t* k = static_cast<const int64_t*>(p.key);
    return search<int64_t>(k, lo, hi, k[i] + off, upper);
  }
  if (p.key_kind == kFloat64) {
    const double* k = static_cast<const double*>(p.key);
    return search<double>(k, lo, hi, k[i] + static_cast<double>(off), upper);
  }
  const float* k = static_cast<const float*>(p.key);
  return search<float>(k, lo, hi, k[i] + static_cast<float>(off), upper);
}

// the frame [lo, hi] of sorted row i (before clipping to the partition)
__device__ void frame_of(const WindowFrameArgs& p, int64_t i, int64_t s,
                         int64_t e, int64_t pl, int64_t* lo, int64_t* hi) {
  if (p.frame == kDefault) {
    *lo = s;
    *hi = pl;
    return;
  }
  if (p.frame == kRows) {
    *lo = p.lo_unbounded ? s : i + p.lo_off;
    *hi = p.hi_unbounded ? e : i + p.hi_off;
    return;
  }
  // RANGE: the partition's NULL keys are one peer group at one end; the
  // valid keys run from nns to nne
  const int64_t nns = p.key_valid[s] ? s : p.peer_last[s] + 1;
  const int64_t nne = p.key_valid[e] ? e : p.peer_first[e] - 1;
  const bool kv = p.key_valid[i];
  const bool before = i < nns;
  const int64_t null_lo = before ? s : nne + 1;
  const int64_t null_hi = before ? (nns - 1 < e ? nns - 1 : e) : e;
  *lo = p.lo_unbounded ? s : (kv ? range_bound(p, i, nns, nne, false)
                                 : null_lo);
  *hi = p.hi_unbounded ? e : (kv ? range_bound(p, i, nns, nne, true) - 1
                                 : null_hi);
}

__device__ __forceinline__ int64_t clip(int64_t x, int64_t n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

__device__ void rank_row(const WindowFrameArgs& p, int64_t i, int64_t s,
                         int64_t e, int64_t pf, int64_t pl, int64_t* res) {
  const int64_t np = e - s + 1;
  switch (p.fn) {
    case kRowNumber: *res = i - s + 1; break;
    case kRankFn: *res = pf - s + 1; break;
    case kDenseRank: *res = p.dense[i] - p.dense[s] + 1; break;
    case kPercentRank:
      *res = as_word(np > 1 ? static_cast<double>(pf - s) /
                                  static_cast<double>(np - 1)
                            : 0.0);
      break;
    case kCumeDist:
      *res = as_word(static_cast<double>(pl - s + 1) /
                     static_cast<double>(np > 1 ? np : 1));
      break;
    default: {  // ntile
      const int64_t r = i - s;
      const int64_t kk = p.offset < np ? p.offset : np;
      const int64_t base = np / kk;
      const int64_t rem = np % kk;
      const int64_t cut = rem * (base + 1);
      *res = (r < cut ? r / (base + 1 > 1 ? base + 1 : 1)
                      : rem + (r - cut) / (base > 1 ? base : 1)) + 1;
    }
  }
}

__global__ void frame_kernel(const WindowFrameArgs p) {
  const int64_t n = p.n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int64_t s = p.seg_start[i], e = p.seg_end[i];
    const int64_t pf = p.peer_first[i], pl = p.peer_last[i];
    int64_t res = 0;
    bool ok = true;
    if (p.mode == kRank) {
      rank_row(p, i, s, e, pf, pl, &res);
    } else if (p.mode == kShift) {
      const int64_t src = i - p.offset;
      if (src >= s && src <= e) {
        res = p.values[src];
        ok = p.valid[src];
      } else {
        res = p.has_default ? p.default_word : 0;
        ok = p.has_default != 0;
      }
    } else {
      int64_t lo, hi;
      frame_of(p, i, s, e, pl, &lo, &hi);
      if (lo < s) lo = s;
      if (hi > e) hi = e;
      const bool empty = hi < lo;
      const int64_t loc = clip(lo, n), hic = clip(hi, n);
      if (p.mode == kPick) {
        int64_t pos = p.fn == kLast ? hic : loc;
        bool short_frame = false;
        if (p.fn == kNth) {
          const int64_t raw = loc + p.offset - 1;
          pos = clip(raw, n);
          short_frame = raw > hic;
        }
        res = p.values[pos];
        ok = !empty && !short_frame && p.valid[pos];
      } else {
        const int64_t run_cnt =
            empty ? 0 : p.cnt[hic] - (lo > 0 ? p.cnt[lo - 1] : 0);
        if (p.fn == kCount) {
          res = run_cnt;
        } else if (p.fn == kSum || p.fn == kAvg) {
          const bool fl = p.value_kind != kInt64;
          if (fl) {
            const double a = as_double(p.sum[hic]);
            const double b = lo > 0 ? as_double(p.sum[lo - 1]) : 0.0;
            const double sum = empty ? 0.0 : a - b;
            res = p.fn == kAvg
                      ? as_word(sum / static_cast<double>(
                                          run_cnt > 1 ? run_cnt : 1))
                      : as_word(sum);
          } else {
            const int64_t sum =
                empty ? 0 : p.sum[hic] - (lo > 0 ? p.sum[lo - 1] : 0);
            res = p.fn == kAvg
                      ? as_word(static_cast<double>(sum) /
                                static_cast<double>(run_cnt > 1 ? run_cnt
                                                                : 1))
                      : sum;
          }
          ok = run_cnt > 0;
        } else {  // min / max
          const bool is_max = p.fn == kMax;
          const int kind = p.value_kind == kInt64 ? kInt64 : kFloat64;
          if (p.loop) {
            int64_t acc = identity(is_max, kind);
            for (int64_t j = loc; j <= hic; ++j) {
              const int64_t x = p.valid[j] ? p.values[j]
                                           : identity(is_max, kind);
              acc = extreme(acc, x, is_max, kind);
            }
            res = acc;
          } else {
            const int64_t len = hic - loc + 1 > 1 ? hic - loc + 1 : 1;
            int k = 63 - __clzll(static_cast<unsigned long long>(len));
            if (k > p.levels - 1) k = p.levels - 1;
            const int64_t a = p.table[k * n + loc];
            const int64_t b = p.table[k * n + clip(hic - (1ll << k) + 1, n)];
            res = extreme(a, b, is_max, kind);
          }
          ok = !empty && run_cnt > 0;
        }
      }
    }
    const int64_t dst = p.perm[i];
    p.out[dst] = ok ? res : 0;  // NULL rows hold 0
    p.out_valid[dst] = ok;
  }
}

}  // namespace

extern "C" int exon_window_frame(const WindowFrameArgs* args, void* stream) {
  if (args->n == 0) return 0;
  int64_t blocks = (args->n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  frame_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
