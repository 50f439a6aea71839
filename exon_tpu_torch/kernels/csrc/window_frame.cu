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
// peer_first, peer_last) and perm (sorted row -> input row); as the mode
// needs, the argument column in input order and in its own width (int8 to
// int64, uint8 or bool, float32 or float64) with its validity, which the
// kernel gathers through perm; for RANGE frames the sorted numeric ORDER BY
// key (negated for DESC) and its validity; and the arrays torch builds where
// the function needs one: the inclusive valid count (COUNT of a column,
// sum, avg, and min/max past LOOP_ROWS), the inclusive sum (int64 or
// float64), the dense-rank peer starts, and for min/max over frames wider
// than LOOP_ROWS (window_frame.py) a sparse table (level k holds the min or
// max of 2^k rows). Output (input order): one 64-bit word (0 where NULL) and
// a validity byte a row.
//
// Bound on the H100: HBM bytes the function must move, each once: perm, the
// bounds it reads, the column in its own width and its validity, a RANGE
// key and its validity, a prefix only where the function needs one, and the
// result and its validity. Query L's four calls over 1,008,303 rows: rank
// (perm, start, peer start, 9 bytes out) 25 bytes a row, 7.5 us at 3.35
// TB/s; lag(pos) and COUNT(*) RANGE 35 34 bytes, 10.2 us; MAX(qual) ROWS 5
// over float32 qual 30 bytes, 9.0 us.
//
// Design: each kind of function (the rank family, lag/lead, the picks and
// aggregates) is its own kernel, with only its own code and registers. A
// block takes a tile of kTile sorted rows, a thread one of them: a row's
// chain of dependent loads is the latency a block hides. Where the mode
// reads other rows' values (lag/lead within the halo, the picks and
// min/max over ROWS frames within it) the block first loads perm over the
// tile and a halo of kHalo rows on each side and gathers the column and its
// validity once into shared memory in their own width (float32 stays 4
// bytes and is widened in registers), each thread issuing all its loads
// before its stores; rows past the halo are read from device memory
// through perm. A RANGE frame stages its keys over the same rows and finds
// each bound by a galloping search from the row itself (probes at +-1, 2,
// 4, ... inside the partition's run of valid keys, then a binary search
// inside the bracket), which returns the index the binary search of the
// twin returns whenever the keys are ordered; a partition whose run of
// valid keys starts or ends with a NaN key takes the twin's binary search
// itself. COUNT(*) is hi - lo + 1 over a non-empty frame, and min/max over
// a frame of at most LOOP_ROWS rows count the valid values in their loop,
// so neither builds a prefix. Sum and avg are differences of the prefix
// arrays and min/max past LOOP_ROWS read two sparse-table entries, as
// before, so every mode equals its twin bit for bit; compares keep a NaN as
// jnp.minimum/maximum do. The store is the scatter out[perm[i]]; the rank
// family's and COUNT's results are never NULL, so their validity is written
// at the sorted index, coalesced, and only the value is scattered.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = kThreads;  // a row a thread
constexpr int kHalo = 64;  // LOOP_ROWS in window_frame.py
constexpr int kStaged = kTile + 2 * kHalo;
constexpr int kStageIters = (kStaged + kThreads - 1) / kThreads;

// modes (then the aggregates); the functions of each mode, in the order of
// window_frame.py's RANK_FNS, PICK_FNS and AGG_FNS (the last rank function
// is ntile, the first pick first_value)
constexpr int kRank = 0, kShift = 1, kPick = 2, kAggregate = 3;
constexpr int kRowNumber = 0, kRankFn = 1, kDenseRank = 2, kPercentRank = 3,
              kCumeDist = 4;
constexpr int kLast = 1, kNth = 2;
constexpr int kCount = 0, kSum = 1, kAvg = 2, kMax = 4;
// frames (the third is RANGE)
constexpr int kDefault = 0, kRows = 1;
// column types (window_frame.py's _COLUMN_KIND)
constexpr int kI64 = 0, kF64 = 1, kF32 = 2, kI32 = 3, kI16 = 4, kI8 = 5,
              kU8 = 6;
// key kinds (the third is float32)
constexpr int kKeyI64 = 0, kKeyF64 = 1;
// what a block stages
constexpr int kStageValues = 1, kStageKeys = 2;

}  // namespace

// Field order must match _ARGS in window_frame.py: 15 pointers, 5 int64,
// 12 int32 (208 bytes, no padding).
struct WindowFrameArgs {
  const int32_t* seg_start;
  const int32_t* seg_end;
  const int32_t* peer_first;
  const int32_t* peer_last;
  const int64_t* perm;
  const void* values;         // the column, input order, its own width
  const bool* valid;          // its validity, input order
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
  int32_t column;             // the column's type
  int32_t is_float;           // the result words are doubles
  int32_t key_kind;
  int32_t levels;
  int32_t loop;               // min/max: loop over the frame, no table
  int32_t has_default;
  int32_t stage;              // kStageValues | kStageKeys
};
static_assert(sizeof(WindowFrameArgs) == 208, "the layout of _ARGS");

namespace {

__device__ __forceinline__ int64_t as_word(double d) {
  return __double_as_longlong(d);
}

__device__ __forceinline__ double as_double(int64_t w) {
  return __longlong_as_double(w);
}

// element i of a column of type `column`, as a 64-bit word: integers sign-
// (uint8: zero-) extended, float32 widened to double bits
__device__ __forceinline__ int64_t load_word(const void* base, int64_t i,
                                             int column) {
  switch (column) {
    case kI64:
    case kF64: return static_cast<const int64_t*>(base)[i];
    case kF32:
      return as_word(static_cast<double>(static_cast<const float*>(base)[i]));
    case kI32: return static_cast<const int32_t*>(base)[i];
    case kI16: return static_cast<const int16_t*>(base)[i];
    case kI8: return static_cast<const int8_t*>(base)[i];
    case kU8:
    default: return static_cast<const uint8_t*>(base)[i];
  }
}

__device__ __forceinline__ int column_size(int column) {
  switch (column) {
    case kI64:
    case kF64: return 8;
    case kF32:
    case kI32: return 4;
    case kI16: return 2;
    default: return 1;
  }
}

// min or max of two words; a NaN wins, as in jnp.minimum/maximum
__device__ __forceinline__ int64_t extreme(int64_t a, int64_t b, bool is_max,
                                          bool fl) {
  if (!fl) return is_max ? (a > b ? a : b) : (a < b ? a : b);
  const double x = as_double(a), y = as_double(b);
  if (x != x) return a;
  if (y != y) return b;
  return is_max ? (x > y ? a : b) : (x < y ? a : b);
}

__device__ __forceinline__ int64_t clip(int64_t x, int64_t n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

// The block's staged rows [lo, hi) of the sorted order: perm, the column's
// raw elements and validity, the RANGE keys; rows outside come from device
// memory.
struct Stage {
  int64_t lo, hi, base;  // base: the sorted row of index 0
  int64_t* perm;
  unsigned char* values;
  bool* valid;
  unsigned char* keys;
};

__device__ __forceinline__ bool staged(const Stage& st, int64_t j) {
  return j >= st.lo && j < st.hi;
}

__device__ __forceinline__ int64_t value_at(const WindowFrameArgs& p,
                                            const Stage& st, int64_t j,
                                            bool* ok) {
  if ((p.stage & kStageValues) && staged(st, j)) {
    *ok = st.valid[j - st.base];
    return load_word(st.values, j - st.base, p.column);
  }
  const int64_t src = p.perm[j];
  *ok = p.valid[src];
  return load_word(p.values, src, p.column);
}

template <typename K>
__device__ __forceinline__ K key_at(const WindowFrameArgs& p,
                                    const Stage& st, int64_t j) {
  if ((p.stage & kStageKeys) && staged(st, j)) {
    return reinterpret_cast<const K*>(st.keys)[j - st.base];
  }
  return static_cast<const K*>(p.key)[j];
}

template <typename K>
__device__ __forceinline__ bool before_target(K v, K target, bool strict) {
  return strict ? v <= target : v < target;
}

template <typename K>
__device__ __forceinline__ K shifted(K k, int64_t off) {
  return k + static_cast<K>(off);
}

template <>
__device__ __forceinline__ int64_t shifted<int64_t>(int64_t k, int64_t off) {
  // wraps as torch's int64 addition does
  return static_cast<int64_t>(static_cast<uint64_t>(k) +
                              static_cast<uint64_t>(off));
}

template <typename K>
__device__ __forceinline__ bool is_nan(K v) { return v != v; }

// smallest j in [a, b + 1) whose key is >= target (strict: > target)
template <typename K>
__device__ int64_t range_search(const WindowFrameArgs& p, const Stage& st,
                                int64_t i, int64_t a, int64_t b,
                                int64_t off, bool strict) {
  const K target = shifted<K>(key_at<K>(p, st, i), off);
  int64_t lo = a, hi = b + 1;
  if (!is_nan(key_at<K>(p, st, a)) && !is_nan(key_at<K>(p, st, b))) {
    // the run is ordered: gallop from row i to a bracket [lo, hi]
    if (before_target(key_at<K>(p, st, i), target, strict)) {
      lo = i + 1;
      for (int64_t step = 1;; step <<= 1) {
        const int64_t j = i + step;
        if (j > b) break;
        if (!before_target(key_at<K>(p, st, j), target, strict)) {
          hi = j;
          break;
        }
        lo = j + 1;
      }
    } else {
      hi = i;
      for (int64_t step = 1;; step <<= 1) {
        const int64_t j = i - step;
        if (j < a) break;
        if (before_target(key_at<K>(p, st, j), target, strict)) {
          lo = j + 1;
          break;
        }
        hi = j;
      }
    }
  }
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (before_target(key_at<K>(p, st, mid), target, strict)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ int64_t range_bound(const WindowFrameArgs& p, const Stage& st,
                               int64_t i, int64_t a, int64_t b, bool upper) {
  const int64_t off = upper ? p.hi_off : p.lo_off;
  if (p.key_kind == kKeyI64) {
    return range_search<int64_t>(p, st, i, a, b, off, upper);
  }
  if (p.key_kind == kKeyF64) {
    return range_search<double>(p, st, i, a, b, off, upper);
  }
  return range_search<float>(p, st, i, a, b, off, upper);
}

// the frame [lo, hi] of sorted row i (before clipping to the partition)
__device__ void frame_of(const WindowFrameArgs& p, const Stage& st,
                         int64_t i, int64_t s, int64_t e, int64_t* lo,
                         int64_t* hi) {
  if (p.frame == kDefault) {
    *lo = s;
    *hi = p.peer_last[i];
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
  *lo = p.lo_unbounded ? s : (kv ? range_bound(p, st, i, nns, nne, false)
                                 : null_lo);
  *hi = p.hi_unbounded ? e : (kv ? range_bound(p, st, i, nns, nne, true) - 1
                                 : null_hi);
}

// a column element as a 64-bit word (load_word's widening)
template <typename T>
__device__ __forceinline__ int64_t to_word(T v) {
  return static_cast<int64_t>(v);
}
template <>
__device__ __forceinline__ int64_t to_word<float>(float v) {
  return as_word(static_cast<double>(v));
}
template <>
__device__ __forceinline__ int64_t to_word<double>(double v) {
  return as_word(v);
}

// min or max of two values of a column's type; a NaN wins (the first one)
template <typename T>
__device__ __forceinline__ T extreme_of(T a, T b, bool is_max) {
  if (a != a) return a;
  if (b != b) return b;
  return is_max ? (a > b ? a : b) : (a < b ? a : b);
}

// min or max over the sorted rows [loc, hic] of a column of type T, NULLs
// skipped, compared in T and widened once: the widening keeps the order
// and the NaN that wins; *any: a valid value was seen
template <typename T>
__device__ int64_t loop_extreme(const WindowFrameArgs& p, const Stage& st,
                                int64_t loc, int64_t hic, bool* any) {
  const bool is_max = p.fn == kMax;
  const bool staged_values = (p.stage & kStageValues) != 0;
  T acc = T();
  bool seen = false;
  for (int64_t j = loc; j <= hic; ++j) {
    T v;
    bool v_ok;
    if (staged_values && staged(st, j)) {
      v = reinterpret_cast<const T*>(st.values)[j - st.base];
      v_ok = st.valid[j - st.base];
    } else {
      const int64_t src = p.perm[j];
      v = static_cast<const T*>(p.values)[src];
      v_ok = p.valid[src];
    }
    if (v_ok) acc = seen ? extreme_of(acc, v, is_max) : v;
    seen |= v_ok;
  }
  *any = seen;
  return to_word(acc);
}

__device__ int64_t rank_row(const WindowFrameArgs& p, int64_t i) {
  const int64_t s = p.seg_start[i];
  switch (p.fn) {
    case kRowNumber: return i - s + 1;
    case kRankFn: return p.peer_first[i] - s + 1;
    case kDenseRank: return p.dense[i] - p.dense[s] + 1;
    default: break;
  }
  const int64_t np = p.seg_end[i] - s + 1;
  switch (p.fn) {
    case kPercentRank:
      return as_word(np > 1 ? static_cast<double>(p.peer_first[i] - s) /
                                  static_cast<double>(np - 1)
                            : 0.0);
    case kCumeDist:
      return as_word(static_cast<double>(p.peer_last[i] - s + 1) /
                     static_cast<double>(np > 1 ? np : 1));
    default: {  // ntile
      const int64_t r = i - s;
      const int64_t kk = p.offset < np ? p.offset : np;
      const int64_t base = np / kk;
      const int64_t rem = np % kk;
      const int64_t cut = rem * (base + 1);
      return (r < cut ? r / (base + 1 > 1 ? base + 1 : 1)
                      : rem + (r - cut) / (base > 1 ? base : 1)) + 1;
    }
  }
}

// the aggregate or pick of sorted row i over its frame
__device__ int64_t frame_row(const WindowFrameArgs& p, const Stage& st,
                             int64_t i, int64_t s, int64_t e, bool* ok) {
  const int64_t n = p.n;
  int64_t lo, hi;
  frame_of(p, st, i, s, e, &lo, &hi);
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
    bool v_ok;
    const int64_t res = value_at(p, st, pos, &v_ok);
    *ok = !empty && !short_frame && v_ok;
    return res;
  }
  const bool fl = p.is_float != 0;
  if (p.fn == kCount && p.cnt == nullptr) {  // COUNT(*): every row counts
    return empty ? 0 : hi - lo + 1;
  }
  if (p.loop) {  // min / max over a frame of at most LOOP_ROWS rows
    bool any = false;
    int64_t acc;
    switch (p.column) {
      case kI64: acc = loop_extreme<int64_t>(p, st, loc, hic, &any); break;
      case kF64: acc = loop_extreme<double>(p, st, loc, hic, &any); break;
      case kF32: acc = loop_extreme<float>(p, st, loc, hic, &any); break;
      case kI32: acc = loop_extreme<int32_t>(p, st, loc, hic, &any); break;
      case kI16: acc = loop_extreme<int16_t>(p, st, loc, hic, &any); break;
      case kI8: acc = loop_extreme<int8_t>(p, st, loc, hic, &any); break;
      default: acc = loop_extreme<uint8_t>(p, st, loc, hic, &any);
    }
    *ok = !empty && any;
    return acc;
  }
  const int64_t run_cnt =
      empty ? 0 : p.cnt[hic] - (lo > 0 ? p.cnt[lo - 1] : 0);
  if (p.fn == kCount) return run_cnt;
  if (p.fn == kSum || p.fn == kAvg) {
    *ok = run_cnt > 0;
    if (fl) {
      const double a = as_double(p.sum[hic]);
      const double b = lo > 0 ? as_double(p.sum[lo - 1]) : 0.0;
      const double sum = empty ? 0.0 : a - b;
      return p.fn == kAvg ? as_word(sum / static_cast<double>(
                                              run_cnt > 1 ? run_cnt : 1))
                          : as_word(sum);
    }
    const int64_t sum = empty ? 0 : p.sum[hic] - (lo > 0 ? p.sum[lo - 1] : 0);
    return p.fn == kAvg ? as_word(static_cast<double>(sum) /
                                  static_cast<double>(run_cnt > 1 ? run_cnt
                                                                  : 1))
                        : sum;
  }
  // min / max from two sparse-table entries
  const bool is_max = p.fn == kMax;
  const int64_t len = hic - loc + 1 > 1 ? hic - loc + 1 : 1;
  int k = 63 - __clzll(static_cast<unsigned long long>(len));
  if (k > p.levels - 1) k = p.levels - 1;
  const int64_t a = p.table[k * n + loc];
  const int64_t b = p.table[k * n + clip(hic - (1ll << k) + 1, n)];
  *ok = !empty && run_cnt > 0;
  return extreme(a, b, is_max, fl);
}

// the dynamic shared memory of a block: perm and the column's elements
// (8 bytes a row), the keys (8), the validity (1), as `stage` asks
__host__ __device__ __forceinline__ int stage_bytes(int stage) {
  return ((stage & kStageValues) ? kStaged * 17 : 0) +
         ((stage & kStageKeys) ? kStaged * 8 : 0);
}

// Stage the block's rows: every load of a thread issued before any of its
// stores, so a thread waits on memory twice (perm, then the gathers), not
// once a row.
__device__ __forceinline__ void stage_rows(const WindowFrameArgs& p,
                                           const Stage& st) {
  const int64_t j0 = st.lo + threadIdx.x;
  if (p.stage & kStageValues) {
    const int size = column_size(p.column);
    int64_t src[kStageIters];
#pragma unroll
    for (int q = 0; q < kStageIters; ++q) {
      const int64_t j = j0 + q * kThreads;
      src[q] = j < st.hi ? p.perm[j] : -1;
    }
    int64_t raw[kStageIters] = {};
    bool ok[kStageIters] = {};
#pragma unroll
    for (int q = 0; q < kStageIters; ++q) {
      if (src[q] < 0) continue;
      ok[q] = p.valid[src[q]];
      const unsigned char* from =
          static_cast<const unsigned char*>(p.values) + src[q] * size;
      switch (size) {
        case 8: raw[q] = *reinterpret_cast<const int64_t*>(from); break;
        case 4: raw[q] = *reinterpret_cast<const int32_t*>(from); break;
        case 2: raw[q] = *reinterpret_cast<const int16_t*>(from); break;
        default: raw[q] = *from;
      }
    }
#pragma unroll
    for (int q = 0; q < kStageIters; ++q) {
      if (src[q] < 0) continue;
      const int64_t at = j0 + q * kThreads - st.base;
      st.perm[at] = src[q];
      st.valid[at] = ok[q];
      switch (size) {
        case 8: reinterpret_cast<int64_t*>(st.values)[at] = raw[q]; break;
        case 4:
          reinterpret_cast<int32_t*>(st.values)[at] =
              static_cast<int32_t>(raw[q]);
          break;
        case 2:
          reinterpret_cast<int16_t*>(st.values)[at] =
              static_cast<int16_t>(raw[q]);
          break;
        default: st.values[at] = static_cast<unsigned char>(raw[q]);
      }
    }
  }
  if (p.stage & kStageKeys) {
    const bool wide = p.key_kind == kKeyI64 || p.key_kind == kKeyF64;
#pragma unroll
    for (int q = 0; q < kStageIters; ++q) {
      const int64_t j = j0 + q * kThreads;
      if (j >= st.hi) continue;
      if (wide) {
        reinterpret_cast<int64_t*>(st.keys)[j - st.base] =
            static_cast<const int64_t*>(p.key)[j];
      } else {
        reinterpret_cast<float*>(st.keys)[j - st.base] =
            static_cast<const float*>(p.key)[j];
      }
    }
  }
  __syncthreads();
}

// One kernel a kind of function (the rank family, lag/lead, the picks and
// aggregates), so each holds only its own code and registers.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
frame_kernel(const WindowFrameArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t n = p.n;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  Stage st;
  st.base = t0 - kHalo;
  st.lo = st.hi = 0;
  unsigned char* at = smem;
  st.perm = nullptr;
  st.values = st.keys = nullptr;
  st.valid = nullptr;
  const int64_t i = t0 + threadIdx.x;
  // the row's partition, loaded before the block stages its rows
  const int64_t s = kKind != kRank && i < n ? p.seg_start[i] : 0;
  const int64_t e = kKind != kRank && i < n ? p.seg_end[i] : 0;
  if (kKind != kRank && p.stage) {
    if (p.stage & kStageValues) {
      st.perm = reinterpret_cast<int64_t*>(at);
      st.values = at + kStaged * 8;
      at += kStaged * 16;
    }
    if (p.stage & kStageKeys) {
      st.keys = at;
      at += kStaged * 8;
    }
    if (p.stage & kStageValues) st.valid = reinterpret_cast<bool*>(at);
    st.lo = t0 - kHalo > 0 ? t0 - kHalo : 0;
    st.hi = t0 + kTile + kHalo < n ? t0 + kTile + kHalo : n;
    stage_rows(p, st);
  }
  if (i >= n) return;
  int64_t res;
  bool ok = true;
  if (kKind == kRank) {
    res = rank_row(p, i);
  } else if (kKind == kShift) {
    const int64_t src = i - p.offset;
    if (src >= s && src <= e) {
      res = value_at(p, st, src, &ok);
    } else {
      res = p.has_default ? p.default_word : 0;
      ok = p.has_default != 0;
    }
  } else {
    res = frame_row(p, st, i, s, e, &ok);
  }
  const int64_t dst = (p.stage & kStageValues) ? st.perm[i - st.base]
                                               : p.perm[i];
  p.out[dst] = ok ? res : 0;  // NULL rows hold 0
  // every row of the rank family and of a COUNT is valid: the validity is
  // written at the sorted index, coalesced, since perm covers every row
  const bool always =
      kKind == kRank || (p.mode == kAggregate && p.fn == kCount);
  p.out_valid[always ? i : dst] = ok;
}

}  // namespace

extern "C" int exon_window_frame(const WindowFrameArgs* args, void* stream) {
  if (args->n == 0) return 0;
  const int64_t blocks = (args->n + kTile - 1) / kTile;
  const int bytes = stage_bytes(args->stage);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->mode == kRank) {
    frame_kernel<kRank><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *args);
  } else if (args->mode == kShift) {
    frame_kernel<kShift><<<static_cast<unsigned>(blocks), kThreads, bytes,
                           s>>>(*args);
  } else {
    frame_kernel<kPick><<<static_cast<unsigned>(blocks), kThreads, bytes,
                          s>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
