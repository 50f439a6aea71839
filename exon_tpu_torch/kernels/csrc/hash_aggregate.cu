// hash_aggregate: grouped count/sum/min/max and sum-of-squares partials in
// one hash table that lives across every batch of a stream.
//
// Replaces the grouped aggregate of the JAX package: ops/aggregate.py
// sort_group_ids (:80) and grouped_reduce_codes (:30) as
// plan/physical.py _jit_grouped_partial (:565) uses them per batch, the
// n-way GroupTable merge (_merge_group_tables_fn :601, _merge_partial :642)
// and _compact_group_table (:659). There, every batch sorts its keys, builds
// a compacted table and folds it into the running state with another sort.
// The sum-of-squares op is K4b, the Σx² partial of the var/stddev family
// (_partial_for's _VAR_FNS branch, plan/physical.py:467-471, 485-490): the
// caller pairs it with a float64 sum over the same values, and the count
// rides along as for every aggregate.
//
// Bound on the H100: HBM bytes and atomic throughput. Each live row reads
// its key parts (9 bytes a part), its mask and its values (9 bytes an
// aggregate) once; the table takes atomics. With few groups (Query I's
// batch: 90 % of its rows in the 4 (chr1, SNV REF) groups; 25 seqnames)
// the atomics of a hot slot serialise in L2, with many groups (1 M keys)
// they are spread and the table's random accesses dominate.
//
// Table: open addressing with linear probing in global memory. A slot holds
//   state (int32): 0 empty, 1 being written, 2 full;
//   one int64 value and one validity byte per key part (a group key has any
//     number of columns, compared in full, so there are no hash collisions
//     between groups and every int64 value is a legal key);
//   first (int64): the smallest global row number seen in the group;
//   per aggregate an accumulator (int64, or float64 bits) and a count of
//     non-null inputs.
// A thread claims an empty slot with atomicCAS on its state word, writes the
// key parts, fences and publishes state 2; a thread that meets state 1 waits
// for 2 and then compares keys.
//
// Design: the rows of a warp are aggregated before they touch the table.
// Every lane hashes its row's key; a lane past n or dropped by the mask
// stays in the warp, inactive, so the warp's collectives see all 32 lanes.
// __match_any_sync groups the active lanes by their 64-bit hash, and the
// lowest lane of a group leads it. Each lane compares every key part and
// its validity with its leader's (__shfl_sync); a lane that differs (a true
// 64-bit collision) leaves the group and waits for a later round, so equal
// hashes never merge two keys. The leader alone probes the table and
// broadcasts the slot; every lane writes its own slot_out (-1 for a masked
// row or a full table). Per aggregate the lanes stage their count and value
// in shared memory, and the leader folds its group's live values in lane
// (row) order and issues one atomic per (group, aggregate): atomicAdd of the
// count (in raw mode the popcount of the live lanes), atomicAdd on the
// unsigned bits of an int64 sum, atomicAdd(double) of a float64 sum or sum
// of squares (x * x in raw mode, the partial itself in merge mode),
// atomicMin/Max for int64 and a CAS loop for float64 min/max (a NaN wins
// and is kept, in the fold as in the loop, as exon_tpu's .at[].min/max and
// the twin's scatter_reduce do; a slot without NaN pays nothing more);
// `first` takes
// atomicMin of the group's least row number (the leader's, in raw mode).
// At Query I's batch, 32 neighbouring position-sorted rows hold a few
// groups, so the hot slots' atomics fall several-fold.
//
// Identity values (0, +/-max, +/-inf) are written by the wrapper when it
// allocates the table; the wrapper keeps the load factor at or below one
// half and grows the table by re-inserting its full slots in merge mode,
// where each input row is one partial (a count and an accumulator) rather
// than a raw value. A probe that wraps the whole table sets an overflow
// flag that the wrapper turns into an error: rows are never dropped
// silently. The kernel allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAggs = 32;
constexpr unsigned kFull = 0xffffffffu;

enum AggOp : int32_t { kCount = 0, kSum = 1, kMin = 2, kMax = 3, kSumSq = 4 };

struct AggArgs {
  int32_t n_aggs;
  int32_t op[kMaxAggs];
  int32_t is_float[kMaxAggs];
  // raw mode: values [n] (int64 or float64) and valid flags uint8 [n];
  // merge mode: partial accumulators [n] and partial counts int64 [n]
  const void* values[kMaxAggs];
  const void* counts[kMaxAggs];
};

struct Table {
  int64_t capacity;  // a power of two
  int32_t* state;
  int64_t* keys;        // [n_parts, capacity]
  uint8_t* key_valid;   // [n_parts, capacity]
  int64_t* first;       // [capacity]
  int64_t* acc;         // [n_aggs, capacity]
  int64_t* cnt;         // [n_aggs, capacity]
  unsigned long long* meta;  // [0] groups created, [1] overflow flag
};

__device__ __forceinline__ uint64_t mix64(uint64_t h) {
  h += 0x9E3779B97F4A7C15ull;
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  return h ^ (h >> 31);
}

__device__ void atomic_min_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(a);
  // a NaN wins, and an accumulator that holds one keeps it
  for (;;) {
    const double cur = __longlong_as_double(static_cast<long long>(old));
    if (isnan(cur) || !(isnan(v) || v < cur)) break;
    const unsigned long long assumed = old;
    old = atomicCAS(a, assumed,
                    static_cast<unsigned long long>(__double_as_longlong(v)));
    if (old == assumed) break;
  }
}

__device__ void atomic_max_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(a);
  for (;;) {
    const double cur = __longlong_as_double(static_cast<long long>(old));
    if (isnan(cur) || !(isnan(v) || v > cur)) break;
    const unsigned long long assumed = old;
    old = atomicCAS(a, assumed,
                    static_cast<unsigned long long>(__double_as_longlong(v)));
    if (old == assumed) break;
  }
}

// The row's 64-bit key hash; the probe starts at its low bits.
__device__ __forceinline__ uint64_t key_hash(int32_t n_parts,
                                             const int64_t* __restrict__ parts,
                                             const uint8_t* __restrict__ part_valid,
                                             int64_t n, int64_t row) {
  uint64_t h = 0;
  for (int32_t p = 0; p < n_parts; ++p) {
    h = h * 1099511628211ull + static_cast<uint64_t>(parts[p * n + row]) +
        (part_valid[p * n + row] ? 1ull : 0ull);
  }
  return mix64(h);
}

// Finds or creates the slot of the row's key, whose hash is h; -1 when the
// table is full.
__device__ int64_t find_slot(const Table& t, int32_t n_parts,
                             const int64_t* __restrict__ parts,
                             const uint8_t* __restrict__ part_valid,
                             int64_t n, int64_t row, uint64_t h) {
  const int64_t mask = t.capacity - 1;
  int64_t slot = static_cast<int64_t>(h) & mask;
  for (int64_t probe = 0; probe < t.capacity; ++probe) {
    volatile int32_t* st = t.state + slot;
    int32_t s = *st;
    if (s == 0) {
      s = atomicCAS(t.state + slot, 0, 1);
      if (s == 0) {
        for (int32_t p = 0; p < n_parts; ++p) {
          t.keys[p * t.capacity + slot] = parts[p * n + row];
          t.key_valid[p * t.capacity + slot] = part_valid[p * n + row] ? 1 : 0;
        }
        __threadfence();
        atomicExch(t.state + slot, 2);
        atomicAdd(t.meta, 1ull);
        return slot;
      }
    }
    while (s == 1) s = *st;
    __threadfence();
    bool same = true;
    for (int32_t p = 0; p < n_parts && same; ++p) {
      const int64_t k =
          *reinterpret_cast<volatile int64_t*>(t.keys + p * t.capacity + slot);
      const uint8_t v = *reinterpret_cast<volatile uint8_t*>(
          t.key_valid + p * t.capacity + slot);
      same = k == parts[p * n + row] &&
             v == (part_valid[p * n + row] ? 1 : 0);
    }
    if (same) return slot;
    slot = (slot + 1) & mask;
  }
  atomicExch(t.meta + 1, 1ull);
  return -1;
}

// The leader's fold of aggregate op over the staged values of the lanes in
// live, in lane order, and its one atomic into dst.
__device__ void fold_and_add(int32_t op, bool is_float, unsigned live,
                             const long long* staged, int64_t* dst) {
  if (is_float) {
    double* d = reinterpret_cast<double*>(dst);
    if (op == kSum || op == kSumSq) {
      double s = __longlong_as_double(staged[__ffs(live) - 1]);
      for (unsigned m = live & (live - 1); m; m &= m - 1) {
        s += __longlong_as_double(staged[__ffs(m) - 1]);
      }
      atomicAdd(d, s);
      return;
    }
    // a NaN wins, as in exon_tpu and the twin: once acc is NaN it stays
    double acc = op == kMin ? __longlong_as_double(0x7ff0000000000000ll)
                            : __longlong_as_double(0xfff0000000000000ll);
    for (unsigned m = live; m && !isnan(acc); m &= m - 1) {
      const double v = __longlong_as_double(staged[__ffs(m) - 1]);
      if (isnan(v) || (op == kMin ? v < acc : v > acc)) acc = v;
    }
    if (op == kMin) atomic_min_f64(d, acc);
    else atomic_max_f64(d, acc);
    return;
  }
  long long acc = staged[__ffs(live) - 1];
  for (unsigned m = live & (live - 1); m; m &= m - 1) {
    const long long v = staged[__ffs(m) - 1];
    if (op == kSum) {
      acc = static_cast<long long>(static_cast<unsigned long long>(acc) +
                                   static_cast<unsigned long long>(v));
    } else if (op == kMin ? v < acc : v > acc) {
      acc = v;
    }
  }
  if (op == kSum) {
    atomicAdd(reinterpret_cast<unsigned long long*>(dst),
              static_cast<unsigned long long>(acc));
  } else if (op == kMin) {
    atomicMin(reinterpret_cast<long long*>(dst), acc);
  } else {
    atomicMax(reinterpret_cast<long long*>(dst), acc);
  }
}

__global__ void hash_aggregate_kernel(int64_t n, int32_t n_parts,
                                      const int64_t* __restrict__ parts,
                                      const uint8_t* __restrict__ part_valid,
                                      const uint8_t* __restrict__ row_mask,
                                      const int64_t* __restrict__ first_in,
                                      int64_t base_row, int32_t merge,
                                      AggArgs aggs, Table t,
                                      int64_t* __restrict__ slot_out) {
  __shared__ long long stage_c[kWarps][32];
  __shared__ long long stage_v[kWarps][32];
  const int lane = threadIdx.x & 31;
  long long* sc = stage_c[threadIdx.x >> 5];
  long long* sv = stage_v[threadIdx.x >> 5];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // no early return: every lane takes part in the warp's collectives
  bool pending = row < n && (row_mask == nullptr || row_mask[row] != 0);
  const uint64_t h =
      pending ? key_hash(n_parts, parts, part_valid, n, row) : 0;
  int64_t my_slot = -1;
  // one round per set of keys that share a hash in the warp: almost always
  // one; a true 64-bit collision takes another
  while (__any_sync(kFull, pending)) {
    const unsigned group =
        __match_any_sync(kFull, static_cast<unsigned long long>(h)) &
        __ballot_sync(kFull, pending);
    const int leader = pending ? __ffs(group) - 1 : lane;
    bool same = pending;
    for (int32_t p = 0; p < n_parts; ++p) {
      const long long k = pending ? parts[p * n + row] : 0;
      const int v = pending ? (part_valid[p * n + row] ? 1 : 0) : 0;
      // both shuffles run on every lane: none may skip a collective
      const long long lk = __shfl_sync(kFull, k, leader);
      const int lv = __shfl_sync(kFull, v, leader);
      same = same && lk == k && lv == v;
    }
    const unsigned mates = __ballot_sync(kFull, same) & group;
    const bool lead = pending && leader == lane;
    long long slot = -1;
    if (lead) slot = find_slot(t, n_parts, parts, part_valid, n, row, h);
    slot = __shfl_sync(kFull, slot, leader);
    if (same) my_slot = slot;
    const bool adds = same && slot >= 0;
    if (merge) {
      sc[lane] = adds ? first_in[row] : 0;
      __syncwarp();
      if (lead && slot >= 0) {
        long long f = sc[lane];
        for (unsigned m = mates; m; m &= m - 1) {
          const long long g = sc[__ffs(m) - 1];
          if (g < f) f = g;
        }
        atomicMin(reinterpret_cast<long long*>(t.first + slot), f);
      }
      __syncwarp();
    } else if (lead && slot >= 0) {
      // the leader's row is its group's first: the lowest lane
      atomicMin(reinterpret_cast<long long*>(t.first + slot),
                static_cast<long long>(base_row + row));
    }
    for (int32_t a = 0; a < aggs.n_aggs; ++a) {
      long long c = 0;
      if (adds) {
        c = merge ? static_cast<const int64_t*>(aggs.counts[a])[row]
                  : (static_cast<const uint8_t*>(aggs.counts[a])[row] ? 1 : 0);
      }
      const unsigned live = __ballot_sync(kFull, c != 0) & mates;
      const int32_t op = aggs.op[a];
      const bool is_float = aggs.is_float[a];
      long long v = 0;
      if (c != 0 && op != kCount) {
        if (is_float) {
          const double x = static_cast<const double*>(aggs.values[a])[row];
          v = __double_as_longlong(op == kSumSq && !merge ? x * x : x);
        } else {
          v = static_cast<const int64_t*>(aggs.values[a])[row];
        }
      }
      sc[lane] = c;
      sv[lane] = v;
      __syncwarp();
      if (lead && live) {
        const int64_t at = static_cast<int64_t>(a) * t.capacity + slot;
        long long total = __popc(live);
        if (merge) {
          total = 0;
          for (unsigned m = live; m; m &= m - 1) total += sc[__ffs(m) - 1];
        }
        atomicAdd(reinterpret_cast<unsigned long long*>(t.cnt + at),
                  static_cast<unsigned long long>(total));
        if (op != kCount) fold_and_add(op, is_float, live, sv, t.acc + at);
      }
      __syncwarp();
    }
    pending = pending && !same;
  }
  if (slot_out != nullptr && row < n) slot_out[row] = my_slot;
}

}  // namespace

// ops/is_float/values/counts are host arrays of n_aggs entries; every other
// pointer is device memory; slot_out may be null. Returns
// cudaGetLastError(), or -1 when n_aggs exceeds kMaxAggs or a sum of
// squares is not float64.
extern "C" int exon_hash_aggregate(
    int64_t n, int32_t n_parts, const void* parts, const void* part_valid,
    const void* row_mask, const void* first_in, int64_t base_row,
    int32_t merge, int32_t n_aggs, const int32_t* ops, const int32_t* is_float,
    const uint64_t* values, const uint64_t* counts, int64_t capacity,
    void* state, void* keys, void* key_valid, void* first, void* acc,
    void* cnt, void* meta, void* slot_out, void* stream) {
  if (n_aggs > kMaxAggs) return -1;
  for (int32_t a = 0; a < n_aggs; ++a) {
    if (ops[a] == kSumSq && !is_float[a]) return -1;
  }
  AggArgs args{};
  args.n_aggs = n_aggs;
  for (int32_t a = 0; a < n_aggs; ++a) {
    args.op[a] = ops[a];
    args.is_float[a] = is_float[a];
    args.values[a] = reinterpret_cast<const void*>(values[a]);
    args.counts[a] = reinterpret_cast<const void*>(counts[a]);
  }
  Table t;
  t.capacity = capacity;
  t.state = static_cast<int32_t*>(state);
  t.keys = static_cast<int64_t*>(keys);
  t.key_valid = static_cast<uint8_t*>(key_valid);
  t.first = static_cast<int64_t*>(first);
  t.acc = static_cast<int64_t*>(acc);
  t.cnt = static_cast<int64_t*>(cnt);
  t.meta = static_cast<unsigned long long*>(meta);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  hash_aggregate_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n, n_parts, static_cast<const int64_t*>(parts),
      static_cast<const uint8_t*>(part_valid),
      static_cast<const uint8_t*>(row_mask),
      static_cast<const int64_t*>(first_in), base_row, merge, args, t,
      static_cast<int64_t*>(slot_out));
  return static_cast<int>(cudaGetLastError());
}
