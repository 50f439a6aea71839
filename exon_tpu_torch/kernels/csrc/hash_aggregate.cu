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
// aggregate) once and issues a few atomics into the table; with few groups
// (25 seqnames) those atomics contend on the same slots and serialise in L2,
// with many groups (1 M keys) they are spread and the table's random
// accesses dominate.
//
// Design: open addressing with linear probing in global memory. A slot holds
//   state (int32): 0 empty, 1 being written, 2 full;
//   one int64 value and one validity byte per key part (a group key is up to
//     kMaxParts columns, compared in full, so there are no hash collisions
//     between groups and every int64 value is a legal key);
//   first (int64): the smallest global row number seen in the group;
//   per aggregate an accumulator (int64, or float64 bits) and a count of
//     non-null inputs.
// A thread claims an empty slot with atomicCAS on its state word, writes the
// key parts, fences and publishes state 2; a thread that meets state 1 waits
// for 2 and then compares keys. It then updates first with atomicMin, the
// count with atomicAdd, int64 sums with atomicAdd on the unsigned bits,
// float64 sums with atomicAdd(double), int64 min/max with atomicMin/Max and
// float64 min/max with a CAS loop, and the sum of squares with
// atomicAdd(double) of x * x (of the partial itself in merge mode).
// Optionally each row's slot is written to slot_out (-1 for a masked row
// or a full table), in the same pass, so that the caller can map rows to
// groups without a second probe. Identity values (0, +/-max, +/-inf) are
// written by the wrapper when it allocates the table; the wrapper keeps the
// load factor at or below one half and grows the table by re-inserting its
// full slots in merge mode, where each input row is one partial (a count and
// an accumulator) rather than a raw value. A probe that wraps the whole
// table sets an overflow flag that the wrapper turns into an error: rows are
// never dropped silently. The kernel allocates nothing and does not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAggs = 32;

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
  while (v < __longlong_as_double(static_cast<long long>(old))) {
    const unsigned long long assumed = old;
    old = atomicCAS(a, assumed,
                    static_cast<unsigned long long>(__double_as_longlong(v)));
    if (old == assumed) break;
  }
}

__device__ void atomic_max_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(a);
  while (v > __longlong_as_double(static_cast<long long>(old))) {
    const unsigned long long assumed = old;
    old = atomicCAS(a, assumed,
                    static_cast<unsigned long long>(__double_as_longlong(v)));
    if (old == assumed) break;
  }
}

// Finds or creates the slot of the row's key; -1 when the table is full.
__device__ int64_t find_slot(const Table& t, int32_t n_parts,
                             const int64_t* __restrict__ parts,
                             const uint8_t* __restrict__ part_valid,
                             int64_t n, int64_t row) {
  uint64_t h = 0;
  for (int32_t p = 0; p < n_parts; ++p) {
    h = h * 1099511628211ull + static_cast<uint64_t>(parts[p * n + row]) +
        (part_valid[p * n + row] ? 1ull : 0ull);
  }
  const int64_t mask = t.capacity - 1;
  int64_t slot = static_cast<int64_t>(mix64(h)) & mask;
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

__global__ void hash_aggregate_kernel(int64_t n, int32_t n_parts,
                                      const int64_t* __restrict__ parts,
                                      const uint8_t* __restrict__ part_valid,
                                      const uint8_t* __restrict__ row_mask,
                                      const int64_t* __restrict__ first_in,
                                      int64_t base_row, int32_t merge,
                                      AggArgs aggs, Table t,
                                      int64_t* __restrict__ slot_out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const int64_t slot = (row_mask != nullptr && row_mask[row] == 0)
                           ? -1
                           : find_slot(t, n_parts, parts, part_valid, n, row);
  if (slot_out != nullptr) slot_out[row] = slot;
  if (slot < 0) return;
  const int64_t first = merge ? first_in[row] : base_row + row;
  atomicMin(reinterpret_cast<long long*>(t.first + slot),
            static_cast<long long>(first));
  for (int32_t a = 0; a < aggs.n_aggs; ++a) {
    const int64_t c =
        merge ? static_cast<const int64_t*>(aggs.counts[a])[row]
              : (static_cast<const uint8_t*>(aggs.counts[a])[row] ? 1 : 0);
    if (c == 0) continue;
    const int64_t at = static_cast<int64_t>(a) * t.capacity + slot;
    atomicAdd(reinterpret_cast<unsigned long long*>(t.cnt + at),
              static_cast<unsigned long long>(c));
    const int32_t op = aggs.op[a];
    if (op == kCount) continue;
    if (aggs.is_float[a]) {
      const double v = static_cast<const double*>(aggs.values[a])[row];
      double* dst = reinterpret_cast<double*>(t.acc + at);
      if (op == kSum) atomicAdd(dst, v);
      else if (op == kSumSq) atomicAdd(dst, merge ? v : v * v);
      else if (op == kMin) atomic_min_f64(dst, v);
      else atomic_max_f64(dst, v);
    } else {
      const int64_t v = static_cast<const int64_t*>(aggs.values[a])[row];
      if (op == kSum) {
        atomicAdd(reinterpret_cast<unsigned long long*>(t.acc + at),
                  static_cast<unsigned long long>(v));
      } else if (op == kMin) {
        atomicMin(reinterpret_cast<long long*>(t.acc + at),
                  static_cast<long long>(v));
      } else {
        atomicMax(reinterpret_cast<long long*>(t.acc + at),
                  static_cast<long long>(v));
      }
    }
  }
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
