// sort_keys: the int64 ORDER BY key matrix of a batch, every key in one
// launch.
//
// Replaces exon_tpu/plan/physical.py sort_key_columns (:1372) with
// _to_sortable_i64 (:1486), _invert_key (:1499) and, for var-width keys,
// exon_tpu/ops/layout.py gather_prefix (:60). The JAX version gathers a
// [rows, 8 * nchunks] prefix matrix (one int32 index per byte) and folds it
// with eight shift-or passes per chunk, each a full [rows] int64 temporary.
//
// Bound on the H100: HBM bytes (bytes / 3.35 TB/s), the writes of 8 bytes
// per row per key row, plus each key's validity and a fixed key's values at
// their own width, or a string key's int32 offsets (once: neighbouring rows
// share them) and up to 8 * nchunks bytes a row, read once: Query C's 1.5 M
// rows x 13 key rows write 156 MB and read about 106 MB, 0.0781 ms.
//
// Design. The first design launched once per sort key plus a fill of the
// padding row, each launch after its own host checks and ctypes call, and a
// var key's thread read its row a byte at a time (8 * nchunks byte loads, a
// length test on each). Here:
//  - One launch writes the whole matrix, row 0 (the padding flag, all 0)
//    included. The keys travel by value in the launch's parameters (a
//    SortKeys block of up to kMaxKeys key descriptions: pointers, kind,
//    nchunks, direction, NULL placement and first output row), so nothing
//    is uploaded and nothing syncs; a call with more keys takes as many
//    launches as it needs, the wrapper's loop.
//  - A block takes tiles of 256 consecutive rows, a thread a row, and walks
//    the keys in turn. Stores stay a thread a row: a warp writes 32
//    consecutive int64 of one key row.
//  - A var key's thread reads its own row's bytes in place as 16-byte
//    words (copy16::load_run: two aligned 16-byte loads funnel-shifted to
//    the row's alignment, byte loads only within 16 bytes of the end of
//    values, never past it), two chunks a word, only the words that hold
//    the row's first 8 * nchunks bytes. Each chunk is two byte reversals
//    (__byte_perm) to big-endian and a mask for the bytes past the row's
//    end; then the sign bit is flipped, and DESC inverts. Staging a tile's
//    byte range in shared memory by cp.async first (two block syncs a var
//    key a tile) was measured and lost to these reads at C's, D's and L's
//    keys (PERF.md section 6, the K5 row): neighbouring rows share the
//    words' sectors, so L1 already gives a warp its rows' bytes once from
//    device memory.
//  - Fixed keys keep their arithmetic (floats by their IEEE bits), in the
//    same launch.
//
// nulls mode: 0 default (ASC nulls last, DESC nulls first), 1 NULLS FIRST,
// 2 NULLS LAST. Kinds: 0 int64, 1 int32, 2 float64, 3 float32, 4 uint8 or
// bool, 5 int16, 6 int8, 7 a var key.

#include <cstdint>
#include <cuda_runtime.h>

#include "copy16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kMaxKeys = 16;  // kernels/sort_keys.py MAX_KEYS
constexpr int kVar = 7;
constexpr uint64_t kSign = 1ull << 63;

// One key, as the wrapper's ctypes structure lays it out (56 bytes).
struct SortKey {
  const int32_t* offsets;  // a var key's, else null
  const void* values;
  const bool* valid;
  int64_t n_values;  // a var key's bytes in values
  int32_t kind;
  int32_t nchunks;
  int32_t asc;
  int32_t mode;
  int64_t row;  // the key's first row of the matrix
};

struct SortKeys {
  SortKey keys[kMaxKeys];
  int64_t* out;
  int64_t n;
  int32_t nkeys;
  int32_t zero_row;
};

__device__ __forceinline__ int64_t validity_key(bool valid, bool asc,
                                                int mode) {
  if (mode == 1) return valid ? 1 : 0;
  if (mode == 2) return valid ? 0 : 1;
  const int64_t vk = valid ? 0 : 1;
  return asc ? vk : -1 - vk;
}

__device__ __forceinline__ int64_t sortable_double(double f) {
  const int64_t bits = __double_as_longlong(f);
  const uint64_t flipped = bits < 0 ? ~static_cast<uint64_t>(bits)
                                    : static_cast<uint64_t>(bits) | kSign;
  return static_cast<int64_t>(flipped ^ kSign);
}

__device__ __forceinline__ int64_t fixed_value(const void* values, int kind,
                                               int64_t r) {
  switch (kind) {
    case 0: return static_cast<const int64_t*>(values)[r];
    case 1: return static_cast<const int32_t*>(values)[r];
    case 2: return sortable_double(static_cast<const double*>(values)[r]);
    case 3: return sortable_double(
                static_cast<double>(static_cast<const float*>(values)[r]));
    case 5: return static_cast<const int16_t*>(values)[r];
    case 6: return static_cast<const int8_t*>(values)[r];
    default: return static_cast<const uint8_t*>(values)[r];
  }
}

// The key row of a chunk: the 8 bytes lo (first 4) and hi as a big-endian
// uint64, the bytes past the row's end (rem < 8 of them kept) zeroed, the
// sign bit flipped, inverted for DESC.
__device__ __forceinline__ int64_t chunk_key(unsigned lo, unsigned hi,
                                             int32_t rem, bool asc) {
  uint64_t k = (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) |
               __byte_perm(hi, 0, 0x0123);
  if (rem <= 0) {
    k = 0;
  } else if (rem < 8) {
    k &= ~0ull << (8 * (8 - rem));
  }
  const int64_t s = static_cast<int64_t>(k ^ kSign);
  return asc ? s : -1 - s;
}

__global__ void __launch_bounds__(kThreads)
    sort_keys_kernel(const __grid_constant__ SortKeys p) {
  const int64_t n = p.n;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * kThreads; r0 < n;
       r0 += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = r0 + threadIdx.x;
    const bool live = r < n;
    if (p.zero_row && live) p.out[r] = 0;
    for (int j = 0; j < p.nkeys; ++j) {
      const SortKey& key = p.keys[j];
      int64_t* out = p.out + key.row * n + r;
      const bool asc = key.asc != 0;
      if (key.kind != kVar) {
        if (live) {
          const int64_t k = fixed_value(key.values, key.kind, r);
          out[0] = validity_key(key.valid[r], asc, key.mode);
          out[n] = asc ? k : -1 - k;
        }
        continue;
      }
      if (!live) continue;
      const int32_t* offsets = key.offsets;
      const uint8_t* values = static_cast<const uint8_t*>(key.values);
      const int32_t start = offsets[r];
      const int32_t len = offsets[r + 1] - start;
      out[0] = validity_key(key.valid[r], asc, key.mode);
      for (int c = 0; c < key.nchunks; c += 2) {
        const int32_t rem = len - 8 * c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (rem > 0) {
          v = copy16::load_run(values, key.n_values, start + 8ll * c,
                               min(rem, 16));
        }
        out[(1 + static_cast<int64_t>(c)) * n] = chunk_key(v.x, v.y, rem,
                                                           asc);
        if (c + 1 < key.nchunks) {
          out[(2 + static_cast<int64_t>(c)) * n] =
              chunk_key(v.z, v.w, rem - 8, asc);
        }
      }
    }
  }
}

}  // namespace

// keys: nkeys (<= kMaxKeys) key descriptions; zero_row: whether this
// launch writes row 0.
extern "C" int exon_sort_keys(const void* keys, int nkeys, int64_t n,
                              int zero_row, void* out, void* stream) {
  if (n == 0) return 0;
  if (nkeys < 0 || nkeys > kMaxKeys) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SortKeys p{};
  const SortKey* k = static_cast<const SortKey*>(keys);
  for (int j = 0; j < nkeys; ++j) p.keys[j] = k[j];
  p.out = static_cast<int64_t*>(out);
  p.n = n;
  p.nkeys = nkeys;
  p.zero_row = zero_row;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sort_keys_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
