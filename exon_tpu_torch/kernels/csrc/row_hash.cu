// row_hash: 64-bit content hash per row of a var-width column.
//
// Replaces exon_tpu/plan/physical.py _hash_var (:831). The JAX version
// builds a per-byte row-id map, a power table P^k and a per-byte product,
// then scatter-adds every byte's contribution into its row: four passes
// over the bytes with int64 temporaries.
//
// Bound on the H100: HBM bytes, each row's bytes once plus 4 bytes of
// offsets and 8 bytes of output per row (bytes / 3.35 TB/s): a 131,072-row
// batch of ~38-byte read names moves about 6.4 MB, 0.0019 ms; D's
// 1,410,750 build-side names about 70 MB, 0.021 ms.
//
// Design: one thread per row runs the Horner form of the same polynomial,
// h = h * P + byte + 1 with uint64 wrap, which equals the JAX sum of
// (byte + 1) * P^(len-1-j) mod 2^64, then adds len * SALT and the
// splitmix64 finalizer: bit for bit _hash_bytes_host (:819). Neighbouring
// threads read neighbouring rows, so a warp's loads fall in a few hundred
// contiguous bytes and are served from L1/L2. Threads stride over rows.
//
// This loop (31 registers, no shared memory) stays because each redesign
// timed beside it on the card lost at D's build side, its largest input
// (PERF.md section 6, the K3 row): 16-byte words with eight bytes a
// dependent step (48 registers), with and without a warp for rows past 256
// bytes, aligned 4-byte words into the same chain, and a warp's rows staged
// in shared memory as coalesced 16-byte words, hashed from there a byte or
// eight bytes a step. A row of 64 KB is one thread's 64 K steps; no query
// hashes a key past a few hundred bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr uint64_t kPrime = 1099511628211ull;
constexpr uint64_t kSalt = 0x9E3779B97F4A7C15ull;

__global__ void row_hash_kernel(const int32_t* __restrict__ offsets,
                                const uint8_t* __restrict__ values,
                                int64_t n, int64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    const int32_t start = offsets[r];
    const int32_t end = offsets[r + 1];
    uint64_t h = 0;
    for (int32_t p = start; p < end; ++p) {
      h = h * kPrime + static_cast<uint64_t>(values[p]) + 1ull;
    }
    h += static_cast<uint64_t>(end - start) * kSalt;
    h += 0x9E3779B97F4A7C15ull;
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
    h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
    h ^= h >> 31;
    out[r] = static_cast<int64_t>(h);
  }
}

}  // namespace

extern "C" int exon_row_hash(const void* offsets, const void* values,
                             int64_t n, void* out, void* stream) {
  if (n == 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  row_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const uint8_t*>(values), n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
