// map_lookup: per map row, the first entry whose key equals a literal.
//
// Replaces the search of exon_tpu/plan/expressions.py _map_lookup (:716):
// ops/strings.py equals_literal over every key, a per-entry row id by
// searchsorted over the map offsets, and a scatter-min of the matching
// entry ids into the rows. Here both passes are one: the result is the
// entry index, or -1 where the row has no such key. The caller takes the
// value through the list take of ops/layout.py.
//
// Bound on the H100: HBM bytes, the map offsets, every key's offsets and
// validity, the bytes of the keys whose length is the literal's, and one
// int32 written per row.
//
// Design: one warp per map row, warps striding over the rows. Lanes take
// neighbouring entries of the row; a key is compared only when it is
// valid and its length is the literal's, then byte by byte against the
// literal, which the launch carries in its parameters (constant bank, a
// broadcast to the warp). __ballot_sync over each 32-entry step gives the
// lowest matching lane, so the row ends at its first match, in entry
// order.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;
constexpr int kMaxLiteral = 1024;

struct Literal {
  int32_t len;
  uint8_t bytes[kMaxLiteral];
};

__global__ void map_lookup_kernel(const int32_t* __restrict__ map_offsets,
                                  const int32_t* __restrict__ key_offsets,
                                  const uint8_t* __restrict__ key_bytes,
                                  const bool* __restrict__ key_validity,
                                  int64_t n,
                                  const __grid_constant__ Literal lit,
                                  int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    const int64_t s = map_offsets[r];
    const int64_t e = map_offsets[r + 1];
    int32_t found = -1;
    for (int64_t base = s; base < e; base += 32) {
      const int64_t k = base + lane;
      bool match = false;
      if (k < e && key_validity[k]) {
        const int64_t ks = key_offsets[k];
        if (key_offsets[k + 1] - ks == lit.len) {
          match = true;
          for (int32_t j = 0; j < lit.len; ++j) {
            if (key_bytes[ks + j] != lit.bytes[j]) {
              match = false;
              break;
            }
          }
        }
      }
      const unsigned hits = __ballot_sync(0xffffffffu, match);
      if (hits != 0u) {
        found = static_cast<int32_t>(base + __ffs(hits) - 1);
        break;
      }
    }
    if (lane == 0) out[r] = found;
  }
}

}  // namespace

extern "C" int exon_map_lookup(const void* map_offsets,
                               const void* key_offsets, const void* key_bytes,
                               const void* key_validity, int64_t n,
                               const void* literal, int32_t literal_len,
                               void* out, void* stream) {
  if (literal_len < 0 || literal_len > kMaxLiteral) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Literal lit;
  lit.len = literal_len;
  if (literal_len > 0) std::memcpy(lit.bytes, literal, literal_len);
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  map_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(map_offsets),
      static_cast<const int32_t*>(key_offsets),
      static_cast<const uint8_t*>(key_bytes),
      static_cast<const bool*>(key_validity), n, lit,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
