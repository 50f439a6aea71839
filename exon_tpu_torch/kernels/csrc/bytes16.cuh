// bytes16.cuh: byte compares over a 16-byte word in 32-bit lanes, shared
// by like_match.cu, line_index.cu and text_records.cu.
//
// eq16 gives one bit a byte of a uint4 that equals a byte value (bit s for
// the byte at offset s, little-endian), with the exact zero-byte test of
// x = word ^ value: ~(((x & 0x7f..) + 0x7f..) | x) keeps a byte's high bit
// only where the byte is 0, with no carry between bytes. The four high bits
// of a 32-bit lane (bits 7, 15, 23, 31) then move to bits 28-31 in one
// multiply by 0x00204081, whose partial products never meet. fold4 maps
// ASCII 'a'-'z' to 'A'-'Z' in each byte of a 32-bit lane and leaves every
// other byte as it is (the case folding of exon_tpu's _upper_u8).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bytes16 {

__device__ __forceinline__ unsigned eq16(const uint4& w, unsigned rep) {
  const unsigned v[4] = {w.x, w.y, w.z, w.w};
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned x = v[j] ^ rep;
    const unsigned z = ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
    m |= ((z * 0x00204081u) >> 28) << (4 * j);
  }
  return m;
}

// The byte value b in every byte of a 32-bit lane, for eq16.
__device__ __forceinline__ unsigned splat(unsigned b) {
  return b * 0x01010101u;
}

__device__ __forceinline__ unsigned fold4(unsigned x) {
  const unsigned lo = x & 0x7f7f7f7fu;
  // high bit set where lo >= 'a' (0x61), and where lo > 'z' (0x7a)
  const unsigned ge_a = lo + 0x1f1f1f1fu;
  const unsigned gt_z = lo + 0x05050505u;
  const unsigned lower = ge_a & ~gt_z & ~x & 0x80808080u;
  return x ^ (lower >> 2);  // clear bit 5 (0x20) of each lower-case byte
}

__device__ __forceinline__ uint4 fold16(uint4 w) {
  return make_uint4(fold4(w.x), fold4(w.y), fold4(w.z), fold4(w.w));
}

__device__ __forceinline__ uint8_t fold1(uint8_t c) {
  return (c >= 'a' && c <= 'z') ? static_cast<uint8_t>(c - 32) : c;
}

}  // namespace bytes16
