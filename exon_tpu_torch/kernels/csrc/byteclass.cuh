// byteclass.cuh: a class of byte values tested on 16-byte words in
// registers; shared by count_bytes.cu and polya_tail.cu.
//
// The class comes in the launch's parameters (a Class, 96 bytes, laid out
// by kernels/count_bytes.py class_params and cached there per class), and
// the kernel is instantiated for one of two tests, which the wrapper picks
// from the class once, on the host:
//   K = 1, 2, 4 or 8: a class that is the union of up to 8 cubes, each the
//     bytes b with b & m == v (a single member is the cube m = 0xff; {G, C,
//     g, c} is one cube, m = 0xdb, v = 0x43; any class of up to 8 members
//     has at most 8), by SWAR: one equality test a cube on each 32-bit lane
//     of a word. For y = (x & m * 0x01010101) ^ v * 0x01010101,
//     ((y & 0x7f..) + 0x7f..) | y keeps a byte's high bit clear exactly
//     where the byte is 0, with no carry between bytes (the cheaper
//     (y - 0x01..) & ~y flags bytes above a match too). The cubes' terms
//     are ANDed, so a byte's high bit ends clear where any cube matched; a
//     class of 3, 5, 6 or 7 cubes repeats its first up to K.
//   K = 0: any other class (none, or more than 8 cubes), each byte against
//     the 256-bit mask held in registers (bit b % 32 of word b / 32).
// Either gives 0x80 in each byte of the class (flags16); bits16 folds those
// into one bit a byte (bit i for byte i of the word, little-endian) for
// __popc, __ffs and __clz. Byte 0 and bytes >= 128 are ordinary members.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace byteclass {

struct Class {
  uint32_t value[8];  // cube j's v * 0x01010101 (the SWAR path)
  uint32_t cube[8];   // cube j's m * 0x01010101
  uint32_t mask[8];   // the 256-bit mask, bit b % 32 of mask[b / 32]
};

// 0x80 in each byte of x that is in the class.
template <int K>
__device__ __forceinline__ uint32_t flags4(const Class& c, uint32_t x) {
  if constexpr (K == 0) {
    uint32_t f = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = (x >> (8 * i)) & 0xffu;
      const uint32_t lo = b & 64u ? (b & 128u ? c.mask[6] : c.mask[2])
                                  : (b & 128u ? c.mask[4] : c.mask[0]);
      const uint32_t hi = b & 64u ? (b & 128u ? c.mask[7] : c.mask[3])
                                  : (b & 128u ? c.mask[5] : c.mask[1]);
      const uint32_t w = b & 32u ? hi : lo;
      f |= ((w >> (b & 31u)) & 1u) << (8 * i + 7);
    }
    return f;
  } else {
    uint32_t all = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t y = (x & c.cube[j]) ^ c.value[j];
      all &= ((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y;
    }
    return ~all & 0x80808080u;
  }
}

template <int K>
__device__ __forceinline__ uint4 flags16(const Class& c, uint4 w) {
  return make_uint4(flags4<K>(c, w.x), flags4<K>(c, w.y), flags4<K>(c, w.z),
                    flags4<K>(c, w.w));
}

// The flags of a word, one bit a byte: the high bits of a 32-bit lane
// (bits 7, 15, 23, 31) move to bits 28-31 in one multiply by 0x00204081,
// whose partial products never meet.
__device__ __forceinline__ unsigned bits16(uint4 f) {
  return ((f.x * 0x00204081u) >> 28) | (((f.y * 0x00204081u) >> 28) << 4) |
         (((f.z * 0x00204081u) >> 28) << 8) |
         (((f.w * 0x00204081u) >> 28) << 12);
}

// The bytes of the word that starts at byte lo of values which lie in the
// row [s, e), one bit a byte.
__device__ __forceinline__ unsigned row_bits(int64_t lo, int64_t s,
                                             int64_t e) {
  const int64_t a = s - lo, b = e - lo;
  const unsigned from = a <= 0 ? 0u : a >= 16 ? 16u : static_cast<unsigned>(a);
  const unsigned to = b <= 0 ? 0u : b >= 16 ? 16u : static_cast<unsigned>(b);
  return ((1u << to) - 1u) & ~((1u << from) - 1u);
}

}  // namespace byteclass
