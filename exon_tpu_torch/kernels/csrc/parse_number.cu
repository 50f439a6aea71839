// parse_number: CAST of utf8 rows to int64 or float64, invalid -> NULL.
//
// Replaces exon_tpu/plan/expressions.py _cast_utf8_to_number (:951), the
// int parse over a [n, 20] byte window, and _cast_utf8_to_float (:876),
// the decimal / scientific parse over a [n, 64] window (_window :862).
// Both JAX versions are a dozen vectorised passes over the window: digit
// masks, first-occurrence mins, cumsums for the digit ranks, and sums of
// digit * 10^p.
//
// Float mode computes the JAX arithmetic exactly, not strtod: the int64
// mantissa of the first 18 significant digits, the decimal exponent
// (written digits - fraction digits + dropped digits), then mant * 10^k or
// mant / 10^k with 10^k read from the host's table of exact doubles
// (pow10 below, the JAX package's _POW10F_NP), inf past 1e308. The multiply
// and the divide use __dmul_rn/__ddiv_rn, which nvcc never fuses or turns
// into a reciprocal, so the result is the same double bit for bit. The
// exponent digits are summed with the same clipped powers and int64
// wrap-around as the JAX sum. The legality rules are the JAX ones: an
// optional leading sign, digits with at most one '.', which must come
// before the first 'e'/'E', an optional sign after it, and at least one
// exponent digit; 64 bytes at most. One pass finds the first '.' and 'e'
// as it goes: a '.' after an 'e' or after another '.', a second 'e', or a
// sign anywhere but first or right after the 'e' makes the row illegal,
// and an illegal row is 0 whatever the pass summed, so ok and the value's
// bits are those of the JAX masks.
//
// Int mode accepts an optional '-' and 1 to 20 bytes of digits. Unlike the
// JAX sum, whose power of ten is clipped at 10^18 (a 20-digit numeral gets
// a wrong value that is still marked valid) and which wraps past
// INT64_MAX, a value outside int64 is NULL here (ROADMAP Queue 3, F10):
// the digits are summed in uint64 by Horner's rule, which is exact up to
// 19 significant digits, and 20 are past INT64_MAX.
//
// Bound on the H100: HBM bytes. Each row's offset, validity and bytes,
// and 9 bytes out (value and validity): for 3.4 M GFF coordinates of ~8.5
// bytes about 77 MB, 0.0229 ms at 3.35 TB/s; a 131,072-row batch of
// SQL_gff about 2.9 MB, 0.0009 ms.
//
// Design: a block of 256 threads takes a tile of consecutive rows, one row a
// thread. The offsets are read coalesced, each row's end from the neighbour
// lane. The text of each row of 1 to W bytes (W = 20 for int, 64 for float)
// is then staged in shared memory in aligned 16-byte words, the words that
// hold its bytes, copied into the row's own slot by cp.async (no register
// holds them; a word that reaches past either end of values is read byte by
// byte, copy16::load_word). A longer row is NULL unread: none of its words is
// staged, and a tile with one 10 kB row among short ones stages the short
// rows' words only. Per-row staging rather than a capped span: a slot a row
// needs no scan of the tile and no second path past a cap; a word two
// neighbouring rows share is copied into both slots, the second copy from L1
// (cp.async.ca), so device memory gives it once. Staging each word once for
// the tile, after two block-wide scans (the last word an earlier row staged,
// the place of a row's new words), was tried first: its scans and block syncs
// made it slower than the byte loop it replaced. Each thread then parses its
// row from shared memory in one pass, four significant digits at a time where
// four follow (a digit test and value in 32-bit SWAR), and writes the row's
// value and ok, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

#include "copy16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kIntWindow = 20;
constexpr int32_t kFloatWindow = 64;
constexpr unsigned kFull = 0xffffffffu;

// A staged row: its bytes, and four at a time from the 4-byte words of its
// slot (a word past the slot's end may be read; the bytes kept are the
// row's).
struct Row {
  const uint32_t* words;  // the row's slot
  int32_t head;           // the row's first byte in the slot
  __device__ __forceinline__ uint8_t operator[](int32_t p) const {
    return reinterpret_cast<const uint8_t*>(words)[head + p];
  }
  __device__ __forceinline__ uint32_t four(int32_t p) const {
    const int32_t q = head + p;
    return __funnelshift_r(words[q >> 2], words[(q >> 2) + 1], 8 * (q & 3));
  }
};

// Whether the four bytes of x are ASCII digits: each byte's high nibble is
// 3, and stays 3 after adding 6 (0x3a-0x3f become 0x40-0x45).
__device__ __forceinline__ bool four_digits(uint32_t x) {
  return (x & 0xf0f0f0f0u) == 0x30303030u &&
         ((x + 0x06060606u) & 0xf0f0f0f0u) == 0x30303030u;
}

// The value of four digits, the first in the low byte: pairs, then the
// two pairs.
__device__ __forceinline__ uint32_t four_value(uint32_t x) {
  const uint32_t t = x - 0x30303030u;
  const uint32_t v = t * 10 + (t >> 8);
  return (v & 0xff) * 100 + ((v >> 16) & 0xff);
}

__device__ void parse_int(const Row& row, int32_t len, bool valid,
                          int64_t* value, bool* ok) {
  if (!valid || len <= 0 || len > kIntWindow) {
    *ok = false;
    *value = 0;
    return;
  }
  const bool neg = row[0] == '-';
  const int32_t skip = neg ? 1 : 0;
  // the magnitude mod 2^64; exact up to 19 significant digits
  uint64_t mag = 0;
  int32_t n_sig = 0;
  bool digits = true, started = false;
  for (int32_t p = skip; p < len;) {
    const uint32_t d = static_cast<uint32_t>(row[p]) - '0';
    if (d < 10 && p + 4 <= len && (started || d != 0)) {
      // four significant digits at once
      const uint32_t x = row.four(p);
      if (four_digits(x)) {
        mag = mag * 10000 + four_value(x);
        n_sig += 4;
        started = true;
        p += 4;
        continue;
      }
    }
    digits = digits && d < 10;
    started = started || d != 0;
    n_sig += started ? 1 : 0;
    mag = mag * 10 + d;
    ++p;
  }
  const uint64_t limit = 9223372036854775808ULL;  // 2^63
  const bool good = len - skip > 0 && digits && n_sig <= 19 &&
                    (neg ? mag <= limit : mag < limit);
  *ok = good;
  *value = good ? (neg ? static_cast<int64_t>(0ULL - mag)
                       : static_cast<int64_t>(mag))
                : 0;
}

__device__ void parse_float(const Row& row, int32_t len, bool valid,
                            const double* __restrict__ pow10, double* value,
                            bool* ok) {
  if (!valid || len <= 0 || len > kFloatWindow) {
    *ok = false;
    *value = 0.0;
    return;
  }
  const bool neg = row[0] == '-';
  const int32_t skip = (neg || row[0] == '+') ? 1 : 0;
  // digit roles, mantissa, exponent and legality in one pass; e_pos < 0
  // until the first 'e'/'E'
  int32_t n_mant = 0, int_digits = 0, n_sig = 0, n_exp = 0;
  int32_t e_pos = -1;
  int64_t mant = 0;
  // the exponent digits' sum of d * 10^clip(len - 1 - p, 0, 18), mod 2^64
  // as the JAX sum: those at powers past 17 summed apart (e_hi, times
  // 10^18), the rest by Horner's rule (a legal row's exponent digits run
  // to its end; an illegal row's value is dropped)
  uint64_t e_hi = 0, e_lo = 0;
  bool seen_dot = false, started = false, eneg = false, legal = true;
  for (int32_t p = skip; p < len;) {
    const uint8_t c = row[p];
    const uint32_t d = static_cast<uint32_t>(c) - '0';
    if (e_pos < 0 && d < 10 && p + 4 <= len && n_sig <= 14 &&
        (started || d != 0)) {
      // four significant mantissa digits at once
      const uint32_t x = row.four(p);
      if (four_digits(x)) {
        mant = mant * 10000 + four_value(x);
        n_mant += 4;
        if (!seen_dot) int_digits += 4;
        n_sig += 4;
        started = true;
        p += 4;
        continue;
      }
    }
    if (e_pos < 0) {
      if (d < 10) {
        ++n_mant;
        if (!seen_dot) ++int_digits;
        started = started || d != 0;
        if (started) {
          // the first 18 significant digits, exactly
          if (n_sig < 18) mant = mant * 10 + d;
          ++n_sig;
        }
      } else if (c == '.') {
        legal = legal && !seen_dot;
        seen_dot = true;
      } else if ((c | 0x20) == 'e') {
        e_pos = p;
      } else {
        legal = false;
      }
    } else if (d < 10) {
      ++n_exp;
      if (len - 1 - p >= 18) {
        e_hi += d;
      } else {
        e_lo = e_lo * 10 + d;
      }
    } else if (p == e_pos + 1 && (c == '-' || c == '+')) {
      eneg = c == '-';
    } else {
      legal = false;
    }
    ++p;
  }
  const int32_t n_used = n_sig < 18 ? n_sig : 18;
  const uint64_t expval = e_hi * 1000000000000000000ULL + e_lo;
  const bool has_e = e_pos >= 0;
  int64_t ev = static_cast<int64_t>(expval);
  if (eneg) ev = static_cast<int64_t>(0ULL - expval);
  const int32_t frac_digits = n_mant - int_digits;
  const int64_t dec_exp = static_cast<int64_t>(
      static_cast<uint64_t>(ev) - static_cast<uint64_t>(frac_digits) +
      static_cast<uint64_t>(n_sig - n_used));
  // |dec_exp| clipped to [0, 308]; |INT64_MIN| wraps negative and clips to 0
  int64_t mag = dec_exp < 0
                    ? static_cast<int64_t>(0ULL - static_cast<uint64_t>(dec_exp))
                    : dec_exp;
  mag = mag < 0 ? 0 : (mag > 308 ? 308 : mag);
  const double mant_f = static_cast<double>(mant);
  // 10^0 is 1.0 and mant_f * 1.0 is mant_f: no table read for an integer
  double out = mant_f;
  if (dec_exp > 0) {
    out = __dmul_rn(mant_f, pow10[mag]);
  } else if (dec_exp < 0) {
    out = __ddiv_rn(mant_f, pow10[mag]);
  }
  if (dec_exp > 308) out = mant_f != 0.0 ? __longlong_as_double(
                                               0x7ff0000000000000LL)
                                         : 0.0;
  if (neg) out = -out;
  const bool good = len - skip > 0 && n_mant >= 1 && (!has_e || n_exp >= 1) &&
                    legal;
  *ok = good;
  *value = good ? out : 0.0;
}

// Copies aligned word w of values to dst: by cp.async, without a register,
// when the word lies inside values, else byte by byte (copy16::load_word).
__device__ __forceinline__ void stage_word(uint4* dst,
                                           const uint8_t* __restrict__ values,
                                           int64_t n_values, int64_t w) {
  const int64_t lo =
      16 * w - static_cast<int64_t>(reinterpret_cast<uintptr_t>(values) & 15);
  if (lo >= 0 && lo + 16 <= n_values) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(values + lo));
  } else {
    *dst = copy16::load_word(values, n_values, w);
  }
}

template <int32_t W>
__global__ void __launch_bounds__(kThreads)
    parse_number_kernel(const int32_t* __restrict__ offsets,
                        const uint8_t* __restrict__ values, int64_t n_values,
                        const bool* __restrict__ validity, int64_t n,
                        const double* __restrict__ pow10,
                        void* __restrict__ out, bool* __restrict__ ok) {
  // a row of at most W bytes spans at most kRowWords aligned words
  constexpr int kRowWords = (W + 30) / 16;
  // one slot more: Row::four may read a word past the last slot
  __shared__ uint4 stage[kThreads + 1][kRowWords];
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const int32_t s = i <= n ? offsets[i] : 0;
  int32_t e = __shfl_down_sync(kFull, s, 1);
  if (lane == 31 && i < n) e = offsets[i + 1];
  const int32_t len = i < n ? e - s : 0;
  const bool valid = i < n && validity[i];
  // the row's first byte, from values' first aligned word
  const int64_t at =
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(values) & 15) + s;
  if (len > 0 && len <= W) {
    const int64_t fw = at >> 4;
    const int64_t nw = ((at + len - 1) >> 4) - fw + 1;
#pragma unroll
    for (int j = 0; j < kRowWords; ++j) {
      if (j < nw) stage_word(&stage[tid][j], values, n_values, fw + j);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (i >= n) return;
  const Row row{reinterpret_cast<const uint32_t*>(stage[tid]),
                static_cast<int32_t>(at & 15)};
  if (W == kFloatWindow) {
    parse_float(row, len, valid, pow10, static_cast<double*>(out) + i, ok + i);
  } else {
    parse_int(row, len, valid, static_cast<int64_t*>(out) + i, ok + i);
  }
}

template <int32_t W>
void launch(const int32_t* offsets, const uint8_t* values, int64_t n_values,
            const bool* validity, int64_t n, const double* pow10, void* out,
            bool* ok, cudaStream_t stream) {
  parse_number_kernel<W>
      <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(offsets, values, n_values, validity, n, pow10, out, ok);
}

}  // namespace

extern "C" int exon_parse_number(const void* offsets, const void* values,
                                 int64_t n_values, const void* validity,
                                 int64_t n, int32_t float_mode,
                                 const void* pow10, void* out, void* ok,
                                 void* stream) {
  if (n == 0) return 0;
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* val = static_cast<const uint8_t*>(values);
  const auto* vld = static_cast<const bool*>(validity);
  const auto* p10 = static_cast<const double*>(pow10);
  auto* k = static_cast<bool*>(ok);
  const auto st = static_cast<cudaStream_t>(stream);
  if (float_mode) {
    launch<kFloatWindow>(off, val, n_values, vld, n, p10, out, k, st);
  } else {
    launch<kIntWindow>(off, val, n_values, vld, n, p10, out, k, st);
  }
  return static_cast<int>(cudaGetLastError());
}
