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
// exponent digit; 64 bytes at most.
//
// Int mode accepts an optional '-' and 1 to 20 bytes of digits. Unlike the
// JAX sum, whose power of ten is clipped at 10^18 (a 20-digit numeral gets
// a wrong value that is still marked valid) and which wraps past
// INT64_MAX, a value outside int64 is NULL here (ROADMAP Queue 3, F10).
//
// Bound on the H100: HBM bytes. Each row's offset pair and validity, its
// bytes, and 9 bytes out (value and validity): for 3.4 M GFF coordinates of
// ~7 digits about 67 MB, some 20 us at 3.35 TB/s.
//
// Design: one thread per row, threads striding over rows; a row reads at
// most its first 64 bytes twice (the first pass finds the first '.' and
// 'e', the second parses), both through L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int32_t kIntWindow = 20;
constexpr int32_t kFloatWindow = 64;

__constant__ int64_t kPow10[19] = {
    1LL, 10LL, 100LL, 1000LL, 10000LL, 100000LL, 1000000LL, 10000000LL,
    100000000LL, 1000000000LL, 10000000000LL, 100000000000LL,
    1000000000000LL, 10000000000000LL, 100000000000000LL,
    1000000000000000LL, 10000000000000000LL, 100000000000000000LL,
    1000000000000000000LL};

__device__ __forceinline__ bool is_digit(uint8_t c) {
  return c >= '0' && c <= '9';
}

__device__ __forceinline__ int32_t clip18(int32_t p) {
  return p < 0 ? 0 : (p > 18 ? 18 : p);
}

__device__ void parse_int(const uint8_t* __restrict__ row, int32_t len,
                          bool valid, int64_t* value, bool* ok) {
  const bool neg = len > 0 && row[0] == '-';
  const int32_t skip = neg ? 1 : 0;
  bool good = valid && len - skip > 0 && len <= kIntWindow;
  // magnitude in uint64; anything above 2^63 overflows
  const uint64_t limit = 9223372036854775808ULL;
  uint64_t mag = 0;
  for (int32_t p = skip; good && p < len; ++p) {
    const uint8_t c = row[p];
    if (!is_digit(c)) {
      good = false;
      break;
    }
    const uint64_t d = c - '0';
    if (mag > (limit - d) / 10) {
      good = false;
      break;
    }
    mag = mag * 10 + d;
  }
  if (good && !neg && mag == limit) good = false;
  *ok = good;
  *value = good ? (neg ? static_cast<int64_t>(0ULL - mag)
                       : static_cast<int64_t>(mag))
                : 0;
}

__device__ void parse_float(const uint8_t* __restrict__ row, int32_t len,
                            bool valid, const double* __restrict__ pow10,
                            double* value, bool* ok) {
  if (!valid || len > kFloatWindow) {
    *ok = false;
    *value = 0.0;
    return;
  }
  const bool neg = len > 0 && row[0] == '-';
  const bool plus = len > 0 && row[0] == '+';
  const int32_t skip = (neg || plus) ? 1 : 0;
  // pass 1: first 'e'/'E' and first '.'
  int32_t e_pos = kFloatWindow, dot_pos = kFloatWindow;
  for (int32_t p = 0; p < len; ++p) {
    const uint8_t c = row[p];
    if (e_pos == kFloatWindow && (c == 'e' || c == 'E')) e_pos = p;
    if (dot_pos == kFloatWindow && c == '.') dot_pos = p;
  }
  const int32_t mant_end = e_pos < len ? e_pos : len;
  const bool has_e = e_pos < len;
  const int32_t es_pos = e_pos + 1;
  const uint8_t esign = es_pos < len ? row[es_pos] : 0;
  const bool eneg = has_e && esign == '-';
  const bool eplus = has_e && esign == '+';
  const int32_t e_start = es_pos + ((eneg || eplus) ? 1 : 0);
  // pass 2: digit roles, mantissa, exponent, legality
  int32_t n_mant = 0, int_digits = 0, sig_start = kFloatWindow, n_exp = 0;
  int64_t mant = 0;
  uint64_t expval = 0;  // int64 wrap-around, as the JAX sum
  bool legal = true;
  for (int32_t p = 0; p < len; ++p) {
    const uint8_t c = row[p];
    const bool digit = is_digit(c);
    const bool mant_digit = digit && p >= skip && p < mant_end;
    const bool exp_digit = digit && p >= e_start;
    if (mant_digit) {
      const int32_t rank = n_mant++;
      if (p < dot_pos) ++int_digits;
      if (c != '0' && sig_start == kFloatWindow) sig_start = rank;
      // the first 18 significant digits, exactly (Horner = sum of d*10^p)
      if (sig_start != kFloatWindow && rank - sig_start < 18) {
        mant = mant * 10 + (c - '0');
      }
    }
    if (exp_digit) {
      ++n_exp;
      expval += static_cast<uint64_t>(c - '0') *
                static_cast<uint64_t>(kPow10[clip18(len - 1 - p)]);
    }
    legal = legal && (p < skip || mant_digit ||
                      (c == '.' && p == dot_pos && dot_pos < mant_end) ||
                      ((c == 'e' || c == 'E') && p == e_pos) ||
                      (p == es_pos && (eneg || eplus)) || exp_digit);
  }
  int64_t ev = static_cast<int64_t>(expval);
  if (eneg) ev = static_cast<int64_t>(0ULL - expval);
  const int32_t frac_digits = n_mant - int_digits;
  int32_t n_sig = n_mant - sig_start;
  if (n_sig < 0) n_sig = 0;
  const int32_t n_used = n_sig < 18 ? n_sig : 18;
  const int64_t dec_exp = static_cast<int64_t>(
      static_cast<uint64_t>(ev) - static_cast<uint64_t>(frac_digits) +
      static_cast<uint64_t>(n_sig - n_used));
  // |dec_exp| clipped to [0, 308]; |INT64_MIN| wraps negative and clips to 0
  int64_t mag = dec_exp < 0
                    ? static_cast<int64_t>(0ULL - static_cast<uint64_t>(dec_exp))
                    : dec_exp;
  mag = mag < 0 ? 0 : (mag > 308 ? 308 : mag);
  const double scale = pow10[mag];
  const double mant_f = static_cast<double>(mant);
  double out = dec_exp >= 0 ? __dmul_rn(mant_f, scale)
                            : __ddiv_rn(mant_f, scale);
  if (dec_exp > 308) out = mant_f != 0.0 ? __longlong_as_double(
                                               0x7ff0000000000000LL)
                                         : 0.0;
  if (neg) out = -out;
  const bool good = len - skip > 0 && n_mant >= 1 && (!has_e || n_exp >= 1) &&
                    legal;
  *ok = good;
  *value = good ? out : 0.0;
}

__global__ void parse_number_kernel(const int32_t* __restrict__ offsets,
                                    const uint8_t* __restrict__ values,
                                    const bool* __restrict__ validity,
                                    int64_t n, int32_t float_mode,
                                    const double* __restrict__ pow10,
                                    void* __restrict__ out,
                                    bool* __restrict__ ok) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int32_t s = offsets[i];
    const int32_t len = offsets[i + 1] - s;
    if (float_mode) {
      parse_float(values + s, len, validity[i], pow10,
                  static_cast<double*>(out) + i, ok + i);
    } else {
      parse_int(values + s, len, validity[i], static_cast<int64_t*>(out) + i,
                ok + i);
    }
  }
}

}  // namespace

extern "C" int exon_parse_number(const void* offsets, const void* values,
                                 const void* validity, int64_t n,
                                 int32_t float_mode, const void* pow10,
                                 void* out, void* ok, void* stream) {
  if (n == 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  parse_number_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets), static_cast<const uint8_t*>(values),
      static_cast<const bool*>(validity), n, float_mode,
      static_cast<const double*>(pow10), out, static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}
