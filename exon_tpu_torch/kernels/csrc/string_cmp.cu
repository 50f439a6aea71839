// string_cmp: ordered compare of every row of a var-width column with a
// literal (<, <=, >, >=).
//
// Replaces exon_tpu/plan/expressions.py _var_cmp_literal (:780) over
// gather_prefix (exon_tpu/ops/layout.py:60). The JAX version gathers a
// [n, k] window of each row's first k = len(literal) bytes, subtracts the
// zero-padded literal, takes the first nonzero difference with argmax and
// breaks a tie on the lengths: a lexicographic compare of unsigned bytes,
// shorter prefix first. It ignores the row's validity, so a NULL row (no
// bytes) compares as the empty string; here a NULL row never passes.
//
// Bound on the H100: HBM bytes. Each row's offset pair and validity, the
// bytes a compare must read (up to the first difference, at most
// min(length, k) + 1), and a bool out: for the 295,660 FASTA ids of a
// 128 MiB chunk against an 11-byte accession about 3.4 MB, about 1 us at
// 3.35 TB/s.
//
// Design: one thread per row, threads striding over rows. A row compares
// at most k + 1 bytes however long it is, so no row needs a warp. A literal
// of up to kInline bytes travels by value in the launch's parameters, so a
// call allocates and copies nothing; the loop index is the same for every
// thread of a warp that is still comparing, so each parameter read is a
// broadcast from the constant bank. A longer literal comes in a device
// buffer, read through the read-only cache.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int32_t kInline = 64;

struct InlineLiteral {
  uint8_t b[kInline];
};

// op: 0 <, 1 <=, 2 >, 3 >=; dev_lit is null when the literal is inline
__global__ void string_cmp_kernel(const int32_t* __restrict__ offsets,
                                  const uint8_t* __restrict__ values,
                                  const bool* __restrict__ validity, int64_t n,
                                  const InlineLiteral inline_lit,
                                  const uint8_t* __restrict__ dev_lit,
                                  int32_t lit_len, int32_t op,
                                  bool* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int32_t s = offsets[i];
    const int32_t len = offsets[i + 1] - s;
    const int32_t m = len < lit_len ? len : lit_len;
    int cmp = 0;
    for (int32_t j = 0; j < m; ++j) {
      const int lit = dev_lit == nullptr ? inline_lit.b[j] : __ldg(dev_lit + j);
      const int d = static_cast<int>(values[s + j]) - lit;
      if (d != 0) {
        cmp = d;
        break;
      }
    }
    if (cmp == 0) cmp = (len > lit_len) - (len < lit_len);
    bool pass;
    switch (op) {
      case 0: pass = cmp < 0; break;
      case 1: pass = cmp <= 0; break;
      case 2: pass = cmp > 0; break;
      default: pass = cmp >= 0; break;
    }
    out[i] = pass && validity[i];
  }
}

}  // namespace

// lit is host memory when lit_len <= 64 (copied into the launch's
// parameters), else a device buffer of lit_len bytes.
extern "C" int exon_string_cmp(const void* offsets, const void* values,
                               const void* validity, int64_t n,
                               const void* lit, int32_t lit_len, int32_t op,
                               void* out, void* stream) {
  if (n == 0) return 0;
  InlineLiteral inline_lit{};
  const uint8_t* dev_lit = nullptr;
  if (lit_len <= kInline) {
    if (lit_len > 0) std::memcpy(inline_lit.b, lit, lit_len);
  } else {
    dev_lit = static_cast<const uint8_t*>(lit);
  }
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  string_cmp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets), static_cast<const uint8_t*>(values),
      static_cast<const bool*>(validity), n, inline_lit, dev_lit, lit_len, op,
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}
