// text_records: the per-line structure of a FASTA or FASTQ chunk.
//
// Replaces exon_tpu/ops/device_text.py record_structure (:92) and
// first_match_in_segment (:115), and the per-byte keep masks and
// segment_lengths (:78) of formats/fasta_device.py _phase1/_phase2 (:59,
// :85) and formats/fastq.py _device_decode (:102). The JAX version derives a
// record id, a "inside a header line" flag and a first-space position for
// every byte with cumsum and cummax passes; here one thread takes one line
// and writes a few numbers for it.
//
// Inputs: the chunk (n bytes), nl[k], the positions of its newlines (from
// line_index), and the line count L (k, or k + 1 when the chunk does not end
// in '\n'). Line i holds [start, end): start = i ? nl[i-1] + 1 : 0,
// end = i < k ? nl[i] : n. Per line the kernel writes
//   start[i], end[i]   the line without its '\n';
//   is_hdr[i]          FASTA: the line starts with '>'; FASTQ: i % 4 == 0;
//   body[i]            0 for a header line, else its bytes that are not '\r';
// and, when want_hdr (0 on other lines):
//   split[i]           the first ' ' in [start + 1, end), or end;
//   name_len[i]        bytes of [start + 1, split) that are neither '\r' nor
//                      name_drop ('>' for FASTA, as the JAX name mask drops
//                      every '>'; '\r' for FASTQ);
//   desc_len[i]        bytes of [split + 1, end) that are not '\r'.
// A FASTQ header line whose first byte is not '@' adds one to *bad.
//
// Bound on the H100: HBM bytes. Every chunk byte is read once (to count
// '\r') plus 4 bytes per newline, and 13 (or 25 with want_hdr) bytes are
// written per line: a 128 MiB chunk of 60-byte lines moves about 0.2 GB,
// some 60 us at 3.35 TB/s.
//
// Design: one thread per line, 256 per block. A body line is scanned four
// bytes at a time (__vcmpeq4 against "\r\r\r\r") between byte-wise head and
// tail; a header line byte by byte, since it also looks for the space. A
// warp's 32 lines are neighbours (about 2 KB of FASTA), so the cache lines
// of one step are reused from L1 by the next ones. A single huge line (an
// unwrapped chromosome) is scanned by one thread; the copy in gather_spans
// is not. The wrapper zeroes *bad, passes a 16-byte-aligned chunk, and
// passes null output pointers for split/name_len/desc_len without want_hdr.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int count_cr(const uint8_t* __restrict__ src,
                                        int64_t p, int64_t e) {
  int c = 0;
  for (; p < e && (p & 3); ++p) c += src[p] == '\r';
  for (; p + 4 <= e; p += 4) {
    const unsigned w = *reinterpret_cast<const unsigned*>(src + p);
    c += __popc(__vcmpeq4(w, 0x0d0d0d0du)) >> 3;
  }
  for (; p < e; ++p) c += src[p] == '\r';
  return c;
}

__global__ void text_records_kernel(
    const uint8_t* __restrict__ src, int64_t n, const int32_t* __restrict__ nl,
    int64_t k, int64_t n_lines, int fastq, uint8_t name_drop,
    int32_t* __restrict__ start_out, int32_t* __restrict__ end_out,
    uint8_t* __restrict__ is_hdr_out, int32_t* __restrict__ body_out,
    int32_t* __restrict__ split_out, int32_t* __restrict__ name_out,
    int32_t* __restrict__ desc_out, int32_t* __restrict__ bad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_lines) return;
  const int64_t s = i == 0 ? 0 : static_cast<int64_t>(nl[i - 1]) + 1;
  const int64_t e = i < k ? static_cast<int64_t>(nl[i]) : n;
  // '\n' for an empty line (and for a line past the chunk, which a wrong
  // n_lines would ask for: it is then read as empty, not out of bounds)
  const uint8_t first = s < n ? src[s] : '\n';
  const bool hdr = fastq ? (i % 4 == 0) : first == '>';
  if (fastq && hdr && first != '@') atomicAdd(bad, 1);
  start_out[i] = static_cast<int32_t>(s);
  end_out[i] = static_cast<int32_t>(e);
  is_hdr_out[i] = hdr;
  body_out[i] = hdr ? 0 : static_cast<int32_t>(e - s - count_cr(src, s, e));
  if (split_out == nullptr) return;
  int64_t split = e;
  int name_len = 0;
  int desc_len = 0;
  if (hdr) {
    int64_t p = s + 1;
    for (; p < e; ++p) {
      const uint8_t b = src[p];
      if (b == ' ') break;
      name_len += b != '\r' && b != name_drop;
    }
    split = p < e ? p : e;
    for (p = split + 1; p < e; ++p) desc_len += src[p] != '\r';
  }
  split_out[i] = static_cast<int32_t>(split);
  name_out[i] = name_len;
  desc_out[i] = desc_len;
}

}  // namespace

extern "C" int exon_text_records(const void* src, int64_t n, const void* nl,
                                 int64_t k, int64_t n_lines, int32_t fastq,
                                 int32_t name_drop, void* start, void* end,
                                 void* is_hdr, void* body, void* split,
                                 void* name_len, void* desc_len, void* bad,
                                 void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n_lines + kThreads - 1) / kThreads);
  text_records_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), n, static_cast<const int32_t*>(nl), k,
      n_lines, fastq, static_cast<uint8_t>(name_drop),
      static_cast<int32_t*>(start), static_cast<int32_t*>(end),
      static_cast<uint8_t*>(is_hdr), static_cast<int32_t*>(body),
      static_cast<int32_t*>(split), static_cast<int32_t*>(name_len),
      static_cast<int32_t*>(desc_len), static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}
