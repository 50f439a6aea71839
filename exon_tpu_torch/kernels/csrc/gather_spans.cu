// gather_spans: copy byte spans of a chunk to their output offsets, dropping
// two byte values.
//
// Replaces exon_tpu/ops/device_text.py compact (:57), as
// formats/fasta_device.py _phase2 (:107-120) and formats/fastq.py
// _device_decode (:123-142) use it: a cumsum over a per-byte keep mask and a
// scatter of every byte of the chunk, once per output column. Here only the
// bytes of the wanted spans are read, and each is written once, in place.
//
// Span r is src[starts[r], stops[r]); its kept bytes (those equal to neither
// drop_a nor drop_b: '\r' for every column, and '>' too for FASTA names;
// -1 drops nothing, as trim_polya's prefixes need) go
// to out[dst[r] ...]. The wrapper computes dst as an exclusive scan
// (torch.cumsum) of the kept lengths that text_records counted.
//
// Bound on the H100: HBM bytes, the span bytes read and written once plus
// 12 bytes of span table per span: a 128 MiB FASTA chunk's sequence column
// moves about 0.3 GB, some 90 us at 3.35 TB/s.
//
// Design: a sibling of gather_var.cu. One warp per span, warps striding over
// the spans: lane j reads byte base + j of each 32-byte step, the warp
// ballots which lanes keep their byte, and each keeping lane writes at the
// step's output position + popc(ballot below its lane). A FASTA sequence is
// copied line by line (one span per line), so a chromosome-sized record is
// spread over as many warps as it has lines.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

__global__ void gather_spans_kernel(const uint8_t* __restrict__ src,
                                    const int32_t* __restrict__ starts,
                                    const int32_t* __restrict__ stops,
                                    const int32_t* __restrict__ dst,
                                    int64_t m, int32_t drop_a, int32_t drop_b,
                                    uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < m; r += nwarps) {
    const int64_t s = starts[r];
    const int64_t e = stops[r];
    int64_t d = dst[r];
    for (int64_t base = s; base < e; base += 32) {
      const int64_t p = base + lane;
      const int32_t b = p < e ? src[p] : 0;
      const bool keep = p < e && b != drop_a && b != drop_b;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) out[d + __popc(ballot & below)] = static_cast<uint8_t>(b);
      d += __popc(ballot);
    }
  }
}

}  // namespace

extern "C" int exon_gather_spans(const void* src, const void* starts,
                                 const void* stops, const void* dst, int64_t m,
                                 int32_t drop_a, int32_t drop_b, void* out,
                                 void* stream) {
  int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_spans_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(stops), static_cast<const int32_t*>(dst), m,
      drop_a, drop_b, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
