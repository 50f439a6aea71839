// span_concat: build each output row of a var-width column from a short
// list of pieces, each a byte span of one of a few sources, cut or cycled
// to a length.
//
// Replaces the per-row assembly programs of exon_tpu/ops/sqlfuncs.py:
// _concat_cols (:268: a per-byte row id over stacked buffers, one pass per
// argument to find each output byte's column), which carries fn_concat,
// the || operator (fn_concat_op) and fn_concat_ws (:325-363, the separator
// a piece of its own, of length 0 where the JAX code suppresses it) and the
// string branch of fn_coalesce (:779); _pad (:387: lpad/rpad, the pad
// pattern a piece cycled from its first byte, the row a piece cut to the
// width); and fn_repeat (:366: the row a piece cycled to k times its
// length).
//
// Piece p of output row r reads source piece_src[p], a device pointer in
// srcs: its byte i (0 <= i < len) is src[start + i % span], so a span at
// least as long as the piece is a plain copy and a shorter one repeats.
// start, span and len are int32 [P, n], piece-major; out_offsets (int32
// [n+1]) is the exclusive scan of each row's summed lengths, which the
// wrapper takes with torch.cumsum (one host read of the total to allocate,
// and the int32 overflow check).
//
// Bound on the H100: the HBM bytes the function must move: each argument's
// offsets and validity and the bytes it reads (a cycled pattern once), the
// output bytes and offsets. The piece tables are this design's own and not
// counted. J's concat_ws over 295,660 ids moves ~29 MB, ~9 us at
// 3.35 TB/s.
//
// Design: one warp per output row, warps striding over the rows, pieces in
// order; lane j writes bytes j, j + 32, ... of each piece, so the stores
// of a row are contiguous and the loads of a copied span too.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;

__global__ void span_concat_kernel(const uint64_t* __restrict__ srcs,
                                   const int32_t* __restrict__ piece_src,
                                   int32_t pieces, int64_t n,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ span,
                                   const int32_t* __restrict__ len,
                                   const int32_t* __restrict__ out_offsets,
                                   uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t r = warp; r < n; r += nwarps) {
    int64_t d = out_offsets[r];
    for (int32_t p = 0; p < pieces; ++p) {
      const int64_t at = static_cast<int64_t>(p) * n + r;
      const int32_t l = len[at];
      if (l <= 0) continue;
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(srcs[piece_src[p]]) + start[at];
      const int32_t w = span[at];
      if (w >= l) {
        for (int32_t i = lane; i < l; i += 32) out[d + i] = src[i];
      } else {
        for (int32_t i = lane; i < l; i += 32) out[d + i] = src[i % w];
      }
      d += l;
    }
  }
}

}  // namespace

extern "C" int exon_span_concat(const void* srcs, const void* piece_src,
                                int32_t pieces, int64_t n, const void* start,
                                const void* span, const void* len,
                                const void* out_offsets, void* out,
                                void* stream) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  span_concat_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(srcs),
      static_cast<const int32_t*>(piece_src), pieces, n,
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(span),
      static_cast<const int32_t*>(len),
      static_cast<const int32_t*>(out_offsets), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
