// span_concat: build each output row of a var-width column from a short
// list of pieces, each a byte span of one of a few sources, cut or cycled
// to a length.
//
// Replaces the per-row assembly programs of exon_tpu/ops/sqlfuncs.py:
// _concat_cols (:268: a per-byte row id over stacked buffers, one pass per
// argument to find each output byte's column), which carries fn_concat,
// the || operator (fn_concat_op) and fn_concat_ws (:325-363), and the
// string branch of fn_coalesce (:779); _pad (:387: lpad/rpad); and
// fn_repeat (:366).
//
// A piece of output row r reads its source (a device buffer, or literal
// bytes that travel in the launch's parameters): its byte i (0 <= i <
// length) is src[start + i % span]. Each of start, span and the base
// length is a per-row int32 array or one value for every row; a column's
// row is its offsets (start = off[r], base = off[r + 1] - off[r]). The
// length is the base times `times` (repeat), cut to `cap` (a pad's row) or,
// for a `fill` piece, what the row's other pieces leave of `fill` bytes
// (the pad). A gate on a validity array opens the piece only where the row
// is valid (concat's skipped NULL), where it and an earlier gated piece are
// valid (concat_ws' separator, given the next argument's validity), or
// where it is the first valid one (coalesce). kernels/span_concat.py's
// span_concat_plain is the twin of these rules.
//
// Bound on the H100: the HBM bytes the function must move: each argument's
// offsets and validity and the bytes it reads (a cycled pattern once), the
// output bytes and offsets. J's concat_ws over 295,660 ids moves ~29 MB,
// ~9 us at 3.35 TB/s.
//
// Design. The first design took the offsets from a torch chain (stack,
// clamp, sum, cumsum, a cast) and one host read, uploaded the source
// pointers and the pieces' sources from pageable memory and stacked every
// start, span and length into [P, n] tables a call; its kernel gave each
// output row a warp, so that at J's rows (about 40 bytes in 5 pieces) most
// lanes idled, and stored single bytes. Here:
//  - The pieces travel by value in a __grid_constant__ Params block of up
//    to kMaxPieces (32) descriptions, scalars in place of rows wherever a
//    field is the same for every row, so nothing is uploaded or stacked. A
//    call with more pieces passes the same descriptions as a device table
//    (the wrapper uploads it: the rare case, never an error).
//  - Literal bytes travel inline, up to kInline (512) bytes a launch: the
//    parameter block then stays under the 4 KB every CUDA 12 driver takes
//    (32 x 88 bytes of pieces, 512 of bytes, the header and the kernels'
//    own arguments: about 3.4 KB), and 512 bytes hold any separator or pad
//    pattern SQL writes by hand. A block copies them to shared memory; a
//    longer literal is a device buffer the wrapper uploads once and keeps.
//  - Offsets in the kernel: concat_offsets_kernel is a single pass with a
//    decoupled look-back on the status words of lookback.cuh. A block takes
//    a tile of kTile rows by ticket, computes each row's length (rows to
//    lanes coalesced, then four consecutive rows a thread for the scan),
//    publishes the tile's sum (saturating at 2^32 - 1, so a total past
//    2^31 stays visible) and writes the exclusive offsets in 16-byte
//    stores. The last tile writes offsets[n] and the int64 total, which the
//    wrapper reads once to allocate and to refuse a total of 2^31 or more.
//    For every output tile of kTileBytes bytes whose first byte falls in
//    this tile's rows, it notes the row holding that byte (first_row), as
//    expand_segments.cu does.
//  - The write pass is balanced over output bytes, not rows: a block owns
//    `words` (1-16, the wrapper's tile_words: more for longer mean rows)
//    consecutive tiles of kTileBytes bytes, and each thread one aligned
//    16-byte output word of each. The block stages the offsets of the rows
//    that hold its bytes in shared memory, and each row's pieces resolved
//    once (length, start, span), by a thread a row with the rows' loads of
//    a piece in flight together. A thread then finds its word's first row
//    by a binary search and walks the staged pieces: a word inside one run
//    of a device source is one copy16 load (two aligned 16-byte words
//    funnel-shifted); any other notes each byte's address (an inline
//    literal's in shared memory), a cycle's phase stepping with the byte,
//    and issues its 16 byte loads together. Words are stored whole. Rows of
//    no bytes past kStageRows, or more (row, piece) runs than kStageRuns,
//    leave a block to its threads' own walk over device memory, which
//    resolves each row's pieces there. A row of megabytes (repeat, a wide
//    lpad) spreads over as many blocks as its bytes fill.
//  Timed on the H100 beside this design (PERF.md section 6, the K12
//  span_concat row): words from 16-byte runs each placed by a funnel
//  shift and mask, a lane a byte through a shared-memory tile found by a
//  max-scan of run marks, and the pieces read from the parameters at each
//  use: none was faster. More tiles a block, or less set-up, did not move
//  the write pass's time either: it is the per-word walk's and loads'
//  instructions, not the bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "copy16.cuh"
#include "lookback.cuh"


namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                   // rows a thread of the scan
constexpr int kTile = kThreads * kRows;    // rows of an offsets tile
constexpr int64_t kTileBytes = kThreads * 16;  // span_concat.py TILE_BYTES
constexpr int kStageRows = 4096;           // rows a write block stages
constexpr int kStageRuns = 2048;  // (row, piece) runs a write block stages
constexpr int kMaxPieces = 32;             // span_concat.py MAX_PIECES
constexpr int kInline = 512;               // span_concat.py INLINE_BYTES
constexpr unsigned kFull = 0xffffffffu;

// gates (flags bits 0-1), and where start and the base length come from
constexpr int kAlways = 0;
constexpr int kValid = 1;
constexpr int kJoin = 2;
constexpr int kFirst = 3;
constexpr int kEnds = 4;    // base = start[r + 1] - start[r]
constexpr int kInlined = 8;  // the source is the inline bytes at lit_off

// One piece, as kernels/span_concat.py lays it out (11 int64 slots).
struct Piece {
  const uint8_t* src;    // a device source (null when inline)
  const int32_t* start;  // per-row start, or null: start_c
  const int32_t* span;   // per-row span, or null: span_c (0: the base)
  const int32_t* len;    // per-row base length, or null: kEnds or len_c
  const bool* valid;     // the gate's validity, or null: every row valid
  int64_t src_len;       // bytes in the source
  int64_t times;         // the length is times x the base
  int32_t start_c;
  int32_t span_c;
  int32_t len_c;
  int32_t cap;    // the length cut to cap (-1: no cut)
  int32_t fill;   // -1, or the length is fill - the row's other pieces
  int32_t flags;  // gate | kEnds | kInlined
  int32_t lit_off;
  int32_t pad_;
};
static_assert(sizeof(Piece) == 88, "Piece must match span_concat.py");

struct Params {
  Piece pieces[kMaxPieces];
  const Piece* table;  // a device table of npieces pieces, or null
  int64_t n;
  int32_t npieces;
  int32_t has_fill;
  int32_t lit_len;
  int32_t pad_;
  alignas(8) uint8_t lit[kInline];
};

struct Row {
  int64_t len;
  int64_t start;
  int32_t span;
};

// The launch's pieces where a block reads them: copied from the parameters
// to shared memory (reads from the parameter block at a per-thread index go
// through generic loads), or the device table of a call of more pieces.
template <bool kTable>
__device__ __forceinline__ const Piece* stage_pieces(const Params& p,
                                                     Piece* s_pieces) {
  if (kTable) return p.table;
  const int words = p.npieces * static_cast<int>(sizeof(Piece) / 8);
  const long long* from = reinterpret_cast<const long long*>(p.pieces);
  long long* to = reinterpret_cast<long long*>(s_pieces);
  for (int i = threadIdx.x; i < words; i += blockDim.x) to[i] = from[i];
  return s_pieces;
}

// Piece q of row r: its length (0 where the gate is closed), start and
// span; `seen` carries whether an earlier gated piece was valid, `others`
// the row's non-fill length (for a fill piece).
__device__ __forceinline__ Row resolve(const Piece& q, int64_t r, bool& seen,
                                       int64_t others) {
  const int64_t start = q.start ? q.start[r] : q.start_c;
  const int64_t base = q.len ? q.len[r]
                       : (q.flags & kEnds) ? q.start[r + 1] - start
                                           : q.len_c;
  int64_t len = base * q.times;
  if (q.cap >= 0 && len > q.cap) len = q.cap;
  if (q.fill >= 0) len = q.fill - others;
  if (len < 0) len = 0;
  const int gate = q.flags & 3;
  const bool ok = q.valid ? q.valid[r] : true;
  bool open = true;
  if (gate == kValid) open = ok;
  if (gate == kJoin) open = ok && seen;
  if (gate == kFirst) open = ok && !seen;
  if (gate == kValid || gate == kFirst) seen = seen || ok;
  int64_t span = q.span ? q.span[r] : q.span_c > 0 ? q.span_c : base;
  if (span < 1) span = 1;
  if (span > INT32_MAX) span = INT32_MAX;
  return {open ? len : 0, start, static_cast<int32_t>(span)};
}

// The sum of row r's non-fill pieces.
__device__ __forceinline__ int64_t row_others(const Piece* ps, int np,
                                              int64_t r) {
  bool seen = false;
  int64_t s = 0;
  for (int j = 0; j < np; ++j) {
    const Row x = resolve(ps[j], r, seen, 0);
    if (ps[j].fill < 0) s += x.len;
  }
  return s;
}

// Every piece of the kN rows r[k] (those with live[k]), piece by piece so
// that the rows' loads of a piece are in flight together; put(k, j, x)
// takes each resolved piece, the fill pieces last (they need the row's
// other length), and total[k] gets each row's length.
template <int kN, typename Put>
__device__ __forceinline__ void resolve_rows(const Piece* ps, int np,
                                             bool has_fill,
                                             const int64_t (&r)[kN],
                                             const bool (&live)[kN],
                                             int64_t (&total)[kN], Put put) {
  bool seen[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    seen[k] = false;
    total[k] = 0;
  }
#pragma unroll 4
  for (int j = 0; j < np; ++j) {
    const Piece& q = ps[j];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (!live[k]) continue;
      const Row x = resolve(q, r[k], seen[k], 0);
      if (q.fill < 0) {
        total[k] += x.len;
        put(k, j, x);
      }
    }
  }
  if (!has_fill) return;
  int64_t others[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    seen[k] = false;
    others[k] = total[k];
  }
  for (int j = 0; j < np; ++j) {  // the gates replayed for the fills
    const Piece& q = ps[j];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (!live[k]) continue;
      const Row x = resolve(q, r[k], seen[k], others[k]);
      if (q.fill >= 0) {
        total[k] += x.len;
        put(k, j, x);
      }
    }
  }
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads)
concat_offsets_kernel(const __grid_constant__ Params p,
                      unsigned long long* __restrict__ status,
                      unsigned long long* __restrict__ ticket,
                      unsigned long long ticket_base,
                      unsigned long long epoch, int32_t* __restrict__ offsets,
                      int32_t* __restrict__ first_row, int64_t max_tiles,
                      long long* __restrict__ total_out) {
  __shared__ long long warp_sums[kWarps];
  __shared__ int64_t prefix_s;
  // the rows' lengths, then the tile's exclusive offsets and its end
  __shared__ int64_t starts[kTile + 1];
  __shared__ Piece s_pieces[kTable ? 1 : kMaxPieces];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n = p.n;
  const int np = p.npieces;
  const bool has_fill = p.has_fill != 0;
  const Piece* ps = stage_pieces<kTable>(p, s_pieces);
  const int64_t tile = lookback::ticket(ticket, ticket_base);  // syncs
  const int64_t start = tile * kTile;
  // neighbouring lanes take neighbouring rows, so the pieces' per-row
  // loads coalesce
  {
    int64_t r[kRows], len[kRows];
    bool live[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      r[k] = start + k * kThreads + threadIdx.x;
      live[k] = r[k] < n;
    }
    resolve_rows<kRows>(ps, np, has_fill, r, live, len,
                        [](int, int, const Row&) {});
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      starts[k * kThreads + threadIdx.x] = len[k];
    }
  }
  __syncthreads();
  const int64_t r0 = start + kRows * threadIdx.x;
  long long c[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) c[j] = starts[kRows * threadIdx.x + j];
  const long long mine = c[0] + c[1] + c[2] + c[3];
  long long incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  long long before = 0, tile_sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const long long s = warp_sums[w];
    before += w < warp ? s : 0;
    tile_sum += s;
  }
  if (threadIdx.x == 0) {
    lookback::publish(status, tile,
                      lookback::word(epoch, tile == 0 ? lookback::kPrefix
                                                      : lookback::kAggregate,
                                     tile_sum));
  }
  if (warp == 0) {
    const int64_t prefix = lookback::exclusive_prefix(status, tile, 1, 0,
                                                      epoch, 32, lane, kFull);
    if (lane == 0) {
      if (tile > 0) {
        lookback::publish(status, tile,
                          lookback::word(epoch, lookback::kPrefix,
                                         prefix + tile_sum));
      }
      prefix_s = prefix;
    }
  }
  __syncthreads();
  const int64_t prefix = prefix_s;
  int32_t o[kRows];
  int64_t run = prefix + before + incl - mine;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    o[j] = static_cast<int32_t>(run);  // wraps only past 2^31: refused
    starts[kRows * threadIdx.x + j] = run;
    run += c[j];
  }
  if (r0 + kRows <= n) {
    // offsets is 256-byte aligned and r0 a multiple of 4: one 16-byte store
    *reinterpret_cast<int4*>(offsets + r0) = make_int4(o[0], o[1], o[2],
                                                       o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (r0 + j < n) offsets[r0 + j] = o[j];
    }
  }
  const int64_t end = prefix + tile_sum;
  if (threadIdx.x == 0) {
    starts[kTile] = end;
    if (start + kTile >= n) {
      offsets[n] = static_cast<int32_t>(end);
      *total_out = end;
    }
  }
  __syncthreads();
  // the output tiles whose first byte lies in [prefix, end), strided over
  // the threads: a thread finds its first tile's row by a binary search and
  // each next one by galloping on from the last
  if (end > prefix) {
    const int64_t t_first = (prefix + kTileBytes - 1) / kTileBytes;
    int64_t t_last = (end - 1) / kTileBytes;
    if (t_last >= max_tiles) t_last = max_tiles - 1;
    int row = -1;
    for (int64_t t = t_first + threadIdx.x; t <= t_last; t += kThreads) {
      const int64_t k = t * kTileBytes;
      // the last row whose offset is <= k: rows of no bytes share their
      // offset with the next row, so this is the row holding byte k
      int a, b;  // starts[a] <= k < starts[b] (starts[kTile] = end > k)
      if (row < 0) {
        a = 0;
        b = kTile;
      } else {
        a = row;
        int step = 1;
        b = row + 1;
        while (starts[b] <= k) {
          a = b;
          step <<= 1;
          b = a + step < kTile ? a + step : kTile;
        }
      }
      while (b - a > 1) {
        const int mid = (a + b) >> 1;
        if (starts[mid] <= k) a = mid; else b = mid;
      }
      row = a;
      first_row[t] = static_cast<int32_t>(start + row);
    }
  }
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// Bytes i, i + 1, ... of a resolved piece x of q, into acc from byte
// `filled` on, until `want` bytes are filled or the piece ends; returns the
// bytes filled.
__device__ __forceinline__ int emit_piece(const Piece& q, const Row& x,
                                          const uint8_t* s_lit, int32_t i,
                                          int want, int filled, uint4& acc) {
  const bool inl = (q.flags & kInlined) != 0;
  const uint8_t* src = inl ? s_lit + q.lit_off : q.src;
  int k = static_cast<int>(min(x.len - i, static_cast<int64_t>(want -
                                                               filled)));
  const int32_t w = x.span;
  const bool plain = w >= x.len;
  bool have = false;
  uint4 cyc = make_uint4(0, 0, 0, 0);
  while (k > 0) {
    const int32_t ph = plain ? i : i % w;
    const int run = plain ? k : min(k, w - ph);
    uint4 v;
    if (inl) {
      v = copy16::load_bytes(src + x.start + ph, run);
    } else if (!plain && w < 16 && ph == 0 && run == w) {
      // a whole cycle of a short span: loaded once, placed from here on
      if (!have) {
        cyc = copy16::load_run(src, q.src_len, x.start, w);
        have = true;
      }
      v = cyc;
    } else {
      v = copy16::load_run(src, q.src_len, x.start + ph, run);
    }
    acc = or4(acc, copy16::place(v, run, filled));
    filled += run;
    i += run;
    k -= run;
  }
  return filled;
}

// The bytes of row r from byte pos of the row on, into acc at byte
// `filled`, until `want` bytes are filled or the row ends, its pieces
// resolved here (a block whose rows' pieces did not fit its stage);
// returns the bytes filled.
__device__ __forceinline__ int emit_row(const Piece* ps, int np,
                                        bool has_fill, const uint8_t* s_lit,
                                        int64_t r, int64_t pos, int want,
                                        int filled, uint4& acc) {
  const int64_t others = has_fill ? row_others(ps, np, r) : 0;
  bool seen = false;
  for (int j = 0; j < np && filled < want; ++j) {
    const Row x = resolve(ps[j], r, seen, others);
    if (pos >= x.len) {
      pos -= x.len;
      continue;
    }
    filled = emit_piece(ps[j], x, s_lit, static_cast<int32_t>(pos), want,
                        filled, acc);
    pos = 0;
  }
  return filled;
}

// An output word from the block's stage: bytes q .. q + want - 1, the
// first in staged row i. A word inside one run of a device source (a long
// row) is one copy16 load; any other is walked once in shared memory, each
// byte's address noted (a device source, or the inline bytes in shared
// memory), so that its 16 byte loads are all in flight at once; a cycle's
// phase steps with the byte, with no division.
__device__ __forceinline__ uint4 staged_word(
    const Piece* ps, int np, const uint8_t* s_lit, const int32_t* s_off,
    const int32_t* s_len, const int32_t* s_start, const int32_t* s_span,
    int i, int64_t q, int want) {
  int e = i * np, j = 0;
  int32_t pos = static_cast<int32_t>(q - s_off[i]), len = s_len[e];
  while (pos >= len) {  // the piece holding byte q
    pos -= len;
    ++e;
    j = j + 1 == np ? 0 : j + 1;
    len = s_len[e];
  }
  const uint8_t* base;
  int32_t span, ph;
  auto enter = [&]() {
    const Piece& pc = ps[j];
    base = ((pc.flags & kInlined) ? s_lit + pc.lit_off : pc.src) +
           s_start[e];
    span = s_span[e] < len ? s_span[e] : len;
    ph = pos % span;
  };
  enter();
  if (len - pos >= want && span - ph >= want &&
      !(ps[j].flags & kInlined)) {
    const Piece& pc = ps[j];
    return copy16::place(
        copy16::load_run(pc.src, pc.src_len, s_start[e] + ph, want), want,
        0);
  }
  const uint8_t* addr[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (b < want) {
      addr[b] = base + ph;
      ++pos;
      if (++ph == span) ph = 0;
      if (pos == len && b + 1 < want) {  // on to the next piece with bytes
        do {
          ++e;
          j = j + 1 == np ? 0 : j + 1;
          len = s_len[e];
        } while (len == 0);
        pos = 0;
        enter();
      }
    }
  }
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (b < want) {
      w[b >> 2] |= static_cast<unsigned>(*addr[b]) << (8 * (b & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The last row in [a, b) whose offset is <= k (offsets[a] <= k).
__device__ __forceinline__ int64_t row_in(const int32_t* offsets, int64_t a,
                                          int64_t b, int64_t k) {
  while (b - a > 1) {
    const int64_t mid = (a + b) >> 1;
    if (offsets[mid] <= k) a = mid; else b = mid;
  }
  return a;
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads)
concat_write_kernel(const __grid_constant__ Params p,
                    const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ first_row, int64_t total,
                    int words, uint8_t* __restrict__ out) {
  __shared__ int32_t s_off[kStageRows + 1];
  // the block's rows' resolved pieces (row * np + piece), where they fit
  __shared__ int32_t s_len[kStageRuns], s_start[kStageRuns],
      s_span[kStageRuns];
  __shared__ __align__(8) uint8_t s_lit[kInline];
  __shared__ Piece s_pieces[kTable ? 1 : kMaxPieces];
  const int64_t n = p.n;
  const int np = p.npieces;
  const bool has_fill = p.has_fill != 0;
  const Piece* ps = stage_pieces<kTable>(p, s_pieces);
  // the block's tile: `words` of the kTileBytes tiles the offsets pass
  // noted
  const int64_t notes = (total + kTileBytes - 1) / kTileBytes;
  const int64_t b = blockIdx.x * static_cast<int64_t>(words);
  const int64_t k0 = b * kTileBytes;
  const int64_t k1 = min(k0 + words * kTileBytes, total);
  // the rows [c, r_end) hold the block's bytes
  const int64_t c = first_row[b];
  const int64_t r_end = b + words < notes ? first_row[b + words] + 1 : n;
  const int64_t m = r_end - c;
  const bool staged = m <= kStageRows;
  if (staged) {
    for (int64_t i = threadIdx.x; i <= m; i += kThreads) {
      s_off[i] = offsets[c + i];
    }
  }
  for (int i = threadIdx.x; 8 * i < p.lit_len; i += kThreads) {
    reinterpret_cast<long long*>(s_lit)[i] =
        reinterpret_cast<const long long*>(p.lit)[i];
  }
  // each row's pieces resolved once, by a thread a row (neighbouring lanes,
  // neighbouring rows), rather than by every thread whose word it touches
  const bool runs = staged && m * np <= kStageRuns;
  if (runs) {
    __syncthreads();  // the pieces staged
    for (int64_t i0 = 0; i0 < m; i0 += kThreads * kRows) {
      int64_t r[kRows], len[kRows];
      bool live[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        r[k] = c + i0 + k * kThreads + threadIdx.x;
        live[k] = r[k] < r_end;
      }
      resolve_rows<kRows>(ps, np, has_fill, r, live, len,
                          [&](int k, int j, const Row& x) {
                            const int64_t at = (r[k] - c) * np + j;
                            s_len[at] = static_cast<int32_t>(x.len);
                            s_start[at] = static_cast<int32_t>(x.start);
                            s_span[at] = x.span;
                          });
    }
  }
  __syncthreads();
  // a word of each of the block's kTileBytes tiles (a warp stores 512
  // consecutive bytes)
  for (int64_t q = k0 + 16 * static_cast<int64_t>(threadIdx.x); q < k1;
       q += kTileBytes) {
    const int want = static_cast<int>(k1 - q < 16 ? k1 - q : 16);
      int64_t r = staged ? c + copy16::find_row(s_off, static_cast<int>(m), q)
                       : row_in(offsets, c, r_end, q);
    uint4 acc = make_uint4(0, 0, 0, 0);
    if (runs) {
      acc = staged_word(ps, np, s_lit, s_off, s_len, s_start, s_span,
                        static_cast<int>(r - c), q, want);
    } else {
      // rows of no bytes, or too many pieces, for the stage: the thread
      // walks its word's rows and resolves their pieces itself
      int filled = 0;
      while (true) {
        const int64_t ro = staged ? s_off[r - c] : offsets[r];
        filled = emit_row(ps, np, has_fill, s_lit, r, q + filled - ro, want,
                          filled, acc);
        if (filled >= want) break;
        // the next row that holds a byte: the last one whose offset is <= q
        // + filled (rows of no bytes share their offset with the next row)
        r = staged ? c + copy16::find_row(s_off, static_cast<int>(m),
                                          q + filled)
                   : row_in(offsets, r + 1, r_end, q + filled);
      }
    }
    if (want == 16) {
      // out is 256-byte aligned and q a multiple of 16
      *reinterpret_cast<uint4*>(out + q) = acc;
    } else {
      copy16::store_bytes(out + q, acc, want);
    }
  }
}

// The launch's parameters: npieces descriptions from the host array
// `pieces` (at most kMaxPieces), or, with `table` a device pointer, from
// that table; lit_len (<= kInline) inline bytes.
bool params(const void* pieces, int npieces, const void* table,
            const void* lit, int lit_len, int64_t n, int has_fill,
            Params* p) {
  if (npieces < 1 || lit_len < 0 || lit_len > kInline) return false;
  if (table == nullptr && npieces > kMaxPieces) return false;
  if (table == nullptr) {
    const Piece* k = static_cast<const Piece*>(pieces);
    for (int j = 0; j < npieces; ++j) p->pieces[j] = k[j];
  }
  const uint8_t* l = static_cast<const uint8_t*>(lit);
  for (int i = 0; i < lit_len; ++i) p->lit[i] = l[i];
  p->table = static_cast<const Piece*>(table);
  p->n = n;
  p->npieces = npieces;
  p->has_fill = has_fill;
  p->lit_len = lit_len;
  return true;
}

}  // namespace

// status holds at least ceil(n / kTile) words of the workspace and ticket
// its counter; ticket_base is the number of tiles launched on them before
// and epoch this call's number, 1 to 2^30 - 1. offsets holds n + 1 int32,
// first_row max_tiles int32 (an entry for each kTileBytes bytes of a total
// below 2^31), total one int64.
extern "C" int exon_span_concat_offsets(const void* pieces, int npieces,
                                        const void* table, const void* lit,
                                        int lit_len, int64_t n, int has_fill,
                                        void* status, void* ticket,
                                        uint64_t ticket_base, uint64_t epoch,
                                        void* offsets, void* first_row,
                                        int64_t max_tiles, void* total,
                                        void* stream) {
  if (n == 0) return 0;
  Params p{};
  if (!params(pieces, npieces, table, lit, lit_len, n, has_fill, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<unsigned long long*>(status);
  auto* tk = static_cast<unsigned long long*>(ticket);
  auto* off = static_cast<int32_t*>(offsets);
  auto* fr = static_cast<int32_t*>(first_row);
  auto* tot = static_cast<long long*>(total);
  if (table != nullptr) {
    concat_offsets_kernel<true><<<static_cast<unsigned>(tiles), kThreads, 0,
                                  s>>>(p, st, tk, ticket_base, epoch, off, fr,
                                       max_tiles, tot);
  } else {
    concat_offsets_kernel<false><<<static_cast<unsigned>(tiles), kThreads, 0,
                                   s>>>(p, st, tk, ticket_base, epoch, off,
                                        fr, max_tiles, tot);
  }
  return static_cast<int>(cudaGetLastError());
}

// total = offsets[n], 1 to 2^31 - 1; out holds total bytes, 16-byte
// aligned.
extern "C" int exon_span_concat_write(const void* pieces, int npieces,
                                      const void* table, const void* lit,
                                      int lit_len, int64_t n, int has_fill,
                                      const void* offsets,
                                      const void* first_row, int64_t total,
                                      int words, void* out, void* stream) {
  if (total <= 0) return 0;
  Params p{};
  if (!params(pieces, npieces, table, lit, lit_len, n, has_fill, &p) ||
      words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (total + words * kTileBytes - 1) /
                         (words * kTileBytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* fr = static_cast<const int32_t*>(first_row);
  auto* o = static_cast<uint8_t*>(out);
  if (table != nullptr) {
    concat_write_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(p, off, fr, total, words, o);
  } else {
    concat_write_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(p, off, fr, total, words, o);
  }
  return static_cast<int>(cudaGetLastError());
}
