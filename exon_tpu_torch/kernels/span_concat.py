"""span_concat: output rows assembled from pieces of byte spans.

Replaces the per-row assembly of exon_tpu/ops/sqlfuncs.py: ``_concat_cols``
(:268) for ``concat``, ``||`` and ``concat_ws`` (:325-363), the string
branch of ``fn_coalesce`` (:779), ``_pad`` (:387) and ``fn_repeat`` (:366).
Kernel source: ``csrc/span_concat.cu``.

``span_concat(sources, pieces, n=None, device=None)`` takes a list of
sources, each a 1-d uint8 tensor or literal ``bytes``, and a list of
``Piece``s (a tuple ``(source index, start, span, length)`` is a Piece of
those fields), and returns ``(offsets int32 [n+1], values uint8)``: output
row r is its pieces in order, byte i of a piece being
``source[start[r] + i % span[r]]`` for ``i < length[r]`` (a span at least
as long as the piece is a plain copy, a shorter one repeats). Each of
start, span and length is an int32 ``[n]`` tensor or one int for every row;
see ``Piece`` for the column form, the repeat, cut and fill rules and the
validity gates. A total of 2^31 bytes or more raises ExecutionError, as
int32 offsets cannot address it; ``values`` holds exactly ``offsets[n]``
bytes.

On the card a call is two launches around one host read: an offsets pass
(each row's length from its pieces, scanned on the look-back of
``_lookback``), the total's read, and a write pass over tiles of output
bytes (``tile_words`` 4 KB tiles a block) in 16-byte words. The pieces
travel by value in the launches' parameters (``MAX_PIECES`` of them,
literal bytes inline up to ``INLINE_BYTES``); nothing is uploaded or
stacked, except for a call of more pieces, whose descriptions go to the
card as a table.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional, Union

import torch

from ..errors import ExecutionError
from . import _build, _lookback

launches = 0

_INT32_LIMIT = 1 << 31
GATES = {"always": 0, "valid": 1, "join": 2, "first": 3}
_ENDS = 4       # csrc kEnds
_INLINED = 8    # csrc kInlined
# pieces a launch's parameters hold (csrc kMaxPieces); a call with more
# passes them as a device table
MAX_PIECES = 32
# literal bytes a launch's parameters hold (csrc kInline; the source's head
# note says why); a longer literal is uploaded once and kept (_device_bytes)
INLINE_BYTES = 512
PIECE_SLOTS = 11  # a piece's 88 bytes in csrc's Piece, as int64 slots
TILE_ROWS = 256 * 4    # rows of an offsets tile (kTile)
TILE_BYTES = 256 * 16  # output bytes the offsets pass notes (kTileBytes)
# a write block's stage (kStageRows, kStageRuns) and its most tiles
STAGE_ROWS = 4096
STAGE_RUNS = 2048
MAX_WORDS = 16
# an output tile's first row for every TILE_BYTES bytes of a total below
# 2^31
_MAX_TILES = -(-(_INT32_LIMIT - 1) // TILE_BYTES)
# times is clamped here: a row of one byte repeated 2^32 times is already
# past the limit, and base x times stays inside int64
_MAX_TIMES = 1 << 32

Field = Union[torch.Tensor, int]


@dataclasses.dataclass(frozen=True)
class Piece:
    """One piece of every output row.

    ``src`` indexes the sources. ``start``: an int32 ``[n]`` tensor, one int,
    or, with ``length`` None, a column's int32 offsets ``[n+1]`` (start
    ``offsets[r]``, base length ``offsets[r+1] - offsets[r]``). ``length``:
    the base length, a tensor or an int; None for a column, or for a literal
    source (its bytes from ``start`` on). ``span``: the cycle, a tensor or
    an int; None for the base length. The piece's length is then the base
    times ``times``, cut to ``cap`` where one is given; a ``fill`` piece's
    is instead what the row's other (non-fill) pieces leave of ``fill``
    bytes. Negative lengths are 0.

    ``gate`` with ``valid`` (a bool ``[n]`` tensor, None for every row
    valid) opens the piece: "always"; "valid" where valid; "join" where
    valid and an earlier "valid" or "first" piece of the row was valid
    (concat_ws' separator, given the next argument's validity); "first"
    where valid and no earlier one was (coalesce). A closed piece is empty.
    """

    src: int
    start: Field = 0
    span: Optional[Field] = None
    length: Optional[Field] = None
    times: int = 1
    cap: Optional[int] = None
    fill: Optional[int] = None
    valid: Optional[torch.Tensor] = None
    gate: str = "always"


def _as_piece(p) -> Piece:
    if isinstance(p, Piece):
        return p
    src, start, span, length = p
    return Piece(src, start, span, length)


def _ends(p: Piece) -> bool:
    return p.length is None and isinstance(p.start, torch.Tensor)


def _rows_of(p: Piece) -> Optional[int]:
    """The row count a piece's tensors imply, if any."""
    if isinstance(p.length, torch.Tensor):
        return p.length.shape[0]
    if isinstance(p.span, torch.Tensor):
        return p.span.shape[0]
    if isinstance(p.start, torch.Tensor):
        return p.start.shape[0] - (1 if _ends(p) else 0)
    if p.valid is not None:
        return p.valid.shape[0]
    return None


def _normalize(sources: list, pieces: list, n, device) -> tuple:
    """(n, device, pieces as Piece) after checking every source and
    field."""
    if not pieces:
        raise ValueError("span_concat needs at least one piece")
    pieces = [p if type(p) is Piece else _as_piece(p) for p in pieces]
    if n is None:
        n = next((k for k in map(_rows_of, pieces) if k is not None), None)
        if n is None:
            raise ValueError("span_concat: no tensor gives the row count; "
                             "pass n")
    if device is None:
        device = next((t.device for p in pieces
                       for t in (p.start, p.span, p.length, p.valid)
                       if isinstance(t, torch.Tensor)), None)
        if device is None:
            device = next((s.device for s in sources
                           if isinstance(s, torch.Tensor)), None)
        if device is None:
            raise ValueError("span_concat: no tensor gives the device; "
                             "pass device")
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # get_device()'s number (-1 on the CPU): cheaper to compare than
    # torch.device
    index = device.index if device.type == "cuda" else -1

    def same(t):
        if t.get_device() != index:
            raise ValueError("span_concat: tensors on different devices")

    for s in sources:
        if isinstance(s, (bytes, bytearray)):
            continue
        if not isinstance(s, torch.Tensor) or s.dtype != torch.uint8 or \
                s.dim() != 1:
            raise TypeError("span_concat: a source must be 1-d uint8 or "
                            f"bytes, got {getattr(s, 'dtype', type(s))}")
        same(s)
    for p in pieces:
        if not 0 <= p.src < len(sources):
            raise ValueError(f"span_concat: no source {p.src}")
        if p.gate not in GATES:
            raise ValueError(f"span_concat: gate must be one of "
                             f"{sorted(GATES)}, got {p.gate!r}")
        ends = _ends(p)
        if p.length is None and not ends and \
                not isinstance(sources[p.src], (bytes, bytearray)):
            raise ValueError("span_concat: a piece of a device source needs "
                             "a length or its column's offsets")
        for name, t in (("start", p.start), ("span", p.span),
                        ("length", p.length)):
            if isinstance(t, torch.Tensor):
                rows = n + 1 if ends and name == "start" else n
                if t.dtype != torch.int32 or t.dim() != 1 or \
                        t.shape[0] != rows:
                    raise TypeError(f"span_concat: a piece's {name} must be "
                                    f"int32 [{rows}] or an int")
                same(t)
            elif t is not None and not isinstance(t, int):
                raise TypeError(f"span_concat: a piece's {name} must be a "
                                "tensor or an int")
        v = p.valid
        if v is not None:
            if v.dtype != torch.bool or v.dim() != 1 or v.shape[0] != n:
                raise TypeError(f"span_concat: validity must be bool [{n}]")
            same(v)
    return n, device, pieces


def _check_total(total: int) -> None:
    if total >= _INT32_LIMIT:
        raise ExecutionError(f"a string function's result holds {total} "
                             "bytes; int32 offsets address fewer than 2^31")


def _per_row(v: Field, n: int, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    return torch.full((n,), int(v), dtype=torch.int64, device=device)


def _resolve(sources: list, pieces: list, n: int, device) -> list:
    """Each piece as (source tensor, start, span, length) int64 [n] rows,
    by the rules of ``Piece``."""
    out, seen = [], torch.zeros(n, dtype=torch.bool, device=device)
    others = torch.zeros(n, dtype=torch.int64, device=device)
    for p in pieces:
        src = sources[p.src]
        if isinstance(src, (bytes, bytearray)):
            src = torch.frombuffer(bytearray(src) or bytearray(1),
                                   dtype=torch.uint8)[:len(src)].to(device)
        if _ends(p):
            off = p.start.to(torch.int64)
            start, base = off[:-1], off[1:] - off[:-1]
        else:
            start = _per_row(p.start, n, device)
            base = (_per_row(p.length, n, device) if p.length is not None
                    else src.shape[0] - start)
        length = base * min(p.times, _MAX_TIMES)
        if p.cap is not None:
            length = length.clamp(max=p.cap)
        ok = (p.valid if p.valid is not None
              else torch.ones(n, dtype=torch.bool, device=device))
        gate = p.gate
        open_ = {"always": torch.ones_like(ok), "valid": ok,
                 "join": ok & seen, "first": ok & ~seen}[gate]
        if gate in ("valid", "first"):
            seen = seen | ok
        span = base if p.span is None else _per_row(p.span, n, device)
        if p.fill is None:
            length = torch.where(open_, length.clamp(min=0), 0)
            others = others + length
        out.append([src, start, span.clamp(min=1), length, open_])
    for p, row in zip(pieces, out):
        if p.fill is not None:
            row[3] = torch.where(row[4], (p.fill - others).clamp(min=0), 0)
    return [row[:4] for row in out]


def span_concat_plain(sources: list, pieces: list, n=None, device=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin: every piece's rows resolved, the offsets by
    ``torch.cumsum``, then per piece a per-byte row id and rank, each byte
    written at its row's running position."""
    n, dev, pieces = _normalize(sources, pieces, n, device)
    rows = _resolve(sources, pieces, n, dev)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    if rows:
        torch.cumsum(sum(r[3] for r in rows), 0, out=offsets[1:])
    total = int(offsets[-1])
    _check_total(total)
    out = torch.zeros(total, dtype=torch.uint8, device=dev)
    base = offsets[:-1]
    for src, start, span, ln in rows:
        rid = torch.repeat_interleave(torch.arange(n, device=dev), ln)
        i = torch.arange(rid.shape[0], device=dev) - \
            (torch.cumsum(ln, 0) - ln)[rid]
        out[base[rid] + i] = src[start[rid] + i % span[rid]]
        base = base + ln
    return offsets.to(torch.int32), out


@functools.lru_cache(maxsize=64)
def _device_bytes(b: bytes, index: int) -> torch.Tensor:
    """A literal too long to travel inline, on card ``index``: uploaded on
    its first use and kept."""
    return torch.tensor(list(b) or [0], dtype=torch.uint8,
                        device=torch.device("cuda", index))[:len(b)]


def _slots(pieces: list, sources: list, inline: dict, index: int,
           keep: list) -> ctypes.Array:
    """The pieces in csrc's layout, PIECE_SLOTS int64 each: the source, the
    start, span, length and validity pointers, the source's bytes, times,
    start | span << 32, length | cap << 32, fill | flags << 32 and the
    inline offset."""
    slots = []
    for p in pieces:
        src = sources[p.src]
        flags = GATES[p.gate]
        lit_off = src_ptr = 0
        if isinstance(src, (bytes, bytearray)):
            src_len = len(src)
            if p.src in inline:
                flags |= _INLINED
                lit_off = inline[p.src]
            else:
                t = _device_bytes(bytes(src), index)
                keep.append(t)
                src_ptr = t.data_ptr()
        else:
            if not src.is_contiguous():
                src = src.contiguous()
                keep.append(src)
            src_ptr, src_len = src.data_ptr(), src.shape[0]
        start, span, length = p.start, p.span, p.length
        start_p = span_p = len_p = start_c = span_c = len_c = 0
        if isinstance(start, torch.Tensor):
            start_p = start.data_ptr()
        else:
            start_c = int(start)
        if length is None:
            if isinstance(start, torch.Tensor):
                flags |= _ENDS
            else:
                len_c = src_len - start_c
        elif isinstance(length, torch.Tensor):
            len_p = length.data_ptr()
        else:
            len_c = int(length)
        if isinstance(span, torch.Tensor):
            span_p = span.data_ptr()
        elif span is not None:
            span_c = max(int(span), 1)
        cap = -1 if p.cap is None else max(int(p.cap), 0)
        fill = -1 if p.fill is None else max(int(p.fill), 0)
        slots += [src_ptr, start_p, span_p, len_p,
                  0 if p.valid is None else p.valid.data_ptr(), src_len,
                  min(int(p.times), _MAX_TIMES), _pack(start_c, span_c),
                  _pack(len_c, cap), _pack(fill, flags), lit_off]
    return (ctypes.c_int64 * len(slots))(*slots)


def _pack(lo: int, hi: int) -> int:
    """Two int32 as one int64 slot (lo in the low half, little-endian)."""
    v = (lo & 0xFFFFFFFF) | ((hi & 0xFFFFFFFF) << 32)
    return v - (1 << 64) if v >= 1 << 63 else v


def tile_words(n: int, total: int, npieces: int) -> int:
    """How many TILE_BYTES tiles a write block takes: the most, up to
    MAX_WORDS and a power of two, whose rows (at the call's mean row
    length) and (row, piece) runs fill at most half of the block's stage,
    so that a block of long rows amortises its set-up over more bytes."""
    rows = max(TILE_BYTES * n // max(total, 1), 1)
    words = 1
    while 2 * words <= MAX_WORDS and 2 * words * rows <= STAGE_ROWS // 2 \
            and 2 * words * rows * npieces <= STAGE_RUNS // 2:
        words *= 2
    return words


_first_rows: dict = {}
_lock = threading.Lock()


def _first_row(device: torch.device, stream: int) -> tuple:
    """The int32 [_MAX_TILES] buffer of output tiles' first rows of
    (device, stream), written by the offsets pass and read by the write
    pass of the same call, and the lock a call holds from one to the other
    (so that another thread's call on the stream cannot note its rows in
    between)."""
    key = (device.index, stream)
    with _lock:
        entry = _first_rows.get(key)
        if entry is None:
            entry = _first_rows[key] = (torch.empty(
                _MAX_TILES, dtype=torch.int32, device=device),
                threading.Lock())
    return entry


def span_concat(sources: list, pieces: list, n=None, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    n, dev, pieces = _normalize(sources, pieces, n, device)
    if dev.type == "cpu":
        return span_concat_plain(sources, pieces, n, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"span_concat: no kernel for tensors on {dev}")
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    if n == 0:
        return offsets.zero_(), torch.empty(0, dtype=torch.uint8, device=dev)
    table, keep, inline, lit = None, [], {}, b""
    if len(pieces) <= MAX_PIECES:
        for p in pieces:
            b = sources[p.src]
            if isinstance(b, (bytes, bytearray)) and p.src not in inline \
                    and len(lit) + len(b) <= INLINE_BYTES:
                inline[p.src] = len(lit)
                lit += bytes(b)
    slots = _slots(pieces, sources, inline, dev.index, keep)
    npieces = len(pieces)
    if npieces > MAX_PIECES:
        # the rare call of many pieces: their descriptions as a device table
        table = torch.frombuffer(slots, dtype=torch.int64).to(dev)
        slots = None
    has_fill = int(any(p.fill is not None for p in pieces))
    lib, stream = _build.library(), _build.stream_of(offsets)
    total_buf = torch.empty(1, dtype=torch.int64, device=dev)
    first, first_lock = _first_row(dev, stream)
    tiles = -(-n // TILE_ROWS)
    table_ptr = 0 if table is None else table.data_ptr()

    def offsets_pass(status, ticket, base, epoch):
        _build.check(lib.exon_span_concat_offsets(
            slots, npieces, table_ptr, lit, len(lit), n, has_fill, status,
            ticket, base, epoch, offsets.data_ptr(), first.data_ptr(),
            _MAX_TILES, total_buf.data_ptr(), stream), "span_concat")

    with first_lock:
        _lookback.scan(dev, stream, tiles, tiles, offsets_pass)
        launches += 1
        total = int(total_buf)  # the one host read: the output's size
        _check_total(total)
        out = torch.empty(total, dtype=torch.uint8, device=dev)
        if total:
            _build.check(lib.exon_span_concat_write(
                slots, npieces, table_ptr, lit, len(lit), n, has_fill,
                offsets.data_ptr(), first.data_ptr(), total,
                tile_words(n, total, npieces), out.data_ptr(), stream),
                "span_concat")
    return offsets, out
