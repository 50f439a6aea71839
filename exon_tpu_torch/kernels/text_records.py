"""text_records: per-line structure of a FASTA or FASTQ chunk.

Replaces exon_tpu/ops/device_text.py ``record_structure`` (:92) and
``first_match_in_segment`` (:115), and the keep masks + ``segment_lengths``
(:78) of formats/fasta_device.py ``_phase1``/``_phase2`` (:59, :85) and
formats/fastq.py ``_device_decode`` (:102). Kernel source:
``csrc/text_records.cu``.

``text_records(chunk, nl, n_lines, fastq, want_hdr)`` takes the chunk, the
positions of its newlines (``line_index``) and its line count, and returns
``Lines``: for every line its span without the '\\n', whether it is a header
(FASTA: starts with '>'; FASTQ: line id mod 4 is 0), its body length (bytes
that are not '\\r'; 0 for a header) and, with ``want_hdr``, for header lines
the first space after the marker (``split``, or the line end) and the kept
lengths of the name ``[start+1, split)`` and the description
``[split+1, end)``. The name drops '\\r' and, in FASTA, every '>' (as the JAX
name mask does); the description drops '\\r'. ``bad`` counts FASTQ header
lines that do not start with '@'.

On the card a call is two launches of ``csrc/text_records.cu`` and no
sync: a lane a line reads its 16-byte words (a header past ``LONG_AT``
bytes is read by its warp), and body lines past ``LONG_AT`` bytes are
counted by whole warps in 16 KB pieces in the second launch. Every output,
with the pieces' list, lies in one int32 buffer, of which the fields are
views; nothing is zeroed (the two counts the kernels add to are status
words of ``_lookback``'s workspace, tagged with the call's epoch). A call
counts one in ``launches``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _build, _lookback

launches = 0

CR, SPACE = 13, 32
LONG_AT = 512        # kLongAt in csrc/text_records.cu: longer lines are
                     # shared across warps
_PIECE = 16384       # kPiece there
_INT32_LIMIT = 1 << 31
GT, AT = ord(">"), ord("@")


@dataclasses.dataclass
class Lines:
    start: torch.Tensor               # int32 [L]
    end: torch.Tensor                 # int32 [L], exclusive, before '\n'
    is_hdr: torch.Tensor              # bool [L]
    body: torch.Tensor                # int32 [L]
    split: Optional[torch.Tensor]     # int32 [L] (want_hdr only)
    name_len: Optional[torch.Tensor]  # int32 [L] (want_hdr only)
    desc_len: Optional[torch.Tensor]  # int32 [L] (want_hdr only)
    bad: torch.Tensor                 # int32 0-d


def _name_drop(fastq: bool) -> int:
    return CR if fastq else GT


def text_records_plain(chunk: torch.Tensor, nl: torch.Tensor, n_lines: int,
                       fastq: bool, want_hdr: bool) -> Lines:
    """The plain PyTorch twin: byte classes by ``nonzero``, counts inside
    spans by ``searchsorted`` over their positions."""
    dev, n = chunk.device, chunk.shape[0]
    nl64 = nl.long()
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        nl64 + 1])[:n_lines]
    ends = torch.cat([nl64, torch.tensor([n], device=dev)])[:n_lines]
    first = chunk[starts.clamp(max=max(n - 1, 0))]
    if fastq:
        is_hdr = torch.arange(n_lines, device=dev) % 4 == 0
        bad = (is_hdr & (first != AT)).sum().to(torch.int32)
    else:
        is_hdr = first == GT
        bad = torch.zeros((), dtype=torch.int32, device=dev)

    def positions(byte: int) -> torch.Tensor:
        return torch.nonzero(chunk == byte).flatten()

    def inside(pos: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
        """How many of ``pos`` lie in each [lo, hi)."""
        return torch.searchsorted(pos, hi) - torch.searchsorted(pos, lo)

    cr = positions(CR)
    zero = torch.zeros_like(starts)
    body = torch.where(is_hdr, zero, ends - starts - inside(cr, starts, ends))
    out = Lines(starts.to(torch.int32), ends.to(torch.int32), is_hdr,
                body.to(torch.int32), None, None, None, bad)
    if not want_hdr:
        return out
    sp = positions(SPACE)
    name_lo = starts + 1
    if sp.shape[0]:
        j = torch.searchsorted(sp, name_lo)
        found = sp[j.clamp(max=sp.shape[0] - 1)]
        split = torch.where(j < sp.shape[0], torch.minimum(found, ends), ends)
    else:
        split = ends
    name_hi = torch.maximum(split, name_lo)
    name_len = name_hi - name_lo - inside(cr, name_lo, name_hi)
    if not fastq:
        name_len = name_len - inside(positions(GT), name_lo, name_hi)
    desc_lo = torch.minimum(split + 1, ends)
    desc_len = ends - desc_lo - inside(cr, desc_lo, ends)
    out.split = torch.where(is_hdr, split, ends).to(torch.int32)
    out.name_len = torch.where(is_hdr, name_len, zero).to(torch.int32)
    out.desc_len = torch.where(is_hdr, desc_len, zero).to(torch.int32)
    return out


def _layout(n: int, n_lines: int, want_hdr: bool) -> tuple:
    """Where the outputs lie in the call's one int32 buffer, by first word:
    ``bad`` (after the 3, or with want_hdr 6, int32 fields of ``n_lines``
    words each, and before the header flags, a byte a line) and the long
    lines' pieces (int32 pairs); and the words in all."""
    fields = 6 if want_hdr else 3
    bad = fields * n_lines
    pieces = bad + 1 + (n_lines + 3) // 4
    pieces += pieces % 2  # 8-byte aligned for int2
    cap = n // _PIECE + 2 * (n // LONG_AT) + 2
    return bad, pieces, pieces + 2 * cap


def text_records(chunk: torch.Tensor, nl: torch.Tensor, n_lines: int,
                 fastq: bool, want_hdr: bool) -> Lines:
    global launches
    if chunk.dtype != torch.uint8 or chunk.dim() != 1:
        raise TypeError(f"text_records: chunk must be 1-d uint8, got "
                        f"{chunk.dtype} {tuple(chunk.shape)}")
    if nl.dtype != torch.int32 or nl.dim() != 1 or nl.device != chunk.device:
        raise TypeError("text_records: nl must be 1-d int32 on the chunk's "
                        "device")
    k, n = nl.shape[0], chunk.shape[0]
    if n_lines not in (k, k + 1) or (n_lines and n == 0):
        raise ValueError(f"text_records: {n_lines} lines for {k} newlines "
                         f"in {n} bytes")
    if n >= _INT32_LIMIT:
        raise ValueError(f"text_records: {n} bytes exceed int32 positions")
    if not _build.on_cuda(chunk, "text_records"):
        return text_records_plain(chunk, nl, n_lines, fastq, want_hdr)
    chunk, nl = chunk.contiguous(), nl.contiguous()
    if chunk.data_ptr() % 16:
        chunk = chunk.clone()  # the kernel reads 16-byte words
    dev = chunk.device
    bad, pieces, words = _layout(n, n_lines, want_hdr)
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    if n_lines:
        # the pointers from the buffer's base; the views come after the
        # launch, off its path
        base = buf.data_ptr()
        fields = [base + 4 * j * n_lines for j in range(6)]
        hdr = fields[3:] if want_hdr else [0, 0, 0]
        stream = _build.stream_of(chunk)

        def launch(status, _ticket, _base, epoch):
            # the two kernels; status words 0 and 1 count the long lines'
            # pieces and the bad FASTQ headers (tagged with this epoch)
            _build.check(_build.library().exon_text_records(
                chunk.data_ptr(), n, nl.data_ptr(), k, n_lines, int(fastq),
                _name_drop(fastq), fields[0], fields[1],
                base + 4 * (bad + 1), fields[2], *hdr,
                base + 4 * bad, base + 4 * pieces, status, epoch, stream),
                "text_records")

        _lookback.scan(dev, stream, 2, 0, launch)
        launches += 1

    def field(j: int):
        return buf[j * n_lines:(j + 1) * n_lines]

    flags = buf[bad + 1:pieces].view(torch.uint8)[:n_lines].view(torch.bool)
    out = Lines(field(0), field(1), flags, field(2),
                *((field(3), field(4), field(5)) if want_hdr else
                  (None, None, None)), buf[bad])
    if n_lines == 0:
        out.bad.zero_()
    return out
