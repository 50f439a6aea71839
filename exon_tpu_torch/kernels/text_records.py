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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _build

launches = 0

CR, SPACE = 13, 32
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


def text_records(chunk: torch.Tensor, nl: torch.Tensor, n_lines: int,
                 fastq: bool, want_hdr: bool) -> Lines:
    global launches
    if chunk.dtype != torch.uint8 or chunk.dim() != 1:
        raise TypeError(f"text_records: chunk must be 1-d uint8, got "
                        f"{chunk.dtype} {tuple(chunk.shape)}")
    if nl.dtype != torch.int32 or nl.dim() != 1 or nl.device != chunk.device:
        raise TypeError("text_records: nl must be 1-d int32 on the chunk's "
                        "device")
    k = nl.shape[0]
    if n_lines not in (k, k + 1) or (n_lines and chunk.shape[0] == 0):
        raise ValueError(f"text_records: {n_lines} lines for {k} newlines "
                         f"in {chunk.shape[0]} bytes")
    if not _build.on_cuda(chunk, "text_records"):
        return text_records_plain(chunk, nl, n_lines, fastq, want_hdr)
    chunk, nl = chunk.contiguous(), nl.contiguous()
    if chunk.data_ptr() % 16:
        chunk = chunk.clone()  # the kernel reads 4-byte words
    dev = chunk.device

    def i32():
        return torch.empty(n_lines, dtype=torch.int32, device=dev)

    out = Lines(i32(), i32(), torch.empty(n_lines, dtype=torch.uint8,
                                          device=dev), i32(),
                i32() if want_hdr else None, i32() if want_hdr else None,
                i32() if want_hdr else None,
                torch.zeros(1, dtype=torch.int32, device=dev))
    if n_lines:
        def ptr(t):
            return 0 if t is None else t.data_ptr()

        lib = _build.library()
        _build.check(lib.exon_text_records(
            chunk.data_ptr(), chunk.shape[0], nl.data_ptr(), k, n_lines,
            int(fastq), _name_drop(fastq), out.start.data_ptr(),
            out.end.data_ptr(), out.is_hdr.data_ptr(), out.body.data_ptr(),
            ptr(out.split), ptr(out.name_len), ptr(out.desc_len),
            out.bad.data_ptr(), _build.stream_of(chunk)), "text_records")
        launches += 1
    out.is_hdr = out.is_hdr.view(torch.bool)
    out.bad = out.bad[0]
    return out
