"""Device text decode: raw FASTA/FASTQ bytes → line table → columns.

Counterpart of exon_tpu/ops/device_text.py. The JAX module parses a padded
buffer with per-byte masks, cumsums and cummaxes (``line_starts_mask`` :37,
``record_structure`` :92, ``first_match_in_segment`` :115, ``compact`` :57,
``segment_lengths`` :78). The port keeps a table of lines instead and works
per line and per span, through three kernels:

  * ``line_index``   — the newline positions of a chunk;
  * ``text_records`` — per line: its span, whether it is a header, its kept
                       body length, and a header's first space and the kept
                       lengths of its name and description;
  * ``gather_spans`` — spans copied to their column offsets, '\\r' dropped.

Record ids and column offsets are ``torch.cumsum`` over lines (Lib), as
``lengths_to_offsets`` (:87) is in the JAX package. Positions are int32:
a chunk holds fewer than 2^31 bytes.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..batch import VarColumn
from ..kernels.gather_spans import gather_spans
from ..kernels.line_index import line_index
from ..kernels.text_records import Lines, text_records

NL, CR = 10, 13


def chunk_to_device(data, lo: int, hi: int, device) -> torch.Tensor:
    """Bytes ``[lo, hi)`` of ``data`` (bytes or a uint8 array) as one uint8
    tensor on ``device``: one copy (a private one on the CPU too)."""
    view = np.frombuffer(data, np.uint8, count=hi - lo, offset=lo)
    with warnings.catch_warnings():
        # read-only bytes: the tensor is only read before it is copied
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(view)
    return host.to(device, copy=True)


def line_table(chunk: torch.Tensor, ends_in_newline: bool, fastq: bool,
               want_hdr: bool, nl: torch.Tensor = None) -> Lines:
    """The chunk's lines (``text_records``) from its newline positions
    (``line_index``, unless given). The last line is counted when the chunk
    does not end in '\\n'."""
    if nl is None:
        nl = line_index(chunk)
    tail = chunk.shape[0] > 0 and not ends_in_newline
    return text_records(chunk, nl, nl.shape[0] + int(tail), fastq, want_hdr)


def lengths_to_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """int32 Arrow offsets ``[m+1]`` of per-row lengths."""
    out = torch.zeros(lengths.shape[0] + 1, dtype=torch.int32,
                      device=lengths.device)
    torch.cumsum(lengths, 0, dtype=torch.int32, out=out[1:])
    return out


def host_ints(*scalars: torch.Tensor) -> list[int]:
    """Several 0-d device tensors read to the host at once (one sync)."""
    return torch.stack([s.to(torch.int64) for s in scalars]).tolist()


def span_column(chunk: torch.Tensor, starts: torch.Tensor, stops: torch.Tensor,
                offsets: torch.Tensor, total: int, validity: torch.Tensor,
                drop: tuple = (CR,)) -> VarColumn:
    """A var-width column whose row r is ``chunk[starts[r]:stops[r]]`` less
    the ``drop`` bytes; ``offsets`` are the kept lengths' (``total`` bytes)."""
    values = gather_spans(chunk, starts, stops, offsets[:-1], total, drop)
    return VarColumn(values, offsets, validity)
