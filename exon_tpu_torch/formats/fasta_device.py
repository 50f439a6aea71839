"""FASTA decode on the device: raw bytes in, device batches out.

Counterpart of exon_tpu/formats/fasta_device.py (``split_chunks`` :37,
copied; ``decode_fasta_device`` :127 with its ``_phase1``/``_phase2`` :58,
:83). The host cuts the file at record boundaries into chunks of at most
128 MiB; each chunk is copied to the device once and decoded there by the
kernels of ``ops/device_text.py``: its lines, its header lines (the
``compact_mask`` kernel), the sequence offsets (``torch.cumsum`` over the
lines' body lengths) and one ``gather_spans`` per projected column. A chunk
yields one batch of exactly its records and bytes (no capacity buckets).

Semantics are the JAX device path's, which is the JAX package's default
scan: every '\\r' is dropped from every column, and so is every '>' of a
name. Unlike it, and like the host decoder, a chunk with sequence bytes
before its first header, or with no header at all, raises
``InvalidSequenceError`` (ROADMAP Queue 3, F7). The integer sequence
encodings (:99-104, ``DNA_CODE``/``PROTEIN_CODE``) map the gathered
sequence bytes through map_bytes' widen mode to int8 codes, a List<Int8>
column over the same offsets; a byte outside the alphabet (code 0) raises
``InvalidSequenceError``, as in the JAX device path.
"""

from __future__ import annotations

import functools
from typing import Iterator, Optional

import numpy as np
import torch

from ..batch import Batch, FixedColumn, ListColumn, VarColumn
from ..errors import InvalidSequenceError
from ..kernels.compact_mask import compact_mask
from ..kernels.gather_spans import gather_spans
from ..kernels.map_bytes import map_bytes_widen
from ..ops.device_text import (CR, NL, chunk_to_device, host_ints,
                               lengths_to_offsets, line_table, span_column)
from .fasta import ENCODINGS, FastaOptions, fasta_schema

DEFAULT_CHUNK = 128 << 20  # 128 MiB raw bytes per device chunk
GT = ord(">")


def split_chunks(data: bytes, max_chunk: int = DEFAULT_CHUNK
                 ) -> list[tuple[int, int]]:
    """Split at record boundaries ('\\n>') so every chunk is whole records."""
    n = len(data)
    if n <= max_chunk:
        return [(0, n)]
    spans = []
    start = 0
    while start < n:
        end = min(start + max_chunk, n)
        if end < n:
            cut = data.rfind(b"\n>", start, end)
            if cut <= start:
                cut = data.find(b"\n>", end)
                end = n if cut == -1 else cut + 1
            else:
                end = cut + 1
        spans.append((start, end))
        start = end
    return spans


@functools.lru_cache(maxsize=None)
def encoding_table(encoding: str, device: torch.device) -> torch.Tensor:
    """The encoding's table as int64 on ``device``, copied there once."""
    return torch.from_numpy(ENCODINGS[encoding][0].astype(np.int64)).to(
        device)


def encode_sequence(col: VarColumn, encoding: str) -> ListColumn:
    """The sequence bytes as int8 codes through the encoding's table (the
    widen mode of map_bytes); a byte outside the alphabet raises."""
    codes = map_bytes_widen(
        col.values, encoding_table(encoding, col.values.device), torch.int8)
    if bool((codes == 0).any()):
        raise InvalidSequenceError(
            f"invalid {ENCODINGS[encoding][1]} in FASTA sequence")
    return ListColumn(FixedColumn(codes, torch.ones_like(codes,
                                                         dtype=torch.bool)),
                      col.offsets, col.validity)


def decode_chunk(chunk: torch.Tensor, ends_in_newline: bool,
                 projection: list[str], schema,
                 encoding: str = "utf8") -> Optional[Batch]:
    """One chunk of whole records (a uint8 tensor) → one batch; None for a
    chunk of blank lines alone."""
    want_hdr = "id" in projection or "description" in projection
    lines = line_table(chunk, ends_in_newline, False, want_hdr)
    hdr_idx, n_hdr = compact_mask(lines.is_hdr)
    seq_offs = lengths_to_offsets(lines.body)  # per line; headers add 0
    # body bytes before the first header (hdr_idx[0] is L when there is none)
    pre = seq_offs[hdr_idx[0].long()]
    scalars = [n_hdr, seq_offs[-1], pre]
    if want_hdr:
        scalars += [lines.name_len.sum(), lines.desc_len.sum()]
    totals = host_ints(*scalars)
    n_rec, seq_total, pre = totals[:3]
    if pre:
        raise InvalidSequenceError("FASTA data before first header")
    if n_rec == 0:
        return None  # blank lines before the first record's chunk
    hdr = hdr_idx[:n_rec].long()
    valid = torch.ones(n_rec, dtype=torch.bool, device=chunk.device)
    cols = {}
    if "sequence" in projection:
        # one span per line (a header's is empty), so a long record is
        # copied by many warps; the record offsets are its header line's
        stops = torch.where(lines.is_hdr, lines.start, lines.end)
        cols["sequence"] = VarColumn(
            gather_spans(chunk, lines.start, stops, seq_offs[:-1], seq_total),
            torch.cat([seq_offs.index_select(0, hdr), seq_offs[-1:]]), valid)
        if encoding in ENCODINGS:
            cols["sequence"] = encode_sequence(cols["sequence"], encoding)
    if want_hdr:
        name_total, desc_total = totals[3:]
        start, end, split = (t.index_select(0, hdr) for t in
                             (lines.start, lines.end, lines.split))
        if "id" in projection:
            cols["id"] = span_column(
                chunk, start + 1, split,
                lengths_to_offsets(lines.name_len.index_select(0, hdr)),
                name_total, valid, (CR, GT))
        if "description" in projection:
            cols["description"] = span_column(
                chunk, torch.minimum(split + 1, end), end,
                lengths_to_offsets(lines.desc_len.index_select(0, hdr)),
                desc_total, split < end)
    return Batch(schema, [cols[name] for name in projection], n_rec)


def decode_fasta_device(data, options: FastaOptions,
                        projection: Optional[list[str]] = None,
                        device="cpu", max_chunk: int = DEFAULT_CHUNK
                        ) -> Iterator[Batch]:
    """Decode raw FASTA bytes into batches on ``device``."""
    schema = fasta_schema(options)
    proj = list(projection) if projection is not None else schema.names
    schema = schema.project(proj)
    if isinstance(data, np.ndarray):
        data = data.tobytes()  # split_chunks wants bytes
    if not data:
        return
    found = False
    for lo, hi in split_chunks(data, max_chunk):
        chunk = chunk_to_device(data, lo, hi, device)
        batch = decode_chunk(chunk, data[hi - 1] == NL, proj, schema,
                             options.sequence_data_type)
        if batch is not None:
            found = True
            yield batch
    if not found:
        raise InvalidSequenceError("no FASTA records found (no '>' headers)")
