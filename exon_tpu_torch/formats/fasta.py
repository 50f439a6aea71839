"""FASTA decoder: whole-buffer vectorized numpy decode → host batches.

Copy of the numpy host path of exon_tpu/formats/fasta.py (``fasta_schema``
:55, ``decode_buffer`` :78-165, ``decoded_to_batches`` :203, ``_slice_var``
:226), without the native C++ scan (:168) and the prefix-staging decode
(:245). Schema ``id, description, sequence``; multi-line sequences; '>'
headers with name = chars to first space, description = rest (null if
absent). ``sequence_data_type`` takes utf8, large_utf8 or the integer
encodings (:27-56): ``integer_encode_dna`` (A, C, G, T, N → 1..5) and
``integer_encode_protein`` (25 letters → 1..25), a List<Int8> column, where
any other byte raises InvalidSequenceError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .. import datatypes as dt
from ..batch import Batch, FixedColumn, ListColumn, Schema, VarColumn
from ..errors import InvalidSequenceError
from .textutil import cumsum_exclusive, gather_slices, to_u8

# Integer encodings — reference: exon-fasta/src/array_builder.rs:144-205
DNA_CODE = np.zeros(256, dtype=np.int8)
for i, c in enumerate(b"ACGTN"):
    DNA_CODE[c] = i + 1
PROTEIN_CODE = np.zeros(256, dtype=np.int8)
for i, c in enumerate(b"ABCDEFGHIKLMNOPQRSTUVWYXZ"):
    PROTEIN_CODE[c] = i + 1
# each encoding's table and the word its error names
ENCODINGS = {"integer_encode_dna": (DNA_CODE, "nucleotide"),
             "integer_encode_protein": (PROTEIN_CODE, "amino acid")}

SEQUENCE_DTYPES = {
    "utf8": dt.utf8,
    "large_utf8": dt.large_utf8,
    "integer_encode_dna": dt.list_(dt.int8),
    "integer_encode_protein": dt.list_(dt.int8),
}


@dataclass
class FastaOptions:
    """Mirrors ListingFASTATableOptions (exon-core/src/datasources/fasta)."""

    sequence_data_type: str = "utf8"
    file_extension: str = ".fasta"
    batch_size: int = 8192
    projection: Optional[list[str]] = None


def fasta_schema(options: FastaOptions) -> Schema:
    return Schema.of(
        dt.Field("id", dt.utf8, nullable=False),
        dt.Field("description", dt.utf8, nullable=True),
        dt.Field("sequence", SEQUENCE_DTYPES[options.sequence_data_type],
                 nullable=False),
    )


@dataclass
class DecodedFasta:
    """Raw decoded arrays for a whole buffer (pre-batch-split)."""

    n: int
    name_values: np.ndarray
    name_offsets: np.ndarray
    desc_values: np.ndarray
    desc_offsets: np.ndarray
    desc_valid: np.ndarray
    seq_values: np.ndarray
    seq_offsets: np.ndarray


def decode_buffer(data, options: FastaOptions) -> DecodedFasta:
    arr = to_u8(data)
    if len(arr) == 0:
        z32 = np.zeros(1, np.int32)
        e8 = np.zeros(0, np.uint8)
        return DecodedFasta(0, e8, z32, e8, z32.copy(), np.zeros(0, bool), e8,
                            z32.copy())

    nl = np.flatnonzero(arr == 10)
    n_lines = len(nl) + (1 if (len(nl) == 0 or nl[-1] != len(arr) - 1) else 0)
    line_starts = np.zeros(n_lines, dtype=np.int64)
    line_starts[1:] = nl[: n_lines - 1] + 1
    line_ends = np.empty(n_lines, dtype=np.int64)
    line_ends[: len(nl[:n_lines])] = nl[:n_lines]
    if n_lines > len(nl):
        line_ends[-1] = len(arr)
    # CRLF tolerance
    cr = (line_ends > line_starts) & (arr[np.clip(line_ends - 1, 0, len(arr) - 1)] == 13)
    line_ends = np.where(cr, line_ends - 1, line_ends)

    is_header = arr[line_starts] == ord(">")
    hdr_idx = np.flatnonzero(is_header)
    n = len(hdr_idx)
    if n == 0:
        raise InvalidSequenceError("no FASTA records found (no '>' headers)")
    hstart = line_starts[hdr_idx]
    hend = line_ends[hdr_idx]

    # --- names & descriptions ---------------------------------------------
    sp = np.flatnonzero(arr == 32)
    if len(sp):
        i = np.searchsorted(sp, hstart)
        first_sp = np.where(i < len(sp), sp[np.clip(i, 0, len(sp) - 1)], hend)
        first_sp = np.minimum(first_sp, hend)
    else:
        first_sp = hend
    name_values, name_offsets = gather_slices(arr, hstart + 1, first_sp)
    has_desc = first_sp < hend
    desc_values, desc_offsets = gather_slices(arr, np.minimum(first_sp + 1, hend), hend)

    # --- sequences ---------------------------------------------------------
    keep = np.ones(len(arr), dtype=bool)
    keep[nl] = False
    cr_pos = np.flatnonzero(arr == 13)
    if len(cr_pos):
        keep[cr_pos] = False
    # zero out header lines including '>' (their newline already excluded)
    hdr_lens = hend - hstart
    if hdr_lens.sum() > 0:
        hdr_flat = np.repeat(hstart - cumsum_exclusive(hdr_lens)[:-1], hdr_lens) \
            + np.arange(int(hdr_lens.sum()), dtype=np.int64)
        keep[hdr_flat] = False
    seq_flat = arr[keep]
    # kept bytes before hstart_i = hstart_i − (#newlines before) −
    # (#CRs before) − (header-content bytes of earlier headers)
    hdr_cum = np.zeros(n, dtype=np.int64)
    np.cumsum(hdr_lens[:-1], out=hdr_cum[1:])
    rec_starts = (hstart
                  - np.searchsorted(nl, hstart)
                  - (np.searchsorted(cr_pos, hstart) if len(cr_pos) else 0)
                  - hdr_cum)
    seq_offsets = np.empty(n + 1, dtype=np.int64)
    seq_offsets[:-1] = rec_starts
    seq_offsets[-1] = len(seq_flat)
    # text before the first '>' is invalid FASTA
    if rec_starts[0] != 0:
        raise InvalidSequenceError("FASTA data before first header")
    if options.sequence_data_type in ENCODINGS:
        table, what = ENCODINGS[options.sequence_data_type]
        coded = table[seq_flat]
        if (coded == 0).any():
            bad = seq_flat[np.flatnonzero(coded == 0)[0]]
            raise InvalidSequenceError(f"invalid {what} {chr(bad)!r}")
        seq_flat = coded
    # offsets stay int64 here (a single buffer may exceed 2 GiB); the
    # per-batch slices rebase into int32 range in _slice_var
    return DecodedFasta(n, name_values, name_offsets, desc_values,
                        desc_offsets, has_desc, seq_flat, seq_offsets)


def decoded_to_batches(d: DecodedFasta, options: FastaOptions) -> Iterator[Batch]:
    """Split a decoded buffer into batches of ``batch_size`` rows."""
    schema = fasta_schema(options)
    proj = options.projection or schema.names
    schema = schema.project(proj)
    bs = options.batch_size
    for lo in range(0, d.n, bs):
        hi = min(lo + bs, d.n)
        cols = []
        for name in proj:
            if name == "id":
                cols.append(_slice_var(d.name_values, d.name_offsets, lo, hi))
            elif name == "description":
                c = _slice_var(d.desc_values, d.desc_offsets, lo, hi)
                c.validity = d.desc_valid[lo:hi].copy()
                cols.append(c)
            elif name == "sequence":
                c = _slice_var(d.seq_values, d.seq_offsets, lo, hi)
                if options.sequence_data_type in ENCODINGS:
                    c = ListColumn(FixedColumn(c.values, np.ones(
                        len(c.values), np.bool_)), c.offsets, c.validity)
                cols.append(c)
        yield Batch(schema, cols, hi - lo)


def _slice_var(values: np.ndarray, offsets: np.ndarray, lo: int, hi: int) -> VarColumn:
    off = offsets[lo: hi + 1].astype(np.int64)
    base = off[0]
    return VarColumn(values[base: off[-1]], (off - base).astype(np.int32),
                     np.ones(hi - lo, dtype=bool))


def decode_host(data, options: FastaOptions,
                projection: Optional[list[str]] = None) -> Iterator[Batch]:
    options = FastaOptions(options.sequence_data_type, options.file_extension,
                           options.batch_size, projection)
    yield from decoded_to_batches(decode_buffer(data, options), options)
