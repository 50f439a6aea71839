"""GFF3 / GTF decoders → host batches.

Copy of exon_tpu/formats/gff.py:51-137: 9 tab-separated columns; '#'
directive lines skipped; '.' = null for source/phase/score.
seqname/source/type/strand/phase are dictionary-encoded, start/end Int64
(1-based inclusive), score Float32, and ``attributes`` a
Map<Utf8, List<Utf8>> parsed by attrmap.py (GFF3 ``k=v1,v2;`` or GTF
``k "v";`` by ``style``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .. import datatypes as dt
from ..batch import Batch, FixedColumn, Schema
from .attrmap import parse_attributes
from .dictenc import dict_encode_slices
from .textutil import (LineIndex, parse_float_fields, parse_int_fields,
                       split_fields, to_u8)

ATTR_DTYPE = dt.DataType(
    dt.TypeKind.MAP,
    value_type=dt.struct([dt.Field("keys", dt.utf8, False),
                          dt.Field("values", dt.list_(dt.utf8), True)]))


@dataclass
class GffOptions:
    file_extension: str = ".gff"
    batch_size: int = 8192
    style: str = "gff"


def gff_schema(options=None) -> Schema:
    return Schema.of(
        dt.Field("seqname", dt.dictionary, nullable=False),
        dt.Field("source", dt.dictionary, nullable=True),
        dt.Field("type", dt.dictionary, nullable=False),
        dt.Field("start", dt.int64, nullable=False),
        dt.Field("end", dt.int64, nullable=False),
        dt.Field("score", dt.float32, nullable=True),
        dt.Field("strand", dt.dictionary, nullable=False),
        dt.Field("phase", dt.dictionary, nullable=True),
        dt.Field("attributes", ATTR_DTYPE, nullable=True),
    )


def decode_host(data, options, projection: Optional[list[str]] = None
                ) -> Iterator[Batch]:
    style = getattr(options, "style", "gff")
    schema = gff_schema()
    proj = projection if projection is not None else schema.names
    out_schema = schema.project(proj)
    arr = to_u8(data)
    if len(arr) == 0:
        return
    li = LineIndex(arr)
    fb = li.first_bytes()
    # skip directives/comments (#) and blank lines; stop at FASTA section
    # (##FASTA directive) like noodles
    keep = (fb != ord("#")) & (li.ends > li.starts)
    fasta_dir = None
    hash_lines = np.flatnonzero(fb == ord("#"))
    for k in hash_lines:  # few directive lines; cheap host check
        s, e = li.starts[k], li.ends[k]
        if e - s >= 7 and bytes(arr[s:s + 7]) == b"##FASTA":
            fasta_dir = k
            break
    if fasta_dir is not None:
        keep &= np.arange(len(li)) < fasta_dir
    li = li.select(keep)
    n = len(li)
    if n == 0:
        return
    fs, fe, present = split_fields(arr, li.starts, li.ends, 9)

    bs = options.batch_size
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        cols = []
        for name in proj:
            cols.append(_decode_col(name, arr, fs, fe, present, lo, hi, style))
        yield Batch(out_schema, cols, hi - lo)


def _is_dot(arr, s, e):
    return (e - s == 1) & (arr[np.clip(s, 0, len(arr) - 1)] == ord("."))


def _decode_col(name, arr, fs, fe, present, lo, hi, style):
    idx = {"seqname": 0, "source": 1, "type": 2, "start": 3, "end": 4,
           "score": 5, "strand": 6, "phase": 7, "attributes": 8}[name]
    s, e = fs[lo:hi, idx], fe[lo:hi, idx]
    pres = present[lo:hi, idx]
    if name in ("seqname", "source", "type", "strand", "phase"):
        validity = pres.copy()
        if name in ("source", "phase"):
            validity &= ~_is_dot(arr, s, e)
        return dict_encode_slices(arr, s, e, validity)
    if name in ("start", "end"):
        vals, ok = parse_int_fields(arr, s, e)
        return FixedColumn(vals, ok)
    if name == "attributes":
        return parse_attributes(arr, s, e, style)
    dot = _is_dot(arr, s, e)
    vals, ok = parse_float_fields(arr, s, e)
    return FixedColumn(np.where(ok, vals, 0.0).astype(np.float32),
                       ok & ~dot & pres)
