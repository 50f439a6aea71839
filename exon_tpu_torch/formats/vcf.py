"""VCF decoder → host batches.

Copy of exon_tpu/formats/vcf.py: ``VcfHeader`` (:34), ``VcfOptions``
(:72), ``vcf_schema`` (:98), ``parse_header_only`` (:126),
``region_row_mask`` (:168), ``_leading_header_lines`` (:194) and
``decode_host`` (:220) with ``_decode_vcf_col`` (:389), on the numpy
field split of textutil.py (the JAX package's fallback to its native
scan). Columns: ``chrom`` dictionary-encoded, ``pos`` int64, ``ref`` utf8,
``qual`` float32 with ``.`` as NULL, ``id``/``alt``/``filter`` as
List<Utf8> (``_split_list_field`` :139; '.' or an empty field is a NULL
list), and ``info``/``formats`` as utf8 text, or with ``parse_info`` /
``parse_formats`` typed from the header's declarations
(``_typed_value_column`` :286, ``_typed_info_column`` :336,
``_typed_formats_column`` :360): a struct of the INFO fields and a list of
one struct per sample.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from .. import datatypes as dt
from ..batch import (Batch, FixedColumn, ListColumn, Schema, StructColumn,
                     VarColumn, utf8_column)
from .dictenc import dict_encode_slices
from .textutil import (LineIndex, cumsum_exclusive, gather_slices,
                       parse_float_fields, parse_int_fields, split_fields,
                       to_u8)


@dataclass
class VcfHeader:
    """Parsed ## header lines (contigs, INFO/FORMAT declarations, samples)."""

    contigs: list[str] = field(default_factory=list)
    infos: dict = field(default_factory=dict)     # id -> (Number, Type)
    formats: dict = field(default_factory=dict)   # id -> (Number, Type)
    filters: list[str] = field(default_factory=list)
    samples: list[str] = field(default_factory=list)

    _META_RE = re.compile(rb"##(\w+)=<(.*)>\s*$")
    _KV_RE = re.compile(rb'(\w+)=("[^"]*"|[^,]*)')

    @classmethod
    def parse(cls, header_bytes: list[bytes]) -> "VcfHeader":
        h = cls()
        for line in header_bytes:
            if line.startswith(b"#CHROM"):
                cols = line.decode().rstrip().split("\t")
                h.samples = cols[9:] if len(cols) > 9 else []
                continue
            m = cls._META_RE.match(line)
            if not m:
                continue
            kind = m.group(1)
            kv = dict((k.decode(), v.strip(b'"').decode())
                      for k, v in cls._KV_RE.findall(m.group(2)))
            if kind == b"contig" and "ID" in kv:
                h.contigs.append(kv["ID"])
            elif kind == b"INFO" and "ID" in kv:
                h.infos[kv["ID"]] = (kv.get("Number", "."), kv.get("Type", "String"))
            elif kind == b"FORMAT" and "ID" in kv:
                h.formats[kv["ID"]] = (kv.get("Number", "."), kv.get("Type", "String"))
            elif kind == b"FILTER" and "ID" in kv:
                h.filters.append(kv["ID"])
        return h


@dataclass
class VcfOptions:
    file_extension: str = ".vcf"
    batch_size: int = 8192
    parse_info: bool = False
    parse_formats: bool = False
    indexed: bool = False
    projection: Optional[list[str]] = None
    # region filter applied at decode time (host row filter matching
    # IndexedAsyncBatchStream.intersects semantics, 1-based inclusive)
    regions: list = field(default_factory=list)


_VCF_BASE_TYPES = {"Integer": dt.int32, "Float": dt.float32,
                   "Flag": dt.bool_, "String": dt.utf8,
                   "Character": dt.utf8}


def _decl_dtype(number: str, typ: str) -> dt.DataType:
    base = _VCF_BASE_TYPES.get(typ, dt.utf8)
    if typ == "Flag":
        return base
    if number != "1":
        return dt.list_(base)
    return base


def vcf_schema(options: VcfOptions = None, header: "VcfHeader" = None
               ) -> Schema:
    # typed info/formats need the file header (vcf_parse_info /
    # vcf_parse_formats, exon-core vcf/table_provider.rs:637-674); the
    # static schema covers the untyped default
    info_t: dt.DataType = dt.utf8
    formats_t: dt.DataType = dt.utf8
    if options is not None and header is not None:
        if getattr(options, "parse_info", False) and header.infos:
            info_t = dt.struct([dt.Field(k, _decl_dtype(*decl), True)
                                for k, decl in header.infos.items()])
        if getattr(options, "parse_formats", False) and header.formats:
            formats_t = dt.list_(dt.struct(
                [dt.Field(k, _decl_dtype(*decl), True)
                 for k, decl in header.formats.items()]))
    return Schema.of(
        dt.Field("chrom", dt.dictionary, nullable=False),
        dt.Field("pos", dt.int64, nullable=False),
        dt.Field("id", dt.list_(dt.utf8), nullable=True),
        dt.Field("ref", dt.utf8, nullable=False),
        dt.Field("alt", dt.list_(dt.utf8), nullable=True),
        dt.Field("qual", dt.float32, nullable=True),
        dt.Field("filter", dt.list_(dt.utf8), nullable=True),
        dt.Field("info", info_t, nullable=True),
        dt.Field("formats", formats_t, nullable=True),
    )


def parse_header_only(data: bytes) -> VcfHeader:
    """Parse just the ## header lines (schema inference for typed mode)."""
    lines = []
    for line in data.split(b"\n"):
        if line.startswith(b"#"):
            lines.append(line)
            if line.startswith(b"#CHROM"):
                break
        else:
            break
    return VcfHeader.parse(lines)


_FIELD_IDX = {"chrom": 0, "pos": 1, "id": 2, "ref": 3, "alt": 4, "qual": 5,
              "filter": 6, "info": 7, "formats": 8}


def region_row_mask(arr: np.ndarray, fs: np.ndarray, fe: np.ndarray,
                    region) -> np.ndarray:
    """Rows whose CHROM equals region.name and POS lies in the 1-based
    inclusive [region.start, region.end] (None = open). The exact
    post-index-seek row filter (vcf/table_provider.rs region residual),
    vectorized over the already-split fields."""
    nb = region.name.encode()
    s0, e0 = fs[:, 0], fe[:, 0]
    keep = (e0 - s0) == len(nb)
    lim = max(len(arr) - 1, 0)
    for k, ch in enumerate(nb):
        keep &= arr[np.minimum(s0 + k, lim)] == ch
    rstart = getattr(region, "start", None)
    rend = getattr(region, "end", None)
    if rstart is not None or rend is not None:
        pos, ok = parse_int_fields(arr, fs[:, 1], fe[:, 1])
        keep &= ok
        if rstart is not None:
            keep &= pos >= rstart
        if rend is not None:
            keep &= pos <= rend
    return keep


def _leading_header_lines(arr: np.ndarray) -> list[bytes]:
    """The '#'-prefixed header block at the top of the buffer."""
    lines: list[bytes] = []
    pos = 0
    n = len(arr)
    while pos < n and arr[pos] == ord("#"):
        # scan successive windows: a single header line can exceed any
        # fixed cap (a #CHROM line for a large cohort easily tops 1 MiB)
        end = -1
        win = pos
        while win < n:
            nl = arr[win:win + (1 << 20)]
            hits = np.flatnonzero(nl == 10)
            if len(hits):
                end = win + int(hits[0])
                break
            win += len(nl)
        if end < 0:
            lines.append(bytes(arr[pos:]))
            pos = n
            break
        lines.append(bytes(arr[pos:end]))
        pos = end + 1
    return lines


def _split_list_field(arr, s, e, sep: int) -> ListColumn:
    """Split slices by sep into List<Utf8>; '.' or empty → null row."""
    n = len(s)
    dot = (e - s == 1) & (arr[np.clip(s, 0, max(len(arr) - 1, 0))] == ord("."))
    empty = e <= s
    null = dot | empty
    s2 = np.where(null, 0, s)
    e2 = np.where(null, 0, e)
    a, roff = gather_slices(arr, s2, e2)
    seps = np.flatnonzero(a == sep)
    sep_row = np.searchsorted(roff[1:], seps, side="right") if len(seps) else np.zeros(0, np.int64)
    sep_counts = np.bincount(sep_row, minlength=n) if n else np.zeros(0, np.int64)
    counts = np.where(null, 0, sep_counts + 1)
    list_offs = cumsum_exclusive(counts)
    # item boundaries, in order: each non-null row contributes its start and
    # every sep+1 as item starts; every sep and the row end as item ends
    live = ~null
    starts_all = np.sort(np.concatenate([roff[:-1][live], seps + 1]))
    ends_all = np.sort(np.concatenate([seps, roff[1:][live]]))
    item_vals, item_offs = gather_slices(a, starts_all, ends_all)
    child = VarColumn(item_vals, item_offs.astype(np.int32),
                      np.ones(len(item_offs) - 1, bool))
    return ListColumn(child, list_offs.astype(np.int32), ~null)


def _typed_value_column(vals: list, number: str, typ: str):
    """Typed column from raw text values (None = absent)."""
    if typ == "Flag":
        present = np.array([v is not None for v in vals], bool)
        return FixedColumn(np.array([v is True or v == "" or bool(v)
                                     if v is not None else False
                                     for v in vals], bool), present)
    is_list = number != "1"

    def parse_one(v: str):
        if v is None or v == ".":
            return None
        if typ == "Integer":
            return int(v)
        if typ == "Float":
            return float(np.float32(float(v)))
        return v

    if not is_list:
        parsed = [parse_one(v) for v in vals]
        valid = np.array([p is not None for p in parsed], bool)
        if typ == "Integer":
            return FixedColumn(np.array([p or 0 for p in parsed], np.int32),
                               valid)
        if typ == "Float":
            return FixedColumn(
                np.array([0.0 if p is None else p for p in parsed],
                         np.float32), valid)
        return utf8_column(parsed)
    lists = [[parse_one(x) for x in v.split(",")] if v not in (None, ".")
             else None for v in vals]
    counts = np.array([len(x) if x else 0 for x in lists], np.int64)
    offs = cumsum_exclusive(counts).astype(np.int32)
    flat = [x for lst in lists if lst for x in lst]
    valid = np.array([x is not None for x in lists], bool)
    if typ == "Integer":
        child = FixedColumn(np.array([0 if x is None else x for x in flat],
                                     np.int32),
                            np.array([x is not None for x in flat], bool))
    elif typ == "Float":
        child = FixedColumn(
            np.array([0.0 if x is None else x for x in flat], np.float32),
            np.array([x is not None for x in flat], bool))
    else:
        child = utf8_column(flat)
    return ListColumn(child, offs, valid)


def _typed_info_column(arr, s, e, pres, header: VcfHeader):
    n = len(s)
    rows = []
    for i in range(n):
        d = {}
        if pres[i]:
            txt = bytes(arr[s[i]:e[i]])
            if txt and txt != b".":
                for part in txt.split(b";"):
                    if b"=" in part:
                        k, _, v = part.partition(b"=")
                        d[k.decode()] = v.decode()
                    elif part:
                        d[part.decode()] = True
        rows.append(d)
    children = {}
    for k, (number, typ) in header.infos.items():
        children[k] = _typed_value_column([r.get(k) for r in rows],
                                          number, typ)
    return StructColumn(children, pres.copy())


def _typed_formats_column(arr, fs, fe, present, lo, hi, header: VcfHeader):
    n = hi - lo
    n_samples = max(len(header.samples), 1)
    # per row: FORMAT keys + per-sample values; one struct entry per sample
    flat: list[dict] = []
    for i in range(lo, hi):
        keys = []
        if present[i, 8]:
            keys = bytes(arr[fs[i, 8]:fe[i, 8]]).decode().split(":")
        for j in range(n_samples):
            col_idx = 9 + j
            d = {}
            if col_idx < fs.shape[1] and present[i, col_idx]:
                parts = bytes(arr[fs[i, col_idx]:fe[i, col_idx]]
                              ).decode().split(":")
                for k, v in zip(keys, parts):
                    d[k] = v
            flat.append(d)
    children = {}
    for k, (number, typ) in header.formats.items():
        children[k] = _typed_value_column([d.get(k) for d in flat],
                                          number, typ)
    child = StructColumn(children, np.ones(len(flat), bool))
    offs = (np.arange(n + 1) * n_samples).astype(np.int32)
    return ListColumn(child, offs, np.ones(n, bool))


def decode_host(data: bytes, options: VcfOptions,
                projection: Optional[list[str]] = None,
                with_header: Optional[VcfHeader] = None,
                region=None, exclude=()) -> Iterator[Batch]:
    """Batches of the VCF text ``data``; with ``region``, only its rows,
    less those inside any region of ``exclude`` (the port's addition: a
    row of several overlapping regions is read once, ROADMAP Queue 3,
    F15)."""
    arr = to_u8(data)
    if len(arr) == 0:
        return
    header = with_header or VcfHeader.parse(_leading_header_lines(arr))
    schema = vcf_schema(options, header)
    proj = projection if projection is not None else schema.names
    out_schema = schema.project(proj)
    typed_formats = getattr(options, "parse_formats", False) and \
        header.formats
    if typed_formats:
        n_fields = 9 + max(len(header.samples), 1)
    elif header.samples or "formats" in proj:
        n_fields = 9
    else:
        # split only as many fields as the projection (and region mask)
        # touch — the tail fields' boundary bookkeeping is dead weight on
        # narrow scans like COUNT
        needed = [_FIELD_IDX[c] for c in proj if c in _FIELD_IDX]
        if region is not None:
            needed.append(1)
        n_fields = min(8, max(needed, default=0) + 2)
    n_fields = max(n_fields, 2)
    li = LineIndex(arr)
    hdr_mask = li.first_bytes() == ord("#")
    li = li.select(~hdr_mask & (li.ends > li.starts))
    n = len(li)
    if n == 0:
        return
    fs, fe, present = split_fields(arr, li.starts, li.ends, n_fields)
    if region is not None:
        keep = region_row_mask(arr, fs, fe, region)
        for r in exclude:
            keep &= ~region_row_mask(arr, fs, fe, r)
        if not keep.all():
            li = li.select(keep)
            fs, fe, present = fs[keep], fe[keep], present[keep]
            n = len(li)
        if n == 0:
            return

    bs = options.batch_size
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        cols = [_decode_vcf_col(name, arr, fs, fe, present, lo, hi, li,
                                header, options) for name in proj]
        yield Batch(out_schema, cols, hi - lo)


def _decode_vcf_col(name, arr, fs, fe, present, lo, hi, li,
                    header: VcfHeader, options=None):
    idx = _FIELD_IDX[name]
    if name == "formats":
        if getattr(options, "parse_formats", False) and header.formats:
            return _typed_formats_column(arr, fs, fe, present, lo, hi,
                                         header)
        s = fs[lo:hi, 8]
        e = li.ends[lo:hi]
        pres = present[lo:hi, 8]
        v, o = gather_slices(arr, np.where(pres, s, 0), np.where(pres, e, 0))
        return VarColumn(v, o.astype(np.int32), pres)
    s, e = fs[lo:hi, idx], fe[lo:hi, idx]
    pres = present[lo:hi, idx]
    dot = (e - s == 1) & (arr[np.clip(s, 0, len(arr) - 1)] == ord("."))
    if name == "chrom":
        return dict_encode_slices(arr, s, e, pres)
    if name == "pos":
        vals, ok = parse_int_fields(arr, s, e)
        return FixedColumn(vals, ok)
    if name == "ref":
        v, o = gather_slices(arr, s, e)
        return VarColumn(v, o.astype(np.int32), pres)
    if name == "qual":
        vals, ok = parse_float_fields(arr, s, e)
        return FixedColumn(np.where(ok, vals, 0.0).astype(np.float32),
                           ok & ~dot & pres)
    if name == "info":
        if getattr(options, "parse_info", False) and header.infos:
            return _typed_info_column(arr, s, e, pres & ~dot, header)
        v, o = gather_slices(arr, np.where(dot, 0, s), np.where(dot, 0, e))
        return VarColumn(v, o.astype(np.int32), pres & ~dot)
    if name in ("id", "filter"):
        return _split_list_field(arr, s, e, ord(";"))
    if name == "alt":
        return _split_list_field(arr, s, e, ord(","))
    raise KeyError(name)
