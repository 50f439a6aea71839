"""BAM decoder: binary alignment records → host batches.

Numpy copy of exon_tpu/formats/bam.py without its native fast paths:
``parse_bam_header`` (:76), the numpy loop of ``scan_record_offsets``
(:100), ``decode_records`` (:223) with its lazy per-field decode, so a
narrow projection touches only the bytes it needs, ``_int_to_utf8`` (:383),
``_render_cigar`` (:401), ``_decode_seq`` (:427) and ``decode_host``
(:442). ``reference`` and ``mate_reference`` are dictionary columns over
the header's reference names (refID −1 gives NULL); ``start`` is 1-based and
``end`` = start + CIGAR reference span − 1. ``quality_score`` is a
List<Int64> of the raw quality bytes (:355-361), ``tags`` a List<Struct{tag,
value}>, or with ``parse_tags`` a struct of the first record's tags
(``first_record_tags`` :47, samtags.py). A BGZF-compressed input is
inflated first.
"""

from __future__ import annotations

import dataclasses
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..batch import (Batch, DictColumn, FixedColumn, ListColumn, Schema,
                     VarColumn)
from ..errors import ExonError
from ..io import bgzf_decompress
from .sam import sam_schema
from .samtags import (infer_tag_fields, parse_bam_aux, tags_list_column,
                      tags_struct_column)
from .textutil import cumsum_exclusive, gather_slices, to_u8

SEQ_CODE = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
CIGAR_OPS = np.frombuffer(b"MIDNSHP=X", dtype=np.uint8)
# ops that consume reference: M(0) D(2) N(3) =(7) X(8)
CIGAR_CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)


@dataclass
class BamOptions:
    file_extension: str = ".bam"
    batch_size: int = 8192
    parse_tags: bool = False


def bam_schema(options=None, tag_fields=None) -> Schema:
    return sam_schema(options, tag_fields)


def first_record_tags(data, header: "BamHeader") -> list[tuple]:
    """Aux tags of the first alignment record (schema inference for
    parse_tags mode, exon-sam schema_builder.rs:70-349)."""
    offsets = scan_record_offsets(data, header.header_end)
    if len(offsets) == 0:
        return []
    off = int(offsets[0])
    (block_size,) = struct.unpack_from("<i", data, off)
    # materialize just the first record (data may be an ndarray view)
    rec = bytes(memoryview(data)[off:off + 4 + block_size])
    body = 4
    l_read_name = rec[body + 8]
    (n_cigar,) = struct.unpack_from("<H", rec, body + 12)
    (l_seq,) = struct.unpack_from("<i", rec, body + 16)
    aux_start = body + 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 \
        + l_seq
    return parse_bam_aux(rec, aux_start, len(rec))


def tag_fields_of(data, header: "BamHeader", options) -> Optional[list]:
    """The parse_tags struct's fields, from the first record's tags; None
    without parse_tags."""
    if not getattr(options, "parse_tags", False):
        return None
    return infer_tag_fields(first_record_tags(data, header))


@dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]
    header_end: int  # offset of the first alignment record


def parse_bam_header(data) -> BamHeader:
    if bytes(memoryview(data)[:4]) != b"BAM\x01":
        raise ExonError("not a BAM file (bad magic)")
    (l_text,) = struct.unpack_from("<i", data, 4)
    text = bytes(memoryview(data)[8:8 + l_text]).split(b"\x00", 1)[0] \
        .decode("utf-8", "replace")
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names, lengths = [], []
    mv = memoryview(data)
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        names.append(bytes(mv[off:off + l_name - 1]).decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        lengths.append(l_ref)
        off += 4
    return BamHeader(text, names, lengths, off)


def scan_record_offsets(data, start: int) -> np.ndarray:
    """Record start offsets (pointing at block_size) from ``start`` on."""
    end = len(data)
    offsets = []
    off = start
    u = struct.Struct("<i").unpack_from
    while off + 4 <= end:
        (bs,) = u(data, off)
        offsets.append(off)
        off += 4 + bs
    return np.asarray(offsets, dtype=np.int64)


def _i32(arr: np.ndarray, offs: np.ndarray) -> np.ndarray:
    return (arr[offs].astype(np.int64)
            | arr[offs + 1].astype(np.int64) << 8
            | arr[offs + 2].astype(np.int64) << 16
            | arr[offs + 3].astype(np.int64) << 24).astype(np.int32) \
        .astype(np.int64)


def _u16(arr: np.ndarray, offs: np.ndarray) -> np.ndarray:
    return arr[offs].astype(np.int64) | arr[offs + 1].astype(np.int64) << 8


def decode_records(data, offsets: np.ndarray, header: BamHeader, options,
                   projection: Optional[list[str]] = None
                   ) -> Iterator[Batch]:
    """Vectorized decode of the alignment records at ``offsets``."""
    # the parse_tags struct from the first record decoded here
    tag_fields = tag_fields_of(data, dataclasses.replace(
        header, header_end=int(offsets[0])), options) if len(offsets) else None
    schema = bam_schema(options, tag_fields)
    proj = projection if projection is not None else schema.names
    out_schema = schema.project(proj)
    arr = to_u8(data)
    tag_data: list = []
    bs = options.batch_size
    for lo in range(0, len(offsets), bs):
        hi = min(lo + bs, len(offsets))
        body = offsets[lo:hi] + 4  # past block_size
        n = hi - lo
        memo: dict = {}

        def F(key, _memo=memo, _body=body, _n=n):
            v = _memo.get(key)
            if v is not None:
                return v
            if key == "ref_id":
                v = _i32(arr, _body)
            elif key == "pos0":
                v = _i32(arr, _body + 4)  # 0-based
            elif key == "l_read_name":
                v = arr[_body + 8].astype(np.int64)
            elif key == "mapq":
                v = arr[_body + 9].astype(np.int64)
            elif key == "n_cigar":
                v = _u16(arr, _body + 12)
            elif key == "flag":
                v = _u16(arr, _body + 14)
            elif key == "l_seq":
                v = _i32(arr, _body + 16)
            elif key == "next_ref_id":
                v = _i32(arr, _body + 20)
            elif key == "name_start":
                v = _body + 32
            elif key == "cigar_start":
                v = F("name_start") + F("l_read_name")
            elif key == "seq_start":
                v = F("cigar_start") + 4 * F("n_cigar")
            elif key == "cigar_walk":
                v = _cigar_walk(arr, F("cigar_start"), F("n_cigar"), _n)
            else:
                raise KeyError(key)
            _memo[key] = v
            return v

        cols = []
        for name in proj:
            if name == "name":
                start, l_name = F("name_start"), F("l_read_name")
                # the name excludes its trailing NUL; '*' (l_read_name 1,
                # the NUL alone) is NULL
                v, o = gather_slices(arr, start, start + l_name - 1)
                cols.append(VarColumn(v, o.astype(np.int32), l_name > 1))
            elif name == "flag":
                cols.append(FixedColumn(F("flag").astype(np.int32),
                                        np.ones(n, bool)))
            elif name in ("reference", "mate_reference"):
                rid = F("ref_id") if name == "reference" else F("next_ref_id")
                valid = (rid >= 0) & (rid < len(header.ref_names))
                codes = np.clip(rid, 0, max(len(header.ref_names) - 1, 0))
                cols.append(DictColumn(codes.astype(np.int32), valid,
                                       tuple(header.ref_names)))
            elif name == "start":
                cols.append(FixedColumn(F("pos0") + 1, F("pos0") >= 0))
            elif name == "end":
                cols.append(FixedColumn(F("pos0") + F("cigar_walk")[3],
                                        F("pos0") >= 0))
            elif name == "mapping_quality":
                cols.append(_int_to_utf8(F("mapq"), null_value=255))
            elif name == "cigar":
                rep, op_len, op_code, _spans = F("cigar_walk")
                cols.append(_render_cigar(n, rep, op_len, op_code))
            elif name == "sequence":
                cols.append(_decode_seq(arr, F("seq_start"), F("l_seq")))
            elif name == "quality_score":
                qual_start = F("seq_start") + (F("l_seq") + 1) // 2
                v, o = gather_slices(arr, qual_start, qual_start + F("l_seq"))
                # 0xFF means missing quality ('*')
                cols.append(ListColumn(FixedColumn(v.astype(np.int64),
                                                   np.ones(len(v), bool)),
                                       o.astype(np.int32), np.ones(n, bool)))
            elif name == "tags":
                if not tag_data:  # parse_bam_aux reads bytes
                    tag_data.append(bytes(memoryview(arr)))
                aux_start = F("seq_start") + (F("l_seq") + 1) // 2 + \
                    F("l_seq")
                rec_end = _body_end(arr, body)
                per_row = [parse_bam_aux(tag_data[0], int(aux_start[i]),
                                         int(rec_end[i])) for i in range(n)]
                cols.append(tags_list_column(per_row) if tag_fields is None
                            else tags_struct_column(per_row, tag_fields))
            else:
                raise KeyError(name)
        yield Batch(out_schema, cols, n)


def _body_end(arr: np.ndarray, body: np.ndarray) -> np.ndarray:
    """Each record's end: its body start plus its block_size."""
    return body + _i32(arr, body - 4)


def _cigar_walk(arr: np.ndarray, cigar_start: np.ndarray,
                n_cigar: np.ndarray, n: int) -> tuple:
    """(row of each op, op lengths, op codes, reference span per row)."""
    cig_offs = cumsum_exclusive(n_cigar)
    total_ops = int(cig_offs[-1])
    if not total_ops:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty, np.zeros(n, np.int64)
    rep = np.repeat(np.arange(n), n_cigar)
    op_idx = np.repeat(cigar_start - 4 * cig_offs[:-1], n_cigar) + \
        4 * np.arange(total_ops, dtype=np.int64)
    opv = (arr[op_idx].astype(np.int64)
           | arr[op_idx + 1].astype(np.int64) << 8
           | arr[op_idx + 2].astype(np.int64) << 16
           | arr[op_idx + 3].astype(np.int64) << 24)
    op_len = opv >> 4
    op_code = opv & 0xF
    spans = np.zeros(n, np.int64)
    np.add.at(spans, rep, op_len * CIGAR_CONSUMES_REF[np.clip(op_code, 0, 8)])
    return rep, op_len, op_code, spans


def _int_to_utf8(vals: np.ndarray, null_value: Optional[int] = None
                 ) -> VarColumn:
    """Vectorized non-negative int → decimal string column."""
    n = len(vals)
    v = np.maximum(vals, 0)
    digits = np.maximum(
        np.floor(np.log10(np.maximum(v, 1))).astype(np.int64) + 1, 1)
    offs = cumsum_exclusive(digits)
    buf = np.zeros(int(offs[-1]), np.uint8)
    last = offs[1:] - 1
    work = v.copy()
    for d in range(int(digits.max()) if n else 0):
        active = d < digits
        buf[last[active] - d] = (work[active] % 10 + ord("0")).astype(np.uint8)
        work = work // 10
    valid = np.ones(n, bool) if null_value is None else (vals != null_value)
    return VarColumn(buf, offs.astype(np.int32), valid)


def _render_cigar(n: int, rep, op_len, op_code) -> VarColumn:
    if len(op_len) == 0:
        return VarColumn(np.zeros(0, np.uint8), np.zeros(n + 1, np.int32),
                         np.ones(n, bool))
    digits = np.maximum(
        np.floor(np.log10(np.maximum(op_len, 1))).astype(np.int64) + 1, 1)
    op_width = digits + 1
    op_text_off = cumsum_exclusive(op_width)
    buf = np.zeros(int(op_text_off[-1]), np.uint8)
    # each op is its digits then its letter; digits are written right to left
    letter_pos = op_text_off[1:] - 1
    buf[letter_pos] = CIGAR_OPS[np.clip(op_code, 0, 8)]
    vals = op_len.copy()
    for d in range(int(digits.max())):
        active = d < digits
        buf[(letter_pos - 1 - d)[active]] = \
            (vals[active] % 10 + ord("0")).astype(np.uint8)
        vals = vals // 10
    per_rec = np.zeros(n, np.int64)
    np.add.at(per_rec, rep, op_width)
    return VarColumn(buf, cumsum_exclusive(per_rec).astype(np.int32),
                     np.ones(n, bool))


def _decode_seq(arr: np.ndarray, seq_start: np.ndarray, l_seq: np.ndarray
                ) -> VarColumn:
    n = len(seq_start)
    offs = cumsum_exclusive(l_seq)
    total = int(offs[-1])
    if total == 0:
        return VarColumn(np.zeros(0, np.uint8), offs.astype(np.int32),
                         np.ones(n, bool))
    pos_in_rec = np.arange(total, dtype=np.int64) - np.repeat(offs[:-1], l_seq)
    byte_idx = np.repeat(seq_start, l_seq) + pos_in_rec // 2
    nib = np.where(pos_in_rec % 2 == 0, arr[byte_idx] >> 4,
                   arr[byte_idx] & 0xF)
    return VarColumn(SEQ_CODE[nib], offs.astype(np.int32), np.ones(n, bool))


def inflate(data):
    """The decompressed BAM: a gzip/BGZF stream is inflated."""
    return bgzf_decompress(data) if bytes(data[:2]) == b"\x1f\x8b" else data


def decode_host(data, options: BamOptions,
                projection: Optional[list[str]] = None) -> Iterator[Batch]:
    """Whole-file decode; a gzip/BGZF stream is inflated first (the
    ``bam_decode`` wrapper of exon_tpu/tables.py:644)."""
    data = inflate(data)
    header = parse_bam_header(data)
    offsets = scan_record_offsets(data, header.header_end)
    yield from decode_records(data, offsets, header, options, projection)
