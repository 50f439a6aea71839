"""SAM/BAM optional-field (tags) decoding shared by the SAM, BAM and CRAM
decoders.

Copy of exon_tpu/formats/samtags.py, unchanged but for its imports.

Parity: exon-sam tag handling (schema_builder.rs:70-349 for the per-tag
Struct inference, array_builder/tag_builder.rs for value building). Value
rendering matches noodles' Display impls as exercised by
sam-select-tests.slt: integer arrays join with "," (no subtype prefix),
float arrays render "%.2f" joined with ", ", floats use shortest-f32 form.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from .. import datatypes as dt
from ..batch import FixedColumn, ListColumn, StructColumn, utf8_column

TAGS_LIST_TYPE = dt.list_(dt.struct([dt.Field("tag", dt.utf8, False),
                                     dt.Field("value", dt.utf8, True)]))

_INT_TYPES = set("cCsSiI")


def render_value(typ: str, v) -> str:
    """noodles Display rendering of a decoded tag value."""
    if typ in _INT_TYPES:
        return str(int(v))
    if typ == "f":
        f = float(np.float32(v))
        if f == int(f):
            return str(int(f))
        return np.format_float_positional(np.float32(v), unique=True,
                                          trim="-")
    if typ == "B":
        sub, vals = v
        if sub == "f":
            return ", ".join(f"{float(x):.2f}" for x in vals)
        return ",".join(str(int(x)) for x in vals)
    return str(v)


def parse_sam_text_value(typ: str, raw: bytes):
    """SAM text tag value → python value ((subtype, list) for B)."""
    if typ in _INT_TYPES:
        return int(raw)
    if typ == "f":
        return float(np.float32(float(raw)))
    if typ == "B":
        parts = raw.split(b",")
        sub = parts[0].decode()
        if sub == "f":
            return (sub, [float(np.float32(float(p))) for p in parts[1:]])
        return (sub, [int(p) for p in parts[1:]])
    return raw.decode("utf-8", "replace")


_BAM_FIXED = {"c": ("<b", 1), "C": ("<B", 1), "s": ("<h", 2), "S": ("<H", 2),
              "i": ("<i", 4), "I": ("<I", 4), "f": ("<f", 4)}


def parse_bam_aux(data: bytes, start: int, end: int) -> list[tuple]:
    """BAM auxiliary region → [(tag, typ, value)] (SAM spec §4.2.4)."""
    out = []
    p = start
    while p + 3 <= end:
        tag = data[p:p + 2].decode("ascii", "replace")
        typ = chr(data[p + 2])
        p += 3
        if typ == "A":
            out.append((tag, "A", chr(data[p])))
            p += 1
        elif typ in _BAM_FIXED:
            fmt, sz = _BAM_FIXED[typ]
            (v,) = struct.unpack_from(fmt, data, p)
            if typ == "f":
                v = float(np.float32(v))
            out.append((tag, typ, v))
            p += sz
        elif typ in ("Z", "H"):
            q = data.index(b"\x00", p)
            out.append((tag, typ, data[p:q].decode("utf-8", "replace")))
            p = q + 1
        elif typ == "B":
            sub = chr(data[p])
            (cnt,) = struct.unpack_from("<I", data, p + 1)
            fmt, sz = _BAM_FIXED[sub]
            vals = list(struct.unpack_from(f"<{cnt}{fmt[1]}", data, p + 5))
            if sub == "f":
                vals = [float(np.float32(x)) for x in vals]
            out.append((tag, "B", (sub, vals)))
            p += 5 + cnt * sz
        else:
            break  # unknown type: stop parsing this record's tags
    return out


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------


def struct_field_for(typ: str, value=None) -> dt.DataType:
    if typ in _INT_TYPES or typ == "A":
        # Character tags type as integers in struct mode (noodles
        # Character → i32, exon-sam schema_builder.rs)
        return dt.int64
    if typ == "f":
        return dt.float32
    if typ == "B":
        sub = value[0] if value is not None else "i"
        return dt.list_(dt.float32 if sub == "f" else dt.int64)
    return dt.utf8


def infer_tag_fields(first_tags: list[tuple]) -> list[dt.Field]:
    """Per-tag struct fields from the first record's tags
    (with_tags_data_type_from_data, exon-sam schema_builder.rs:70-349)."""
    return [dt.Field(tag, struct_field_for(typ, v), True)
            for tag, typ, v in first_tags]


def tags_field(parse_tags: bool,
               tag_fields: Optional[list] = None) -> dt.Field:
    if parse_tags and tag_fields is not None:
        return dt.Field("tags", dt.struct(tag_fields), nullable=True)
    return dt.Field("tags", TAGS_LIST_TYPE, nullable=True)


# ---------------------------------------------------------------------------
# column building
# ---------------------------------------------------------------------------


def tags_list_column(per_row: list[list[tuple]]) -> ListColumn:
    """tags as List<Struct{tag, value}> (default mode)."""
    n = len(per_row)
    counts = np.array([len(t) for t in per_row], np.int64)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    flat_tags = [t for row in per_row for t, _ty, _v in row]
    flat_vals = [render_value(ty, v) for row in per_row for _t, ty, v in row]
    child = StructColumn({"tag": utf8_column(flat_tags),
                          "value": utf8_column(flat_vals)},
                         np.ones(int(offs[-1]), bool))
    return ListColumn(child, offs.astype(np.int32), np.ones(n, bool))


def tags_struct_column(per_row: list[list[tuple]],
                       fields: list[dt.Field]) -> StructColumn:
    """tags as a per-tag Struct (parse_tags mode)."""
    n = len(per_row)
    maps = [dict((t, (ty, v)) for t, ty, v in row) for row in per_row]
    children = {}
    for f in fields:
        entries = [m.get(f.name) for m in maps]
        valid = np.array([e is not None for e in entries], bool)
        if f.dtype == dt.int64:
            arr = np.array(
                [(ord(e[1]) if e[0] == "A" else int(e[1])) if e else 0
                 for e in entries], np.int64)
            children[f.name] = FixedColumn(arr, valid)
        elif f.dtype == dt.float32:
            arr = np.array([float(e[1]) if e else 0.0 for e in entries],
                           np.float32)
            children[f.name] = FixedColumn(arr, valid)
        elif f.dtype.kind == dt.TypeKind.LIST:
            elem_f32 = f.dtype.value_type == dt.float32
            lists = [list(e[1][1]) if e else [] for e in entries]
            counts = np.array([len(x) for x in lists], np.int64)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(counts, out=offs[1:])
            flat = np.array([x for lst in lists for x in lst],
                            np.float32 if elem_f32 else np.int64)
            inner = FixedColumn(flat, np.ones(len(flat), bool))
            children[f.name] = ListColumn(inner, offs.astype(np.int32),
                                          valid)
        else:
            children[f.name] = utf8_column(
                [render_value(e[0], e[1]) if e else None for e in entries])
    return StructColumn(children, np.ones(n, bool))
