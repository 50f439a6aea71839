"""The SAM/BAM schema.

Copy of exon_tpu/formats/sam.py ``sam_schema`` (:37): ``name,
flag(Int32), reference, start, end, mapping_quality(Utf8), cigar,
mate_reference, sequence, quality_score(List<Int64>), tags``, where
``tags`` is List<Struct{tag, value}>, or with ``parse_tags`` and the first
record's tags a struct of one field per tag (samtags.py ``tags_field``
:125). The SAM text decoder is not ported yet (ROADMAP Queue 1, item 2c).
"""

from __future__ import annotations

from .. import datatypes as dt
from ..batch import Schema
from .samtags import tags_field


def sam_schema(options=None, tag_fields=None) -> Schema:
    parse_tags = getattr(options, "parse_tags", False) if options else False
    return Schema.of(
        dt.Field("name", dt.utf8, nullable=False),
        dt.Field("flag", dt.int32, nullable=False),
        dt.Field("reference", dt.dictionary, nullable=True),
        dt.Field("start", dt.int64, nullable=True),
        dt.Field("end", dt.int64, nullable=True),
        dt.Field("mapping_quality", dt.utf8, nullable=True),
        dt.Field("cigar", dt.utf8, nullable=False),
        dt.Field("mate_reference", dt.dictionary, nullable=True),
        dt.Field("sequence", dt.utf8, nullable=False),
        dt.Field("quality_score", dt.list_(dt.int64), nullable=False),
        tags_field(parse_tags, tag_fields),
    )
