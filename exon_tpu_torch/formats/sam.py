"""The SAM/BAM schema.

Copy of exon_tpu/formats/sam.py ``sam_schema`` (:37) with the default
(unparsed) ``tags`` field of exon_tpu/formats/samtags.py ``tags_field``
(:125): ``name, flag(Int32), reference, start, end, mapping_quality(Utf8),
cigar, mate_reference, sequence, quality_score(List<Int64>), tags``. The
SAM text decoder and the parsed-tags schema are not ported yet (ROADMAP
Queue 1, other decoders).
"""

from __future__ import annotations

from .. import datatypes as dt
from ..batch import Schema

TAGS_LIST_TYPE = dt.list_(dt.struct([dt.Field("tag", dt.utf8, False),
                                     dt.Field("value", dt.utf8, True)]))


def sam_schema(options=None) -> Schema:
    if getattr(options, "parse_tags", False):
        raise NotImplementedError(
            "parsed BAM/SAM tags are not ported yet (ROADMAP Queue 1, other "
            "decoders)")
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
        dt.Field("tags", TAGS_LIST_TYPE, nullable=True),
    )
