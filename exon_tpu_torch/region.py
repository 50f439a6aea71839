"""Genomic regions: ``Region`` and ``Region.parse``.

Copied from exon_tpu/io/indexes.py:25-40 (the dataclass and its parser),
for ``region_match``. The index readers around it are not ported yet
(ROADMAP Queue 1, item 2).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from .errors import InvalidRegionError


@dataclass(frozen=True)
class Region:
    """1-based inclusive genomic interval; start/end None → whole contig."""

    name: str
    start: Optional[int] = None  # 1-based
    end: Optional[int] = None    # inclusive

    _RE = re.compile(r"^([^:]+)(?::([\d,]+)?(?:-([\d,]+)?)?)?$")

    @classmethod
    def parse(cls, s: str) -> "Region":
        m = cls._RE.match(s.strip())
        if not m or not m.group(1):
            raise InvalidRegionError(f"invalid region {s!r}")
        start = int(m.group(2).replace(",", "")) if m.group(2) else None
        end = int(m.group(3).replace(",", "")) if m.group(3) else None
        if start is not None and end is not None and end < start:
            raise InvalidRegionError(f"invalid interval in {s!r}")
        return cls(m.group(1), start, end)
