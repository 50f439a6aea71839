"""Genomic regions: ``Region`` and ``Region.parse``.

Copied from exon_tpu/io/indexes.py:25-62 (the dataclass, its parser, the
0-based bounds a tabix query takes and its text form), for
``region_match``, the region filters of plan/regions.py and the tabix
queries of indexes.py.
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

    @property
    def zero_start(self) -> int:
        return (self.start - 1) if self.start else 0

    @property
    def excl_end(self) -> int:
        return self.end if self.end is not None else 1 << 60

    def __str__(self) -> str:
        if self.start is None:
            return self.name
        if self.end is None:
            return f"{self.name}:{self.start}"
        return f"{self.name}:{self.start}-{self.end}"
