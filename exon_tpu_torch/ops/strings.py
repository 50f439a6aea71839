"""String predicates over uint8 values + int32 offsets.

Counterpart of exon_tpu/ops/strings.py. ``like`` (:177) runs the
like_match kernel for every pattern shape: the JAX function's fast paths
(prefix, suffix, equality, contains, :56-122) give the same answers as its
general greedy match (:257), which the kernel implements once, and so
do ``starts_with``, ``ends_with`` and ``contains`` (:56, :70, :97) as
'lit%', '%lit' and '%lit%'. ``find_first`` is ``_find_from`` (:229) from
each row's start, on the kernel's position mode. ``upper``/``lower``
(:44, :48, the ASCII folds ``_upper_u8``/``_lower_u8`` :34,39) run the
map_bytes kernel with a fold table. ``tokenize_like`` (:125) and
``like_regex`` (:150) are host-side copies; ``dict_equals``/``dict_isin``
(:290, :298) map a literal through the host vocabulary.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import torch

from ..batch import DictColumn, VarColumn
from ..kernels.like_match import like_find, like_match
from ..kernels.map_bytes import map_bytes

_CODES = np.arange(256, dtype=np.uint8)
_IS_LOWER = (_CODES >= ord("a")) & (_CODES <= ord("z"))
_IS_UPPER = (_CODES >= ord("A")) & (_CODES <= ord("Z"))
UPPER = np.where(_IS_LOWER, _CODES - 32, _CODES).astype(np.uint8)
LOWER = np.where(_IS_UPPER, _CODES + 32, _CODES).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def byte_table(table: bytes, device: torch.device) -> torch.Tensor:
    """One of the module's fixed byte tables on ``device``,
    copied there once."""
    return torch.frombuffer(bytearray(table), dtype=torch.uint8).to(device)


def _fold(col: VarColumn, table: np.ndarray) -> VarColumn:
    t = byte_table(table.tobytes(), col.values.device)
    return VarColumn(map_bytes(col.offsets, col.values, t, "table"),
                     col.offsets, col.validity)


def upper(col: VarColumn) -> VarColumn:
    return _fold(col, UPPER)


def lower(col: VarColumn) -> VarColumn:
    return _fold(col, LOWER)


def tokenize_like(pattern: str, escape: str | None = None) -> list[tuple]:
    """Split a LIKE pattern into '%'-separated chunks of byte tokens.

    Each chunk is a tuple of ints: a UTF-8 byte value, or -1 for the
    single-char wildcard '_'. ``escape`` (the SQL ESCAPE clause character)
    makes the following pattern character literal."""
    chunks: list[list[int]] = [[]]
    i, n = 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if escape is not None and ch == escape:
            i += 1
            if i >= n:
                raise ValueError("LIKE pattern ends with its escape character")
            chunks[-1].extend(pattern[i].encode())
        elif ch == "%":
            chunks.append([])
        elif ch == "_":
            chunks[-1].append(-1)
        else:
            chunks[-1].extend(ch.encode())
        i += 1
    return [tuple(c) for c in chunks]


def like_regex(pattern: str, escape: str | None = None,
               case_insensitive: bool = False):
    """The equivalent compiled ``re`` pattern — host-side LIKE evaluation
    (dictionary vocabularies). '_' matches any char incl. newline."""
    out = ["^"]
    i, n = 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if escape is not None and ch == escape:
            i += 1
            if i >= n:
                raise ValueError("LIKE pattern ends with its escape character")
            out.append(re.escape(pattern[i]))
        elif ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    out.append("$")
    flags = re.DOTALL | (re.IGNORECASE if case_insensitive else 0)
    return re.compile("".join(out), flags)


def like(col: VarColumn, pattern: str, case_insensitive: bool = False,
         escape: str | None = None) -> torch.Tensor:
    """SQL LIKE with full '%'/'_'/ESCAPE semantics: bool[n]."""
    return like_match(col.offsets, col.values, tokenize_like(pattern, escape),
                      case_insensitive)


def equals_literal(col: VarColumn, lit: bytes) -> torch.Tensor:
    """Row bytes equal to ``lit`` (LIKE with one chunk and no wildcard)."""
    return like_match(col.offsets, col.values, [tuple(lit)], False)


def starts_with(col: VarColumn, prefix: bytes) -> torch.Tensor:
    return like_match(col.offsets, col.values, [tuple(prefix), ()], False)


def ends_with(col: VarColumn, suffix: bytes) -> torch.Tensor:
    return like_match(col.offsets, col.values, [(), tuple(suffix)], False)


def contains(col: VarColumn, needle: bytes) -> torch.Tensor:
    return like_match(col.offsets, col.values, [(), tuple(needle), ()], False)


def find_first(col: VarColumn, needle: bytes) -> torch.Tensor:
    """int32 [n]: the leftmost start of ``needle`` in each row, relative to
    the row start, or -1."""
    return like_find(col.offsets, col.values, tuple(needle))


def vocab_mask(col: DictColumn, hits: list[int]) -> torch.Tensor:
    table = torch.zeros(max(len(col.vocab), 1), dtype=torch.bool)
    table[hits] = True
    return table.to(col.codes.device)[col.codes.long().clamp(
        0, max(len(col.vocab) - 1, 0))]


def dict_equals(col: DictColumn, lit: str) -> torch.Tensor:
    return vocab_mask(col, [i for i, s in enumerate(col.vocab) if s == lit])


def dict_isin(col: DictColumn, lits: list[str]) -> torch.Tensor:
    want = set(lits)
    return vocab_mask(col, [i for i, s in enumerate(col.vocab) if s in want])


def dict_like(col: DictColumn, pattern: str, case_insensitive: bool,
              escape: str | None) -> torch.Tensor:
    """LIKE over a dictionary column: match the host vocabulary, then map
    codes (exon_tpu/plan/expressions.py _dict_to_mask_like :571)."""
    rx = like_regex(pattern, escape, case_insensitive)
    return vocab_mask(col, [i for i, s in enumerate(col.vocab) if rx.match(s)])
