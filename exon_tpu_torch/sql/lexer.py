"""SQL lexer.

Copied unchanged from exon_tpu/sql/lexer.py:1-108 (pure Python, no JAX).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

from ..errors import SqlError

KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit", "offset",
    "having", "as", "and", "or", "not", "like", "ilike", "between", "in",
    "is", "null", "true", "false", "asc", "desc", "join", "inner", "left",
    "right", "full", "outer", "on", "using", "create", "external", "table",
    "stored", "location", "options", "partitioned", "copy", "to", "set",
    "describe", "show", "tables", "explain", "analyze", "drop", "if",
    "exists", "distinct", "cast", "union", "all", "intersect", "except",
    "case", "when", "then",
    "else", "end", "with", "compression", "type",
    "insert", "into", "values",
}


@dataclass
class Token:
    kind: str  # kw | ident | str | num | op | eof
    value: str
    pos: int


def tokenize(sql: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise SqlError("unterminated string literal")
            out.append(Token("str", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError("unterminated quoted identifier")
            out.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_e = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_e and j > i:
                    seen_e = True
                    j += 1
                    if j < n and sql[j] in "+-":
                        j += 1
                else:
                    break
            out.append(Token("num", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            kind = "kw" if word.lower() in KEYWORDS else "ident"
            out.append(Token(kind, word, i))
            i = j
            continue
        for op in ("<>", "!=", ">=", "<=", "::", "||"):
            if sql.startswith(op, i):
                out.append(Token("op", op, i))
                i += len(op)
                break
        else:
            if c in "()+-*/%,.;=<>[]":
                out.append(Token("op", c, i))
                i += 1
            else:
                raise SqlError(f"unexpected character {c!r} at {i}")
    out.append(Token("eof", "", n))
    return out
