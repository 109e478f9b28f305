"""Tiny SELECT parser for the S3-Select dialect subset.

Supported (the slice the reference's Query RPC exercises,
server/volume_grpc_query.go + weed/query/json):

    SELECT * | col[, col...] FROM S3Object|s [WHERE cond]
    cond: comparisons (= != <> < <= > >=), LIKE '%pat%',
          AND / OR / NOT, parentheses, IS [NOT] NULL
    columns: bare names, s.field, _1-style CSV ordinals,
             dotted paths into nested JSON (a.b.c)

Hand-rolled recursive-descent — no SQL library in the image.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


class SqlError(ValueError):
    pass


_TOKEN = re.compile(r"""
    \s*(
        '(?:[^']|'')*'            # string literal
      | -?\d+\.\d+ | -?\d+        # number
      | <> | != | <= | >= | = | < | >
      | \( | \) | \* | ,
      | [A-Za-z_][A-Za-z0-9_.]*   # identifier / keyword
    )""", re.VERBOSE)


def _tokenize(text: str) -> list[str]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip():
                raise SqlError(f"bad token at: {text[pos:pos + 20]!r}")
            break
        out.append(m.group(1))
        pos = m.end()
    return out


@dataclass
class Comparison:
    column: str
    op: str
    value: object  # str | float | None

    def evaluate(self, get) -> bool:
        v = get(self.column)
        if self.op == "isnull":
            return v is None
        if self.op == "notnull":
            return v is not None
        if v is None:
            return False
        if self.op == "like":
            pat = re.escape(str(self.value)).replace("%", ".*") \
                .replace("_", ".")
            return re.fullmatch(pat, str(v)) is not None
        want = self.value
        if isinstance(want, float):
            try:
                v = float(v)
            except (TypeError, ValueError):
                return False
        else:
            v = str(v)
            want = str(want)
        return {"=": v == want, "!=": v != want, "<": v < want,
                "<=": v <= want, ">": v > want, ">=": v >= want}[self.op]


@dataclass
class BoolOp:
    op: str  # and | or | not
    args: list

    def evaluate(self, get) -> bool:
        if self.op == "and":
            return all(a.evaluate(get) for a in self.args)
        if self.op == "or":
            return any(a.evaluate(get) for a in self.args)
        return not self.args[0].evaluate(get)


@dataclass
class SelectStatement:
    columns: list[str] = field(default_factory=list)  # [] means *
    where: object | None = None

    def matches(self, get) -> bool:
        return self.where is None or self.where.evaluate(get)


def _strip_alias(col: str) -> str:
    # 's.field' / 'S3Object.field' -> 'field'
    for prefix in ("s.", "S3Object.", "s3object."):
        if col.startswith(prefix):
            return col[len(prefix):]
    return col


class _Parser:
    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise SqlError("unexpected end of query")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_kw(self, kw: str) -> None:
        t = self.next()
        if t.lower() != kw:
            raise SqlError(f"expected {kw.upper()}, got {t!r}")

    # SELECT cols FROM tbl [WHERE expr]
    def parse(self) -> SelectStatement:
        self.expect_kw("select")
        cols: list[str] = []
        if self.peek() == "*":
            self.next()
        else:
            while True:
                cols.append(_strip_alias(self.next()))
                if self.peek() == ",":
                    self.next()
                    continue
                break
        self.expect_kw("from")
        self.next()  # table name (S3Object / s) — single-table dialect
        nxt = self.peek()
        if nxt and nxt.lower() not in ("where",) and \
                re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", nxt):
            self.next()  # optional table alias ("FROM S3Object s")
        where = None
        if self.peek() and self.peek().lower() == "where":
            self.next()
            where = self.parse_or()
        if self.peek() is not None:
            raise SqlError(f"trailing tokens at {self.peek()!r}")
        return SelectStatement(columns=cols, where=where)

    def parse_or(self):
        left = self.parse_and()
        while self.peek() and self.peek().lower() == "or":
            self.next()
            left = BoolOp("or", [left, self.parse_and()])
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.peek() and self.peek().lower() == "and":
            self.next()
            left = BoolOp("and", [left, self.parse_not()])
        return left

    def parse_not(self):
        if self.peek() and self.peek().lower() == "not":
            self.next()
            return BoolOp("not", [self.parse_not()])
        return self.parse_atom()

    def parse_atom(self):
        if self.peek() == "(":
            self.next()
            inner = self.parse_or()
            if self.next() != ")":
                raise SqlError("missing )")
            return inner
        col = _strip_alias(self.next())
        op = self.next()
        if op.lower() == "is":
            neg = False
            t = self.next()
            if t.lower() == "not":
                neg = True
                t = self.next()
            if t.lower() != "null":
                raise SqlError("expected NULL after IS")
            return Comparison(col, "notnull" if neg else "isnull", None)
        if op.lower() == "like":
            lit = self.next()
            return Comparison(col, "like", _literal(lit))
        if op == "<>":
            op = "!="
        if op not in ("=", "!=", "<", "<=", ">", ">="):
            raise SqlError(f"unknown operator {op!r}")
        return Comparison(col, op, _literal(self.next()))


def _literal(tok: str):
    if tok.startswith("'"):
        return tok[1:-1].replace("''", "'")
    try:
        return float(tok)
    except ValueError:
        raise SqlError(f"expected literal, got {tok!r}") from None


def parse_select(text: str) -> SelectStatement:
    return _Parser(_tokenize(text)).parse()
