"""Query execution over JSON-lines / CSV byte streams.

Reference: weed/query/json/query_json.go (gjson-based projection and
filtering) and server/volume_grpc_query.go (wiring input/output
serialization options from the Query RPC).
"""

from __future__ import annotations

import csv
import io
import json

from .sql import SelectStatement, parse_select


def _json_getter(doc: dict):
    def get(col: str):
        cur: object = doc
        for part in col.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return None
            cur = cur[part]
        return cur
    return get


def _rows_json(data: bytes):
    """JSON documents: a single document / top-level array, or NDJSON
    (one per line, bad lines skipped like the reference's tolerant
    scanner)."""
    text = data.decode("utf-8", "replace").strip()
    if not text:
        return
    # Whole-document parse first: handles pretty-printed JSON (which a
    # line-by-line pass would misread) and single objects/arrays.
    try:
        parsed = json.loads(text)
    except json.JSONDecodeError:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue
        return
    if isinstance(parsed, list):
        yield from parsed
    else:
        yield parsed


def _rows_csv(data: bytes, header: bool = True, delimiter: str = ","):
    text = data.decode("utf-8", "replace")
    reader = csv.reader(io.StringIO(text), delimiter=delimiter)
    rows = iter(reader)
    if header:
        try:
            names = next(rows)
        except StopIteration:
            return
        for row in rows:
            yield dict(zip(names, row))
    else:
        for row in rows:
            # S3-Select ordinal columns: _1, _2, ...
            yield {f"_{i + 1}": v for i, v in enumerate(row)}


def _project(doc: dict, columns: list[str], get) -> dict:
    if not columns:
        return doc
    # Key by the full column path: projecting a.x and b.x must not
    # collapse onto one "x" key.
    return {col: get(col) for col in columns}


def run_query(data: bytes, query: str | SelectStatement,
              input_format: str = "json", csv_header: bool = True,
              csv_delimiter: str = ",",
              output_format: str = "json") -> bytes:
    """Execute a SELECT over an object's bytes; returns NDJSON or CSV."""
    stmt = parse_select(query) if isinstance(query, str) else query
    if input_format == "csv":
        rows = _rows_csv(data, header=csv_header,
                         delimiter=csv_delimiter)
    elif input_format == "json":
        rows = _rows_json(data)
    else:
        raise ValueError(f"unknown input format {input_format!r}")
    out_rows = []
    for doc in rows:
        if not isinstance(doc, dict):
            continue
        get = _json_getter(doc)
        if stmt.matches(get):
            out_rows.append(_project(doc, stmt.columns, get))
    if output_format == "csv":
        buf = io.StringIO()
        if out_rows:
            names = list(out_rows[0])
            w = csv.DictWriter(buf, fieldnames=names,
                               extrasaction="ignore")
            for r in out_rows:
                w.writerow({k: ("" if r.get(k) is None else r.get(k))
                            for k in names})
        return buf.getvalue().encode()
    return b"".join(
        json.dumps(r, separators=(",", ":")).encode() + b"\n"
        for r in out_rows)
