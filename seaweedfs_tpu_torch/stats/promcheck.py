"""Pure-python Prometheus text-exposition validator (promtool-style).

`validate_exposition(text)` returns a list of problems (empty = clean).
Checks the invariants Prometheus' own parser enforces on a scrape:

- line grammar: `name{labels} value` with a legal metric name, legal
  label names, and correctly escaped label values (`\\`, `\"`, `\n`);
- HELP/TYPE comments: at most one each per family, emitted before any
  of the family's samples, with a known TYPE;
- family grouping: a family's samples are contiguous (interleaving two
  families is a parse error for Prometheus);
- histograms: every `<base>_bucket` series group (same labels minus
  `le`) has ascending `le` values, CUMULATIVE (non-decreasing) counts,
  and a `+Inf` bucket that matches `<base>_count` when present;
- values parse as floats (NaN/+Inf/-Inf allowed).

Used by the tier-1 tests against live scrapes of master/volume/filer,
and usable standalone against any registry's `expose()` output.
"""

from __future__ import annotations

import math
import re

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _parse_value(tok: str) -> float | None:
    t = tok.strip()
    if t in ("+Inf", "Inf"):
        return math.inf
    if t == "-Inf":
        return -math.inf
    if t == "NaN":
        return math.nan
    try:
        return float(t)
    except ValueError:
        return None


def _parse_labels(s: str, lineno: int,
                  problems: list[str]) -> dict[str, str] | None:
    """Parse `k="v",k2="v2"` honoring the escape rules; None on error."""
    labels: dict[str, str] = {}
    i = 0
    n = len(s)
    while i < n:
        eq = s.find("=", i)
        if eq < 0:
            problems.append(f"line {lineno}: label without '=': {s[i:]!r}")
            return None
        name = s[i:eq].strip()
        if not _LABEL_NAME_RE.match(name):
            problems.append(f"line {lineno}: bad label name {name!r}")
            return None
        if eq + 1 >= n or s[eq + 1] != '"':
            problems.append(f"line {lineno}: unquoted value for {name}")
            return None
        j = eq + 2
        val = []
        while True:
            if j >= n:
                problems.append(
                    f"line {lineno}: unterminated value for {name}")
                return None
            c = s[j]
            if c == "\\":
                if j + 1 >= n or s[j + 1] not in ('\\', '"', 'n'):
                    problems.append(
                        f"line {lineno}: bad escape in value of {name}")
                    return None
                val.append("\n" if s[j + 1] == "n" else s[j + 1])
                j += 2
            elif c == '"':
                j += 1
                break
            else:
                val.append(c)
                j += 1
        labels[name] = "".join(val)
        if j < n:
            if s[j] != ",":
                problems.append(
                    f"line {lineno}: junk after value of {name}: "
                    f"{s[j:]!r}")
                return None
            j += 1
        i = j
    return labels


def _family_of(name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def validate_exposition(text: str) -> list[str]:
    problems: list[str] = []
    helped: set[str] = set()
    typed: dict[str, str] = {}
    sampled: set[str] = set()      # families that emitted samples
    closed: set[str] = set()       # families whose sample run ended
    current_family: str | None = None
    # (family, labels-minus-le frozen) -> [(le, count, lineno)]
    buckets: dict[tuple, list[tuple[float, float, int]]] = {}
    counts: dict[tuple, float] = {}

    for lineno, line in enumerate(text.split("\n"), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                if parts[1:2] and parts[1] in ("HELP", "TYPE"):
                    problems.append(f"line {lineno}: truncated {parts[1]}")
                continue  # plain comment
            kind, fam = parts[1], parts[2]
            if fam in sampled:
                problems.append(
                    f"line {lineno}: {kind} for {fam} after its samples")
            if kind == "HELP":
                if fam in helped:
                    problems.append(f"line {lineno}: duplicate HELP {fam}")
                helped.add(fam)
            else:
                if fam in typed:
                    problems.append(f"line {lineno}: duplicate TYPE {fam}")
                if len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    problems.append(
                        f"line {lineno}: unknown TYPE for {fam}")
                typed[fam] = parts[3] if len(parts) > 3 else ""
            continue

        # sample line: name[{labels}] value [timestamp]
        if "{" in line:
            brace = line.index("{")
            name = line[:brace]
            close = line.rfind("}")
            if close < brace:
                problems.append(f"line {lineno}: unbalanced braces")
                continue
            labels = _parse_labels(line[brace + 1:close], lineno,
                                   problems)
            if labels is None:
                continue
            rest = line[close + 1:]
        else:
            toks = line.split(None, 1)
            name = toks[0]
            labels = {}
            rest = toks[1] if len(toks) > 1 else ""
        if not _NAME_RE.match(name):
            problems.append(f"line {lineno}: bad metric name {name!r}")
            continue
        toks = rest.split()
        if not toks:
            problems.append(f"line {lineno}: missing value for {name}")
            continue
        value = _parse_value(toks[0])
        if value is None:
            problems.append(
                f"line {lineno}: bad value {toks[0]!r} for {name}")
            continue

        fam = _family_of(name)
        if fam != current_family:
            if current_family is not None:
                closed.add(current_family)
            if fam in closed:
                problems.append(
                    f"line {lineno}: samples of {fam} interleaved with "
                    "another family")
            current_family = fam
        sampled.add(fam)

        if typed.get(fam) == "histogram":
            key = (fam, frozenset((k, v) for k, v in labels.items()
                                  if k != "le"))
            if name == fam + "_bucket":
                if "le" not in labels:
                    problems.append(
                        f"line {lineno}: {name} without le label")
                    continue
                le = _parse_value(labels["le"])
                if le is None:
                    problems.append(
                        f"line {lineno}: bad le {labels['le']!r}")
                    continue
                buckets.setdefault(key, []).append((le, value, lineno))
            elif name == fam + "_count":
                counts[key] = value

    for (fam, _lk), entries in buckets.items():
        les = [e[0] for e in entries]
        if les != sorted(les):
            problems.append(f"{fam}: le buckets not ascending")
        vals = [e[1] for e in entries]
        if any(b < a for a, b in zip(vals, vals[1:])):
            problems.append(f"{fam}: bucket counts not cumulative")
        if not les or not math.isinf(les[-1]):
            problems.append(f"{fam}: missing +Inf bucket")
        elif (fam, _lk) in counts and vals[-1] != counts[(fam, _lk)]:
            problems.append(
                f"{fam}: +Inf bucket {vals[-1]} != _count "
                f"{counts[(fam, _lk)]}")
    return problems
