"""Declarative lifecycle rules: which collections tier where, and what
expires.

Two formats, one model.  The line grammar (the `-lifecycle.rules`
default) is one rule per line:

    # collection  action  [key=value ...]
    logs    tier   dest=local:///cold  idle=10m
    pics    tier   dest=s3://minio:9000/frozen  age=30d  fullness=0.8
    scratch expire
    *       expire

and the same rules in TOML (a `.toml` path switches parsers):

    [[rule]]
    collection = "logs"
    action = "tier"
    dest = "local:///cold"
    idle = "10m"

`tier` conditions (idle / age / fullness) AND together; at least one is
required — an unconditional tier rule would tier a volume the moment
it rolls readonly.  `expire` needs no conditions: it opts the
collection's TTL volumes into vacuum-driven reclaim (the TTL itself
rides the assign-time `?ttl`, stamped in the volume superblock and on
each needle).

Collections match exactly; `*` matches any.  The FIRST matching rule
per action wins, so specific lines go above the wildcard.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([smhdw]?)$")

_UNIT_SECONDS = {"": 1.0, "s": 1.0, "m": 60.0, "h": 3600.0,
                 "d": 86400.0, "w": 604800.0}


class PolicyError(ValueError):
    pass


def parse_duration(text: str) -> float:
    """'90s' / '10m' / '2h' / '30d' / bare seconds -> seconds.  Finer
    grained than core/ttl.py's wire codec on purpose: rule thresholds
    are scan-time comparisons, not stored per needle."""
    m = _DURATION_RE.match(str(text).strip())
    if not m:
        raise PolicyError(f"bad duration: {text!r}")
    return float(m.group(1)) * _UNIT_SECONDS[m.group(2)]


@dataclass(frozen=True)
class Rule:
    collection: str          # exact name, or "*"
    action: str              # "tier" | "expire"
    dest: str = ""           # tier: backend spec (backend_for_spec)
    idle_for: float = 0.0    # tier: seconds with no reads AND no writes
    min_age: float = 0.0     # tier: seconds since the newest write
    fullness: float = 0.0    # tier: fraction of the volume size limit

    def matches(self, collection: str) -> bool:
        return self.collection == "*" or self.collection == collection

    def to_dict(self) -> dict:
        d = {"collection": self.collection, "action": self.action}
        if self.dest:
            d["dest"] = self.dest
        if self.idle_for:
            d["idle_for"] = self.idle_for
        if self.min_age:
            d["min_age"] = self.min_age
        if self.fullness:
            d["fullness"] = self.fullness
        return d


def _build_rule(collection: str, action: str, kv: dict) -> Rule:
    if action not in ("tier", "expire"):
        raise PolicyError(f"unknown lifecycle action {action!r} "
                          f"(want tier|expire)")
    known = {"dest", "idle", "age", "fullness"}
    bad = set(kv) - known
    if bad:
        raise PolicyError(f"unknown rule keys {sorted(bad)}")
    dest = str(kv.get("dest", ""))
    idle_for = parse_duration(kv["idle"]) if "idle" in kv else 0.0
    min_age = parse_duration(kv["age"]) if "age" in kv else 0.0
    fullness = float(kv.get("fullness", 0.0))
    if action == "tier":
        if not dest:
            raise PolicyError("tier rule needs dest=<backend spec>")
        if not (idle_for or min_age or fullness):
            raise PolicyError(
                "tier rule needs at least one of idle=/age=/fullness=")
        if fullness and not 0.0 < fullness <= 1.0:
            raise PolicyError(f"fullness must be in (0, 1]: {fullness}")
    elif kv:
        raise PolicyError("expire rule takes no conditions "
                          f"(got {sorted(kv)})")
    return Rule(collection=collection, action=action, dest=dest,
                idle_for=idle_for, min_age=min_age, fullness=fullness)


def parse_rules_text(text: str) -> "Policy":
    rules = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) < 2:
            raise PolicyError(f"line {lineno}: want "
                              f"'<collection> <action> [k=v ...]'")
        collection, action = parts[0], parts[1]
        kv = {}
        for tok in parts[2:]:
            k, eq, v = tok.partition("=")
            if not eq:
                raise PolicyError(f"line {lineno}: bad token {tok!r}")
            kv[k] = v
        try:
            rules.append(_build_rule(collection, action, kv))
        except PolicyError as e:
            raise PolicyError(f"line {lineno}: {e}") from None
    return Policy(rules)


def parse_rules_toml(text: str) -> "Policy":
    try:
        import tomllib
    except ModuleNotFoundError:  # stdlib tomllib is 3.11+
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ModuleNotFoundError:
            raise PolicyError(
                "TOML rules need Python 3.11+ (stdlib tomllib) or the "
                "tomli package; use the line grammar instead") from None
    try:
        doc = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise PolicyError(f"bad TOML: {e}") from None
    rules = []
    for i, entry in enumerate(doc.get("rule", [])):
        if not isinstance(entry, dict):
            raise PolicyError(f"rule #{i}: want a table")
        kv = {k: v for k, v in entry.items()
              if k not in ("collection", "action")}
        try:
            rules.append(_build_rule(str(entry.get("collection", "*")),
                                     str(entry.get("action", "")), kv))
        except PolicyError as e:
            raise PolicyError(f"rule #{i}: {e}") from None
    return Policy(rules)


def load_rules(path: str) -> "Policy":
    with open(path) as f:
        text = f.read()
    if path.endswith(".toml"):
        return parse_rules_toml(text)
    return parse_rules_text(text)


class Policy:
    """An ordered rule list; first match per action wins."""

    def __init__(self, rules: list[Rule] | None = None):
        self.rules = list(rules or [])

    def tier_rule_for(self, collection: str) -> Rule | None:
        for r in self.rules:
            if r.action == "tier" and r.matches(collection):
                return r
        return None

    def expire_rule_for(self, collection: str) -> Rule | None:
        for r in self.rules:
            if r.action == "expire" and r.matches(collection):
                return r
        return None

    def to_dict(self) -> dict:
        return {"rules": [r.to_dict() for r in self.rules]}

    def __len__(self) -> int:
        return len(self.rules)
