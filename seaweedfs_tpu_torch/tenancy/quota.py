"""Declarative per-tenant quota rules: how much each principal may
store and how fast it may go.

Two formats, one model, same loader style as lifecycle/policy.py.  The
line grammar (the `-tenant.rules` default) is one rule per line:

    # tenant   [key=value ...]
    alice   max_bytes=10GB  max_objects=1000000
    bob     max_rps=200     max_mbps=64   weight=4
    probe   max_bytes=1MB   soft=true
    *       max_rps=500

and the same rules in TOML (a `.toml` path switches parsers):

    [[rule]]
    tenant = "alice"
    max_bytes = "10GB"
    max_objects = 1000000

Semantics:

- `max_bytes` / `max_objects` bound STORED usage (the master rollup's
  live view).  Hard rules (the default) reject over-quota writes with
  403 QuotaExceeded at the master assign and the filer/S3 upload path;
  `soft=true` only emits `quota.exceeded` events and healthz warnings.
- `max_rps` / `max_mbps` feed per-tenant token buckets in the admission
  plane (tenancy/qos.py): over-rate requests get 429 + Retry-After.
- `weight` is the tenant's deficit-round-robin share when a lane's
  queue backs up (default 1).

Tenants match exactly; `*` matches any.  The FIRST matching rule wins,
so specific lines go above the wildcard.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([KMGT]?I?B?)$",
                      re.IGNORECASE)

# Binary multiples either way: 1KB == 1KiB == 1024 (storage-quota
# convention, matching -volumeSizeLimitMB and friends).
_UNIT_BYTES = {"": 1, "B": 1, "K": 1 << 10, "KB": 1 << 10,
               "KIB": 1 << 10,
               "M": 1 << 20, "MB": 1 << 20, "MIB": 1 << 20,
               "G": 1 << 30, "GB": 1 << 30, "GIB": 1 << 30,
               "T": 1 << 40, "TB": 1 << 40, "TIB": 1 << 40}


class QuotaError(ValueError):
    pass


def parse_size(text) -> int:
    """'64MB' / '10GB' / '512K' / bare bytes -> bytes."""
    m = _SIZE_RE.match(str(text).strip())
    unit = _UNIT_BYTES.get(m.group(2).upper()) if m else None
    if unit is None:
        raise QuotaError(f"bad size: {text!r}")
    return int(float(m.group(1)) * unit)


@dataclass(frozen=True)
class QuotaRule:
    tenant: str              # exact name, or "*"
    max_bytes: int = 0       # stored bytes (0 = unlimited)
    max_objects: int = 0     # stored objects (0 = unlimited)
    max_rps: float = 0.0     # requests per second (0 = unlimited)
    max_mbps: float = 0.0    # write bandwidth, MB/s (0 = unlimited)
    soft: bool = False       # soft: warn + events, never reject
    weight: float = 1.0      # DRR share when the lane queue backs up
    home: str = ""           # geo home cluster id ("" = no preference)

    def matches(self, tenant: str) -> bool:
        return self.tenant == "*" or self.tenant == tenant

    def to_dict(self) -> dict:
        d: dict = {"tenant": self.tenant}
        if self.max_bytes:
            d["max_bytes"] = self.max_bytes
        if self.max_objects:
            d["max_objects"] = self.max_objects
        if self.max_rps:
            d["max_rps"] = self.max_rps
        if self.max_mbps:
            d["max_mbps"] = self.max_mbps
        if self.soft:
            d["soft"] = True
        if self.weight != 1.0:
            d["weight"] = self.weight
        if self.home:
            d["home"] = self.home
        return d


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise QuotaError(f"bad bool: {v!r}")


def _build_rule(tenant: str, kv: dict) -> QuotaRule:
    if not tenant:
        raise QuotaError("rule needs a tenant name (or *)")
    known = {"max_bytes", "max_objects", "max_rps", "max_mbps",
             "soft", "weight", "home"}
    bad = set(kv) - known
    if bad:
        raise QuotaError(f"unknown rule keys {sorted(bad)}")
    max_bytes = parse_size(kv["max_bytes"]) if "max_bytes" in kv else 0
    max_objects = int(kv.get("max_objects", 0))
    max_rps = float(kv.get("max_rps", 0.0))
    max_mbps = float(kv.get("max_mbps", 0.0))
    soft = _parse_bool(kv.get("soft", False))
    weight = float(kv.get("weight", 1.0))
    home = str(kv.get("home", "")).strip()
    if max_bytes < 0 or max_objects < 0 or max_rps < 0 or max_mbps < 0:
        raise QuotaError("quota limits must be >= 0")
    if weight <= 0:
        raise QuotaError(f"weight must be > 0: {weight}")
    if not (max_bytes or max_objects or max_rps or max_mbps or home):
        raise QuotaError(
            "rule needs at least one of max_bytes=/max_objects=/"
            "max_rps=/max_mbps=/home=")
    return QuotaRule(tenant=tenant, max_bytes=max_bytes,
                     max_objects=max_objects, max_rps=max_rps,
                     max_mbps=max_mbps, soft=soft, weight=weight,
                     home=home)


def parse_rules_text(text: str) -> "QuotaPolicy":
    rules = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        tenant = parts[0]
        kv = {}
        for tok in parts[1:]:
            k, eq, v = tok.partition("=")
            if not eq:
                raise QuotaError(f"line {lineno}: bad token {tok!r}")
            kv[k] = v
        try:
            rules.append(_build_rule(tenant, kv))
        except QuotaError as e:
            raise QuotaError(f"line {lineno}: {e}") from None
    return QuotaPolicy(rules)


def parse_rules_toml(text: str) -> "QuotaPolicy":
    try:
        import tomllib
    except ModuleNotFoundError:  # stdlib tomllib is 3.11+
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ModuleNotFoundError:
            raise QuotaError(
                "TOML rules need Python 3.11+ (stdlib tomllib) or the "
                "tomli package; use the line grammar instead") from None
    try:
        doc = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise QuotaError(f"bad TOML: {e}") from None
    rules = []
    for i, entry in enumerate(doc.get("rule", [])):
        if not isinstance(entry, dict):
            raise QuotaError(f"rule #{i}: want a table")
        kv = {k: v for k, v in entry.items() if k != "tenant"}
        try:
            rules.append(_build_rule(str(entry.get("tenant", "*")), kv))
        except QuotaError as e:
            raise QuotaError(f"rule #{i}: {e}") from None
    return QuotaPolicy(rules)


def load_rules(path: str) -> "QuotaPolicy":
    with open(path) as f:
        text = f.read()
    if path.endswith(".toml"):
        return parse_rules_toml(text)
    return parse_rules_text(text)


class QuotaPolicy:
    """An ordered rule list; the first rule matching a tenant wins."""

    def __init__(self, rules: list[QuotaRule] | None = None):
        self.rules = list(rules or [])

    def rule_for(self, tenant: str) -> QuotaRule | None:
        if not tenant:
            return None  # untenanted / internal traffic is unbounded
        for r in self.rules:
            if r.matches(tenant):
                return r
        return None

    def weight_for(self, tenant: str) -> float:
        r = self.rule_for(tenant)
        return r.weight if r is not None else 1.0

    def to_dict(self) -> dict:
        return {"rules": [r.to_dict() for r in self.rules]}

    def __len__(self) -> int:
        return len(self.rules)
