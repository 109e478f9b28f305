"""tenant.ls / tenant.quota / cluster.tenants — the tenancy plane.

`cluster.tenants` renders the master's cluster-wide usage rollup (the
same `/cluster/tenants` surface quota enforcement reads), one row per
tenant with its matched rule and verdict.  `tenant.ls` walks every
reachable server's `/debug/tenants` for the LIVE view — per-node stored
ledgers and sliding req/s / bytes/s meters.  `tenant.quota` shows the
declared rules and, per tenant, usage against each limit.

The port's copy of `seaweedfs_tpu/shell/command_tenant.py`.
"""

from __future__ import annotations

from ..cluster import rpc
from .commands import Command, register
from .env import CommandEnv, ShellError


def _human(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TB"


def _rule_str(rule: dict | None) -> str:
    if not rule:
        return "-"
    parts = []
    if rule.get("max_bytes"):
        parts.append(f"bytes<={_human(rule['max_bytes'])}")
    if rule.get("max_objects"):
        parts.append(f"objects<={rule['max_objects']}")
    if rule.get("max_rps"):
        parts.append(f"rps<={rule['max_rps']:g}")
    if rule.get("max_mbps"):
        parts.append(f"mbps<={rule['max_mbps']:g}")
    if rule.get("soft"):
        parts.append("soft")
    if rule.get("weight", 1.0) != 1.0:
        parts.append(f"weight={rule['weight']:g}")
    return ",".join(parts) or "-"


def _rollup(env: CommandEnv) -> dict:
    try:
        out = rpc.call(f"{env.master_url}/cluster/tenants", timeout=5.0)
    except Exception as e:  # noqa: BLE001
        raise ShellError(f"master /cluster/tenants failed: {e}") from e
    if not isinstance(out, dict):
        raise ShellError("unexpected /cluster/tenants answer")
    return out


@register
class ClusterTenants(Command):
    name = "cluster.tenants"
    help = ("cluster.tenants — master-side per-tenant usage rollup "
            "(the view quota enforcement reads), with rule + verdict")

    def do(self, args: list[str], env: CommandEnv) -> str:
        out = _rollup(env)
        tenants = out.get("tenants", {})
        if not tenants:
            return "no tenant usage reported yet"
        lines = [f"{'TENANT':16} {'BYTES':>10} {'OBJECTS':>8} "
                 f"{'COLLECTIONS':>11}  {'RULE':28} VERDICT"]
        for t in sorted(tenants):
            row = tenants[t]
            over = row.get("over_quota") or []
            verdict = "ok" if not over else \
                f"over:{','.join(over)} ({row.get('enforcement', '?')})"
            ncoll = len(row.get("collections", {}))
            lines.append(
                f"{t:16} {_human(row.get('bytes', 0)):>10} "
                f"{row.get('objects', 0):>8} {ncoll:>11}  "
                f"{_rule_str(row.get('rule')):28} {verdict}")
        lines.append(f"({len(tenants)} tenants, "
                     f"{len(out.get('rules', []))} rules, "
                     f"leader {out.get('leader', env.master_url)})")
        return "\n".join(lines)


@register
class TenantLs(Command):
    name = "tenant.ls"
    help = ("tenant.ls [-server host:port] — live per-node tenant "
            "ledgers: stored bytes/objects and sliding req/s meters "
            "from every reachable /debug/tenants")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        lines: list[str] = []
        reached = 0
        for url in env.debug_servers(flags):
            try:
                out = rpc.call(f"{url}/debug/tenants", timeout=5.0)
            except Exception:  # noqa: BLE001 — role without the route
                continue
            if not isinstance(out, dict) or "stored" not in out:
                continue
            reached += 1
            lines.append(f"{out.get('node', url)}:")
            rows = out.get("stored", [])
            rates = out.get("rates", {})
            if not rows and not rates:
                lines.append("  (no tenant activity)")
            for r in rows:
                coll = r.get("collection") or "(default)"
                lines.append(
                    f"  {r['tenant']:16} {coll:12} "
                    f"{_human(r.get('bytes', 0)):>10} "
                    f"{r.get('objects', 0):>7} objects")
            for t in sorted(rates):
                m = rates[t]
                lines.append(
                    f"  {t:16} {'[rates]':12} "
                    f"{m.get('req_s', 0):.1f} req/s "
                    f"r {_human(m.get('read_bps', 0))}/s "
                    f"w {_human(m.get('write_bps', 0))}/s")
        if not reached:
            raise ShellError("no server answered /debug/tenants")
        return "\n".join(lines)


@register
class TenantQuota(Command):
    name = "tenant.quota"
    help = ("tenant.quota [tenant] — declared quota rules and usage "
            "against each limit (from the master rollup)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        _flags, rest = self.parse_flags(args)
        want = rest[0] if rest else ""
        out = _rollup(env)
        rules = out.get("rules", [])
        tenants = out.get("tenants", {})
        if want:
            rules = [r for r in rules
                     if r.get("tenant") in (want, "*")]
            tenants = {t: v for t, v in tenants.items() if t == want}
            if not rules and not tenants:
                raise ShellError(f"no rule or usage for {want!r}")
        lines = [f"{len(rules)} rules:"]
        for r in rules:
            lines.append(f"  {r.get('tenant', '?'):16} {_rule_str(r)}")
        if tenants:
            lines.append("usage:")
            for t in sorted(tenants):
                row = tenants[t]
                rule = row.get("rule") or {}
                b, o = row.get("bytes", 0), row.get("objects", 0)
                cap_b = rule.get("max_bytes", 0)
                cap_o = rule.get("max_objects", 0)
                use = [f"{_human(b)}"
                       + (f"/{_human(cap_b)}" if cap_b else ""),
                       f"{o}" + (f"/{cap_o}" if cap_o else "")
                       + " objects"]
                over = row.get("over_quota") or []
                if over:
                    use.append(f"OVER ({row.get('enforcement', '?')}: "
                               f"{','.join(over)})")
                lines.append(f"  {t:16} " + "  ".join(use))
        return "\n".join(lines)
