"""trace.ls / trace.get — browse distributed request traces.

Traces are recorded per process into a bounded ring (trace/tracer.py)
and served by each server's `/debug/traces` (mounted when the server
was started with SEAWEEDFS_TPU_TRACES=1).  These commands aggregate
across every reachable server — master, all registered volume servers,
and the filer when configured — because in a multi-process deployment
each process only holds its own spans of a trace.

The port's copy of `seaweedfs_tpu/shell/command_trace.py`.
"""

from __future__ import annotations

from ..cluster import rpc
from .commands import Command, register
from .env import CommandEnv, ShellError


def _fetch(url: str, qs: str) -> dict | None:
    try:
        out = rpc.call(f"{url}/debug/traces{qs}", timeout=5.0)
        return out if isinstance(out, dict) else None
    except Exception:  # noqa: BLE001 — endpoint off / server gone
        return None


@register
class TraceLs(Command):
    name = "trace.ls"
    help = ("trace.ls [-server host:port] [-limit N] — list recent "
            "traces (needs servers started with SEAWEEDFS_TPU_TRACES=1)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        limit = int(flags.get("limit", "50"))
        merged: dict[str, dict] = {}
        reached = 0
        for url in env.debug_servers(flags):
            out = _fetch(url, f"?limit={limit}")
            if out is None:
                continue
            reached += 1
            for s in out.get("traces", []):
                cur = merged.get(s["trace_id"])
                if cur is None:
                    merged[s["trace_id"]] = dict(s)
                elif (cur["spans"], cur["start"], cur["duration_ms"]) \
                        == (s["spans"], s["start"], s["duration_ms"]):
                    # Identical view = servers sharing one in-process
                    # buffer (test stacks): don't double-count.
                    continue
                else:  # the same trace seen from another process
                    cur["spans"] += s["spans"]
                    cur["duration_ms"] = max(cur["duration_ms"],
                                             s["duration_ms"])
                    cur["services"] = sorted(set(cur["services"])
                                             | set(s["services"]))
                    if s["start"] < cur["start"]:
                        cur["start"], cur["root"] = s["start"], s["root"]
        if not reached:
            raise ShellError(
                "no /debug/traces endpoint reachable — start servers "
                "with SEAWEEDFS_TPU_TRACES=1")
        rows = sorted(merged.values(), key=lambda s: -s["start"])[:limit]
        if not rows:
            return "no traces recorded"
        lines = [f"{'TRACE':32}  {'MS':>9}  {'SPANS':>5}  ROOT"]
        for s in rows:
            lines.append(
                f"{s['trace_id']:32}  {s['duration_ms']:9.2f}  "
                f"{s['spans']:5d}  {s['root']} "
                f"[{','.join(s['services'])}]")
        return "\n".join(lines)


@register
class TraceGet(Command):
    name = "trace.get"
    help = ("trace.get <trace_id> [-server host:port] — span tree of "
            "one trace, aggregated across all reachable servers")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, rest = self.parse_flags(args)
        if not rest:
            raise ShellError("trace.get requires a trace id (trace.ls)")
        trace_id = rest[0]
        spans: dict[str, dict] = {}
        for url in env.debug_servers(flags):
            out = _fetch(url, f"?trace={trace_id}")
            if out is None:
                continue
            for s in out.get("spans", []):
                spans.setdefault(s["span_id"], s)
        if not spans:
            raise ShellError(f"trace {trace_id} not found on any server")
        children: dict[str, list[dict]] = {}
        roots: list[dict] = []
        for s in spans.values():
            if s["parent_id"] and s["parent_id"] in spans:
                children.setdefault(s["parent_id"], []).append(s)
            else:
                roots.append(s)  # true root, or an orphan whose parent
                #                  lives in an unreachable process
        lines = [f"trace {trace_id}: {len(spans)} spans"]

        def render(s: dict, depth: int) -> None:
            attrs = " ".join(f"{k}={v}" for k, v in
                             sorted(s["attrs"].items()))
            mark = "!" if s["status"] == "error" else ""
            lines.append(
                f"{'  ' * depth}{s['duration_ms']:9.2f}ms  "
                f"[{s['service']}] {s['name']}{mark}"
                + (f"  {attrs}" if attrs else ""))
            for c in sorted(children.get(s["span_id"], []),
                            key=lambda x: x["start"]):
                render(c, depth + 1)

        for root in sorted(roots, key=lambda s: s["start"]):
            render(root, 0)
        return "\n".join(lines)
