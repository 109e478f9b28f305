"""fault.ls / fault.set — inspect and arm fault-injection points.

Fault points live per process (fault/registry.py) and are served by
each server's `/debug/faults` (mounted when the process was started
with SEAWEEDFS_TPU_FAULTS set, or SEAWEEDFS_TPU_FAULTS_DEBUG=1).
These commands aggregate across every reachable server — master, all
registered volume servers, and the filer when configured — mirroring
trace.ls/trace.get: in a multi-process deployment each process arms
its own faults.

The port's copy of `seaweedfs_tpu/shell/command_fault.py`.
"""

from __future__ import annotations

from ..cluster import rpc
from ..fault import registry as _registry
from .commands import Command, register
from .env import CommandEnv, ShellError


def _fetch(url: str, qs: str = "", method: str = "GET") -> dict | None:
    try:
        out = rpc.call(f"{url}/debug/faults{qs}", method, timeout=5.0)
        return out if isinstance(out, dict) else None
    except Exception:  # noqa: BLE001 — endpoint off / server gone
        return None


@register
class FaultLs(Command):
    name = "fault.ls"
    help = ("fault.ls [-server host:port] — fault-point catalog and "
            "armed state per server (needs servers started with "
            "SEAWEEDFS_TPU_FAULTS set)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        lines = [f"{'POINT':18}  DESCRIPTION"]
        for name in sorted(_registry.POINTS):
            lines.append(f"{name:18}  {_registry.POINTS[name]}")
        reached = 0
        armed_lines: list[str] = []
        for url in env.debug_servers(flags):
            out = _fetch(url)
            if out is None:
                continue
            reached += 1
            for row in out.get("points", []):
                if row.get("armed"):
                    armed_lines.append(
                        f"{url:28}  {row['point']:18}  "
                        f"{row.get('spec', '')}  "
                        f"hits={row.get('hits', 0)} "
                        f"triggered={row.get('triggered', 0)} "
                        f"remaining={row.get('remaining', -1)}")
        if not reached:
            raise ShellError(
                "no /debug/faults endpoint reachable — start servers "
                "with SEAWEEDFS_TPU_FAULTS set (may be empty) or "
                "SEAWEEDFS_TPU_FAULTS_DEBUG=1")
        lines.append("")
        if armed_lines:
            lines.append(f"{'SERVER':28}  {'POINT':18}  SPEC")
            lines += armed_lines
        else:
            lines.append(f"nothing armed on {reached} server(s)")
        return "\n".join(lines)


@register
class FaultSet(Command):
    name = "fault.set"
    help = ("fault.set <point> <spec|off> [-server host:port] — arm "
            "(or disarm) a fault point on every reachable server; "
            "spec grammar: kind[:arg][*times][@prob][~match], kinds "
            "fail|delay|status|drop (see README Robustness)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, rest = self.parse_flags(args)
        if len(rest) < 2:
            raise ShellError(
                "usage: fault.set <point> <spec|off> [-server ...]")
        point, spec = rest[0], rest[1]
        if spec not in ("off", "none"):
            # Validate locally before spraying it at the cluster.
            if point not in _registry.POINTS:
                raise ShellError(f"unknown fault point {point!r}")
            try:
                _registry.FaultSpec(point, spec)
            except ValueError as e:
                raise ShellError(str(e)) from None
        import urllib.parse
        qs = (f"?point={urllib.parse.quote(point)}"
              f"&spec={urllib.parse.quote(spec)}")
        done, failed = [], []
        for url in env.debug_servers(flags):
            out = _fetch(url, qs, method="POST")
            (done if out is not None else failed).append(url)
        if not done:
            raise ShellError(
                "no /debug/faults endpoint accepted the change — "
                "start servers with SEAWEEDFS_TPU_FAULTS set")
        verb = "disarmed" if spec in ("off", "none") else \
            f"armed {spec!r}"
        out = [f"{point}: {verb} on {len(done)} server(s)"]
        out += [f"  {u}" for u in done]
        if failed:
            out.append(f"unreachable/disabled: {len(failed)}")
        return "\n".join(out)
