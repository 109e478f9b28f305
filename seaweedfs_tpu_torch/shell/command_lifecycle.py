"""cluster.lifecycle / volume.tier.status — the data-lifecycle plane.

`cluster.lifecycle` renders the master daemon's status (rules, scan
history, recent actions) and can force a synchronous scan;
`volume.tier.status` walks every volume server's /debug/tier for
per-volume tier state plus the shared block cache's live numbers.

The port's copy of `seaweedfs_tpu/shell/command_lifecycle.py`.
"""

from __future__ import annotations

import time

from ..cluster import rpc
from .commands import Command, register
from .env import CommandEnv, ShellError


@register
class ClusterLifecycle(Command):
    name = "cluster.lifecycle"
    help = ("cluster.lifecycle [run] — lifecycle daemon status (rules, "
            "scans, recent actions); `run` forces one policy scan now")

    def do(self, args: list[str], env: CommandEnv) -> str:
        _flags, rest = self.parse_flags(args)
        if rest and rest[0] == "run":
            out = rpc.call_json(f"{env.master_url}/cluster/lifecycle/run",
                                payload={}, timeout=300.0)
            return (f"scan complete: tiered={out.get('tiered', [])} "
                    f"vacuumed={out.get('vacuumed', [])} "
                    f"errors={len(out.get('errors', []))}")
        st = rpc.call(f"{env.master_url}/cluster/lifecycle", timeout=10.0)
        if not isinstance(st, dict):
            raise ShellError("bad /cluster/lifecycle answer")
        lines = [f"enabled: {st.get('enabled')}   "
                 f"interval: {st.get('interval')}s   "
                 f"scans: {st.get('scans')}   "
                 f"last_scan_age: {st.get('last_scan_age')}"]
        rules = st.get("rules", [])
        lines.append(f"rules ({len(rules)}):")
        for r in rules:
            cond = " ".join(f"{k}={v}" for k, v in sorted(r.items())
                            if k not in ("collection", "action"))
            lines.append(f"  {r.get('collection', '*'):12} "
                         f"{r.get('action', ''):7} {cond}")
        acts = st.get("actions", {})
        lines.append("actions: " + "  ".join(
            f"{k}={acts[k]}" for k in sorted(acts)))
        recent = st.get("recent", [])
        if recent:
            lines.append("recent:")
            for a in recent[-10:]:
                at = time.strftime("%H:%M:%S",
                                   time.localtime(a.get("at", 0)))
                extra = " ".join(
                    f"{k}={v}" for k, v in sorted(a.items())
                    if k not in ("at", "kind", "volume", "node"))
                lines.append(f"  {at}  {a.get('kind', ''):12} "
                             f"vol {a.get('volume')} @ "
                             f"{a.get('node')} {extra}")
        return "\n".join(lines)


@register
class VolumeTierStatus(Command):
    name = "volume.tier.status"
    help = ("volume.tier.status [-server host:port] — per-volume tier "
            "state and the remote block cache's live numbers from "
            "every volume server's /debug/tier")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        if flags.get("server"):
            targets = [flags["server"]]
        else:
            targets = [n["url"] for n in env.data_nodes()]
        if not targets:
            raise ShellError("no volume servers registered")
        lines = [f"{'NODE':21}  {'VOL':>5}  {'COLLECTION':12}  "
                 f"{'TTL':6}  {'STATE':7}  REMOTE"]
        caches = []
        for url in targets:
            try:
                out = rpc.call(f"http://{url}/debug/tier", timeout=10.0)
            except Exception as e:  # noqa: BLE001
                lines.append(f"{url:21}  unreachable: {e}")
                continue
            if not isinstance(out, dict):
                continue
            caches.append((url, out.get("cache", {})))
            for v in out.get("volumes", []):
                state = "remote" if v.get("tiered") else "local"
                remote = ""
                if v.get("tiered"):
                    r = v.get("remote", {})
                    remote = (f"{r.get('backend_spec')} "
                              f"key={r.get('key')} "
                              f"hits={v.get('hits_in_window', 0)}")
                lines.append(f"{url:21}  {v.get('volume', 0):>5}  "
                             f"{v.get('collection') or '-':12}  "
                             f"{v.get('ttl') or '-':6}  {state:7}  "
                             f"{remote}")
        for url, c in caches:
            lines.append(
                f"cache @ {url}: {c.get('used_bytes', 0)}/"
                f"{c.get('max_bytes', 0)} bytes in "
                f"{c.get('blocks', 0)} blocks, "
                f"hit={c.get('hit_bytes', 0)}B "
                f"miss={c.get('miss_bytes', 0)}B "
                f"fetch p99={c.get('fetch_ms', {}).get('p99')}ms")
        return "\n".join(lines)
