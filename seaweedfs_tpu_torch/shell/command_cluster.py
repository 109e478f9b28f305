"""events.ls / cluster.check — the cluster timeline and health rollup.

Events are recorded per process into a bounded ring (events/journal.py)
and served by each server's `/debug/events`.  `events.ls` aggregates
across every reachable server — master, all registered volume servers,
and the filer when configured — deduplicating by each journal's
(token, seq) identity, because roles sharing one process (test stacks,
`weed server`) share one journal.  `cluster.check` renders the master's
`/cluster/healthz` rollup: per-node liveness (heartbeat age, breaker
state, disk fill) and per-volume/EC-volume health.

The port's copy of `seaweedfs_tpu/shell/command_cluster.py`.
"""

from __future__ import annotations

import time

from ..cluster import rpc
from ..events import TYPES
from .commands import Command, register
from .env import CommandEnv, ShellError


@register
class EventsLs(Command):
    name = "events.ls"
    help = ("events.ls [-type T] [-severity S] [-since TS] [-limit N] "
            "[-server host:port] [-types] — one cluster timeline "
            "merged from every reachable server's /debug/events")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        if flags.get("types"):
            lines = [f"{'TYPE':22}  DESCRIPTION"]
            for name in sorted(TYPES):
                lines.append(f"{name:22}  {TYPES[name]}")
            return "\n".join(lines)
        type_ = flags.get("type", "")
        if type_ and type_ not in TYPES:
            raise ShellError(f"unknown event type {type_!r} "
                             "(events.ls -types)")
        limit = int(flags.get("limit", "50"))
        qs_parts = [f"type={type_}" if type_ else "",
                    f"severity={flags['severity']}"
                    if flags.get("severity") else "",
                    f"since={flags['since']}"
                    if flags.get("since") else ""]
        qs = "&".join(p for p in qs_parts if p)
        merged: dict[tuple, dict] = {}
        reached = 0
        for url in env.debug_servers(flags):
            try:
                out = rpc.call(f"{url}/debug/events"
                               + (f"?{qs}" if qs else ""), timeout=5.0)
            except Exception:  # noqa: BLE001 — endpoint off / gone
                continue
            if not isinstance(out, dict):
                continue
            reached += 1
            token = out.get("token", url)
            for ev in out.get("events", []):
                merged.setdefault((token, ev.get("seq", 0)), ev)
        if not reached:
            raise ShellError("no /debug/events endpoint reachable")
        rows = sorted(merged.values(), key=lambda e: e["ts"])[-limit:]
        if not rows:
            return "no events recorded"
        lines = [f"{'AT':12}  {'SEV':5}  {'TYPE':22}  {'NODE':21}  "
                 "ATTRS"]
        for ev in rows:
            at = time.strftime("%H:%M:%S",
                               time.localtime(ev["ts"])) \
                + f".{int(ev['ts'] % 1 * 1000):03d}"
            attrs = " ".join(f"{k}={v}" for k, v in
                             sorted(ev.get("attrs", {}).items()))
            if ev.get("trace_id"):
                attrs += f"  trace={ev['trace_id']}"
            lines.append(f"{at:12}  {ev['severity']:5}  "
                         f"{ev['type']:22}  "
                         f"{ev.get('node', '') or '-':21}  {attrs}")
        return "\n".join(lines)


@register
class ClusterDrain(Command):
    name = "cluster.drain"
    help = ("cluster.drain -node host:port [-grace N] — gracefully "
            "drain one volume server: it refuses new writes (503 + "
            "Retry-After), finishes in-flight requests up to the "
            "grace, then goodbyes the master (unregistered "
            "immediately, no dead-sweep window).  The rolling-upgrade "
            "step: drain, restart the process, verify with "
            "cluster.check, move to the next node")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        node = flags.get("node", "")
        if not node:
            raise ShellError("cluster.drain -node host:port is "
                             "required")
        grace = float(flags.get("grace", "30"))
        base = node if "://" in node else f"http://{node}"
        try:
            out = rpc.call_json(f"{base}/admin/drain", "POST",
                                {"grace": grace},
                                timeout=grace + 10.0)
        except Exception as e:  # noqa: BLE001
            raise ShellError(
                f"cannot drain {node}: {e}") from None
        if out.get("already"):
            return f"{node} was already draining"
        return (f"{node} drained: new writes refused, "
                f"{out.get('inflight', 0)} request(s) still in flight "
                f"at goodbye; safe to stop/upgrade the process")


@register
class ClusterHot(Command):
    name = "cluster.hot"
    help = ("cluster.hot [-k N] [-dimension volume|needle|client] "
            "[-node host:port] — heavy hitters from every volume "
            "server's /debug/hot (space-saving top-k): the hot "
            "volumes, needles, and client IPs that decide where a "
            "cache or small-file pack pays off.  The true cluster "
            "count of a KEY lies within [count-err, count+err]")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        k = int(flags.get("k", "10"))
        want_dim = flags.get("dimension", "")
        if flags.get("node"):
            nodes = [flags["node"]]
        else:
            try:
                nodes = [n["url"] for n in env.data_nodes()]
            except Exception as e:  # noqa: BLE001
                raise ShellError(f"cannot list volume servers: {e}") \
                    from None
        # Pull each node's FULL table, then merge per (dimension, op).
        # A key a full node evicted may hold up to that node's minimum
        # counter there — fold that into the key's error (as under-
        # count slack) instead of pretending the sum is still a pure
        # upper bound; a non-full table means absence = exactly zero.
        node_tables: list[dict] = []
        reached = 0
        for node in nodes:
            base = node if "://" in node else f"http://{node}"
            try:
                out = rpc.call(f"{base}/debug/hot?k=1000000",
                               timeout=5.0)
            except Exception:  # noqa: BLE001 — node gone
                continue
            if isinstance(out, dict):
                reached += 1
                node_tables.append(out)
        if not reached:
            raise ShellError("no /debug/hot endpoint reachable")
        # First pass: per (dimension, op), each node's table + the
        # slack a full table implies for keys it evicted.
        per_dim: dict[tuple[str, str], list[tuple[dict, int]]] = {}
        totals: dict[tuple[str, str], int] = {}
        for out in node_tables:
            capacity = out.get("capacity", 0)
            for dim, ops in out.get("dimensions", {}).items():
                for op, data in ops.items():
                    dkey = (dim, op)
                    totals[dkey] = totals.get(dkey, 0) \
                        + data.get("total", 0)
                    rows = data.get("top", [])
                    table = {str(r["key"]): r for r in rows}
                    full = capacity and len(rows) >= capacity
                    node_min = min((r["count"] for r in rows),
                                   default=0) if full else 0
                    per_dim.setdefault(dkey, []).append(
                        (table, node_min))
        # Second pass: union of keys; a node that tracks the key
        # contributes its count+error, a full node that evicted it
        # contributes up to its minimum counter as error slack.
        merged: dict[tuple[str, str], dict] = {}
        for dkey, tables in per_dim.items():
            bucket = merged.setdefault(dkey, {})
            union: set[str] = set()
            for table, _ in tables:
                union.update(table)
            for key in union:
                count = err = 0
                for table, node_min in tables:
                    r = table.get(key)
                    if r is not None:
                        count += r["count"]
                        err += r["error"]
                    else:
                        err += node_min
                bucket[key] = [count, err]
        lines = []
        for (dim, op) in sorted(merged):
            if want_dim and dim != want_dim:
                continue
            total = totals.get((dim, op), 0)
            if not total:
                continue
            lines.append(f"{dim} ({op}, {total} ops):")
            lines.append(f"  {'KEY':24} {'COUNT':>9} {'ERR':>7}  SHARE")
            rows = sorted(merged[(dim, op)].items(),
                          key=lambda kv: kv[1][0], reverse=True)[:k]
            for key, (count, err) in rows:
                share = 100.0 * count / total if total else 0.0
                lines.append(f"  {key:24} {count:9d} {err:7d}  "
                             f"{share:5.1f}%")
        return "\n".join(lines) if lines else \
            "no traffic recorded yet"


@register
class ClusterConns(Command):
    name = "cluster.conns"
    help = ("cluster.conns [-node host:port] [-limit N] — open-"
            "connection census from every reachable server's "
            "/debug/conns: transport, per-state counts (idle / "
            "reading / handling), and the oldest connections.  The "
            "front-door dashboard: a slow-loris flood shows up as "
            "piles of 'reading' conns, a worker-pool stall as "
            "'handling' ones")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        limit = int(flags.get("limit", "5"))
        if flags.get("node"):
            nodes = [flags["node"]]
        else:
            nodes = [env.master_url]
            try:
                nodes += [n["url"] for n in env.data_nodes()]
            except Exception:  # noqa: BLE001 — master-only census
                pass
        lines = [f"{'NODE':21}  {'TRANSPORT':9}  {'OPEN':>5}  STATES"]
        detail: list[str] = []
        reached = 0
        for node in nodes:
            base = node if "://" in node else f"http://{node}"
            try:
                out = rpc.call(f"{base}/debug/conns?limit={limit}",
                               timeout=5.0)
            except Exception:  # noqa: BLE001 — node gone
                continue
            if not isinstance(out, dict):
                continue
            reached += 1
            name = base.split("://", 1)[1]
            states = ",".join(f"{k}={v}" for k, v in
                              sorted(out.get("states", {}).items())) \
                or "-"
            lines.append(f"{name:21}  {out.get('transport', '?'):9}  "
                         f"{out.get('open', 0):5d}  {states}")
            for c in out.get("conns", []):
                detail.append(
                    f"  {name:21}  {c.get('peer', '?'):21} "
                    f"{c.get('state', '?'):9} "
                    f"age={c.get('age_s', 0.0):7.1f}s "
                    f"idle={c.get('idle_s', 0.0):6.1f}s "
                    f"reqs={c.get('requests', 0)}")
        if not reached:
            raise ShellError("no /debug/conns endpoint reachable")
        if detail:
            lines.append("")
            lines.append(f"oldest {limit} per node:")
            lines.extend(detail)
        return "\n".join(lines)


@register
class ClusterFlows(Command):
    name = "cluster.flows"
    help = ("cluster.flows [-purpose P] [-watch] [-interval S] "
            "[-count N] — the wire-flow traffic matrix from the "
            "master's /cluster/flows: per-link per-purpose bytes "
            "(user.read, replicate.fanout, ec.gather, ...), rates "
            "from successive heartbeat samples, top-talker links, "
            "bandwidth-budget status, and the conservation verdict "
            "(every sender's count must match its receiver within "
            "1%).  -watch repolls every -interval seconds (default "
            "2) until interrupted (or -count polls)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        purpose = flags.get("purpose", "")
        watch = flags.get("watch") == "true"
        interval = float(flags.get("interval", "2"))
        count = int(flags.get("count", "0"))
        q = f"?purpose={purpose}" if purpose else ""
        if not watch:
            return self._render(self._fetch(env, q))
        import time as _time
        polls = 0
        out = ""
        try:
            while True:
                out = self._render(self._fetch(env, q))
                polls += 1
                if count and polls >= count:
                    break
                print(out)
                print("---")
                _time.sleep(interval)
        except KeyboardInterrupt:
            pass
        return out

    @staticmethod
    def _fetch(env: CommandEnv, q: str) -> dict:
        try:
            doc = rpc.call(f"{env.master_url}/cluster/flows{q}",
                           timeout=10.0)
        except Exception as e:  # noqa: BLE001
            raise ShellError(
                f"cannot reach {env.master_url}/cluster/flows: "
                f"{e}") from None
        if not isinstance(doc, dict):
            raise ShellError(f"unexpected /cluster/flows reply: "
                             f"{doc!r}")
        return doc

    @staticmethod
    def _render(doc: dict) -> str:
        cons = doc.get("conservation", {})
        lines = [f"nodes={len(doc.get('nodes', []))}  "
                 f"cells={len(doc.get('cells', []))}  conservation="
                 + ("OK" if cons.get("ok") else "VIOLATED")
                 + f" ({cons.get('paired_cells', 0)} paired)"]
        for v in cons.get("violations", []):
            lines.append(f"  !! {v['src']} -> {v['dst']} "
                         f"[{v['purpose']}]: sent={v['sent']} "
                         f"recv={v['recv']} skew={v['skew']}")
        purposes = doc.get("purposes", {})
        if purposes:
            lines.append("")
            lines.append(f"{'PURPOSE':18}  {'GB':>12}")
            for p, ent in purposes.items():
                lines.append(f"{p:18}  {ent['gb']:12.6f}")
        cells = doc.get("cells", [])
        if cells:
            lines.append("")
            lines.append(f"{'SRC':21}  {'DST':21}  {'PURPOSE':18}  "
                         f"{'SENT':>12}  {'RECV':>12}  {'B/S':>10}  "
                         f"{'OPS':>6}")
            for c in cells:
                sent = c.get("sent_bytes")
                recv = c.get("recv_bytes")
                ops = max(c.get("sent_ops", 0), c.get("recv_ops", 0))
                lines.append(
                    f"{c['src']:21}  {c['dst']:21}  "
                    f"{c['purpose']:18}  "
                    f"{'-' if sent is None else sent:>12}  "
                    f"{'-' if recv is None else recv:>12}  "
                    f"{c.get('rate_bps', 0.0):10.0f}  {ops:6d}")
        top = doc.get("top_talkers", [])
        if top:
            lines.append("")
            lines.append("top talkers: " + ", ".join(
                f"{t['src']}->{t['dst']} ({t['bytes']}B)"
                for t in top[:5]))
        breached = []
        for node, status in sorted(doc.get("budgets", {}).items()):
            for p, st in sorted(status.items()):
                state = "BREACH" if st.get("breached") else "ok"
                breached.append(
                    f"  {node}  {p}: {st.get('rate_bps', 0):.0f} of "
                    f"{st.get('limit_bps', 0):.0f} B/s [{state}]")
        if breached:
            lines.append("")
            lines.append("budgets:")
            lines.extend(breached)
        return "\n".join(lines)


@register
class ClusterRoofline(Command):
    name = "cluster.roofline"
    help = ("cluster.roofline [-node host:port] [-kernel K] [-codec C] "
            "[-save out.json] [-diff baseline.json] — the device "
            "roofline rollup from the master's /cluster/device (or one "
            "node's /debug/device with -node): probed peaks, the "
            "per-kernel table (count, seconds, bytes, GF(2) work, "
            "achieved fraction of roofline p50/p95), per-node pipeline "
            "occupancy with bubble attribution, and collapse "
            "warnings.  -save writes the table as JSON; -diff ranks "
            "achieved-fraction deltas vs a saved baseline (the "
            "kernel-regression gate)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        import json as _json
        if flags.get("node"):
            node = flags["node"]
            base = node if "://" in node else f"http://{node}"
            url = f"{base}/debug/device"
        else:
            q = []
            if flags.get("kernel"):
                q.append(f"kernel={flags['kernel']}")
            if flags.get("codec"):
                q.append(f"codec={flags['codec']}")
            qs = ("?" + "&".join(q)) if q else ""
            url = f"{env.master_url}/cluster/device{qs}"
        try:
            doc = rpc.call(url, timeout=15.0)
        except Exception as e:  # noqa: BLE001
            raise ShellError(f"cannot reach {url}: {e}") from None
        if not isinstance(doc, dict):
            raise ShellError(f"unexpected reply from {url}: {doc!r}")
        table = doc.get("kernels", [])
        if flags.get("node"):
            # /debug/device rows are unmerged; apply filters locally.
            if flags.get("kernel"):
                table = [r for r in table
                         if r["kernel"] == flags["kernel"]]
            if flags.get("codec"):
                table = [r for r in table
                         if r["codec"] == flags["codec"]]
        lines = []
        peaks = doc.get("peaks") or {}
        mm = peaks.get("matmul_flops") or {}
        if peaks:
            mmtxt = "  ".join(
                f"{d}={v / 1e9:.1f}GF/s" for d, v in sorted(mm.items())
                if v)
            lines.append(
                f"peaks[{peaks.get('backend', '?')}]: {mmtxt}  "
                f"membw={peaks.get('membw_bps', 0) / 1e9:.2f}GB/s  "
                f"h2d={peaks.get('h2d_bps', 0) / 1e9:.2f}GB/s")
        if table:
            lines.append("")
            lines.append(f"{'KERNEL':22} {'CODEC':12} {'DTYPE':5} "
                         f"{'GEOMETRY':16} {'COUNT':>7} {'SECONDS':>9} "
                         f"{'BYTES':>13} {'WORK':>15} {'P50':>6} "
                         f"{'P95':>6}")
            for r in table:
                p50, p95 = r.get("achieved_p50"), r.get("achieved_p95")
                lines.append(
                    f"{r['kernel']:22} {r['codec']:12} {r['dtype']:5} "
                    f"{r['geometry']:16} {r['count']:7d} "
                    f"{r['seconds']:9.4f} {r['bytes']:13d} "
                    f"{r['work']:15d} "
                    f"{'-' if p50 is None else format(p50, '6.3f')} "
                    f"{'-' if p95 is None else format(p95, '6.3f')}")
        else:
            lines.append("no kernel invocations recorded yet")
        occ_lines = []
        if flags.get("node"):
            occ = (doc.get("occupancy") or {}).get("latest", {})
            for kind, ent in sorted(occ.items()):
                frac = ent.get("fraction")
                occ_lines.append(
                    f"  {doc.get('node', '?'):21} {kind:8} "
                    f"{'-' if frac is None else format(frac, '.0%'):>5}"
                    f"  starved by {ent.get('starving_stage') or '-'}")
        else:
            for nurl, nd in sorted((doc.get("nodes") or {}).items()):
                occ = (nd.get("occupancy") or {}).get("latest", {})
                for kind, ent in sorted(occ.items()):
                    frac = ent.get("fraction")
                    occ_lines.append(
                        f"  {nurl:21} {kind:8} "
                        f"{'-' if frac is None else format(frac, '.0%'):>5}"
                        f"  starved by {ent.get('starving_stage') or '-'}")
        if occ_lines:
            lines.append("")
            lines.append("pipeline occupancy (device stage):")
            lines.extend(occ_lines)
        for w in doc.get("warnings", []):
            lines.append(f"  !! {w}")
        if flags.get("save"):
            with open(flags["save"], "w") as f:
                _json.dump({"ts": time.time(), "kernels": table}, f,
                           indent=2, sort_keys=True)
            lines.append("")
            lines.append(f"wrote {len(table)} kernel rows to "
                         f"{flags['save']}")
        if flags.get("diff"):
            try:
                with open(flags["diff"]) as f:
                    base_doc = _json.load(f)
            except (OSError, ValueError) as e:
                raise ShellError(
                    f"cannot read baseline {flags['diff']}: {e}") \
                    from None
            base = {(r["kernel"], r["codec"], r["dtype"],
                     r["geometry"]): r
                    for r in base_doc.get("kernels", [])}
            cur = {(r["kernel"], r["codec"], r["dtype"],
                    r["geometry"]): r for r in table}
            deltas = []
            for key in set(base) | set(cur):
                b = (base.get(key) or {}).get("achieved_p50")
                c = (cur.get(key) or {}).get("achieved_p50")
                if b is None and c is None or b == c:
                    continue
                deltas.append((key, b, c,
                               (c or 0.0) - (b or 0.0)))
            deltas.sort(key=lambda d: d[3])
            lines.append("")
            lines.append(f"{'DELTA':>7}  {'BASE':>6}  {'NOW':>6}  "
                         "KERNEL/CODEC/DTYPE/GEOMETRY (achieved p50; "
                         "negative = regression)")
            for key, b, c, d in deltas:
                lines.append(
                    f"{d:+7.3f}  "
                    f"{'-' if b is None else format(b, '6.3f')}  "
                    f"{'-' if c is None else format(c, '6.3f')}  "
                    f"{'/'.join(key)}")
            if not deltas:
                lines.append("no achieved-fraction movement vs "
                             "baseline")
        return "\n".join(lines)


@register
class ClusterCheck(Command):
    name = "cluster.check"
    help = ("cluster.check — health rollup from the master's "
            "/cluster/healthz: node liveness, disk fill, volume and "
            "EC-shard health; exit text is HEALTHY or the problem list")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        url = flags.get("server")
        base = (url if "://" in url else f"http://{url}") if url \
            else env.master_url
        try:
            status, doc = rpc.call_status(f"{base}/cluster/healthz",
                                          timeout=10.0)
        except Exception as e:  # noqa: BLE001
            raise ShellError(
                f"cannot reach {base}/cluster/healthz: {e}") from None
        if not isinstance(doc, dict):
            raise ShellError(f"unexpected healthz reply: {doc!r}")
        lines = [("HEALTHY" if doc.get("healthy")
                  else f"UNHEALTHY (HTTP {status})")
                 + f"  leader={doc.get('leader', '?')}"]
        for p in doc.get("problems", []):
            lines.append(f"  !! {p}")
        nodes = doc.get("nodes", [])
        if nodes:
            lines.append("")
            lines.append(f"{'NODE':21}  {'HB AGE':>7}  {'BREAKER':9}  "
                         f"{'VOLS':>4}  {'EC':>3}  DISK")
            for n in nodes:
                disk = ", ".join(
                    f"{d.get('dir', '?')} {d.get('percent_used', 0):.0f}%"
                    for d in n.get("disks", [])) or "-"
                lines.append(
                    f"{n['node']:21}  {n['heartbeat_age']:7.1f}  "
                    f"{n['breaker']:9}  {n['volumes']:4d}  "
                    f"{n['ec_shards']:3d}  {disk}")
        ec = doc.get("ec_volumes", [])
        if ec:
            lines.append("")
            lines.append(f"{'EC VOLUME':>9}  {'SHARDS':>6}  MISSING")
            for v in ec:
                missing = ",".join(map(str, v["missing"])) or "-"
                lines.append(f"{v['id']:9d}  {v['present']:6d}  "
                             f"{missing}")
        ro = [v for v in doc.get("volumes", []) if v.get("read_only")]
        if ro:
            lines.append("")
            lines.append("readonly volumes: " + ", ".join(
                f"{v['id']}@{v['node']}" for v in ro))
        placement = (doc.get("placement") or {}).get("warnings", [])
        if placement:
            lines.append("")
            for w in placement:
                lines.append(f"  ~ placement: {w}")
        rep = doc.get("repair") or {}
        if rep:
            state = "armed" if rep.get("enabled") else "disarmed"
            if rep.get("paused"):
                state += ", paused"
            lines.append("")
            lines.append(f"repair autopilot: {state}  "
                         f"queue={rep.get('queue', 0)}  "
                         f"inflight={rep.get('inflight', 0)}")
        filers = (doc.get("filers") or {}).get("nodes", [])
        if filers:
            lines.append("")
            lines.append(f"{'FILER':29}  {'HB AGE':>7}  {'PRIMARY OF':>10}")
            for f in filers:
                mark = "" if f.get("alive") else "  !! dead"
                lines.append(
                    f"{f['url']:29}  {f['age_seconds']:7.1f}  "
                    f"{f['shards_primary']:10d}{mark}")
        return "\n".join(lines)


@register
class ClusterRepair(Command):
    name = "cluster.repair"
    help = ("cluster.repair [status|run|pause|resume] [-kind="
            "replicate|ec] — the durability autopilot: `status` "
            "renders the risk-ranked repair queue, in-flight repairs "
            "with phase, the dry-run plan (with hysteresis/suppression "
            "annotations) and the MTTR histogram; `run` drains one "
            "synchronous repair pass (works while the daemon is "
            "disarmed); `pause`/`resume` gate the armed daemon's "
            "executors at runtime")

    @staticmethod
    def _render_rows(title: str, rows: list[dict]) -> list[str]:
        lines = ["", f"{title} ({len(rows)}):"]
        for r in rows:
            extra = f" missing={len(r.get('missing', []))}" \
                if r.get("kind") == "ec" else \
                f" rp={r.get('replication', '?')}"
            note = ""
            if r.get("suppressed"):
                note = "  (drain-fenced)"
            elif "degraded_for" in r:
                note = f"  degraded {r['degraded_for']:.1f}s"
            lines.append(
                f"  risk={r['risk']}  {r['kind']:9}  "
                f"volume {r['volume']:6d}  {r.get('have', '?')}/"
                f"{r.get('want', '?')}  phase={r['phase']}"
                f"{extra}{note}")
        return lines

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, rest = self.parse_flags(args)
        sub = rest[0] if rest else "status"
        base = env.master_url
        if sub == "status":
            doc = rpc.call(f"{base}/cluster/repair", timeout=30.0)
            state = "armed" if doc.get("enabled") else "disarmed"
            if doc.get("paused"):
                state += ", PAUSED"
            lines = [f"durability autopilot: {state}  "
                     f"delay={doc.get('delay_seconds', 0):.0f}s  "
                     f"concurrent={doc.get('concurrent', 0)}"]
            if doc.get("queue"):
                lines += self._render_rows("queued", doc["queue"])
            if doc.get("inflight"):
                lines += self._render_rows("in flight",
                                           doc["inflight"])
            if doc.get("plan"):
                lines += self._render_rows("plan (live scan)",
                                           doc["plan"])
            m = doc.get("mttr") or {}
            if m.get("count"):
                lines.append("")
                lines.append(
                    f"MTTR over last {m['count']} repairs: "
                    f"mean {m['mean_seconds']}s, "
                    f"max {m['max_seconds']}s")
                hist = m.get("histogram") or {}
                lines.append("  " + "  ".join(
                    f"{k.removeprefix('le_')}s:{v}"
                    for k, v in hist.items() if v))
            if len(lines) == 1:
                lines.append("nothing degraded — queue empty")
            return "\n".join(lines)
        if sub == "run":
            env.confirm_is_locked()
            kinds = [flags["kind"]] if flags.get("kind") else None
            doc = rpc.call_json(f"{base}/cluster/repair/run",
                                payload={"kinds": kinds},
                                timeout=600.0)
            lines = [f"ran {doc.get('ran', 0)} repairs"]
            for r in doc.get("results", []):
                lines.append(
                    f"  {r['kind']:9}  volume {r['volume']:6d}  "
                    f"{r.get('outcome', '?')}"
                    + (f"  ({r['error']})" if r.get("error") else ""))
            for r in doc.get("trimmed", []):
                lines.append(f"  dedupe     volume {r['volume']:6d}  "
                             f"trimmed surplus copy on {r['node']}")
            return "\n".join(lines)
        if sub in ("pause", "resume"):
            env.confirm_is_locked()
            doc = rpc.call_json(f"{base}/cluster/repair/{sub}",
                                payload={}, timeout=30.0)
            return ("autopilot paused" if doc.get("paused")
                    else "autopilot resumed")
        raise ShellError(f"unknown subcommand {sub!r} "
                         "(status|run|pause|resume)")


@register
class FilerShardsLs(Command):
    name = "filer.shards.ls"
    help = ("filer.shards.ls — the master's filer shard map: per-shard "
            "primary, fencing epoch, followers, and each registered "
            "filer's journal positions (metadata-HA plane; empty when "
            "the master runs without -filer.shards)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        try:
            doc = rpc.call(f"{env.master_url}/cluster/filer/shards",
                           timeout=10.0)
        except Exception as e:  # noqa: BLE001
            raise ShellError(
                f"cannot read the shard map: {e}") from None
        assert isinstance(doc, dict)
        if not doc.get("num_shards"):
            return ("metadata plane disarmed "
                    "(master started without -filer.shards)")
        lines = [f"{doc['num_shards']} shards, map version "
                 f"{doc.get('version', 0)}", "",
                 f"{'SHARD':>5}  {'EPOCH':>5}  {'PRIMARY':29}  FOLLOWERS"]
        for k in sorted((doc.get("shards") or {}), key=int):
            row = doc["shards"][k]
            lines.append(
                f"{int(k):5d}  {row.get('epoch', 0):5d}  "
                f"{row.get('primary') or '(none)':29}  "
                + (", ".join(row.get("followers", [])) or "-"))
        filers = doc.get("filers", [])
        if filers:
            lines.append("")
            lines.append(f"{'FILER':29}  {'ALIVE':5}  JOURNALS "
                         "(shard:last_seq/applied)")
            for f in filers:
                js = " ".join(
                    f"{k}:{v.get('last_seq', 0)}/"
                    f"{v.get('applied_seq', 0)}"
                    for k, v in sorted(f.get("shards", {}).items(),
                                       key=lambda kv: int(kv[0]))) \
                    or "-"
                lines.append(f"{f['url']:29}  "
                             f"{'yes' if f.get('alive') else 'NO':5}  "
                             f"{js}")
        return "\n".join(lines)


@register
class FilerShardsMove(Command):
    name = "filer.shards.move"
    help = ("filer.shards.move -shard N -to http://host:port — "
            "demote-first primary transfer: the old primary stops "
            "acking before the new one exists anywhere (mid-move the "
            "shard fails closed), then the epoch bumps and the target "
            "acquires; clients re-route on their next 409/map refresh")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        if "shard" not in flags or "to" not in flags:
            raise ShellError(
                "filer.shards.move -shard N -to url is required")
        shard = int(flags["shard"])
        to = flags["to"]
        to = to if "://" in to else f"http://{to}"
        try:
            out = rpc.call_json(
                f"{env.master_url}/cluster/filer/shards/move", "POST",
                {"shard": shard, "to": to}, timeout=30.0)
        except Exception as e:  # noqa: BLE001
            raise ShellError(f"move failed: {e}") from None
        if out.get("already"):
            return f"shard {shard} already primary on {to}"
        return (f"shard {shard} moved to {to} at epoch "
                f"{out.get('epoch', '?')} (old primary "
                f"{out.get('old_primary') or '(none)'} fenced)")
