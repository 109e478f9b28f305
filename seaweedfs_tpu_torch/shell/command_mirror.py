"""cluster.mirror.* — operate the cross-cluster async mirror.

The mirror pairing itself is configuration (`-replicate.peer` on the
primary's volume servers, `-replicate.lag.slo` on the master); these
commands are the runbook verbs on top of it:

- `cluster.mirror.status`   one table: per-volume ship watermarks and
                            lag, from the master's `/cluster/mirror`
                            rollup (heartbeat-fed), plus each node's
                            `/debug/replication` role.
- `cluster.mirror.pause`    stop shipping (the change logs keep
                            journaling; lag grows) — the knob for WAN
                            maintenance windows.
- `cluster.mirror.resume`   start shipping again and kick an immediate
                            tick.
- `cluster.mirror.cutover`  the verified failover: drain the primary's
                            volume servers (new writes refused with
                            503 + Retry-After — the drain semantics),
                            wait until every change log is acked up to
                            its last record, then pause the shippers
                            and declare the standby authoritative.
                            Zero acked-write loss by construction: a
                            write is only acked to clients after it is
                            journaled, and cutover only completes after
                            every journaled record is acked by the
                            standby.

Convergence after cutover is machine-checkable with
`volume.fsck -crc -json` against both clusters (README "Disaster
recovery").

The port's copy of `seaweedfs_tpu/shell/command_mirror.py`.
"""

from __future__ import annotations

import time

from ..cluster import rpc
from ..events import emit as emit_event
from .commands import Command, register
from .env import CommandEnv, ShellError


def _mirror_doc(env: CommandEnv) -> dict:
    try:
        out = rpc.call(f"{env.master_url}/cluster/mirror", timeout=10.0)
    except Exception as e:  # noqa: BLE001
        raise ShellError(
            f"cannot reach {env.master_url}/cluster/mirror: {e}") \
            from None
    if not isinstance(out, dict):
        raise ShellError(f"unexpected /cluster/mirror reply: {out!r}")
    return out


def _shipper_nodes(env: CommandEnv) -> list[tuple[str, dict]]:
    """(node url, /debug/replication doc) for every data node that has
    a shipper configured — the primary side of the mirror."""
    out = []
    for n in env.data_nodes():
        try:
            doc = rpc.call(f"http://{n['url']}/debug/replication",
                           timeout=5.0)
        except Exception:  # noqa: BLE001 — node gone mid-walk
            continue
        if isinstance(doc, dict) and "primary" in doc.get("role", []):
            out.append((n["url"], doc))
    return out


@register
class ClusterMirrorStatus(Command):
    name = "cluster.mirror.status"
    help = ("cluster.mirror.status [-watch] [-interval S] [-count N] "
            "— per-volume mirror state from the master's "
            "/cluster/mirror: change-log watermarks, ship lag "
            "(records + seconds), pause state, geo lease holders, and "
            "the lag SLO.  -watch repolls every -interval seconds "
            "(default 2) until interrupted (or -count polls)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        watch = flags.get("watch") == "true"
        interval = float(flags.get("interval", "2"))
        count = int(flags.get("count", "0"))
        if not watch:
            return self._render(_mirror_doc(env))
        polls = 0
        out = ""
        try:
            while True:
                out = self._render(_mirror_doc(env))
                polls += 1
                if count and polls >= count:
                    break
                print(out)
                print("---")
                time.sleep(interval)
        except KeyboardInterrupt:
            pass
        return out

    @staticmethod
    def _render(doc: dict) -> str:
        if not doc.get("paired"):
            return ("not paired: no volume server reports a "
                    "-replicate.peer")
        lines = [f"peer(s): {', '.join(doc.get('peers', [])) or '-'}"
                 + (f"  lag SLO: {doc['lag_slo']:g}s"
                    if doc.get("lag_slo") is not None else "")
                 + ("  CAUGHT UP" if doc.get("caught_up")
                    else "  SHIPPING")]
        if doc.get("cluster_id"):
            lines[0] += f"  cluster: {doc['cluster_id']}"
        if doc.get("paused_nodes"):
            lines.append("paused: "
                         + ", ".join(doc["paused_nodes"]))
        leases = doc.get("leases") or {}
        rows = doc.get("volumes", [])
        if rows:
            lines.append("")
            lines.append(f"{'VOLUME':>6}  {'NODE':21}  {'LAST':>8}  "
                         f"{'ACKED':>8}  {'LAG':>6}  {'LAG SEC':>8}  "
                         f"{'LEASE':12}")
            for r in sorted(rows, key=lambda r: (r["volume"],
                                                 r["node"])):
                lr = leases.get(str(r["volume"]))
                lease = (f"{lr['cluster_id']}@e{lr['epoch']}"
                         + ("*" if lr.get("moving") else "")
                         if lr else "-")
                lines.append(
                    f"{r['volume']:6d}  {r['node']:21}  "
                    f"{r.get('last_seq', 0):8d}  "
                    f"{r.get('acked_seq', 0):8d}  "
                    f"{r.get('lag_seq', 0):6d}  "
                    f"{r.get('lag_seconds', 0.0):8.1f}  "
                    f"{lease:12}")
        return "\n".join(lines)


class _PauseResume(Command):
    _pause = True

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        verb = "pause" if self._pause else "resume"
        if flags.get("node"):
            nodes = [flags["node"]]
        else:
            nodes = [u for u, _doc in _shipper_nodes(env)]
        if not nodes:
            raise ShellError("no volume server with a shipper "
                             "(-replicate.peer) reachable")
        done = []
        for node in nodes:
            try:
                env.vs_call(node, f"/admin/replication/{verb}",
                            payload={}, timeout=10.0)
                done.append(node)
            except rpc.RpcError as e:
                if e.status != 400:  # 400 = no shipper there
                    raise ShellError(
                        f"cannot {verb} shipping on {node}: {e}") \
                        from None
        if not done:
            raise ShellError(f"no shipper {verb}d")
        return (f"shipping {verb}d on {len(done)} node(s): "
                + ", ".join(done))


@register
class ClusterMirrorPause(_PauseResume):
    name = "cluster.mirror.pause"
    help = ("cluster.mirror.pause [-node host:port] — stop shipping "
            "change-log batches to the standby (journaling continues; "
            "lag grows until resume)")
    _pause = True


@register
class ClusterMirrorResume(_PauseResume):
    name = "cluster.mirror.resume"
    help = ("cluster.mirror.resume [-node host:port] — resume shipping "
            "and kick an immediate tick")
    _pause = False


@register
class ClusterMirrorCutover(Command):
    name = "cluster.mirror.cutover"
    help = ("cluster.mirror.cutover [-grace N] [-timeout N] — verified "
            "failover to the standby cluster: drain every primary "
            "volume server (new writes 503 + Retry-After), wait until "
            "each change log is acked up to its last record, pause the "
            "shippers, and declare the standby authoritative.  "
            "Requires `lock`.  Zero acked-write loss: cutover only "
            "completes once every journaled record is acked")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _rest = self.parse_flags(args)
        grace = float(flags.get("grace", "30"))
        deadline = time.monotonic() + float(flags.get("timeout", "60"))
        t0 = time.monotonic()

        # 1. Who ships?  Collect BEFORE draining: a drained node says
        # goodbye to the master and drops out of the topology walk.
        primaries = _shipper_nodes(env)
        if not primaries:
            raise ShellError("no volume server with a shipper "
                             "(-replicate.peer) reachable — nothing "
                             "to cut over")
        peers = sorted({doc.get("shipper", {}).get("peer", "")
                        for _u, doc in primaries if doc.get("shipper")})

        # 2. Drain the primary: from here on, no client write can land,
        # so the change logs stop growing and catch-up can terminate.
        for node, _doc in primaries:
            try:
                env.vs_call(node, "/admin/drain",
                            payload={"grace": grace},
                            timeout=grace + 10.0)
            except Exception as e:  # noqa: BLE001
                raise ShellError(
                    f"cannot drain {node}: {e}") from None

        # 3. Standby catches up: every journaled record acked.  The
        # drained servers keep serving admin/debug routes and their
        # shippers keep shipping; resume-kick forces immediate ticks.
        volumes = 0
        while True:
            behind = []
            volumes = 0
            for node, _doc in primaries:
                try:
                    doc = rpc.call(
                        f"http://{node}/debug/replication",
                        timeout=5.0)
                except Exception as e:  # noqa: BLE001
                    raise ShellError(
                        f"{node} unreachable during catch-up: {e}") \
                        from None
                for vid, st in (doc.get("rlog") or {}).items():
                    volumes += 1
                    if st.get("acked_seq", 0) < st.get("last_seq", 0):
                        behind.append((node, vid,
                                       st["last_seq"]
                                       - st["acked_seq"]))
            if not behind:
                break
            if time.monotonic() > deadline:
                detail = ", ".join(
                    f"volume {vid}@{node} {n} record(s) behind"
                    for node, vid, n in behind[:8])
                raise ShellError(
                    f"cutover timed out waiting for catch-up: {detail}")
            for node, _doc in primaries:
                try:  # resume == kick: ship NOW, not next tick
                    env.vs_call(node, "/admin/replication/resume",
                                payload={}, timeout=10.0)
                except Exception:  # noqa: BLE001
                    pass
            time.sleep(0.05)

        # 4. Quiesce the old primary's shippers: the standby is
        # authoritative now; nothing must ship INTO it as a mirror.
        for node, _doc in primaries:
            try:
                env.vs_call(node, "/admin/replication/pause",
                            payload={}, timeout=10.0)
            except Exception:  # noqa: BLE001 — already drained away
                pass

        seconds = round(time.monotonic() - t0, 3)
        emit_event("replication.cutover",
                   peers=",".join(p for p in peers if p),
                   drained=",".join(u for u, _d in primaries),
                   volumes=volumes, seconds=seconds)
        return ("cutover complete in "
                f"{seconds:.1f}s: {len(primaries)} primary node(s) "
                f"drained, {volumes} change log(s) fully acked, "
                "shipping paused.  The standby cluster is "
                "authoritative — point clients at its master"
                + (f" ({', '.join(p for p in peers if p)})"
                   if any(peers) else "")
                + ".  Verify convergence: volume.fsck -crc -json "
                  "against both clusters")


@register
class ClusterLeaseLs(Command):
    name = "cluster.lease.ls"
    help = ("cluster.lease.ls — per-volume geo write leases from the "
            "master's /cluster/mirror rollup: holding cluster, fencing "
            "epoch, and whether a transfer is mid-drain")

    def do(self, args: list[str], env: CommandEnv) -> str:
        doc = _mirror_doc(env)
        leases = doc.get("leases") or {}
        if not leases:
            return ("no geo leases: no volume server reports a "
                    ".lease sidecar (active/passive mirroring, or "
                    "-geo.cluster.id unset)")
        lines = []
        if doc.get("cluster_id"):
            lines.append(f"this cluster: {doc['cluster_id']}")
        lines.append(f"{'VOLUME':>6}  {'NODE':21}  {'HOLDER':10}  "
                     f"{'EPOCH':>6}  {'LOCAL':>5}  {'MOVING':>6}")
        for vid, lr in sorted(leases.items(), key=lambda kv:
                              int(kv[0])):
            lines.append(
                f"{int(vid):6d}  {lr.get('node', '-'):21}  "
                f"{lr.get('cluster_id', '?'):10}  "
                f"{lr.get('epoch', 0):6d}  "
                f"{'yes' if lr.get('holder_is_local') else 'no':>5}  "
                f"{'yes' if lr.get('moving') else 'no':>6}")
        return "\n".join(lines)


@register
class ClusterLeaseMove(Command):
    name = "cluster.lease.move"
    help = ("cluster.lease.move -volume V -to CLUSTER [-timeout N] — "
            "transfer a volume's geo write lease to the named peer "
            "cluster: the holder refuses new writes, drains its "
            "change log to the peer, then demotes itself at epoch+1 "
            "BEFORE the peer acquires (a partition mid-move leaves NO "
            "holder — fail-closed, never split-brained).  Requires "
            "`lock`")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _rest = self.parse_flags(args)
        if not flags.get("volume") or not flags.get("to"):
            raise ShellError("usage: cluster.lease.move -volume V "
                             "-to CLUSTER [-timeout N]")
        vid = int(flags["volume"])
        to = flags["to"]
        timeout = float(flags.get("timeout", "10"))
        try:
            out = rpc.call(
                f"{env.master_url}/dir/lookup?volumeId={vid}",
                timeout=10.0)
            locs = out.get("locations") or []
        except Exception as e:  # noqa: BLE001
            raise ShellError(f"lookup of volume {vid} failed: {e}") \
                from None
        if not locs:
            raise ShellError(f"volume {vid}: no locations known to "
                             f"{env.master_url}")
        node = locs[0].get("url") or locs[0].get("publicUrl")
        try:
            doc = env.vs_call(node, "/admin/lease/move",
                              payload={"volume": vid, "to": to,
                                       "timeout": timeout},
                              timeout=timeout + 10.0)
        except rpc.RpcError as e:
            raise ShellError(
                f"lease move failed on {node}: {e.message}") from None
        msg = (f"volume {vid}: lease moved to cluster {to} at epoch "
               f"{doc.get('epoch')} (drained on {node})")
        if not doc.get("peer_acquired"):
            msg += ("\nwarning: " + doc.get(
                "warning", "peer did not confirm the acquire"))
        return msg
