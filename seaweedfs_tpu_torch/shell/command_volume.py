"""Volume maintenance commands: list/balance/fix.replication/move/....

Reference: weed/shell/command_volume_list.go, command_volume_balance.go
(ideal-ratio moves), command_volume_fix_replication.go (under-replicated
copy), command_volume_move.go / _copy.go / _delete.go / _mount.go,
command_volume_vacuum (via master /vol/vacuum).
"""

from __future__ import annotations

from ..core.replica_placement import ReplicaPlacement
from ..cluster import rpc
from .commands import Command, register
from .env import CommandEnv, ShellError


def _volumes_by_id(env: CommandEnv) -> dict[int, list[tuple[dict, dict]]]:
    """vid -> [(node, vinfo), ...] across the cluster."""
    out: dict[int, list[tuple[dict, dict]]] = {}
    for n in env.data_nodes():
        for v in n["volumes"]:
            out.setdefault(v["id"], []).append((n, v))
    return out


@register
class VolumeList(Command):
    name = "volume.list"
    help = "volume.list — topology tree with every volume and EC shard"

    def do(self, args: list[str], env: CommandEnv) -> str:
        topo = env.topology()["topology"]
        lines = []
        for dc in topo["data_centers"]:
            lines.append(f"DataCenter {dc['id']}")
            for rack in dc["racks"]:
                lines.append(f"  Rack {rack['id']}")
                for n in rack["nodes"]:
                    lines.append(
                        f"    DataNode {n['url']} "
                        f"volumes:{len(n['volumes'])}"
                        f"/{n['max_volume_count']} "
                        f"ec_volumes:{len(n['ec_shards'])}")
                    for v in sorted(n["volumes"], key=lambda v: v["id"]):
                        rp = ReplicaPlacement.from_byte(
                            v.get("replica_placement", 0))
                        lines.append(
                            f"      volume id:{v['id']} "
                            f"collection:{v.get('collection', '') or '-'} "
                            f"size:{v['size']} "
                            f"files:{v['file_count']} "
                            f"replication:{rp} "
                            f"{'readonly' if v.get('read_only') else 'rw'}")
                    for e in sorted(n["ec_shards"], key=lambda e: e["id"]):
                        from ..ec.shard_bits import ShardBits
                        sids = ShardBits(e["shard_bits"]).shard_ids()
                        lines.append(
                            f"      ec volume id:{e['id']} shards:{sids}")
        return "\n".join(lines)


@register
class VolumeMove(Command):
    name = "volume.move"
    help = ("volume.move -volumeId <id> -source <host:port> "
            "-target <host:port> — copy a volume then remove the source")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        vid = int(flags["volumeId"])
        source, target = flags["source"], flags["target"]
        copy_volume(env, vid, source, target)
        env.vs_call(source, "/admin/delete_volume", {"volume": vid})
        return f"moved volume {vid}: {source} -> {target}"


def copy_volume(env: CommandEnv, vid: int, source: str, target: str) -> None:
    """Freeze the source, copy .idx+.dat to the target, restore.

    Without the freeze a write landing between the two file fetches would
    be referenced by neither copy — after a `move` deletes the source,
    that needle would be lost (the reference freezes/tails instead)."""
    locs = _volumes_by_id(env).get(vid, [])
    collection = locs[0][1].get("collection", "") if locs else ""
    was_readonly = bool(locs and locs[0][1].get("read_only"))
    env.vs_call(source, "/admin/readonly",
                {"volume": vid, "readonly": True})
    try:
        env.vs_call(target, "/admin/copy_volume",
                    {"volume": vid, "source": source,
                     "collection": collection})
    finally:
        if not was_readonly:
            env.vs_call(source, "/admin/readonly",
                        {"volume": vid, "readonly": False})


@register
class VolumeCopy(Command):
    name = "volume.copy"
    help = ("volume.copy -volumeId <id> -source <host:port> "
            "-target <host:port>")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        vid = int(flags["volumeId"])
        copy_volume(env, vid, flags["source"], flags["target"])
        return f"copied volume {vid} to {flags['target']}"


@register
class VolumeDelete(Command):
    name = "volume.delete"
    help = "volume.delete -volumeId <id> -node <host:port>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        vid = int(flags["volumeId"])
        env.vs_call(flags["node"], "/admin/delete_volume", {"volume": vid})
        return f"deleted volume {vid} on {flags['node']}"


@register
class VolumeMount(Command):
    name = "volume.mount"
    help = "volume.mount -volumeId <id> -node <host:port>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        env.vs_call(flags["node"], "/admin/mount",
                    {"volume": int(flags["volumeId"])})
        return "mounted"


@register
class VolumeConfigureReplication(Command):
    """Change a volume's intended replica placement on every holder
    (command_volume_configure_replication.go); follow with
    volume.fix.replication to create/trim actual copies."""
    name = "volume.configure.replication"
    help = ("volume.configure.replication -volumeId <id> "
            "-replication <xyz>")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        vid = int(flags["volumeId"])
        replication = flags.get("replication", "")
        if not replication:
            # parse("") would quietly mean 000 and trim real replicas
            raise ShellError("empty -replication value")
        rp = ReplicaPlacement.parse(replication)  # validates format
        changed = []
        topo = env.topology()["topology"]
        for dc in topo["data_centers"]:
            for rack in dc["racks"]:
                for n in rack["nodes"]:
                    for v in n["volumes"]:
                        if v["id"] == vid and \
                                v["replica_placement"] != rp.to_byte():
                            env.vs_call(n["url"],
                                        "/admin/configure_replication",
                                        {"volume": vid,
                                         "replication": replication})
                            changed.append(n["url"])
        if not changed:
            raise ShellError(f"no volume {vid} replica needs change")
        return (f"configured {replication} on {len(changed)} "
                f"holder(s): {', '.join(changed)} — run "
                f"volume.fix.replication to realize it")


@register
class VolumeUnmount(Command):
    name = "volume.unmount"
    help = "volume.unmount -volumeId <id> -node <host:port>"

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        env.vs_call(flags["node"], "/admin/unmount",
                    {"volume": int(flags["volumeId"])})
        return "unmounted"


@register
class VolumeFsck(Command):
    """The port's volume.fsck differs from the reference's in two ways.
    A chunk on an erasure-coded volume is probed on its shard holders
    (any live one reconstructs the needle), where the reference finds
    no `locations` for the volume and reports every such chunk missing.
    `-orphans` adds the other direction of command_volume_fsck.go
    (findExtraChunksInVolumeServers): live needles of every volume, by
    its .idx or its .ecx, that no filer chunk names.  The reference
    reads each file's metadata and probes each chunk one after another;
    the port does both on FSCK_WORKERS threads, with the same report."""

    name = "volume.fsck"
    FSCK_WORKERS = 8
    help = ("volume.fsck [-v] [-crc] [-json] [-orphans] — verify every "
            "filer chunk resolves to a live needle (command_volume_fsck.go's "
            "findMissingChunksInVolumeServers direction; chunks on EC "
            "volumes are probed on their shard holders); -crc HEADs "
            "EVERY replica and compares the stored needle CRC "
            "(X-Needle-Checksum) so divergent copies are caught "
            "without transferring bodies; -json emits a machine-"
            "readable report (per-volume per-needle checksum sets + "
            "verdict) whose `volumes` map is node-address-free, so two "
            "mirrored clusters converged exactly when their reports' "
            "`volumes` maps are equal; -orphans also counts live needles "
            "that no filer chunk names")

    @staticmethod
    def _head_checksum(url: str, fid: str) -> str:
        import urllib.request
        req = urllib.request.Request(f"http://{url}/{fid}",
                                     method="HEAD")
        resp = urllib.request.urlopen(req, timeout=10)
        resp.read()
        return resp.headers.get("X-Needle-Checksum", "")

    @classmethod
    def _head_any(cls, urls: list[str], fid: str) -> str:
        """HEAD on the first of `urls` that answers (EC shard holders:
        a dead one stays listed until the master sweeps it)."""
        err: Exception = LookupError("no locations")
        for url in urls:
            try:
                return cls._head_checksum(url, fid)
            except Exception as e:  # noqa: BLE001 — try the next holder
                err = e
        raise err

    @staticmethod
    def _ec_holders(env: CommandEnv, vid: int) -> list[str]:
        return sorted({u for urls in env.ec_shard_locations(vid).values()
                       for u in urls})

    @staticmethod
    def _live_keys(env: CommandEnv) -> dict[int, set[int]]:
        """vid -> live needle ids of every volume in the cluster: a
        normal volume's from one holder's .idx (the last entry of a key
        wins), an EC volume's from a live holder's .ecx (deletes
        tombstone it in place)."""
        import io

        from ..core import idx as _idx
        from ..core import types as t

        def keys(data: bytes, last_wins: bool) -> set[int]:
            live: dict[int, bool] = {}
            for e in _idx.iter_index(io.BytesIO(data)):
                ok = e.offset != 0 and t.size_is_valid(e.size)
                if last_wins or ok:
                    live[e.key] = ok
            return {k for k, ok in live.items() if ok}

        normal: dict[int, str] = {}
        ec: dict[int, list[str]] = {}
        for n in env.data_nodes():
            for v in n["volumes"]:
                normal.setdefault(v["id"], n["url"])
            for e in n["ec_shards"]:
                ec.setdefault(e["id"], []).append(n["url"])
        out: dict[int, set[int]] = {}
        for vid, url in normal.items():
            data = rpc.call(f"http://{url}/admin/volume_file?"
                            f"volume={vid}&ext=.idx", timeout=60)
            out[vid] = keys(bytes(data), True)
        for vid, urls in ec.items():
            if vid in out:
                continue
            err: Exception | None = None
            for url in sorted(urls):
                try:
                    data = rpc.call(f"http://{url}/admin/ec/shard_file?"
                                    f"volume={vid}&ext=.ecx", timeout=60)
                    out[vid] = keys(bytes(data), False)
                    break
                except Exception as e:  # noqa: BLE001 — next holder
                    err = e
            else:
                raise ShellError(f"volume {vid}: no holder serves .ecx: "
                                 f"{err}")
        return out

    def do(self, args: list[str], env: CommandEnv) -> str:
        from concurrent.futures import ThreadPoolExecutor

        from ..core import types as t
        flags, _ = self.parse_flags(args)
        crc_mode = "crc" in flags
        json_mode = "json" in flags
        orphans_mode = "orphans" in flags
        proxy = env.filer()
        files: list[str] = []
        stack = ["/"]
        while stack:
            d = stack.pop()
            for e in proxy.list_all(d):
                if e["is_directory"]:
                    stack.append(e["FullPath"])
                else:
                    files.append(e["FullPath"])
        # The metadata reads and the needle probes run on FSCK_WORKERS
        # threads; the report keeps the walk's order.  Each volume is
        # looked up once per run.
        holders: dict[int, tuple[list[str], list[str]]] = {}

        def locations(vid: int) -> tuple[list[str], list[str]]:
            if vid not in holders:
                locs = env.volume_locations(vid)
                holders[vid] = (locs, locs or self._ec_holders(env, vid))
            return holders[vid]

        def probe(item: tuple[str, str]):
            """(vid, key, {url: crc}) or the error's text."""
            _path, fid = item
            try:
                vid, key, _cookie = t.parse_file_id(fid)
                locs, found = locations(vid)
                if not found:
                    raise LookupError("no locations")
                if not crc_mode and not json_mode:
                    self._head_any(found, fid)
                    return vid, key, None
                if crc_mode and locs:
                    return vid, key, {url: self._head_checksum(url, fid)
                                      for url in locs}
                return vid, key, {"": self._head_any(found, fid)}
            except Exception as err:  # noqa: BLE001
                return str(err)

        with ThreadPoolExecutor(self.FSCK_WORKERS) as pool:
            metas = list(pool.map(proxy.meta, files))
            items = [(path, chunk["file_id"])
                     for path, meta in zip(files, metas)
                     for chunk in (meta or {}).get("chunks", [])]
            results = list(pool.map(probe, items))
        checked, missing, diverged = len(items), [], []
        # vid -> fid -> sorted distinct replica checksums.  Keyed by
        # needle, not node, so two clusters' reports compare directly.
        vols: dict[str, dict[str, list[str]]] = {}
        named: dict[int, set[int]] = {}  # vid -> needle ids chunks name
        for (path, fid), got in zip(items, results):
            if isinstance(got, str):
                missing.append((path, fid, got))
                try:
                    vid, key, _cookie = t.parse_file_id(fid)
                    named.setdefault(vid, set()).add(key)
                except ValueError:
                    pass
                continue
            vid, key, crcs = got
            named.setdefault(vid, set()).add(key)
            if crcs is None:
                continue
            vols.setdefault(str(vid), {})[fid] = sorted(set(crcs.values()))
            if len(set(crcs.values())) > 1:
                diverged.append(
                    (path, fid, ", ".join(f"{u}={c or '?'}"
                                          for u, c in sorted(crcs.items()))))
        orphans: list[tuple[int, int]] = []
        if orphans_mode:
            for vid, keys in sorted(self._live_keys(env).items()):
                orphans += [(vid, k) for k in
                            sorted(keys - named.get(vid, set()))]
        if json_mode:
            import json as _json
            verdict = "missing" if missing else \
                "divergent" if diverged else "ok"
            doc = {"verdict": verdict, "checked": checked,
                   "missing": [{"path": p, "fid": f, "error": err}
                               for p, f, err in missing],
                   "diverged": [{"path": p, "fid": f, "detail": d}
                                for p, f, d in diverged],
                   "volumes": {vid: dict(sorted(fids.items()))
                               for vid, fids in sorted(vols.items())}}
            if orphans_mode:
                doc["orphans"] = [{"volume": v, "needle": f"{k:x}"}
                                  for v, k in orphans]
            return _json.dumps(doc, indent=1, sort_keys=True)
        lines = [f"checked {checked} chunks, {len(missing)} missing"
                 + (f", {len(diverged)} replica CRC mismatches"
                    if crc_mode else "")
                 + (f", {len(orphans)} orphans" if orphans_mode else "")]
        if "v" in flags or missing:
            lines += [f"  MISSING {path} chunk {fid}: {err}"
                      for path, fid, err in missing[:50]]
        lines += [f"  CRC MISMATCH {path} chunk {fid}: {detail}"
                  for path, fid, detail in diverged[:50]]
        if "v" in flags:
            lines += [f"  ORPHAN volume {v} needle {k:x}"
                      for v, k in orphans[:50]]
        return "\n".join(lines)


@register
class VolumeScrub(Command):
    name = "volume.scrub"
    help = ("volume.scrub [-volumeId <id>] [-node <host:port>] "
            "[-repair] — CRC-verify every live needle and EC shard "
            "block on the targeted server(s) now; -repair heals "
            "corruption from replicas / EC decode "
            "(volume_checking.go's direction, on demand)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _ = self.parse_flags(args)
        repair = "repair" in flags
        if repair:
            env.confirm_is_locked()
        vid = int(flags["volumeId"]) if "volumeId" in flags else \
            int(flags["vid"]) if "vid" in flags else None
        nodes = [flags["node"]] if "node" in flags else \
            [n["url"] for n in env.data_nodes()]
        payload: dict = {"repair": repair}
        if vid is not None:
            payload["volume"] = vid
        lines = []
        for node in nodes:
            out = env.vs_call(node, "/admin/scrub", payload)
            for r in out.get("volumes", []):
                lines.append(
                    f"{node} {r['kind']} volume {r['id']}: "
                    f"checked {r['checked']}, corrupt {r['corrupt']}, "
                    f"repaired {r['repaired']}"
                    + (f", quarantined {r['quarantined']}"
                       if r.get("quarantined") else "")
                    + (f", unrepaired {r['unrepaired']}"
                       if r.get("unrepaired") else ""))
        return "\n".join(lines) or "nothing to scrub"


@register
class VolumeCheckDisk(Command):
    name = "volume.check.disk"
    help = ("volume.check.disk [-volumeId <id>] [-n] — compare the "
            "needle sets of every replicated volume's holders (via "
            "their .idx files) and heal divergence: a needle missing "
            "or quarantined on one holder is re-fetched from a "
            "healthy sibling (command_volume_check_disk.go)")

    @staticmethod
    def _idx_state(node: str, vid: int
                   ) -> tuple[set[int], set[int], set[int]]:
        """(live_keys, seen_keys, quarantined_keys) from one holder.
        `seen` includes tombstoned keys: a key a holder has *deleted*
        must not be mistaken for one it never received — resurrecting
        a tombstoned needle would undo an acknowledged delete.
        `quarantined` (open repair tickets, /admin/scrub/status) tells
        a scrub-quarantine tombstone apart from a user delete: that
        holder needs a REPAIR, and its tombstone must never be
        propagated as a delete — it would erase the healthy copies."""
        import io

        from ..core import idx as idx_mod
        from ..core import types as t
        raw = rpc.call(f"http://{node}/admin/volume_file?"
                       f"volume={vid}&ext=.idx")
        last: dict[int, tuple[int, int]] = {}
        for e in idx_mod.iter_index(io.BytesIO(bytes(raw))):
            last[e.key] = (e.offset, e.size)
        live = {k for k, (off, size) in last.items()
                if off > 0 and t.size_is_valid(size)}
        quarantined: set[int] = set()
        try:
            st = rpc.call(f"http://{node}/admin/scrub/status")
            row = next((r for r in st.get("volumes", [])
                        if r["id"] == vid), None)
            if row:
                quarantined = {int(k, 16) for k in row["tickets"]}
        except Exception:  # noqa: BLE001 — older server: no tickets
            pass
        return live, set(last), quarantined

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        dry = "n" in flags
        only = int(flags["volumeId"]) if "volumeId" in flags else None
        out = []
        for vid, holders in sorted(_volumes_by_id(env).items()):
            if only is not None and vid != only:
                continue
            if len(holders) < 2:
                continue
            states = {}
            for n, _v in holders:
                try:
                    states[n["url"]] = self._idx_state(n["url"], vid)
                except Exception as e:  # noqa: BLE001 — holder down
                    out.append(f"volume {vid}: cannot read idx on "
                               f"{n['url']}: {e}")
            if len(states) < 2:
                continue
            union_live: set[int] = set().union(
                *(live | quar for live, _seen, quar
                  in states.values()))
            for key in sorted(union_live):
                # A USER tombstone anywhere wins: the delete was
                # acknowledged to a client, so holders still serving
                # the needle get the delete, never the reverse
                # (command_volume_check_disk.go resolves direction by
                # timestamp; deletes are strictly newer here).  A
                # QUARANTINE tombstone is the opposite case — that
                # holder lost its copy to rot and needs a repair.
                deleters = [u for u, (live, seen, quar)
                            in states.items()
                            if key in seen and key not in live
                            and key not in quar]
                for url, (live, seen, quar) in sorted(states.items()):
                    if key in quar and not deleters:
                        if dry:
                            out.append(f"volume {vid}: {url} "
                                       f"quarantined needle {key:x} "
                                       f"(would repair)")
                            continue
                        try:
                            env.vs_call(url, "/admin/scrub/repair",
                                        {"volume": vid, "key": key})
                            out.append(f"volume {vid}: repaired "
                                       f"quarantined needle {key:x} "
                                       f"on {url}")
                        except Exception as e:  # noqa: BLE001
                            out.append(f"volume {vid}: FAILED to "
                                       f"repair quarantined needle "
                                       f"{key:x} on {url}: {e}")
                    elif deleters and key in live:
                        fid = f"{vid},{key:x}{0:08x}"
                        if dry:
                            out.append(f"volume {vid}: {url} still "
                                       f"serves deleted needle "
                                       f"{key:x} (would delete)")
                            continue
                        try:
                            rpc.call(f"http://{url}/{fid}"
                                     "?type=replicate", "DELETE")
                            out.append(f"volume {vid}: propagated "
                                       f"delete of {key:x} to {url}")
                        except Exception as e:  # noqa: BLE001
                            out.append(f"volume {vid}: FAILED to "
                                       f"delete {key:x} on {url}: {e}")
                    elif not deleters and key not in seen:
                        if dry:
                            out.append(f"volume {vid}: {url} missing "
                                       f"needle {key:x} (would repair)")
                            continue
                        try:
                            env.vs_call(url, "/admin/scrub/repair",
                                        {"volume": vid, "key": key})
                            out.append(f"volume {vid}: repaired "
                                       f"needle {key:x} on {url}")
                        except Exception as e:  # noqa: BLE001
                            out.append(f"volume {vid}: FAILED to "
                                       f"repair needle {key:x} on "
                                       f"{url}: {e}")
        return "\n".join(out) or "all replicas agree"


@register
class VolumeServerLeave(Command):
    name = "volumeServer.leave"
    help = ("volumeServer.leave -node <host:port> — stop the server's "
            "heartbeats so the master drains it "
            "(command_volume_server_leave.go)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        env.vs_call(flags["node"], "/admin/leave", {})
        return f"{flags['node']} is leaving the cluster"


@register
class VolumeTierUpload(Command):
    name = "volume.tier.upload"
    help = ("volume.tier.upload -volumeId <id> -node <host:port> "
            "-dest <s3://host/bucket | local:///dir> [-keepLocal] "
            "(shell/command_volume_tier_upload.go: marks the volume "
            "readonly, then moves its .dat to the backend)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        vid = int(flags["volumeId"])
        node = flags["node"]
        env.vs_call(node, "/admin/readonly",
                    {"volume": vid, "readonly": True})
        out = env.vs_call(node, "/admin/tier_upload", {
            "volume": vid, "dest": flags["dest"],
            "keep_local": "keepLocal" in flags,
            "access_key": flags.get("accessKey", ""),
            "secret_key": flags.get("secretKey", "")})
        r = out["remote"]
        return (f"volume {vid} tiered to {r['backend_spec']} "
                f"({r['file_size']} bytes)")


@register
class VolumeTierDownload(Command):
    name = "volume.tier.download"
    help = ("volume.tier.download -volumeId <id> -node <host:port> "
            "[-keepRemote] (command_volume_tier_download.go)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        vid = int(flags["volumeId"])
        env.vs_call(flags["node"], "/admin/tier_download", {
            "volume": vid, "keep_remote": "keepRemote" in flags,
            "access_key": flags.get("accessKey", ""),
            "secret_key": flags.get("secretKey", "")})
        return f"volume {vid} downloaded back to local storage"


@register
class VolumeBalance(Command):
    name = "volume.balance"
    help = ("volume.balance [-collection <name>] — move volumes so every "
            "node is at a similar fill ratio")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        collection = flags.get("collection")
        out = []
        for _ in range(64):
            nodes = env.data_nodes()
            if len(nodes) < 2:
                break
            ratios = {n["url"]: len(n["volumes"]) / max(
                n["max_volume_count"], 1) for n in nodes}
            hi = max(ratios, key=ratios.get)  # type: ignore[arg-type]
            lo = min(ratios, key=ratios.get)  # type: ignore[arg-type]
            hi_n = next(n for n in nodes if n["url"] == hi)
            lo_n = next(n for n in nodes if n["url"] == lo)
            if (len(hi_n["volumes"]) - len(lo_n["volumes"])) <= 1:
                break
            lo_vids = {v["id"] for v in lo_n["volumes"]}
            candidates = [v for v in hi_n["volumes"]
                          if v["id"] not in lo_vids
                          and (collection is None
                               or v.get("collection", "") == collection)]
            if not candidates:
                break
            v = min(candidates, key=lambda v: v["size"])
            copy_volume(env, v["id"], hi, lo)
            env.vs_call(hi, "/admin/delete_volume", {"volume": v["id"]})
            out.append(f"moved volume {v['id']}: {hi} -> {lo}")
        return "\n".join(out) or "already balanced"


@register
class VolumeFixReplication(Command):
    name = "volume.fix.replication"
    help = ("volume.fix.replication [-n] — one manual pass of the "
            "durability autopilot's re-replication planner "
            "(cluster/repair_daemon.py): -n renders the risk-ranked "
            "plan the daemon would execute (see it before arming "
            "-repair); without -n the master runs the plan "
            "synchronously — same risk ordering, placement-aware "
            "target choice, verified crash-safe copies, and surplus "
            "dedupe as the armed daemon")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _ = self.parse_flags(args)
        dry = "n" in flags
        if dry:
            doc = rpc.call(f"{env.master_url}/cluster/repair",
                           timeout=30.0)
            rows = [r for r in doc.get("plan", [])
                    if r["kind"] == "replicate"]
            out = []
            for r in rows:
                note = " (drain-fenced: would NOT auto-repair)" \
                    if r.get("suppressed") else ""
                out.append(
                    f"volume {r['volume']}: would re-replicate "
                    f"{r['have']}/{r['want']} "
                    f"(risk={r['risk']}, rp={r['replication']})"
                    f"{note}")
            return "\n".join(out) or \
                "all volumes sufficiently replicated"
        env.confirm_is_locked()
        doc = rpc.call_json(f"{env.master_url}/cluster/repair/run",
                            payload={"kinds": ["replicate"]},
                            timeout=600.0)
        out = []
        for r in doc.get("results", []):
            if r.get("outcome") == "ok":
                out.append(f"volume {r['volume']}: copied — restored "
                           f"{r['want']}/{r['want']}")
            else:
                out.append(f"volume {r['volume']}: "
                           f"{r.get('outcome', '?')}"
                           + (f" ({r['error']})"
                              if r.get("error") else ""))
        for r in doc.get("trimmed", []):
            out.append(f"volume {r['volume']}: trimmed surplus copy "
                       f"on {r['node']}")
        return "\n".join(out) or "all volumes sufficiently replicated"


@register
class VolumeVacuum(Command):
    name = "volume.vacuum"
    help = "volume.vacuum [-garbageThreshold 0.3] — trigger a vacuum scan"

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _ = self.parse_flags(args)
        q = ""
        if "garbageThreshold" in flags:
            q = f"?garbageThreshold={flags['garbageThreshold']}"
        resp = rpc.call_json(f"{env.master_url}/vol/vacuum{q}")
        return f"vacuumed volumes: {resp.get('vacuumed', [])}"


@register
class VolumeServerEvacuate(Command):
    name = "volumeServer.evacuate"
    help = ("volumeServer.evacuate -node <host:port> — move every volume "
            "and EC shard off one server")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        node = flags["node"]
        me = next((n for n in env.data_nodes() if n["url"] == node), None)
        if me is None:
            raise ShellError(f"node {node} not found")
        out = []
        failed = []
        i = 0
        for v in me["volumes"]:
            # Re-fetch per move: capacities change as copies land.
            others = [n for n in env.data_nodes() if n["url"] != node]
            if not others:
                raise ShellError("no other nodes to evacuate to")
            placed = False
            for _ in range(len(others)):
                target = others[i % len(others)]
                i += 1
                if len(target["volumes"]) < target["max_volume_count"] and \
                        v["id"] not in {x["id"] for x in target["volumes"]}:
                    copy_volume(env, v["id"], node, target["url"])
                    env.vs_call(node, "/admin/delete_volume",
                                {"volume": v["id"]})
                    out.append(f"volume {v['id']} -> {target['url']}")
                    placed = True
                    break
            if not placed:
                failed.append(f"volume {v['id']}")
        from .command_ec import move_shard
        from ..ec.shard_bits import ShardBits
        for e in me["ec_shards"]:
            others = [n for n in env.data_nodes() if n["url"] != node]
            for sid in ShardBits(e["shard_bits"]).shard_ids():
                target = others[i % len(others)]
                i += 1
                move_shard(env, e["id"], sid, node, target["url"])
                out.append(f"ec {e['id']}.{sid} -> {target['url']}")
        if failed:
            # The node is NOT safe to decommission — refuse to report
            # success with replicas still aboard.
            raise ShellError(
                "evacuation incomplete, no capacity for: "
                + ", ".join(failed)
                + ("\n" + "\n".join(out) if out else ""))
        return "\n".join(out) or "nothing to evacuate"
