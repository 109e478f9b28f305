"""EC lifecycle commands: ec.encode / ec.rebuild / ec.balance / ec.decode.

Reference: weed/shell/command_ec_encode.go (freeze -> generate -> spread ->
delete original, :55-264), command_ec_rebuild.go (:57-240),
command_ec_balance.go (dedupe + spread), command_ec_decode.go, and the
shared helpers in command_ec_common.go (collectEcNodes, moveMountedShard).
"""

from __future__ import annotations

from ..cluster import rpc
from ..ec import TOTAL_SHARDS
from ..ec.shard_bits import ShardBits
from .commands import Command, register
from .env import CommandEnv, ShellError

ECX_EXTS = (".ecx", ".ecj", ".vif")


# -- shared helpers (command_ec_common.go) ----------------------------------

def collect_ec_nodes(env: CommandEnv, dc: str = "") -> list[dict]:
    """Data nodes with free EC-slot estimates, most-free first
    (collectEcNodes / sortEcNodesByFreeslotsDecending)."""
    nodes = []
    for n in env.data_nodes():
        if dc and n["dc"] != dc:
            continue
        shard_count = sum(
            ShardBits(e["shard_bits"]).shard_id_count()
            for e in n["ec_shards"])
        # One volume slot holds ~10 shards (erasure_coding.DataShardsCount).
        free = n["max_volume_count"] * 10 - len(n["volumes"]) * 10 \
            - shard_count
        n = dict(n)
        n["ec_shard_count"] = shard_count
        n["free_ec_slots"] = max(free, 0)
        nodes.append(n)
    nodes.sort(key=lambda n: -n["free_ec_slots"])
    return nodes


def node_shard_map(env: CommandEnv, vid: int) -> dict[str, list[int]]:
    """url -> sorted shard ids currently held for vid."""
    out: dict[str, list[int]] = {}
    for sid, urls in env.ec_shard_locations(vid).items():
        for url in urls:
            out.setdefault(url, []).append(sid)
    return {u: sorted(s) for u, s in out.items()}


def copy_shards(env: CommandEnv, vid: int, target: str, source: str,
                shards: list[int], copy_ecx: bool = False) -> None:
    env.vs_call(target, "/admin/ec/copy_shard",
                {"volume": vid, "source": source, "shards": shards,
                 "copy_ecx": copy_ecx})


def mount_shards(env: CommandEnv, vid: int, url: str) -> None:
    env.vs_call(url, "/admin/ec/mount", {"volume": vid})


def delete_shards(env: CommandEnv, vid: int, url: str,
                  shards: list[int]) -> None:
    env.vs_call(url, "/admin/ec/delete_shards",
                {"volume": vid, "shards": shards})


def move_shard(env: CommandEnv, vid: int, sid: int, source: str,
               target: str) -> None:
    """Copy -> mount on target -> delete from source (moveMountedShard)."""
    copy_shards(env, vid, target, source, [sid], copy_ecx=True)
    mount_shards(env, vid, target)
    delete_shards(env, vid, source, [sid])


def balanced_distribution(nodes: list[dict],
                          n_shards: int = TOTAL_SHARDS
                          ) -> dict[str, list[int]]:
    """Round-robin shard ids over nodes that still have free slots
    (balancedEcDistribution, command_ec_encode.go:248-264) — spreading
    wide maximises surviving shards when a node dies."""
    if not nodes:
        raise ShellError("no data nodes available for EC spread")
    picked: dict[str, list[int]] = {n["url"]: [] for n in nodes}
    free = {n["url"]: n["free_ec_slots"] for n in nodes}
    order = [n["url"] for n in nodes]
    sid, i, stuck = 0, 0, 0
    while sid < n_shards:
        url = order[i % len(order)]
        i += 1
        if free[url] > 0:
            picked[url].append(sid)
            free[url] -= 1
            sid += 1
            stuck = 0
        else:
            stuck += 1
            if stuck >= len(order):  # no free slots anywhere: overflow
                free[max(free, key=free.get)] += 1  # type: ignore[arg-type]
    return {u: s for u, s in picked.items() if s}


# -- ec.encode ---------------------------------------------------------------

@register
class EcEncode(Command):
    name = "ec.encode"
    help = ("ec.encode -volumeId <id>[,<id>...] | -collection <name> "
            "[-fullPercent 95] [-codec rs|lrc] [-batch] "
            "[-maxBatchMB 256] — erasure-code volumes and spread the "
            "shards across the cluster.  Default: per-volume generate "
            "on the holder (VolumeEcShardsGenerate).  -codec lrc: "
            "LRC(10,2,2) — single-shard repair reads 5 shards instead "
            "of 10.  -batch: pull quiet volumes, encode MANY at once "
            "in mesh-batched compiled steps (volumes data-parallel "
            "over chips), scatter shards + .ecx back (SURVEY §2.3 "
            "'shard scatter after encode')")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        from ..codecs import get_codec
        codec = get_codec(flags.get("codec") or None).name
        vids = self._collect_vids(flags, env)
        if not vids:
            return "no volumes to encode"
        if flags.get("batch") == "true":
            return self.encode_batch(env, vids, flags, codec)
        out = []
        for vid in vids:
            out.append(self.encode_one(env, vid, codec))
        return "\n".join(out)

    def encode_batch(self, env: CommandEnv, vids: list[int],
                     flags: dict, codec: str = "rs") -> str:
        from ..parallel import cluster_encode
        mesh = env.mesh()
        max_mb = int(flags.get("maxBatchMB", 256))
        messages = cluster_encode.batch_encode(
            env, vids, mesh=mesh, max_batch_bytes=max_mb << 20,
            codec=codec)
        return "\n".join(messages) or "no volumes to encode"

    def _collect_vids(self, flags: dict, env: CommandEnv) -> list[int]:
        if "volumeId" in flags:
            return [int(v) for v in flags["volumeId"].split(",")]
        collection = flags.get("collection", "")
        full_pct = float(flags.get("fullPercent", 95))
        topo = env.topology()
        limit = topo["volume_size_limit"]
        vids = set()
        for dc in topo["topology"]["data_centers"]:
            for rack in dc["racks"]:
                for n in rack["nodes"]:
                    for v in n["volumes"]:
                        if v.get("collection", "") != collection:
                            continue
                        if v["size"] >= limit * full_pct / 100.0:
                            vids.add(v["id"])
        return sorted(vids)

    def encode_one(self, env: CommandEnv, vid: int,
                   codec: str = "rs") -> str:
        from ..codecs import get_codec
        total = get_codec(codec).total_shards
        locations = env.volume_locations(vid)
        if not locations:
            raise ShellError(f"volume {vid} not found")
        # 1. freeze: mark every replica readonly (markVolumeReadonly).
        for url in locations:
            env.vs_call(url, "/admin/readonly",
                        {"volume": vid, "readonly": True})
        # 2. generate the codec's shards + .ecx + .vif on one holder.
        source = locations[0]
        env.vs_call(source, "/admin/ec/generate",
                    {"volume": vid, "codec": codec})
        # 3. spread: balanced distribution over free slots.
        plan = balanced_distribution(collect_ec_nodes(env),
                                     n_shards=total)
        # Copy everywhere before trimming anything: the source must keep
        # its full set until every target has pulled its shards.
        for url, shards in plan.items():
            if url != source:
                copy_shards(env, vid, url, source, shards, copy_ecx=True)
        for url, shards in plan.items():
            mount_shards(env, vid, url)
            drop = [s for s in range(total) if s not in shards]
            if url == source:
                delete_shards(env, vid, url, drop)
            # Non-source targets only ever copied their own shards.
        if source not in plan:  # source got no shards: clear its full set
            delete_shards(env, vid, source, list(range(total)))
        # 4. delete the original volume from every replica.
        for url in locations:
            env.vs_call(url, "/admin/delete_volume", {"volume": vid})
        return (f"volume {vid} -> ec shards on "
                f"{len(plan)} servers: "
                + ", ".join(f"{u}:{s}" for u, s in sorted(plan.items())))


# -- ec.rebuild --------------------------------------------------------------

@register
class EcRebuild(Command):
    name = "ec.rebuild"
    help = ("ec.rebuild [-volumeId <id>[,<id>...]] [-batch] "
            "[-maxBatchMB 256] — regenerate missing EC shards.  Default: "
            "one volume at a time on a rebuilder node.  -batch: gather "
            "survivors from their holders, rebuild EVERY volume in "
            "mesh-batched compiled steps (volumes data-parallel over "
            "chips), scatter the shards back — the multi-volume path "
            "(BASELINE configs #3/#5)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        if "volumeId" in flags:
            vids = [int(v) for v in flags["volumeId"].split(",")]
        else:
            vids = self._all_ec_vids(env)
        if flags.get("batch") == "true":
            return self.rebuild_batch(env, vids, flags)
        out = []
        for vid in vids:
            msg = self.rebuild_one(env, vid)
            if msg:
                out.append(msg)
        return "\n".join(out) or "nothing to rebuild"

    def rebuild_batch(self, env: CommandEnv, vids: list[int],
                      flags: dict) -> str:
        from ..parallel import cluster_rebuild
        mesh = env.mesh()
        max_mb = int(flags.get("maxBatchMB", 256))
        messages = cluster_rebuild.batch_rebuild(
            env, vids, mesh=mesh, max_batch_bytes=max_mb << 20)
        return "\n".join(messages) or "nothing to rebuild"

    def _all_ec_vids(self, env: CommandEnv) -> list[int]:
        vids = set()
        for n in env.data_nodes():
            for e in n["ec_shards"]:
                vids.add(e["id"])
        return sorted(vids)

    def rebuild_one(self, env: CommandEnv, vid: int) -> str | None:
        from ..codecs import get_codec
        codec = get_codec(env.ec_codec(vid))
        holders = node_shard_map(env, vid)
        present = sorted({s for shards in holders.values() for s in shards})
        missing = [s for s in range(codec.total_shards)
                   if s not in present]
        if not missing:
            return None
        try:
            codec.repair_plan(tuple(present), missing)
        except ValueError:
            raise ShellError(
                f"volume {vid}: only {len(present)} shards survive; "
                "cannot rebuild") from None
        # Rebuilder: the holder with most shards (prepareDataToRecover
        # copies the rest to it).
        rebuilder = max(holders, key=lambda u: len(holders[u]))
        local = set(holders[rebuilder])
        borrowed: list[int] = []
        for url, shards in holders.items():
            if url == rebuilder:
                continue
            need = [s for s in shards if s not in local and
                    s not in borrowed]
            if need:
                copy_shards(env, vid, rebuilder, url, need, copy_ecx=True)
                borrowed.extend(need)
        resp = env.vs_call(rebuilder, "/admin/ec/rebuild", {"volume": vid})
        rebuilt = resp.get("rebuilt_shards", missing)
        # Keep only (original locals + rebuilt missing); drop borrowed helps.
        drop = [s for s in borrowed if s not in rebuilt]
        if drop:
            delete_shards(env, vid, rebuilder, drop)
        mount_shards(env, vid, rebuilder)
        return f"volume {vid}: rebuilt shards {rebuilt} on {rebuilder}"


# -- ec.balance --------------------------------------------------------------

@register
class EcBalance(Command):
    name = "ec.balance"
    help = ("ec.balance [-collection <name>] — dedupe replicated shards "
            "and spread EC shards evenly across data nodes")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        vids = sorted({e["id"] for n in env.data_nodes()
                       for e in n["ec_shards"]})
        moves = []
        for vid in vids:
            moves += self._dedupe(env, vid)
        moves += self._spread(env, vids)
        return "\n".join(moves) or "already balanced"

    def _dedupe(self, env: CommandEnv, vid: int) -> list[str]:
        """Remove duplicate copies of a shard (deleteDuplicatedEcShards):
        keep the copy on the least-loaded node."""
        out = []
        holders = node_shard_map(env, vid)
        load = {u: len(s) for u, s in holders.items()}
        for sid, urls in sorted(env.ec_shard_locations(vid).items()):
            if len(urls) <= 1:
                continue
            keep = min(urls, key=lambda u: load.get(u, 0))
            for url in urls:
                if url != keep:
                    delete_shards(env, vid, url, [sid])
                    load[url] = load.get(url, 1) - 1
                    out.append(f"volume {vid} shard {sid}: dropped dup "
                               f"on {url}")
        return out

    def _spread(self, env: CommandEnv, vids: list[int]) -> list[str]:
        """Even out total shard counts across nodes (balanceEcShards)."""
        out = []
        for _round in range(TOTAL_SHARDS * max(len(vids), 1)):
            nodes = collect_ec_nodes(env)
            if len(nodes) < 2:
                break
            counts = {n["url"]: n["ec_shard_count"] for n in nodes}
            lo = min(counts, key=counts.get)  # type: ignore[arg-type]
            hi = max(counts, key=counts.get)  # type: ignore[arg-type]
            if counts[hi] - counts[lo] <= 1:
                break
            moved = False
            for vid in vids:
                holders = node_shard_map(env, vid)
                src_shards = holders.get(hi, [])
                dst_shards = set(holders.get(lo, []))
                for sid in src_shards:
                    if sid not in dst_shards:
                        move_shard(env, vid, sid, hi, lo)
                        out.append(f"volume {vid} shard {sid}: "
                                   f"{hi} -> {lo}")
                        moved = True
                        break
                if moved:
                    break
            if not moved:
                break
        return out


# -- ec.decode ---------------------------------------------------------------

@register
class EcDecode(Command):
    name = "ec.decode"
    help = ("ec.decode -volumeId <id> | -collection <name> — convert EC "
            "shards back into a normal volume")

    def do(self, args: list[str], env: CommandEnv) -> str:
        env.confirm_is_locked()
        flags, _ = self.parse_flags(args)
        if "volumeId" in flags:
            vids = [int(flags["volumeId"])]
        else:
            vids = sorted({e["id"] for n in env.data_nodes()
                           for e in n["ec_shards"]})
        out = []
        for vid in vids:
            out.append(self.decode_one(env, vid))
        return "\n".join(out) or "no ec volumes"

    def decode_one(self, env: CommandEnv, vid: int) -> str:
        holders = node_shard_map(env, vid)
        if not holders:
            raise ShellError(f"no EC shards for volume {vid}")
        present = {s for shards in holders.values() for s in shards}
        data_missing_everywhere = [s for s in range(10) if s not in present]
        if data_missing_everywhere and len(present) < 10:
            raise ShellError(
                f"volume {vid}: cannot decode, shards lost beyond repair")
        # Collector: node with most data shards.
        collector = max(holders,
                        key=lambda u: len([s for s in holders[u]
                                           if s < 10]))
        local = set(holders[collector])
        # Pull missing data shards (and parity if reconstruction needed).
        want = set(range(10))
        if data_missing_everywhere:
            want |= present  # need >=10 of anything to rebuild data shards
        for url, shards in holders.items():
            if url == collector:
                continue
            need = [s for s in shards if s in want and s not in local]
            if need:
                copy_shards(env, vid, collector, url, need, copy_ecx=True)
                local |= set(need)
        if data_missing_everywhere:
            env.vs_call(collector, "/admin/ec/rebuild", {"volume": vid})
        env.vs_call(collector, "/admin/ec/to_volume", {"volume": vid})
        # Drop all EC shards cluster-wide; the volume lives on collector.
        for url in holders:
            try:
                env.vs_call(url, "/admin/ec/unmount", {"volume": vid})
            except rpc.RpcError:
                pass
            all_sids = list(range(TOTAL_SHARDS))
            try:
                delete_shards(env, vid, url, all_sids)
            except rpc.RpcError:
                pass
        return f"volume {vid}: decoded back to normal volume on {collector}"
