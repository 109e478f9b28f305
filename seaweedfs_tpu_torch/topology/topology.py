"""Topology root: the master's view of the cluster.

Port of weed/topology/topology.go + topology_ec.go: collections of
VolumeLayouts keyed by (replica placement, ttl), heartbeat-driven
registration with full and incremental sync, EC shard map, dead-node
sweeps, and volume id / file key issuance.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from ..core.replica_placement import ReplicaPlacement
from ..core.ttl import TTL
from ..ec.shard_bits import ShardBits
from .node import DataCenter, DataNode, Node, Rack
from .sequence import MemorySequencer
from .volume_layout import VolumeLayout


@dataclass
class VolumeGrowOption:
    collection: str = ""
    replica_placement: str = "000"
    ttl: str = ""
    data_center: str = ""
    rack: str = ""
    data_node: str = ""


@dataclass
class EcShardLocations:
    collection: str = ""
    locations: dict[int, list[DataNode]] = field(default_factory=dict)
    # Erasure codec the volume's shards were generated with ("rs",
    # "lrc", ...) — learned from shard-holder heartbeats so rebuild
    # planning and health math use the right shard counts per volume
    # in a mixed-codec cluster.
    codec: str = "rs"

    def add(self, shard_id: int, dn: DataNode) -> None:
        lst = self.locations.setdefault(shard_id, [])
        if dn not in lst:
            lst.append(dn)

    def remove(self, shard_id: int, dn: DataNode) -> None:
        lst = self.locations.get(shard_id, [])
        if dn in lst:
            lst.remove(dn)


class Collection:
    def __init__(self, name: str, volume_size_limit: int):
        self.name = name
        self.volume_size_limit = volume_size_limit
        self.layouts: dict[str, VolumeLayout] = {}
        self._lock = threading.RLock()

    def get_or_create_layout(self, rp: ReplicaPlacement,
                             ttl: TTL) -> VolumeLayout:
        key = f"{rp}{ttl}"
        with self._lock:
            vl = self.layouts.get(key)
            if vl is None:
                vl = VolumeLayout(rp, ttl, self.volume_size_limit)
                self.layouts[key] = vl
            return vl

    def lookup(self, vid: int):
        for vl in list(self.layouts.values()):
            locs = vl.lookup(vid)
            if locs:
                return locs
        return []


class Topology(Node):
    node_type = "Topology"

    def __init__(self, id_: str = "topo",
                 volume_size_limit: int = 30 * 1024 * 1024 * 1024,
                 sequencer: MemorySequencer | None = None,
                 pulse_seconds: int = 5,
                 vid_stride: int = 1, vid_offset: int = 0):
        super().__init__(id_)
        self.volume_size_limit = volume_size_limit
        self.collections: dict[str, Collection] = {}
        self.ec_shard_map: dict[int, EcShardLocations] = {}
        self.sequencer = sequencer or MemorySequencer()
        self.pulse_seconds = pulse_seconds
        self._max_volume_id = 0
        # Geo id-space partitioning: with stride > 1 this master only
        # mints volume ids ≡ offset (mod stride), so two active/active
        # regions can never allocate the same id for different volumes
        # (a collision would make their lease planes fence each other).
        self.vid_stride = max(1, int(vid_stride))
        self.vid_offset = int(vid_offset) % self.vid_stride
        self._lock = threading.RLock()

    # -- tree helpers --------------------------------------------------------

    def get_or_create_data_center(self, id_: str) -> DataCenter:
        return self.get_or_create(id_, DataCenter)  # type: ignore

    # -- id issuance ---------------------------------------------------------

    # Set by a clustered master: volume-id issuance goes through raft
    # (topology/cluster_commands.go MaxVolumeIdCommand) so every master
    # agrees on the high-water mark.
    next_volume_id_hook = None

    def stride_align(self, vid: int) -> int:
        """Smallest id >= vid in this master's residue class (identity
        when unstrided).  Learned ids from heartbeats or mirrored
        volumes raise the high-water mark across BOTH classes, so the
        classes stay disjoint even as each region hosts the other's
        volumes."""
        if self.vid_stride <= 1:
            return vid
        return vid + (self.vid_offset - vid) % self.vid_stride

    def next_volume_id(self) -> int:
        if self.next_volume_id_hook is not None:
            return self.next_volume_id_hook()
        with self._lock:
            self._max_volume_id = self.stride_align(
                max(self._max_volume_id, self.max_volume_id) + 1)
            self.up_adjust_max_volume_id(self._max_volume_id)
            return self._max_volume_id

    def set_max_volume_id(self, vid: int) -> None:
        """Raft state-machine apply: raise the cluster-wide max."""
        with self._lock:
            self._max_volume_id = max(self._max_volume_id, vid)
            self.up_adjust_max_volume_id(self._max_volume_id)

    def next_file_key(self, count: int = 1) -> int:
        return self.sequencer.next_file_id(count)

    # -- collections / layouts ----------------------------------------------

    def get_or_create_layout(self, collection: str, rp: ReplicaPlacement,
                             ttl: TTL) -> VolumeLayout:
        with self._lock:
            col = self.collections.get(collection)
            if col is None:
                col = Collection(collection, self.volume_size_limit)
                self.collections[collection] = col
            return col.get_or_create_layout(rp, ttl)

    def delete_collection(self, name: str) -> None:
        with self._lock:
            self.collections.pop(name, None)

    def lookup(self, collection: str, vid: int) -> list[DataNode]:
        if collection:
            col = self.collections.get(collection)
            return col.lookup(vid) if col else []
        for col in list(self.collections.values()):
            locs = col.lookup(vid)
            if locs:
                return locs
        return []

    def lookup_ec_shards(self, vid: int) -> EcShardLocations | None:
        return self.ec_shard_map.get(vid)

    def ec_codec(self, vid: int) -> str:
        locs = self.ec_shard_map.get(vid)
        return locs.codec if locs is not None else "rs"

    # -- heartbeat sync ------------------------------------------------------

    def _layout_for(self, v) -> VolumeLayout:
        rp = ReplicaPlacement.from_byte(v.replica_placement)
        ttl = TTL.from_uint32(v.ttl)
        return self.get_or_create_layout(v.collection, rp, ttl)

    def register_volume(self, v, dn: DataNode) -> None:
        # Tree counters (up_adjust_counts walks shared ancestors) need
        # the topology lock: heartbeats from different volume servers
        # apply concurrently and '+=' would lose updates.
        with self._lock:
            self.sequencer.set_max(v.max_file_key)
            old = dn.volumes.get(v.id)
            if old is not None and (
                    old.replica_placement != v.replica_placement
                    or old.ttl != v.ttl
                    or old.collection != v.collection):
                # volume.configure.replication (or a ttl/collection
                # change) moved the volume to a different layout key:
                # the stale registration must go, or lookups keep
                # resolving through the old layout and never see
                # replicas registered under the new one.
                self._layout_for(old).unregister_volume(old, dn)
            dn.add_or_update_volume(v)
            self._layout_for(v).register_volume(v, dn)

    def unregister_volume(self, v, dn: DataNode) -> None:
        with self._lock:
            self._layout_for(v).unregister_volume(v, dn)
            dn.delete_volume(v.id)

    def sync_data_node_registration(self, volumes: list,
                                    dn: DataNode) -> tuple[list, list]:
        """Full-state heartbeat: returns (new, deleted) volume infos."""
        with self._lock:
            incoming = {v.id: v for v in volumes}
            existing = dict(dn.volumes)
            new, deleted = [], []
            for vid, v in incoming.items():
                self.register_volume(v, dn)
                if vid not in existing:
                    new.append(v)
            for vid, v in existing.items():
                if vid not in incoming:
                    self.unregister_volume(v, dn)
                    deleted.append(v)
            dn.last_seen = time.time()
            return new, deleted

    def incremental_sync(self, new_volumes: list, deleted_volumes: list,
                         dn: DataNode) -> None:
        with self._lock:
            for v in new_volumes:
                self.register_volume(v, dn)
            for v in deleted_volumes:
                self.unregister_volume(v, dn)
            dn.last_seen = time.time()

    # -- EC shards -----------------------------------------------------------

    def sync_data_node_ec_shards(self, shard_infos: list[tuple],
                                 dn: DataNode) -> None:
        """Full EC state: list of (vid, collection, shard_bits[, codec])."""
        incoming: dict[int, int] = {}
        for vid, collection, bits, *rest in shard_infos:
            incoming[vid] = bits
            self.register_ec_shards(vid, collection, bits, dn,
                                    codec=rest[0] if rest else None)
        for vid in list(dn.ec_shards):
            if vid not in incoming:
                self.unregister_ec_shards(vid, dn)

    def register_ec_shards(self, vid: int, collection: str, bits: int,
                           dn: DataNode, codec: str | None = None) -> None:
        with self._lock:
            locs = self.ec_shard_map.setdefault(
                vid, EcShardLocations(collection))
            if codec:
                locs.codec = codec
            old_bits = ShardBits(dn.ec_shards.get(vid, 0))
            new_bits = ShardBits(bits)
            for sid in new_bits.shard_ids():
                locs.add(sid, dn)
            for sid in old_bits.minus(new_bits).shard_ids():
                locs.remove(sid, dn)
            delta = new_bits.shard_id_count() - old_bits.shard_id_count()
            if delta:
                dn.up_adjust_counts(ec_delta=delta)
            dn.ec_shards[vid] = int(new_bits)

    def unregister_ec_shards(self, vid: int, dn: DataNode) -> None:
        with self._lock:
            bits = ShardBits(dn.ec_shards.pop(vid, 0))
            locs = self.ec_shard_map.get(vid)
            if locs is not None:
                for sid in bits.shard_ids():
                    locs.remove(sid, dn)
                if not any(locs.locations.values()):
                    self.ec_shard_map.pop(vid, None)
            if bits.shard_id_count():
                dn.up_adjust_counts(ec_delta=-bits.shard_id_count())

    # -- liveness ------------------------------------------------------------

    def register_data_node(self, dc: str, rack: str, ip: str, port: int,
                           public_url: str = "",
                           max_volume_count: int = 7) -> DataNode:
        with self._lock:
            dc_node = self.get_or_create_data_center(dc)
            rack_node = dc_node.get_or_create_rack(rack)
            dn = rack_node.get_or_create_data_node(
                f"{ip}:{port}", ip, port, public_url, max_volume_count)
        dn.last_seen = time.time()
        return dn

    def unregister_data_node(self, dn: DataNode) -> None:
        for v in list(dn.volumes.values()):
            self._layout_for(v).set_volume_unavailable(v.id, dn)
        for vid in list(dn.ec_shards):
            self.unregister_ec_shards(vid, dn)
        active = sum(1 for v in dn.volumes.values() if not v.read_only)
        dn.up_adjust_counts(volume_delta=-len(dn.volumes),
                            active_delta=-active,
                            max_delta=-dn.max_volume_count)
        rack = dn.get_rack()
        if rack is not None:
            rack.children.pop(dn.id, None)
        dn.parent = None

    def collect_dead_nodes(self, fresh_threshold: float | None = None
                           ) -> list[DataNode]:
        threshold = fresh_threshold if fresh_threshold is not None else \
            time.time() - 2 * self.pulse_seconds
        dead = [dn for dn in self.leaves() if dn.last_seen < threshold]
        return dead

    # -- writability ---------------------------------------------------------

    def layout_for(self, option: VolumeGrowOption) -> "VolumeLayout":
        """Resolve the layout for an assign option once — /dir/assign
        used to resolve it three times (writability check + pick),
        each with two ReplicaPlacement/TTL parses."""
        return self.get_or_create_layout(
            option.collection,
            ReplicaPlacement.parse(option.replica_placement),
            TTL.parse(option.ttl))

    def has_writable_volume(self, option: VolumeGrowOption) -> bool:
        return self.layout_for(option).active_volume_count(option) > 0

    def pick_for_write(self, count: int, option: VolumeGrowOption,
                       layout: "VolumeLayout | None" = None,
                       exclude=None) -> tuple[str, int, list[DataNode]]:
        """Returns (fid, count, locations) — the Assign core.
        `exclude(locations)` vetoes volumes (draining/low-disk
        steering, cluster/master.py)."""
        vl = layout if layout is not None else self.layout_for(option)
        vid, locs = vl.pick_for_write(option, exclude=exclude)
        if not locs:
            raise ValueError(f"volume {vid} has no locations")
        file_key = self.next_file_key(count)
        # math/rand cookie like the reference (topology.go:137) — the
        # cookie is a read-guessing deterrent, not a crypto secret.
        cookie = random.getrandbits(32)
        from ..core.types import format_file_id
        return format_file_id(vid, file_key, cookie), count, locs
