"""VolumeLayout: per-(collection, replica placement, ttl) volume state.

Port of weed/topology/volume_layout.go: tracks vid -> location list,
writable/readonly/oversized vid sets, and the state machine driven by
heartbeat registrations (a volume is writable only when enough replicas
are present, it isn't oversized, and no replica is read-only).
"""

from __future__ import annotations

import random
import threading

from ..core.replica_placement import ReplicaPlacement
from .node import DataNode


class VolumeLayout:
    def __init__(self, rp: ReplicaPlacement, ttl, volume_size_limit: int):
        self.rp = rp
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.vid2location: dict[int, list[DataNode]] = {}
        self.writables: list[int] = []
        self.readonly_volumes: set[int] = set()
        self.oversized_volumes: set[int] = set()
        self._lock = threading.RLock()

    # -- registration (heartbeat-driven) ------------------------------------

    def register_volume(self, v, dn: DataNode) -> None:
        with self._lock:
            locs = self.vid2location.setdefault(v.id, [])
            if dn not in locs:
                locs.append(dn)
            for vinfo in [dn.volumes.get(v.id, v)]:
                if vinfo.read_only:
                    self.readonly_volumes.add(v.id)
                else:
                    self.readonly_volumes.discard(v.id)
            if self._is_oversized(v):
                self.oversized_volumes.add(v.id)
            self._remember_oversized(v)
            if len(locs) == self.rp.copy_count() and self._is_writable(v):
                if v.id not in self.oversized_volumes:
                    self._set_writable(v.id)
            else:
                self._remove_writable(v.id)

    def _is_near_expiry(self, v) -> bool:
        """TTL layout steering: past half the TTL since the volume's
        newest write, new assignments go to a fresher volume so this
        one drains toward whole-volume retirement (the holder-side
        sweeper deletes it once fully expired) instead of being kept
        alive by a trickle of writes."""
        from ..storage import expiry as _expiry
        return _expiry.volume_near_expiry(
            self.ttl, getattr(v, "modified_at", 0))

    def unregister_volume(self, v, dn: DataNode) -> None:
        with self._lock:
            locs = self.vid2location.get(v.id, [])
            if dn in locs:
                locs.remove(dn)
            if not locs:
                self.vid2location.pop(v.id, None)
                self._remove_writable(v.id)
                self.readonly_volumes.discard(v.id)
                self.oversized_volumes.discard(v.id)
            elif len(locs) < self.rp.copy_count():
                self._remove_writable(v.id)

    def _remember_oversized(self, v) -> None:
        if not self._is_oversized(v):
            self.oversized_volumes.discard(v.id)

    def _is_oversized(self, v) -> bool:
        return v.size >= self.volume_size_limit

    def _is_writable(self, v) -> bool:
        return not self._is_oversized(v) and not v.read_only \
            and not self._is_near_expiry(v)

    def _set_writable(self, vid: int) -> None:
        if vid not in self.writables:
            self.writables.append(vid)

    def _remove_writable(self, vid: int) -> None:
        if vid in self.writables:
            self.writables.remove(vid)

    def set_volume_unavailable(self, vid: int, dn: DataNode) -> bool:
        """Node died: drop its replica; unwritable if under-replicated."""
        with self._lock:
            locs = self.vid2location.get(vid)
            if locs and dn in locs:
                locs.remove(dn)
                if len(locs) < self.rp.copy_count():
                    self._remove_writable(vid)
                    return True
        return False

    def set_volume_capacity_full(self, vid: int) -> bool:
        with self._lock:
            self.oversized_volumes.add(vid)
            was = vid in self.writables
            self._remove_writable(vid)
            return was

    # -- queries -------------------------------------------------------------

    def pick_for_write(self, option=None,
                       rng: random.Random | None = None,
                       exclude=None) -> tuple[int, list[DataNode]]:
        """Random writable vid (+locations); optional DC/rack/node
        filter.  `exclude(locations) -> bool` vetoes candidate volumes
        (the master passes its draining/low-disk steering predicate:
        a replicated write to a vetoed volume would fail at fan-out)."""
        rng = rng or random
        with self._lock:
            if not self.writables:
                raise ValueError("no more writable volumes!")
            if option is None or not option.data_center:
                if exclude is None:
                    vid = self.writables[
                        rng.randrange(len(self.writables))]
                    return vid, list(self.vid2location.get(vid, []))
                candidates = [
                    v for v in self.writables
                    if not exclude(self.vid2location.get(v, []))]
                if not candidates:
                    raise ValueError(
                        "no writable volumes outside excluded nodes")
                vid = candidates[rng.randrange(len(candidates))]
                return vid, list(self.vid2location.get(vid, []))
            # Reservoir-sample a writable replica in the preferred place.
            counter = 0
            chosen = None
            for v in self.writables:
                if exclude is not None and \
                        exclude(self.vid2location.get(v, [])):
                    continue
                for dn in self.vid2location.get(v, []):
                    dc = dn.get_data_center()
                    if dc is None or dc.id != option.data_center:
                        continue
                    rack = dn.get_rack()
                    if option.rack and (rack is None or
                                        rack.id != option.rack):
                        continue
                    if option.data_node and dn.id != option.data_node:
                        continue
                    counter += 1
                    if rng.randrange(counter) < 1:
                        chosen = v
            if chosen is None:
                raise ValueError(
                    f"no writable volumes in {option.data_center}")
            return chosen, list(self.vid2location.get(chosen, []))

    def lookup(self, vid: int) -> list[DataNode]:
        with self._lock:
            return list(self.vid2location.get(vid, []))

    def active_volume_count(self, option=None) -> int:
        with self._lock:
            if option is None or not option.data_center:
                return len(self.writables)
            count = 0
            for v in self.writables:
                for dn in self.vid2location.get(v, []):
                    dc = dn.get_data_center()
                    if dc is None or dc.id != option.data_center:
                        continue
                    rack = dn.get_rack()
                    if option.rack and (rack is None or
                                        rack.id != option.rack):
                        continue
                    if option.data_node and dn.id != option.data_node:
                        continue
                    count += 1
            return count

    def stats(self) -> dict:
        with self._lock:
            return {
                "writables": list(self.writables),
                "readonly": sorted(self.readonly_volumes),
                "oversized": sorted(self.oversized_volumes),
                "volume_count": len(self.vid2location),
            }
