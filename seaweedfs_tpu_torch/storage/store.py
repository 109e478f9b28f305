"""Store: all volumes on one volume server, across disk locations.

weed/storage/store.go (Store), disk_location.go (DiskLocation).
The store discovers existing volumes at startup, routes needle CRUD by
volume id, assembles heartbeat summaries for the master, and emits delta
events (new/deleted volumes, EC shard mounts) that the cluster layer
streams to the master (store.go:198-268).
"""

from __future__ import annotations

import glob
import os
import re
import threading
from dataclasses import dataclass, field

from ..core.needle import Needle
from ..core.replica_placement import ReplicaPlacement
from ..core.ttl import TTL
from .volume import NotFoundError, Volume, VolumeError

_VOLUME_RE = re.compile(
    r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.(?:dat|vif)$")


@dataclass
class VolumeInfo:
    """Heartbeat summary of one volume (master_pb VolumeInformationMessage)."""
    id: int
    collection: str
    size: int
    file_count: int
    delete_count: int
    deleted_byte_count: int
    read_only: bool
    replica_placement: int
    ttl: int
    compact_revision: int
    max_file_key: int = 0
    version: int = 3
    # Unrepaired corrupt needles (open repair tickets, storage/scrub):
    # nonzero degrades the volume on /cluster/healthz.
    corrupt_count: int = 0
    # Newest-write wall time (epoch sec) and tier state, the signals
    # the master's lifecycle daemon plans from (idle/age rules, TTL
    # retirement, don't-re-tier).
    modified_at: int = 0
    tiered: bool = False


class DiskLocation:
    """One data directory holding volumes (and EC shards)."""

    def __init__(self, directory: str, max_volume_count: int = 7):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        self.volumes: dict[int, Volume] = {}
        self._lock = threading.RLock()

    def load_existing_volumes(self) -> int:
        count = 0
        with self._lock:
            # Tiered volumes FIRST (volume_tier.go maybeLoadVolumeInfo):
            # a .vif marks the remote copy as authoritative, so even a
            # keep_local .dat must not be opened writable — writes to it
            # would silently diverge from (and later lose to) the tier.
            tiered: set[int] = set()
            for path in sorted(glob.glob(os.path.join(self.directory,
                                                      "*.vif"))):
                m = _VOLUME_RE.match(os.path.basename(path))
                if not m:
                    continue
                from .tier import load_vif
                info = load_vif(path[:-4])
                if not info or not info.get("files"):
                    continue  # EC/version metadata, not a tier marker
                vid = int(m.group("vid"))
                tiered.add(vid)
                if vid in self.volumes:
                    continue
                collection = m.group("collection") or ""
                try:
                    from .tier import open_remote_volume
                    self.volumes[vid] = open_remote_volume(
                        self.directory, collection, vid)
                    count += 1
                except Exception:  # noqa: BLE001 — unreachable backend
                    continue       # must not block the store
            for path in sorted(glob.glob(os.path.join(self.directory,
                                                      "*.dat"))):
                m = _VOLUME_RE.match(os.path.basename(path))
                if not m:
                    continue
                vid = int(m.group("vid"))
                if vid in self.volumes or vid in tiered:
                    # A .vif whose backend was unreachable must NOT
                    # fall back to a writable stale local .dat.
                    continue
                collection = m.group("collection") or ""
                try:
                    self.volumes[vid] = Volume(
                        self.directory, collection, vid, create=False)
                    count += 1
                except Exception:  # noqa: BLE001 — one corrupt volume file
                    # (e.g. 0-byte .dat from a crashed create) must not
                    # prevent the rest of the store from loading.
                    continue
        return count

    def close(self) -> None:
        with self._lock:
            for v in self.volumes.values():
                v.close()
            self.volumes.clear()


class Store:
    """Routes needle operations to volumes; the volume server's core."""

    def __init__(self, directories: list[str],
                 max_volume_counts: list[int] | None = None,
                 ip: str = "localhost", port: int = 8080,
                 public_url: str = "",
                 disk_reserve_bytes: int = 0):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        counts = max_volume_counts or [7] * len(directories)
        self.locations = [DiskLocation(d, c)
                          for d, c in zip(directories, counts)]
        for loc in self.locations:
            loc.load_existing_volumes()
        self._lock = threading.RLock()
        # Delta events for the heartbeat stream (master sync).
        self.new_volumes: list[VolumeInfo] = []
        self.deleted_volumes: list[VolumeInfo] = []
        # Free-space reserve (-disk.reserve): volumes on a location
        # whose free bytes fall below this flip readonly BEFORE ENOSPC
        # can tear a write.  low_disk_dirs feeds heartbeats (the master
        # steers assignment away) and the reserve-breached gauge.
        self.disk_reserve_bytes = int(disk_reserve_bytes)
        self.low_disk_dirs: set[str] = set()
        self._reserve_flipped: set[int] = set()

    def check_disk_reserve(self) -> list[int]:
        """Enforce the free-space reserve: flip volumes on a breached
        location readonly (recording them), and flip OUR flips back
        once free space recovers past twice the reserve — the
        hysteresis keeps a disk hovering at the reserve from flapping
        volumes between modes.  Called from the heartbeat path (every
        pulse) and after any ENOSPC.  Returns vids whose mode changed
        in EITHER direction — the caller must full-heartbeat on any
        change, or the master would keep recovered volumes out of its
        writable pool forever."""
        if self.disk_reserve_bytes <= 0:
            # Reserve disabled (possibly at runtime): drop any state a
            # previously-configured reserve left behind, or the node
            # would stay low-disk/readonly forever.
            reset: list[int] = []
            if self.low_disk_dirs or self._reserve_flipped:
                with self._lock:
                    self.low_disk_dirs.clear()
                    for loc in self.locations:
                        for v in list(loc.volumes.values()):
                            if v.vid in self._reserve_flipped and \
                                    v.readonly:
                                v.set_readonly(False)
                                reset.append(v.vid)
                    self._reserve_flipped.clear()
            return reset
        from ..stats.sysstats import disk_status
        flipped: list[int] = []
        with self._lock:
            for loc in self.locations:
                try:
                    free = disk_status(loc.directory)["free"]
                except OSError:
                    continue
                if free < self.disk_reserve_bytes:
                    newly_low = loc.directory not in self.low_disk_dirs
                    self.low_disk_dirs.add(loc.directory)
                    for v in list(loc.volumes.values()):
                        if not v.readonly:
                            v.set_readonly(True)
                            self._reserve_flipped.add(v.vid)
                            flipped.append(v.vid)
                    if newly_low or flipped:
                        from ..events import emit as emit_event
                        emit_event("disk.low",
                                   node=f"{self.ip}:{self.port}",
                                   severity="warn", dir=loc.directory,
                                   free_bytes=free,
                                   reserve_bytes=self.disk_reserve_bytes,
                                   flipped=len(flipped))
                elif loc.directory in self.low_disk_dirs and \
                        free >= 2 * self.disk_reserve_bytes:
                    self.low_disk_dirs.discard(loc.directory)
                    for v in list(loc.volumes.values()):
                        if v.vid in self._reserve_flipped and v.readonly:
                            v.set_readonly(False)
                            self._reserve_flipped.discard(v.vid)
                            flipped.append(v.vid)  # recovered: the
                            # master must re-learn writability too
        return flipped

    # -- volume management --------------------------------------------------

    def find_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def free_location(self) -> DiskLocation | None:
        """A disk location with spare volume slots, or None when full."""
        return self._find_free_location()

    def _find_free_location(self) -> DiskLocation | None:
        best, best_free = None, 0
        for loc in self.locations:
            free = loc.max_volume_count - len(loc.volumes)
            if free > best_free:
                best, best_free = loc, free
        return best

    def add_volume(self, vid: int, collection: str = "",
                   replica_placement: str = "000", ttl: str = "",
                   version: int = 3) -> Volume:
        with self._lock:
            if self.has_volume(vid):
                raise VolumeError(f"volume {vid} already exists")
            loc = self._find_free_location()
            if loc is None:
                raise VolumeError("no free disk location")
            v = Volume(loc.directory, collection, vid,
                       replica_placement=ReplicaPlacement.parse(
                           replica_placement),
                       ttl=TTL.parse(ttl), version=version)
            loc.volumes[vid] = v
            self.new_volumes.append(self._volume_info(v))
            return v

    def delete_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    info = self._volume_info(v)
                    tiered = v.remote_file is not None
                    v.close()
                    base = v.file_name()
                    exts = [".dat", ".idx", ".qrt",
                            ".rlog", ".rwm", ".rap"]
                    if tiered:
                        # Only a tiered volume owns the .vif it mounts
                        # from.  A local volume's sidecar (if any)
                        # belongs to EC shards sharing the base name —
                        # ec.generate's version record must survive
                        # deleting the source replica.
                        exts.append(".vif")
                    for ext in exts:
                        try:
                            os.remove(base + ext)
                        except FileNotFoundError:
                            pass
                    self.deleted_volumes.append(info)
                    return
            raise VolumeError(f"volume {vid} not found")

    def mount_volume(self, vid: int) -> Volume:
        """Load an existing .dat/.idx pair from disk into the store
        (VolumeServer.VolumeMount — used after VolumeCopy pulls files)."""
        with self._lock:
            v = self.find_volume(vid)
            if v is not None:
                return v
            for loc in self.locations:
                # A .vif marks the remote copy authoritative — remount
                # must not reopen a keep_local .dat writable.
                for path in glob.glob(os.path.join(loc.directory,
                                                   "*.vif")):
                    m = _VOLUME_RE.match(os.path.basename(path))
                    if not m or int(m.group("vid")) != vid:
                        continue
                    from .tier import load_vif, open_remote_volume
                    info = load_vif(path[:-4])
                    if not info or not info.get("files"):
                        continue  # EC metadata .vif, not a tier marker
                    v = open_remote_volume(
                        loc.directory, m.group("collection") or "", vid)
                    loc.volumes[vid] = v
                    self.new_volumes.append(self._volume_info(v))
                    return v
                for path in glob.glob(os.path.join(loc.directory, "*.dat")):
                    m = _VOLUME_RE.match(os.path.basename(path))
                    if not m or int(m.group("vid")) != vid:
                        continue
                    v = Volume(loc.directory, m.group("collection") or "",
                               vid, create=False)
                    loc.volumes[vid] = v
                    self.new_volumes.append(self._volume_info(v))
                    return v
            raise VolumeError(f"no volume files for {vid} on this server")

    def unmount_volume(self, vid: int) -> None:
        """Detach a volume without deleting its files (VolumeUnmount)."""
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    self.deleted_volumes.append(self._volume_info(v))
                    v.close()
                    return
            raise VolumeError(f"volume {vid} not found")

    def configure_volume(self, vid: int, replication: str) -> None:
        """Change a mounted volume's replica placement in its superblock
        (store.ConfigureVolume); the next heartbeat reports the new
        placement so the master's layout re-groups it."""
        v = self.find_volume(vid)
        if v is None:
            raise VolumeError(f"volume {vid} not found")
        v.configure_replication(ReplicaPlacement.parse(replication))
        with self._lock:
            self.new_volumes.append(self._volume_info(v))

    def mark_volume_readonly(self, vid: int, ro: bool = True) -> None:
        v = self.find_volume(vid)
        if v is None:
            raise VolumeError(f"volume {vid} not found")
        v.set_readonly(ro)

    # -- needle CRUD ---------------------------------------------------------

    def write_needle(self, vid: int, n: Needle,
                     fsync: bool = False) -> tuple[int, int]:
        v = self.find_volume(vid)
        if v is None:
            raise VolumeError(f"volume {vid} not found")
        return v.write_needle(n, fsync=fsync)

    def read_needle(self, vid: int, needle_id: int,
                    cookie: int | None = None) -> Needle:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        return v.read_needle(needle_id, cookie)

    def delete_needle(self, vid: int, needle_id: int) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise VolumeError(f"volume {vid} not found")
        return v.delete_needle(needle_id)

    # -- heartbeat -----------------------------------------------------------

    def _volume_info(self, v: Volume) -> VolumeInfo:
        return VolumeInfo(
            id=v.vid, collection=v.collection, size=v.dat_size(),
            file_count=v.file_count(), delete_count=v.nm.metrics.deletion_count,
            deleted_byte_count=v.deleted_size(), read_only=v.readonly,
            replica_placement=v.super_block.replica_placement.to_byte(),
            ttl=v.super_block.ttl.to_uint32(),
            compact_revision=v.super_block.compaction_revision,
            max_file_key=v.max_file_key(), version=v.version,
            corrupt_count=v.corrupt_count(),
            modified_at=int(getattr(v, "modified_at", 0) or 0),
            tiered=v.remote_file is not None)

    def collect_heartbeat(self) -> dict:
        """Full heartbeat payload (CollectHeartbeat, store.go:198)."""
        volumes = []
        max_file_key = 0
        with self._lock:
            for loc in self.locations:
                for v in loc.volumes.values():
                    volumes.append(self._volume_info(v))
                    max_file_key = max(max_file_key, v.max_file_key())
        return {
            "ip": self.ip,
            "port": self.port,
            "public_url": self.public_url,
            "max_volume_count": sum(l.max_volume_count
                                    for l in self.locations),
            "max_file_key": max_file_key,
            "volumes": volumes,
        }

    def drain_deltas(self) -> tuple[list[VolumeInfo], list[VolumeInfo]]:
        with self._lock:
            new, deleted = self.new_volumes, self.deleted_volumes
            self.new_volumes, self.deleted_volumes = [], []
            return new, deleted

    def close(self) -> None:
        # Under the store's lock, as `add_volume` and `mount_volume`
        # write a location's volumes: a request still in flight when a
        # volume server stops waits, where it would change the dict
        # `DiskLocation.close` walks (Go's DiskLocation.Close holds the
        # volumesLock that its adds take).
        with self._lock:
            for loc in self.locations:
                loc.close()
