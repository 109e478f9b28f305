"""Epoch-fenced per-volume write leases: the `.lease` sidecar.

Geo active/active needs exactly one answer, per volume, to "who may
commit writes right now?" that survives partitions, crashes, and lease
movement.  This module is that answer: a tiny durable sidecar next to
the volume's `.dat` (the `.rwm`/`.qrt` atomic tmp+rename idiom)
recording

    {cluster_id, epoch, acquired_ts}

- `cluster_id` names the HOLDING cluster (the `-geo.cluster.id` of the
  region whose writes are authoritative for this volume).  A write
  arriving at a non-holder forwards to the holder — it never commits
  locally.
- `epoch` is a fencing token, bumped exactly once per lease transfer.
  Every shipped rlog batch carries `(cluster_id, epoch)`; a receiver
  rejects any batch whose epoch is behind its own sidecar, so a
  partitioned old holder that kept committing at a stale epoch fails
  closed on heal instead of silently diverging the pair.
- Transfer order is the safety argument: the old holder DEMOTES
  (writes the new holder's id at epoch+1 into its own sidecar, so it
  fences itself) strictly BEFORE the new holder acquires.  A partition
  between the two steps leaves the volume with NO holder — writes 503
  everywhere until heal — which is fail-closed: unavailable, never
  split-brained.  Two clusters can never both hold epoch E.

A volume with no `.lease` sidecar is in the plain active/passive mode:
the shipper ships everything, applies are unfenced, writes commit
locally.  Leases opt a volume into geo semantics one volume at a time.

The port's copy of `seaweedfs_tpu/replication/lease.py`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass

LEASE_SUFFIX = ".lease"


@dataclass(frozen=True)
class VolumeLease:
    """One volume's durable lease row."""
    cluster_id: str
    epoch: int
    acquired_ts: float

    def to_doc(self) -> dict:
        return asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "VolumeLease | None":
        try:
            return cls(cluster_id=str(doc["cluster_id"]),
                       epoch=int(doc["epoch"]),
                       acquired_ts=float(doc.get("acquired_ts", 0.0)))
        except (KeyError, TypeError, ValueError):
            return None


def load_lease(path: str) -> VolumeLease | None:
    try:
        with open(path) as f:
            return VolumeLease.from_doc(json.load(f))
    except (OSError, ValueError):
        return None


def store_lease(path: str, lease: VolumeLease) -> None:
    """Durable write, atomic like the Watermark: a torn lease file must
    never demote OR promote anybody by accident."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(lease.to_doc(), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class LeaseTable:
    """The volume server's view of every local volume's lease.

    Keyed by vid; rows are cached in memory and persisted through the
    `.lease` sidecar next to the volume files.  All transitions go
    through `fence()` — the single monotonic-epoch gate — so no code
    path can regress an epoch."""

    def __init__(self, store, cluster_id: str):
        self.store = store
        self.cluster_id = cluster_id
        self._lock = threading.Lock()
        self._cache: dict[int, VolumeLease] = {}
        # vids mid-transfer: writes refuse while the old holder drains.
        self._moving: set[int] = set()

    # -- sidecar I/O ---------------------------------------------------------

    def _path(self, vid: int) -> str | None:
        v = self.store.find_volume(vid)
        return None if v is None else v.file_name() + LEASE_SUFFIX

    def get(self, vid: int) -> VolumeLease | None:
        with self._lock:
            hit = self._cache.get(vid)
            if hit is not None:
                return hit
            path = self._path(vid)
            if path is None:
                return None
            lease = load_lease(path)
            if lease is not None:
                self._cache[vid] = lease
            return lease

    # -- predicates ----------------------------------------------------------

    def is_holder(self, vid: int) -> bool:
        """True when the LOCAL cluster may commit writes for `vid`.
        No sidecar = active/passive legacy mode = writable."""
        lease = self.get(vid)
        if lease is None:
            return True
        if vid in self._moving:
            return False
        return lease.cluster_id == self.cluster_id

    def ships(self, vid: int) -> bool:
        """True when the LOCAL shipper should ship this volume: we
        hold the lease (or no lease exists — legacy mode).  Unlike
        is_holder, a mid-move volume still ships: the transfer's
        drain step depends on it."""
        lease = self.get(vid)
        return lease is None or lease.cluster_id == self.cluster_id

    def holder(self, vid: int) -> str | None:
        lease = self.get(vid)
        return None if lease is None else lease.cluster_id

    def epoch(self, vid: int) -> int:
        lease = self.get(vid)
        return 0 if lease is None else lease.epoch

    def check_batch(self, vid: int, cluster_id: str,
                    epoch: int) -> str | None:
        """Fencing gate for an incoming rlog batch stamped
        `(cluster_id, epoch)`.  Returns None to admit the batch or a
        human-readable reason to reject it with 409.  Side effect: an
        epoch AHEAD of ours is the new-holder announcement riding the
        data path — we adopt it (demoting ourselves if we held)."""
        lease = self.get(vid)
        if lease is None:
            # First contact: learn the sender's lease so later stale
            # epochs are fenced even before any explicit acquire.
            self.fence(vid, cluster_id, epoch)
            return None
        if epoch < lease.epoch:
            return (f"stale epoch {epoch} < {lease.epoch} "
                    f"(holder {lease.cluster_id})")
        if epoch == lease.epoch and cluster_id != lease.cluster_id:
            return (f"epoch {epoch} held by {lease.cluster_id}, "
                    f"not {cluster_id}")
        if epoch > lease.epoch:
            self.fence(vid, cluster_id, epoch)
        return None

    # -- transitions (all monotonic in epoch) --------------------------------

    def fence(self, vid: int, cluster_id: str, epoch: int) -> VolumeLease:
        """Record `cluster_id` as holder at `epoch` iff that does not
        regress our epoch; persist through the sidecar.  This is
        acquire (cluster_id == ours), demote (cluster_id != ours), and
        heal-time fencing in one primitive."""
        with self._lock:
            cur = self._cache.get(vid)
            path = self._path(vid)
            if cur is None and path is not None:
                cur = load_lease(path)
            if cur is not None and epoch < cur.epoch:
                return cur  # monotonic: a stale fence is a no-op
            if cur is not None and epoch == cur.epoch and \
                    cur.cluster_id == cluster_id:
                return cur
            lease = VolumeLease(cluster_id=cluster_id, epoch=epoch,
                                acquired_ts=time.time())
            if path is not None:
                store_lease(path, lease)
            self._cache[vid] = lease
            self._moving.discard(vid)
            return lease

    def acquire(self, vid: int, epoch: int | None = None) -> VolumeLease:
        """Become the holder.  Default epoch: one past whatever we
        know, so a fresh acquire always fences prior holders."""
        if epoch is None:
            epoch = self.epoch(vid) + 1
        return self.fence(vid, self.cluster_id, epoch)

    def begin_move(self, vid: int) -> None:
        """Refuse local writes while the transfer drains the rlog."""
        with self._lock:
            self._moving.add(vid)

    def abort_move(self, vid: int) -> None:
        with self._lock:
            self._moving.discard(vid)

    # -- surfaces ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Per-volume lease rows for heartbeats and /debug: only
        volumes that actually have a sidecar appear."""
        out: dict[str, dict] = {}
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                lease = self.get(vid)
                if lease is None:
                    continue
                row = lease.to_doc()
                row["holder_is_local"] = \
                    lease.cluster_id == self.cluster_id
                row["moving"] = vid in self._moving
                out[str(vid)] = row
        return out
