"""Vacuum (compaction): reclaim deleted space by copying live needles.

SeaweedFS's flow (weed/storage/volume_vacuum.go): Compact writes live records
into `.cpd`/`.cpx` staging files; CommitCompact replays any records appended
after the snapshot (makeupDiff), then atomically renames staging over the
live files and reloads.  The superblock compaction revision increments so
replicas can detect divergence.

Staging state (`volume.vacuum_staged`) and its guard
(`volume.vacuum_lock`) live on the Volume itself, mirroring the
Go Volume struct's fields: two Compacts from different
*in-process* planes (gRPC facade and JSON admin in the same server)
serialize instead of interleaving writes to the same `.cpd`/`.cpx`,
and a Commit consumes whichever plane's snapshot is staged.  Like the
Go code, nothing guards against a separate process (`weed compact`)
operating on a volume a live server has mounted.
"""

from __future__ import annotations

import os

from ..core import idx as idx_mod
from ..core import types as t
from ..core.needle import Needle
from ..core.super_block import SuperBlock
from . import expiry as _expiry
from .volume import Volume
from .volume_scanner import scan_volume_file


class VacuumError(Exception):
    pass


def compact(volume: Volume) -> int:
    """Phase 1: copy live needles to .cpd/.cpx. Returns snapshot dat size.

    The volume stays writable; records appended after the returned offset
    are replayed by commit_compact.  Re-running compact replaces any
    previously staged (uncommitted) snapshot, like SeaweedFS.
    """
    base = volume.file_name()
    with volume.vacuum_lock:
        # Invalidate any previously staged snapshot *before* truncating
        # the staging files: if this compact fails midway, a commit of
        # the stale snapshot would swap a partial .cpd over the live
        # .dat.
        volume.vacuum_staged = None
        volume.sync()
        snapshot_size = volume.dat_size()

        sb = SuperBlock(
            version=volume.super_block.version,
            replica_placement=volume.super_block.replica_placement,
            ttl=volume.super_block.ttl,
            compaction_revision=volume.super_block.compaction_revision + 1,
            extra=volume.super_block.extra)

        expired_count = 0
        expired_bytes = 0
        with open(base + ".cpd", "wb") as cpd, \
                open(base + ".cpx", "wb") as cpx:
            cpd.write(sb.to_bytes())
            new_offset = cpd.tell()
            for needle, offset, total in scan_volume_file(base + ".dat"):
                if offset >= snapshot_size:
                    break
                if needle.size <= 0:
                    continue
                live = volume.nm.get(needle.id)
                if live is None or live[0] != offset:
                    continue  # deleted or superseded
                # TTL-expired == dead: the read path already 404s these
                # (volume.read_needle), so dropping the record is the
                # reclaim step, not a behavior change.  The map entry
                # vanishes with the .cpx swap.
                if _expiry.needle_expired(needle, volume.super_block.ttl):
                    expired_count += 1
                    expired_bytes += total
                    continue
                blob = needle.to_bytes(volume.version)
                cpd.write(blob)
                idx_mod.append_entry(cpx, needle.id, new_offset, needle.size)
                new_offset += len(blob)
        volume.vacuum_staged = snapshot_size
        volume.vacuum_expired_count = expired_count
        volume.vacuum_expired_bytes = expired_bytes
    return snapshot_size


def commit_compact(volume: Volume, snapshot_size: int | None = None) -> None:
    """Phase 2: replay post-snapshot appends, swap files, reload the map.

    With no explicit `snapshot_size`, commits the snapshot staged on the
    volume by the last compact(); raises VacuumError if none is staged.
    Holds the volume's vacuum lock for the whole replay+swap so a
    concurrent compact cannot truncate the `.cpd` mid-commit, and the
    file lock in write mode so lock-free readers can never pread a
    closed fd or stale offsets.
    """
    base = volume.file_name()
    with volume.vacuum_lock:
        if snapshot_size is None:
            snapshot_size = volume.vacuum_staged
        if snapshot_size is None:
            raise VacuumError("no compact staged for this volume")
        with volume._file_lock.write(), volume._lock:
            volume.sync()
            # makeupDiff: replay records appended after the snapshot.
            with open(base + ".cpd", "r+b") as cpd, \
                    open(base + ".cpx", "ab") as cpx:
                cpd.seek(0, os.SEEK_END)
                new_offset = cpd.tell()
                for needle, _off, _total in scan_volume_file(
                        base + ".dat", start_offset=snapshot_size):
                    if needle.size > 0:
                        blob = needle.to_bytes(volume.version)
                        cpd.write(blob)
                        idx_mod.append_entry(cpx, needle.id, new_offset,
                                             needle.size)
                        new_offset += len(blob)
                    else:  # tombstone marker: propagate the delete
                        idx_mod.append_entry(cpx, needle.id, 0,
                                             t.TOMBSTONE_FILE_SIZE)
            # Swap.
            volume._dat.close()
            volume.nm.close()
            os.replace(base + ".cpd", base + ".dat")
            os.replace(base + ".cpx", base + ".idx")
            # Reload in place (same map kind the volume was opened with).
            from .needle_map import new_needle_map
            volume._dat = open(base + ".dat", "r+b")
            volume.super_block = SuperBlock.from_bytes(
                volume._dat.read(64 * 1024))
            volume.nm = new_needle_map(
                getattr(volume, "needle_map_kind", "compact"),
                base + ".idx")
            volume._dat.seek(0, os.SEEK_END)
            volume._append_at = volume._dat.tell()
            # The replication change log is compacted with the volume:
            # the acked prefix can never need re-shipping, and the
            # appended vacuum record keeps the seq chain alive (and
            # documents the rewrite to the standby).
            if volume.rlog is not None:
                volume.rlog.compact()
        volume.vacuum_staged = None


def cleanup_compact(volume: Volume) -> None:
    """Abandon a staged compact: drop the snapshot and remove the
    `.cpd`/`.cpx` staging files (VacuumVolumeCleanup)."""
    base = volume.file_name()
    with volume.vacuum_lock:
        volume.vacuum_staged = None
        for ext in (".cpd", ".cpx"):
            try:
                os.remove(base + ext)
            except FileNotFoundError:
                pass


def vacuum(volume: Volume) -> None:
    """Compact + commit in one step (single-process convenience).

    Holds the (reentrant) vacuum lock across both phases so concurrent
    vacuum() calls fully serialize instead of one consuming the
    other's staged snapshot between its phases.  Journaled as a
    volume.vacuum event with the reclaimed bytes and garbage ratios.
    """
    import time as _time

    from ..events import emit as emit_event
    with volume.vacuum_lock:
        before_bytes = volume.dat_size()
        before_ratio = volume.garbage_ratio()
        t0 = _time.perf_counter()
        compact(volume)
        commit_compact(volume)
        expired_count = getattr(volume, "vacuum_expired_count", 0)
        expired_bytes = getattr(volume, "vacuum_expired_bytes", 0)
        if expired_bytes:
            from ..stats import metrics as _metrics
            _metrics.ttl_expired_bytes_total.inc(expired_bytes,
                                                 via="vacuum")
        emit_event("volume.vacuum", vid=volume.vid,
                   seconds=round(_time.perf_counter() - t0, 6),
                   reclaimed_bytes=before_bytes - volume.dat_size(),
                   expired_needles=expired_count,
                   expired_bytes=expired_bytes,
                   garbage_before=round(before_ratio, 4),
                   garbage_after=round(volume.garbage_ratio(), 4))
