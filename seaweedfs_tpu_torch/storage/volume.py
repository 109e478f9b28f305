"""Volume engine: one append-only `.dat` + `.idx` pair.

Mirrors SeaweedFS's Volume behavior (weed/storage/volume.go,
volume_read_write.go) with its key design points kept:

- append-only writes, 8-byte aligned records, offsets stored /8;
- an async batched write worker: requests queue up and are written +
  fsynced as one group (SeaweedFS batches <=128 requests / 4MB then one
  sync — volume_read_write.go:297-370);
- O(1) reads: one map lookup then one pread;
- deletes append a tombstone needle and a tombstone idx entry;
- vacuum (volume_vacuum.py) copies live needles to `.cpd/.cpx` then
  atomically swaps, bumping the superblock compaction revision.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass

from ..core import types as t
from ..core.needle import (CURRENT_VERSION, Needle, get_actual_size)
from ..core.replica_placement import ReplicaPlacement
from ..core.super_block import SUPER_BLOCK_SIZE, SuperBlock
from ..core.ttl import TTL
from ..fault import registry as _fault
from ..stats import contention as _contention
from ..stats import phases as _phases
from ..utils.rwlock import RWLock
from . import expiry as _expiry
from .needle_map import new_needle_map

MAX_BATCH_REQUESTS = 128
MAX_BATCH_BYTES = 4 * 1024 * 1024


class VolumeError(Exception):
    pass


class NotFoundError(VolumeError):
    pass


class CorruptNeedleError(VolumeError):
    """The record's stored CRC disagrees with its data bytes: bit-rot
    or a torn write.  Distinct from VolumeError so the read path can
    route it to self-healing repair instead of a plain 4xx."""


class DiskFullError(VolumeError):
    """An append hit ENOSPC.  The partially-written record was rolled
    back (truncated — no torn tail for crash recovery to find) and the
    volume flipped readonly; the volume server re-checks its disk
    reserve and heartbeats the state so the master steers assignment
    away."""


class TierReadError(VolumeError):
    """A remote-tier ranged read failed (WAN partition, backend down,
    timeout).  Distinct from CorruptNeedleError/OSError so the read
    path answers a bounded, retryable 503 instead of routing into
    degraded-read repair — the local bytes are gone by design, not
    rotten."""


@dataclass
class _WriteReq:
    needle: Needle
    done: threading.Event
    offset: int = 0
    size: int = 0
    error: Exception | None = None
    # journal=False marks mutations that must NOT land in the
    # replication change log: the standby's apply path (or the mirror
    # would ship its own inputs back) and quarantine tombstones (which
    # must never propagate as user deletes — the repair rule).
    journal: bool = True


def _parse_needle_extras(tail: bytes) -> dict:
    """Parse the post-data record tail (flags + optional extras, no
    checksum) for the response-header metadata the zero-copy GET path
    serves: name, mime, last-modified.  Mirrors the field order of
    Needle._read_body_v2."""
    from ..core.needle import (FLAG_HAS_LAST_MODIFIED_DATE,
                               FLAG_HAS_MIME, FLAG_HAS_NAME,
                               LAST_MODIFIED_BYTES_LENGTH)
    flags = tail[0]
    i = 1
    name = mime = b""
    last_modified = 0
    if flags & FLAG_HAS_NAME and i < len(tail):
        n = tail[i]
        name = tail[i + 1:i + 1 + n]
        i += 1 + n
    if flags & FLAG_HAS_MIME and i < len(tail):
        n = tail[i]
        mime = tail[i + 1:i + 1 + n]
        i += 1 + n
    if flags & FLAG_HAS_LAST_MODIFIED_DATE and \
            i + LAST_MODIFIED_BYTES_LENGTH <= len(tail):
        last_modified = int.from_bytes(
            tail[i:i + LAST_MODIFIED_BYTES_LENGTH], "big")
    return {"name": name, "mime": mime,
            "last_modified": last_modified}


class NeedleSlice:
    """A byte range of a volume's .dat holding one needle's payload,
    produced by Volume.read_needle_slice after cookie+CRC checks.

    File-like enough for the HTTP responder: read(n) serves chunks via
    os.pread (the TLS / fallback path) and sendfile_to(sock) moves the
    whole remainder kernel-side with os.sendfile.  OWNS a dup'd fd of
    the .dat rather than holding the volume's file lock: a slow client
    must never block deletes/fsync-writes/vacuum on the volume, and if
    vacuum swaps the file mid-transfer the dup keeps the old inode
    alive — the client finishes reading a consistent pre-compact
    snapshot."""

    __slots__ = ("fd", "offset", "size", "_pos", "_closed", "etag",
                 "name", "mime", "last_modified")

    def __init__(self, fd: int, offset: int, size: int,
                 etag: str = "", name: bytes = b"", mime: bytes = b"",
                 last_modified: int = 0):
        self.fd = fd  # dup'd; closed by close()
        self.offset = offset
        self.size = size
        self._pos = 0
        self._closed = False
        # Response-header metadata (checksum etag + record extras).
        self.etag = etag
        self.name = name
        self.mime = mime
        self.last_modified = last_modified

    def read(self, n: int = -1) -> bytes:
        remaining = self.size - self._pos
        if remaining <= 0:
            return b""
        want = remaining if n < 0 else min(n, remaining)
        data = os.pread(self.fd, want, self.offset + self._pos)
        if not data:
            raise VolumeError("needle slice truncated mid-read")
        self._pos += len(data)
        return data

    def sendfile_to(self, sock, note=None) -> None:
        """Zero-copy the remaining payload into a plaintext socket.
        `note(n)` receives each syscall-returned byte total — these
        bytes never transit userspace, so the wire-flow ledger
        (stats/flows.py) counts them here or not at all."""
        sock_fd = sock.fileno()
        end = self.offset + self.size
        off = self.offset + self._pos
        while off < end:
            sent = os.sendfile(sock_fd, self.fd, off,
                               min(end - off, 8 << 20))
            if sent == 0:
                raise ConnectionError("peer closed during sendfile")
            off += sent
            if note is not None:
                note(sent)
        self._pos = self.size

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                os.close(self.fd)
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # backstop; close() is the contract
        self.close()


class Volume:
    """A single volume. Thread-safe; writes go through the batch worker."""

    def __init__(self, dir_: str, collection: str, vid: int,
                 replica_placement: ReplicaPlacement | None = None,
                 ttl: TTL | None = None, create: bool = True,
                 version: int = CURRENT_VERSION, use_worker: bool = True,
                 remote_file=None, needle_map_kind: str = "compact"):
        self.dir = dir_
        self.collection = collection
        self.vid = vid
        self.readonly = False
        # Metered (stats/contention.py): the append lock is THE
        # serialization point of the write path — its wait histogram
        # is where a write convoy becomes visible, and waits land in
        # the blocked request's `lock` phase.
        self._lock = _contention.MeteredLock("volume.write",
                                             threading.RLock())
        # Readers-writer discipline like SeaweedFS's dataFileAccessLock:
        # concurrent preads; exclusive for write batches and the vacuum
        # file swap.  Write-side waits/holds are metered as
        # "volume.file" (read side stays free).
        self._file_lock = RWLock(name="volume.file")
        # Vacuum staging state lives on the Volume (volume_vacuum.go
        # keeps it on the Volume struct) so the in-process planes —
        # gRPC facade and JSON admin — serialize on the same guard and
        # a Commit can find the snapshot whichever plane staged it.
        self.vacuum_lock = threading.RLock()
        self.vacuum_staged: int | None = None
        # Self-healing state: quarantined-needle repair tickets
        # (key -> quarantine unix time) and the last scrub sweep time
        # (storage/scrub.py).  len(repair_tickets) is the volume's
        # corrupt_count in heartbeats and /cluster/healthz.  Tickets
        # persist in a `.qrt` sidecar: a restart must neither forget
        # that quarantined data awaits repair (healthz would lie
        # healthy) nor let its tombstone masquerade as a user delete.
        self.repair_tickets: dict[int, float] = self._load_tickets()
        self.last_scrub = 0.0
        # Replication change log (replication/rlog.py): None until
        # mirroring is configured for this volume.  Auto-reopened below
        # when the sidecar already exists, so a restarted primary keeps
        # journaling without waiting for the shipper to re-enable it.
        self.rlog = None
        base = self.file_name()
        # Tiered volume: the .dat lives on a remote BackendStorage
        # (storage/volume_tier.go); reads proxy through remote_file,
        # writes are forbidden, the .idx stays local.
        self.remote_file = remote_file
        if remote_file is not None:
            self._dat = None
            self.readonly = True
            use_worker = False
            self.super_block = SuperBlock.from_bytes(
                remote_file.pread(SUPER_BLOCK_SIZE + 64 * 1024, 0))
            self.needle_map_kind = needle_map_kind
            self.nm = new_needle_map(needle_map_kind, base + ".idx")
            self._append_at = remote_file.size()
            self.last_modified = time.time()
            # Newest-write wall time; open_remote_volume restores the
            # real value from the .vif (a tiered volume is readonly, so
            # it can't advance).
            self.modified_at = 0.0
            self._closed = False
            self._use_worker = False
            self._queue = queue.Queue(maxsize=1)
            self._worker = None
            return
        exists = os.path.exists(base + ".dat")
        if not exists and not create:
            raise VolumeError(f"volume file {base}.dat not found")
        if exists:
            # Crash-safe mount (storage/scrub.py): validate the
            # superblock, truncate a torn trailing record, and repair/
            # regenerate the .idx BEFORE anything trusts either file —
            # a kill -9 mid-write must never leave this volume
            # unmountable or lying about what it holds.
            from .scrub import recover_volume_files
            recover_volume_files(base + ".dat", base + ".idx", vid=vid)
            self._dat = open(base + ".dat", "r+b")
            self.super_block = SuperBlock.from_bytes(
                self._dat.read(SUPER_BLOCK_SIZE + 64 * 1024))
        else:
            self._dat = open(base + ".dat", "w+b")
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl or TTL())
            self._dat.write(self.super_block.to_bytes())
            self._dat.flush()
        self.needle_map_kind = needle_map_kind
        # No dat_path here: recover_volume_files above already ran the
        # strictly-stronger crash pass (verify_idx_against_dat is the
        # gate for mappers loaded OUTSIDE a Volume) — passing it would
        # just re-read the whole .idx a second time per mount.
        self.nm = new_needle_map(needle_map_kind, base + ".idx")
        if needle_map_kind == "sorted_file":
            self.readonly = True  # the .sdx map cannot journal updates
        self._dat.seek(0, os.SEEK_END)
        self._append_at = self._dat.tell()
        self.last_modified = time.time()
        # Newest-write wall time, the TTL-expiry anchor: seeded from
        # the .dat mtime across restarts (close enough — the mtime IS
        # the last append), advanced by every committed write.
        self.modified_at = os.path.getmtime(base + ".dat") if exists \
            else 0.0
        if os.path.exists(base + ".rlog"):
            self.enable_rlog()

        self._closed = False
        self._use_worker = use_worker
        self._queue: queue.Queue[_WriteReq | None] = queue.Queue(maxsize=1024)
        self._worker = None
        if use_worker:
            self._worker = threading.Thread(
                target=self._worker_loop, name=f"vol{vid}-writer", daemon=True)
            self._worker.start()

    # -- naming ------------------------------------------------------------

    def file_name(self) -> str:
        name = f"{self.collection}_{self.vid}" if self.collection else \
            str(self.vid)
        return os.path.join(self.dir, name)

    @property
    def version(self) -> int:
        return self.super_block.version

    def enable_rlog(self):
        """Switch on the durable replication change log for this
        volume (idempotent).  From here every committed write/delete
        journals a fixed-size record into the `.rlog` sidecar at the
        same commit point as the needle itself, so the shipper can
        resume exactly after a kill -9.  Standby volumes never call
        this — their mutations arrive FROM a mirror and shipping them
        back would loop."""
        with self._lock:
            if self.rlog is None:
                # Lazy import: storage must not pull the replication
                # package (and its filer-client deps) at module import.
                from ..replication.rlog import ReplicationLog
                self.rlog = ReplicationLog(self.file_name())
        return self.rlog

    # -- write path --------------------------------------------------------

    def _worker_loop(self) -> None:
        """Batch pending requests, write them, fsync once per batch."""
        while True:
            req = self._queue.get()
            if req is None:
                return
            batch = [req]
            bytes_est = len(req.needle.data)
            while (len(batch) < MAX_BATCH_REQUESTS and
                   bytes_est < MAX_BATCH_BYTES):
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._drain_batch(batch)
                    return
                batch.append(nxt)
                bytes_est += len(nxt.needle.data)
            self._drain_batch(batch)

    def _drain_batch(self, batch: list[_WriteReq]) -> None:
        """Write all records, fsync once, then publish map entries.

        Publication order matters: needle-map entries become visible only
        after the data is durable on the .dat fd, so a concurrent
        read_needle (lock-free os.pread) can never observe a mapped offset
        whose bytes haven't reached the OS yet.
        """
        try:
            with self._file_lock.write(), self._lock:
                written: list[_WriteReq] = []
                for req in batch:
                    try:
                        off, size = self._write_record_locked(req.needle)
                        req.offset, req.size = off, size
                        written.append(req)
                    except Exception as e:  # noqa: BLE001 — to the waiter
                        req.error = e
                try:
                    self._dat.flush()
                    os.fsync(self._dat.fileno())
                    for req in written:
                        self.nm.put(req.needle.id, req.offset,
                                    req.needle.size)
                    # Durable writes are durable in BOTH files: an idx
                    # entry lost to a crash would orphan the fsynced
                    # data (recovery re-journals it, but an fsync ack
                    # should never depend on recovery).
                    self.nm.sync()
                    if self.rlog is not None:
                        # Change-log records land AFTER the data is
                        # durable and BEFORE the waiters are released:
                        # a crash here loses only un-acked writes, and
                        # every acked write has its log record.
                        for req in written:
                            if req.journal:
                                self.rlog.append(self.rlog.OP_WRITE,
                                                 req.needle.id,
                                                 req.needle.cookie,
                                                 req.needle.size)
                        self.rlog.sync()
                except Exception as e:  # noqa: BLE001
                    for req in batch:
                        req.error = req.error or e
                self.last_modified = time.time()
        except Exception as e:  # noqa: BLE001 — never strand the waiters
            for req in batch:
                req.error = req.error or e
        finally:
            for req in batch:
                req.done.set()

    def _write_record_locked(self, n: Needle) -> tuple[int, int]:
        """Append the record bytes (no map publication, no sync)."""
        if self.readonly:
            raise VolumeError(f"volume {self.vid} is read only")
        self.modified_at = _expiry.now()
        offset = self._append_at
        if offset % t.NEEDLE_PADDING_SIZE != 0:
            # Self-heal like SeaweedFS: realign to the padding grid.
            offset += t.NEEDLE_PADDING_SIZE - (offset % t.NEEDLE_PADDING_SIZE)
            self._dat.truncate(offset)
        if offset >= t.MAX_POSSIBLE_VOLUME_SIZE:
            raise VolumeError(f"volume {self.vid} exceeds max size")
        if n.append_at_ns == 0:
            n.append_at_ns = time.time_ns()
        blob = n.to_bytes(self.version)
        if _fault.ARMED and n.data:
            # volume.corrupt: deterministic bit-rot injection — the
            # write SUCCEEDS but a data bit flips on its way to disk
            # (the stored checksum was already computed from the true
            # bytes, so the damage is CRC-detectable like real rot).
            try:
                _fault.hit("volume.corrupt", vid=self.vid,
                           key=f"{n.id:x}")
            except _fault.FaultInjected:
                buf = bytearray(blob)
                buf[t.NEEDLE_HEADER_SIZE + 4] ^= 0xFF  # first data byte
                blob = bytes(buf)
        self._dat.seek(offset)
        try:
            if _fault.ARMED and "disk.full" in _fault.ARMED:
                # Injected ENOSPC mid-record: half the blob lands (a
                # real torn write) before the fault fires, so the
                # rollback below has something real to clean up.
                half = max(1, len(blob) // 2)
                self._dat.write(blob[:half])
                self._dat.flush()
                _fault.hit("disk.full", vid=self.vid, key=f"{n.id:x}")
                self._dat.write(blob[half:])
            else:
                self._dat.write(blob)
        except OSError as e:
            # Roll the partial record back NOW (truncate to the
            # pre-append offset): the .dat keeps no torn tail, so the
            # volume stays mountable as-is instead of leaning on crash
            # recovery at the next mount.  If the truncate itself fails
            # the torn-tail machinery (scrub.recover_volume_files)
            # still catches it on remount.
            try:
                self._dat.truncate(offset)
                self._dat.flush()
            except OSError:
                pass
            self._append_at = offset
            import errno as _errno
            if isinstance(e, _fault.FaultInjected) or \
                    e.errno == _errno.ENOSPC:
                # Out of space: stop admitting writes to this volume
                # before the next append can tear again.
                self.readonly = True
                from ..events import emit as emit_event
                emit_event("disk.full", severity="error", vid=self.vid,
                           rolled_back_bytes=len(blob),
                           key=f"{n.id:x}")
                raise DiskFullError(
                    f"volume {self.vid}: disk full (ENOSPC); partial "
                    f"record rolled back, volume now readonly") from e
            raise
        self._append_at = offset + len(blob)
        return offset, n.size

    def write_needle(self, n: Needle, fsync: bool = False,
                     journal: bool = True) -> tuple[int, int]:
        """Append an object. Returns (offset, stored size).

        Like SeaweedFS, writes reach the OS page cache (flush) but
        are NOT fsynced by default — durability rides replication, and
        `?fsync=true` opts a request in per-call
        (topology/store_replicate.go:37-44, writeNeedle2's fsync
        branch).  fsync=True requests ride the batch worker so
        concurrent durable writers share one fsync per ≤128-request
        batch.  Map entries publish only after flush, so a lock-free
        pread can never observe a mapped offset whose bytes haven't
        reached the OS.
        """
        if self._closed:
            raise VolumeError(f"volume {self.vid} is closed")
        if not fsync or not self._use_worker:
            # Same lock discipline as the batch worker: the file lock
            # in write mode excludes vacuum's and tiering's fd swaps
            # (which synchronize on _file_lock.write() only), _lock
            # orders appends.
            with self._file_lock.write(), self._lock:
                with _phases.phase("disk"):
                    off, size = self._write_record_locked(n)
                    self._dat.flush()
                    if fsync:
                        os.fsync(self._dat.fileno())
                    self.nm.put(n.id, off, n.size)
                    if fsync:
                        self.nm.sync()
                    else:
                        self.nm.flush()
                    if journal and self.rlog is not None:
                        self.rlog.append(self.rlog.OP_WRITE, n.id,
                                         n.cookie, n.size)
                        if fsync:
                            self.rlog.sync()
                self.last_modified = time.time()
                return off, size
        req = _WriteReq(needle=n, done=threading.Event(),
                        journal=journal)
        self._queue.put(req)
        if self._closed:
            # close() may already have drained the queue; fail fast instead
            # of waiting on a worker that will never run.
            req.error = req.error or VolumeError(
                f"volume {self.vid} is closed")
            req.done.set()
        # The batch worker appends + fsyncs on its own thread; this
        # handler's wall time spent waiting on it IS the request's
        # disk time (write + shared group fsync).
        with _phases.phase("disk"):
            req.done.wait()
        if req.error:
            raise req.error
        return req.offset, req.size

    def delete_needle(self, needle_id: int, journal: bool = True) -> int:
        """Tombstone an object. Returns bytes freed (0 if absent).

        Appends a zero-data needle (so the .dat replays the delete) and a
        tombstone idx entry, mirroring doDeleteRequest
        (volume_read_write.go).  journal=False suppresses the
        replication change-log record: quarantine tombstones (and the
        standby's own apply path) must never propagate as user deletes.
        """
        with self._file_lock.write(), self._lock:
            if self.readonly:
                raise VolumeError(f"volume {self.vid} is read only")
            entry = self.nm.get(needle_id)
            if entry is None:
                return 0
            marker = Needle(cookie=0, id=needle_id, data=b"")
            marker.append_at_ns = time.time_ns()
            offset = self._append_at
            blob = marker.to_bytes(self.version)
            self._dat.seek(offset)
            self._dat.write(blob)
            self._append_at = offset + len(blob)
            self._dat.flush()
            # Publish the tombstone only after the marker bytes are flushed.
            freed = self.nm.delete(needle_id)
            self.nm.flush()
            if journal and self.rlog is not None:
                self.rlog.append(self.rlog.OP_DELETE, needle_id, 0, 0)
            self.last_modified = time.time()
            return freed

    # -- self-healing (storage/scrub.py drives these) ------------------------

    def _tickets_path(self) -> str:
        return self.file_name() + ".qrt"

    def _load_tickets(self) -> dict[int, float]:
        import json
        try:
            with open(self._tickets_path()) as f:
                return {int(k, 16): float(ts)
                        for k, ts in json.load(f).items()}
        except (OSError, ValueError):
            return {}

    def _save_tickets(self) -> None:
        """Persist the open repair tickets (best effort — a failed save
        costs re-detection by the next scrub, never data)."""
        import json
        path = self._tickets_path()
        try:
            if not self.repair_tickets:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
                return
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({f"{k:x}": ts
                           for k, ts in self.repair_tickets.items()}, f)
            os.replace(tmp, path)
        except OSError:
            pass

    def corrupt_count(self) -> int:
        """Unrepaired corrupt needles (open repair tickets) — reported
        in heartbeats; any nonzero count degrades /cluster/healthz."""
        return len(self.repair_tickets)

    def quarantine_needle(self, key: int, node: str = "") -> bool:
        """Stop serving a corrupt needle's bytes: tombstone it and keep
        a repair ticket so a later sweep (or a degraded read) can still
        re-fetch it from a healthy replica.  Returns True if the needle
        was newly quarantined."""
        if key in self.repair_tickets:
            return False
        if self.nm.get(key) is None:
            return False
        try:
            # journal=False: a quarantine tombstone is NOT a user
            # delete — shipping it would delete the standby's healthy
            # copy of data this cluster merely failed to keep.
            self.delete_needle(key, journal=False)
        except VolumeError:
            pass  # readonly volume: the ticket still flags it degraded
        self.repair_tickets[key] = time.time()
        self._save_tickets()
        from ..events import emit as emit_event
        emit_event("volume.quarantine", node=node, severity="warn",
                   vid=self.vid, key=f"{key:x}")
        return True

    def repair_needle(self, n: Needle, fsync: bool = True) -> tuple[int, int]:
        """Rewrite a healthy copy of a needle in place (append + map
        publish), closing its repair ticket.  Runs even on a readonly
        volume: repair restores what the volume already promised to
        hold, it does not admit new data."""
        with self._file_lock.write(), self._lock:
            ro, self.readonly = self.readonly, False
            try:
                off, size = self._write_record_locked(n)
                self._dat.flush()
                if fsync:
                    os.fsync(self._dat.fileno())
                self.nm.put(n.id, off, n.size)
                if fsync:
                    self.nm.sync()  # both files durable, like write
                else:
                    self.nm.flush()
                if self.rlog is not None:
                    # A repair is journaled as a WRITE: the standby
                    # either already holds these bytes (same id+cookie,
                    # idempotent) or its copy is what this repair
                    # restored — re-shipping converges both cases.
                    self.rlog.append(self.rlog.OP_WRITE, n.id,
                                     n.cookie, n.size)
                self.last_modified = time.time()
            finally:
                self.readonly = ro
        if self.repair_tickets.pop(n.id, None) is not None:
            self._save_tickets()
        return off, size

    def read_needle_blob(self, needle_id: int) -> bytes:
        """Raw CRC-verified record bytes (header..padding) of one live
        needle — what a sibling replica pulls to heal its copy.  Raises
        CorruptNeedleError when this copy is rotten too."""
        entry = self.nm.get(needle_id)
        if entry is None or not t.size_is_valid(entry[1]):
            raise NotFoundError(f"needle {needle_id:x} not found")
        total = get_actual_size(entry[1], self.version)
        blob = self.pread(total, entry[0])
        if len(blob) < total:
            raise CorruptNeedleError(
                f"needle {needle_id:x}: record truncated")
        try:
            Needle.from_bytes(blob, self.version)  # CRC gate
        except ValueError as e:
            raise CorruptNeedleError(
                f"needle {needle_id:x}: {e}") from None
        return blob

    # -- read path ---------------------------------------------------------

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        """One map lookup + one pread (the O(1) design point).

        Takes the file lock in read mode so vacuum's fd swap can't close
        the fd mid-pread; readers run concurrently with each other.
        """
        with self._file_lock.read():
            entry = self.nm.get(needle_id)
            if entry is None:
                raise NotFoundError(f"needle {needle_id:x} not found")
            offset, size = entry
            if not t.size_is_valid(size):
                raise NotFoundError(f"needle {needle_id:x} deleted")
            total = get_actual_size(size, self.version)
            if _fault.ARMED:
                # disk.read: an armed fail is an OSError here — the
                # exact failure mode of a dying sector.
                _fault.hit("disk.read", vid=self.vid,
                           key=f"{needle_id:x}")
            # Inline disk-phase accounting (not the phases.phase ctx):
            # this is THE hot read path — the context manager's object
            # allocation and two method calls are measurable at
            # thousands of reads/sec, the inline form is not.
            _led = _phases.active()
            _t = time.perf_counter() if _led is not None else 0.0
            if self.remote_file is not None:
                # Any remote failure — FaultInjected (an OSError!),
                # URLError, timeout — becomes TierReadError so the
                # server maps it to a retryable 503 instead of routing
                # it into degraded-read repair.
                try:
                    blob = self.remote_file.pread(total, offset)
                except Exception as e:
                    raise TierReadError(
                        f"volume {self.vid}: remote read failed: "
                        f"{e}") from e
            else:
                blob = os.pread(self._dat.fileno(), total, offset)
            if _led is not None:
                _led.arr[_phases.IDX_DISK] += \
                    time.perf_counter() - _t
        try:
            n = Needle.from_bytes(blob, self.version)
        except ValueError as e:
            raise CorruptNeedleError(
                f"needle {needle_id:x}: {e}") from None
        if cookie is not None and n.cookie != cookie:
            raise VolumeError(
                f"cookie mismatch for needle {needle_id:x}")
        # Expiry honors the per-needle TTL first, then the volume
        # superblock's (the assign-time ?ttl) — storage/expiry.py is
        # the single decision point.
        if _expiry.needle_expired(n, self.super_block.ttl):
            raise NotFoundError(f"needle {needle_id:x} expired")
        return n

    def pread(self, size: int, offset: int) -> bytes:
        """Raw .dat range read under the read lock (local or remote) —
        the tail/backup scanners' and the scrubber's access path."""
        with self._file_lock.read():
            if _fault.ARMED:
                _fault.hit("disk.read", vid=self.vid)
            with _phases.phase("disk"):
                if self.remote_file is not None:
                    try:
                        return self.remote_file.pread(size, offset)
                    except Exception as e:
                        raise TierReadError(
                            f"volume {self.vid}: remote read "
                            f"failed: {e}") from e
                return os.pread(self._dat.fileno(), size, offset)

    def read_needle_slice(self, needle_id: int,
                          cookie: int | None = None,
                          min_size: int = 0) -> "NeedleSlice | None":
        """Zero-copy read: locate a needle, verify cookie + CRC by
        streaming preads, and return a NeedleSlice over the raw data
        bytes in the .dat — never materializing the payload as one
        Python object.  The slice rides a dup'd fd, so no volume lock
        is held during CRC or the client transfer: a vacuum swap
        mid-read just leaves the reader on the old inode's consistent
        bytes (the GET handler streams the slice with os.sendfile).

        Returns None when the record needs the full parse path: v1
        layout, remote-tiered volume, empty body, a body smaller than
        `min_size`, or flags the read pipeline must interpret
        (compressed / TTL).  Raises like read_needle for absent or
        deleted needles so callers map errors identically.
        (SeaweedFS parity: volume_server_handlers_read.go reads then
        verifies the CRC before writing data out — same check, no
        userspace copy of the payload.)
        """
        from ..core import crc as crc_mod
        from ..core.needle import (FLAG_HAS_TTL, FLAG_IS_COMPRESSED,
                                   VERSION1)
        if self.remote_file is not None or self.version == VERSION1:
            return None
        with self._file_lock.read():
            entry = self.nm.get(needle_id)
            if entry is None:
                raise NotFoundError(f"needle {needle_id:x} not found")
            offset, size = entry
            if not t.size_is_valid(size):
                raise NotFoundError(f"needle {needle_id:x} deleted")
            if size < max(min_size, 5):  # data_size(4)+flags(1) floor
                return None
            fd = os.dup(self._dat.fileno())
        try:
            head = os.pread(fd, t.NEEDLE_HEADER_SIZE + 4, offset)
            if len(head) < t.NEEDLE_HEADER_SIZE + 4:
                raise VolumeError(f"needle {needle_id:x} truncated")
            disk_cookie = t.get_uint32(head, 0)
            disk_size = t.get_uint32(head, 12)
            data_size = t.get_uint32(head, 16)
            if cookie is not None and disk_cookie != cookie:
                raise VolumeError(
                    f"cookie mismatch for needle {needle_id:x}")
            if disk_size != size or data_size + 5 > size \
                    or data_size < min_size:
                os.close(fd)
                return None  # unusual record: take the full parse path
            data_off = offset + t.NEEDLE_HEADER_SIZE + 4
            # Everything after the data bytes up to the checksum:
            # flags(1) + optional name/mime/last-modified extras —
            # bounded by `size`, typically a handful of bytes.
            tail = os.pread(fd, size - 4 - data_size,
                            data_off + data_size)
            if not tail or tail[0] & (FLAG_IS_COMPRESSED
                                      | FLAG_HAS_TTL):
                os.close(fd)
                return None  # needs decode / expiry logic
            meta = _parse_needle_extras(tail)
            stored = t.get_uint32(os.pread(
                fd, 4, offset + t.NEEDLE_HEADER_SIZE + size))
            crc = 0
            pos, remaining = data_off, data_size
            # Attributed to `disk`: the streaming CRC pass is the read
            # path's per-byte payload verification — its cost scales
            # with the bytes pread, not with handler logic.
            with _phases.phase("disk"):
                while remaining:
                    chunk = os.pread(fd, min(remaining, 4 << 20), pos)
                    if not chunk:
                        raise VolumeError(
                            f"needle {needle_id:x} truncated")
                    crc = crc_mod.crc32c(chunk, crc)
                    pos += len(chunk)
                    remaining -= len(chunk)
            if crc_mod.masked_value(crc) != stored:
                raise CorruptNeedleError(
                    f"CRC error on needle {needle_id:x}")
            return NeedleSlice(fd, data_off, data_size,
                               etag=f"{stored:08x}", **meta)
        except BaseException:
            os.close(fd)
            raise

    # -- stats / lifecycle --------------------------------------------------

    def content_size(self) -> int:
        return self.nm.content_size()

    def deleted_size(self) -> int:
        return self.nm.deleted_size()

    def file_count(self) -> int:
        return len(self.nm)

    def dat_size(self) -> int:
        with self._lock:
            return self._append_at

    def copy_sizes(self) -> tuple[int, int]:
        """(.dat, .idx) bytes to copy of this volume: both flushed and
        fsynced, taken together under the append lock, so that a copy of
        a live volume ends between two records and its .idx names no
        byte past its .dat."""
        with self._lock:
            self.sync()
            return (self._append_at,
                    os.path.getsize(self.file_name() + ".idx"))

    def garbage_ratio(self) -> float:
        total = self.dat_size()
        if total <= SUPER_BLOCK_SIZE:
            return 0.0
        return self.nm.deleted_size() / total

    def max_file_key(self) -> int:
        return self.nm.metrics.maximum_file_key

    def set_readonly(self, ro: bool = True) -> None:
        with self._lock:
            self.readonly = ro

    def configure_replication(self, rp: ReplicaPlacement) -> None:
        """Rewrite the superblock's replica-placement byte in place
        (VolumeConfigure RPC, server/volume_grpc_admin.go:104): the
        volume's intended copy count changes; actual replica repair is
        volume.fix.replication's job afterward."""
        with self._lock:
            if self._dat is None:
                raise VolumeError(
                    f"volume {self.vid} is tiered to remote storage; "
                    f"its superblock cannot be reconfigured in place")
            self.super_block.replica_placement = rp
            pos = self._dat.tell()
            self._dat.seek(0)
            self._dat.write(self.super_block.to_bytes())
            self._dat.flush()
            os.fsync(self._dat.fileno())
            self._dat.seek(pos)

    def sync(self) -> None:
        with self._lock:
            if self._dat is not None:
                self._dat.flush()
                os.fsync(self._dat.fileno())
            # The .idx is fsynced alongside the .dat: a sync() caller
            # (EC generate, volume copy, tiering) must get a pair of
            # files that agree after a crash, not data without index.
            self.nm.sync()

    def close(self) -> None:
        self._closed = True
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=5)
            self._worker = None
        # Fail any request that raced past the shutdown sentinel.
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = VolumeError(f"volume {self.vid} is closed")
                req.done.set()
        with self._lock:
            try:
                if self._dat is not None:
                    self._dat.flush()
                    self._dat.close()
                elif self.remote_file is not None:
                    self.remote_file.close()
            except ValueError:
                pass
            self.nm.close()
            if self.rlog is not None:
                self.rlog.close()
