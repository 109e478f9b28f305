"""Durable per-volume replication change log: the `.rlog` sidecar.

The event journal (events/journal.py) is a bounded in-process ring — it
cannot survive a restart, so it cannot drive disaster recovery.  This
module is the durable change feed cross-cluster mirroring ships from: a
crash-safe append-only sidecar next to the volume's `.dat`, journaled
at the SAME commit points as the needle write (storage/volume.py), so
every acked mutation has a log record and shipping resumes exactly
where it stopped after a kill -9.

One record per committed mutation, fixed size (40 bytes):

    seq u64 | op u8 | pad3 | needle_id u64 | cookie u32 | size u32
    | ts_ns u64 | crc32c u32 (of the preceding 36 bytes)

- `seq` is contiguous and strictly increasing per volume — the
  receiver's idempotency key (with needle_id + cookie) and the unit the
  acked watermark counts in.  Fixed-size records + contiguous seqs make
  seek-by-seq pure arithmetic: no index sidecar for the sidecar.
- `op` is write / delete / vacuum-rewrite.  Deletes are first-class so
  tombstones always propagate (a delete must never resurrect — the
  same rule the repair path enforces); vacuum records document a
  log rewrite and keep the seq chain alive across compactions.
- Torn-tail tolerant like the `.dat` recovery (storage/scrub.py): on
  open, a trailing partial record is truncated and CRC-bad trailing
  records are stepped back over — a crash mid-append costs at most the
  unacked tail, never the log.

The remote-acked offset lives in a `.rwm` watermark sidecar (atomic
tmp+rename JSON, the `.qrt` ticket idiom) persisted only AFTER the
standby acknowledged a batch — a shipper restart re-reads it and
resumes from acked+1, re-sending at most one in-flight batch that the
receiver's own applied-seq watermark then no-ops.

Vacuum compaction (storage/vacuum.py) rewrites the log too: the acked
prefix is dropped (those records can never be shipped again) and a
vacuum record is appended so the log is never empty and the next seq
is recoverable from the file alone.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from dataclasses import dataclass

from ..core.crc import crc32c

# seq, op, pad3, needle_id, cookie, size, ts_ns  (+ trailing crc32c u32)
_REC = struct.Struct(">QB3xQIIQ")
_CRC = struct.Struct(">I")
RECORD_SIZE = _REC.size + _CRC.size  # 40

OP_WRITE, OP_DELETE, OP_VACUUM = 1, 2, 3
OP_NAMES = {OP_WRITE: "write", OP_DELETE: "delete", OP_VACUUM: "vacuum"}


@dataclass(frozen=True)
class LogRecord:
    seq: int
    op: int
    needle_id: int
    cookie: int
    size: int
    ts_ns: int

    def to_bytes(self) -> bytes:
        head = _REC.pack(self.seq, self.op, self.needle_id,
                         self.cookie, self.size, self.ts_ns)
        return head + _CRC.pack(crc32c(head))

    @classmethod
    def from_bytes(cls, buf: bytes) -> "LogRecord | None":
        """Parse one record; None when the CRC disagrees (torn tail)."""
        if len(buf) < RECORD_SIZE:
            return None
        head = buf[:_REC.size]
        if crc32c(head) != _CRC.unpack_from(buf, _REC.size)[0]:
            return None
        seq, op, needle_id, cookie, size, ts_ns = _REC.unpack(head)
        return cls(seq, op, needle_id, cookie, size, ts_ns)


class Watermark:
    """Durable monotonic seq checkpoint (atomic tmp+rename JSON).

    Used on both ends of the wire: `.rwm` on the primary records the
    highest seq the standby ACKED (persisted only after the ack, so a
    crash re-ships rather than skips), `.rap` on the standby records
    the highest seq APPLIED (persisted before the ack, so a replayed
    batch is a no-op instead of a resurrection)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        try:
            with open(path) as f:
                self._value = int(json.load(f).get("seq", 0))
        except (OSError, ValueError):
            self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def set(self, seq: int) -> None:
        """Advance (never regress) and persist durably."""
        with self._lock:
            if seq <= self._value:
                return
            self._value = seq
            tmp = f"{self.path}.{os.getpid()}.tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump({"seq": seq}, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
            except OSError:
                pass  # re-ship on restart, never skip

    def remove(self) -> None:
        with self._lock:
            self._value = 0
            try:
                os.remove(self.path)
            except OSError:
                pass


class ReplicationLog:
    """The append-only `.rlog` + its `.rwm` acked watermark.

    Thread-safe; append() is called from inside the volume's locked
    commit sections while read_from()/set_acked() run on the shipper
    daemon thread."""

    OP_WRITE, OP_DELETE, OP_VACUUM = OP_WRITE, OP_DELETE, OP_VACUUM

    def __init__(self, base: str):
        self.path = base + ".rlog"
        self.watermark = Watermark(base + ".rwm")
        self._lock = threading.Lock()
        self.first_seq = 0  # seq of the record at file offset 0
        self.last_seq = 0
        self._open_recovered()

    # -- crash-safe open ----------------------------------------------------

    def _open_recovered(self) -> None:
        """Open the log, truncating a torn tail like the .dat recovery:
        drop a trailing partial record, then step back over CRC-bad
        trailing records until a good one (or the head) is reached."""
        mode = "r+b" if os.path.exists(self.path) else "w+b"
        self._f = open(self.path, mode)
        self._f.seek(0, os.SEEK_END)
        keep = self._f.tell() - self._f.tell() % RECORD_SIZE
        while keep > 0:
            self._f.seek(keep - RECORD_SIZE)
            if LogRecord.from_bytes(self._f.read(RECORD_SIZE)) is not None:
                break
            keep -= RECORD_SIZE
        self._f.truncate(keep)
        if keep:
            self._f.seek(0)
            head = LogRecord.from_bytes(self._f.read(RECORD_SIZE))
            self._f.seek(keep - RECORD_SIZE)
            tail = LogRecord.from_bytes(self._f.read(RECORD_SIZE))
            if head is None or tail is None:
                # A rotten head breaks seq arithmetic for the whole
                # file: reset, resuming the seq chain from the acked
                # watermark (unacked tail records are lost, which the
                # shipper surfaces as a gap it cannot re-ship — the
                # same contract as losing the disk they lived on).
                self._f.truncate(0)
                self.first_seq = self.last_seq = 0
            else:
                self.first_seq, self.last_seq = head.seq, tail.seq
        self._f.seek(0, os.SEEK_END)
        if self.last_seq == 0:
            self.last_seq = self.watermark.value

    # -- append (volume commit points) --------------------------------------

    def append(self, op: int, needle_id: int, cookie: int,
               size: int, ts_ns: int | None = None) -> int:
        """Journal one committed mutation; returns its seq.  Flushes to
        the OS (like the .dat write path); call sync() for the fsync'd
        commit points."""
        if ts_ns is None:
            import time
            ts_ns = time.time_ns()
        with self._lock:
            seq = self.last_seq + 1
            rec = LogRecord(seq, op, needle_id, cookie, size, ts_ns)
            self._f.write(rec.to_bytes())
            self._f.flush()
            if self.first_seq == 0:
                self.first_seq = seq
            self.last_seq = seq
            return seq

    def sync(self) -> None:
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    # -- shipper side --------------------------------------------------------

    @property
    def acked_seq(self) -> int:
        return self.watermark.value

    def set_acked(self, seq: int) -> None:
        self.watermark.set(seq)

    def pending(self) -> int:
        return max(0, self.last_seq - self.acked_seq)

    def read_from(self, seq: int, limit: int = 128) -> list[LogRecord]:
        """Up to `limit` records starting at `seq` (seek is arithmetic:
        fixed-size records, contiguous seqs)."""
        with self._lock:
            if self.first_seq == 0 or seq > self.last_seq:
                return []
            seq = max(seq, self.first_seq)
            off = (seq - self.first_seq) * RECORD_SIZE
            n = min(limit, self.last_seq - seq + 1)
            buf = os.pread(self._f.fileno(), n * RECORD_SIZE, off)
        out = []
        for i in range(len(buf) // RECORD_SIZE):
            rec = LogRecord.from_bytes(
                buf[i * RECORD_SIZE:(i + 1) * RECORD_SIZE])
            if rec is None:
                break  # torn tail raced in; ship what checks out
            out.append(rec)
        return out

    # -- compaction (vacuum) -------------------------------------------------

    def compact(self) -> int:
        """Drop the acked prefix (those records can never need
        re-shipping) and append a vacuum record so the log is never
        empty and the seq chain stays recoverable from the file alone.
        Atomic rewrite (tmp + os.replace) like the .dat swap.  Returns
        the number of records dropped."""
        import time
        with self._lock:
            acked = self.watermark.value
            if self.first_seq == 0:
                start = self.last_seq + 1
            else:
                start = max(self.first_seq, acked + 1)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            dropped = start - self.first_seq if self.first_seq else 0
            with open(tmp, "wb") as f:
                if self.first_seq and start <= self.last_seq:
                    off = (start - self.first_seq) * RECORD_SIZE
                    n = self.last_seq - start + 1
                    f.write(os.pread(self._f.fileno(),
                                     n * RECORD_SIZE, off))
                seq = self.last_seq + 1
                f.write(LogRecord(seq, OP_VACUUM, 0, 0, 0,
                                  time.time_ns()).to_bytes())
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "r+b")
            self._f.seek(0, os.SEEK_END)
            self.first_seq = start if start <= self.last_seq else seq
            self.last_seq = seq
            return max(0, dropped)

    # -- lifecycle -----------------------------------------------------------

    def status(self) -> dict:
        return {"first_seq": self.first_seq, "last_seq": self.last_seq,
                "acked_seq": self.acked_seq, "pending": self.pending()}

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                self._f.close()
            except (OSError, ValueError):
                pass
