"""Persistent filer meta log: segmented append-only event journal.

Reference: weed/filer/filer_notify.go (every mutation appended to a
LogBuffer and persisted into dated segment files under
``/topics/.system/log``; SubscribeMetadata replays persisted segments
then tails the live buffer, filer_notify.go:18-143) and
weed/util/log_buffer/log_buffer.go:24-50 (the in-memory tail).

TPU-first deviation: the reference stores its log *inside SeaweedFS
itself*; we journal to local JSONL segment files named by the first
event timestamp, which keeps replay a pure host-side scan (no blob-store
round trips on the subscription hot path) while preserving the same
replay-then-tail contract.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterable

SEGMENT_MAX_BYTES = 8 * 1024 * 1024


class MetaLog:
    """Append-only, timestamp-ordered event journal.

    Events are plain dicts with a monotone ``ts_ns`` key.  Disk layout:
    ``<dir>/<first_ts_ns>.meta.jsonl`` segments, rotated by size.  When
    ``directory`` is None the log is memory-only (ring buffer), which is
    the single-process test configuration.
    """

    def __init__(self, directory: str | None = None,
                 capacity: int = 4096,
                 segment_max_bytes: int = SEGMENT_MAX_BYTES):
        self.dir = directory
        self.capacity = capacity
        self.segment_max_bytes = segment_max_bytes
        self._lock = threading.RLock()
        self._ring: list[dict] = []
        self._seg_file = None
        self._seg_size = 0
        self._last_ts = 0
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            self._truncate_torn_tail()
            self._last_ts = self._scan_last_ts()

    def _truncate_torn_tail(self) -> None:
        """Drop a partial trailing line from the newest segment once at
        open.  A crash mid-append leaves the segment ending in a torn
        JSONL line; left in place it poisons replay for every event the
        process appends *after* it (the new events land behind the torn
        bytes, and a line-oriented reader that trips on the tear can
        never reach them).  Same open-time repair stance as the volume
        needle-log and replication-log recovery paths."""
        segs = self._segments()
        if not segs:
            return
        path = os.path.join(self.dir, segs[-1])
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return
        if not data:
            return
        end = len(data)
        # Step 1: an unterminated final line is torn by definition.
        last_nl = data.rfind(b"\n", 0, end)
        if last_nl != end - 1:
            end = last_nl + 1  # 0 when the file has no newline at all
        # Step 2: step back over terminated-but-unparseable tail lines
        # (fsync ordering can persist the newline without the payload).
        # Bad lines *surrounded by* good ones are left for read_since
        # to skip individually — truncation only ever eats the tail.
        while end > 0:
            prev_nl = data.rfind(b"\n", 0, end - 1)
            line = data[prev_nl + 1:end - 1]
            if not line.strip():
                end = prev_nl + 1
                continue
            try:
                json.loads(line)
                break
            except json.JSONDecodeError:
                end = prev_nl + 1
        if end < len(data):
            with open(path, "r+b") as f:
                f.truncate(end)

    def _scan_last_ts(self) -> int:
        """Newest persisted ts_ns: last parseable line of the newest
        segment (cheap — one file, not a full journal replay)."""
        for name in reversed(self._segments()):
            last = 0
            try:
                with open(os.path.join(self.dir, name), "rb") as f:
                    for raw in f:
                        try:
                            last = json.loads(raw)["ts_ns"]
                        except (json.JSONDecodeError, KeyError):
                            continue
            except OSError:
                continue
            if last:
                return last
        return 0

    # -- write ---------------------------------------------------------------

    def append(self, event: dict) -> int:
        """Append and return the (possibly adjusted) ts_ns.

        ts_ns is forced strictly increasing (topic_log's max(now, last+1)
        rule): subscribers page with a strict `> since_ns` cursor, so two
        events sharing a boundary timestamp would be silently skipped
        between pages.  The dict is adjusted in place so the caller can
        propagate the final timestamp to live subscribers.
        """
        with self._lock:
            if event["ts_ns"] <= self._last_ts:
                event["ts_ns"] = self._last_ts + 1
            self._last_ts = event["ts_ns"]
            self._ring.append(event)
            if len(self._ring) > self.capacity:
                self._ring = self._ring[-self.capacity:]
            if self.dir is None:
                return event["ts_ns"]
            line = json.dumps(event, separators=(",", ":")) + "\n"
            data = line.encode()
            if self._seg_file is None or \
                    self._seg_size + len(data) > self.segment_max_bytes:
                self._rotate(event["ts_ns"])
            self._seg_file.write(data)
            self._seg_file.flush()
            self._seg_size += len(data)
            return event["ts_ns"]

    def _rotate(self, first_ts_ns: int) -> None:
        if self._seg_file is not None:
            self._seg_file.close()
        path = os.path.join(self.dir, f"{first_ts_ns:020d}.meta.jsonl")
        self._seg_file = open(path, "ab")
        self._seg_size = 0

    # -- read ----------------------------------------------------------------

    def _segments(self) -> list[str]:
        if self.dir is None or not os.path.isdir(self.dir):
            return []
        return sorted(f for f in os.listdir(self.dir)
                      if f.endswith(".meta.jsonl"))

    def read_since(self, since_ns: int, limit: int = 10000) -> list[dict]:
        """All events with ts_ns > since_ns, oldest first.

        Reads persisted segments (skipping whole segments older than
        since_ns via the filename timestamp — the reference's
        ReadPersistedLogBuffer binary-searches dated files the same way)
        and falls through to the in-memory ring for anything newer than
        the last persisted byte.
        """
        with self._lock:
            ring = list(self._ring)
        out: list[dict] = []
        segs = self._segments()
        # A segment may contain events newer than its name suggests only
        # forward in time, so keep every segment whose *successor* starts
        # after since_ns.
        keep: list[str] = []
        for i, name in enumerate(segs):
            nxt = int(segs[i + 1].split(".")[0]) if i + 1 < len(segs) \
                else None
            if nxt is None or nxt > since_ns:
                keep.append(name)
        ring_first = ring[0]["ts_ns"] if ring else None
        for name in keep:
            try:
                f = open(os.path.join(self.dir, name), "rb")
            except OSError:
                continue
            with f:
                for raw in f:
                    if not raw.strip():
                        continue
                    try:
                        ev = json.loads(raw)
                    except json.JSONDecodeError:
                        # Skip only the bad line: a mid-segment tear
                        # must not eat every event after it (the
                        # old per-segment except did exactly that).
                        continue
                    if ev["ts_ns"] <= since_ns:
                        continue
                    if ring_first is not None and \
                            ev["ts_ns"] >= ring_first:
                        break  # rest is covered by the ring
                    out.append(ev)
                    if len(out) >= limit:
                        return out
        for ev in ring:
            if ev["ts_ns"] > since_ns:
                out.append(ev)
                if len(out) >= limit:
                    break
        return out

    def iter_all(self) -> Iterable[dict]:
        return self.read_since(0, limit=1 << 62)

    def last_ts_ns(self) -> int:
        with self._lock:
            return self._last_ts

    def close(self) -> None:
        with self._lock:
            if self._seg_file is not None:
                self._seg_file.close()
                self._seg_file = None
