"""Per-partition message log: in-memory tail + filer segment files.

Reference: weed/messaging/broker/topic_manager.go (TopicControl wrapping
a util/log_buffer.LogBuffer) + broker_grpc_server_subscribe.go (replay
persisted filer files, then tail the live buffer).  Segments live in
the filer at /topics/<ns>/<topic>/<partition>/<first_ts>.seg as JSONL,
so any broker (or a restarted one) can replay history — the filer IS
the durable log.
"""

from __future__ import annotations

import base64
import json
import threading
import time

from ..filer.client import FilerProxy

FLUSH_BYTES = 1 << 20
FLUSH_SECONDS = 2.0


def partition_dir(namespace: str, topic: str, partition: int) -> str:
    return f"/topics/{namespace}/{topic}/{partition:04d}"


def encode_message(m: dict) -> dict:
    out = dict(m)
    if isinstance(out.get("value"), (bytes, bytearray)):
        out["value"] = base64.b64encode(bytes(out["value"])).decode()
        out["value_b64"] = True
    return out


def decode_message(m: dict) -> dict:
    out = dict(m)
    if out.pop("value_b64", False):
        out["value"] = base64.b64decode(out["value"])
    return out


class TopicPartitionLog:
    """One partition's log on one broker."""

    def __init__(self, filer: FilerProxy, namespace: str, topic: str,
                 partition: int, flush_bytes: int = FLUSH_BYTES,
                 flush_seconds: float = FLUSH_SECONDS):
        self.filer = filer
        self.dir = partition_dir(namespace, topic, partition)
        self.flush_bytes = flush_bytes
        self.flush_seconds = flush_seconds
        self._tail: list[dict] = []  # encoded messages, ts order
        self._tail_bytes = 0
        self._last_flush = time.monotonic()
        self._lock = threading.RLock()
        self._last_ts = 0
        self._history_scanned = False

    # -- write ---------------------------------------------------------------

    def append(self, key: str, value, headers: dict | None = None) -> int:
        with self._lock:
            ts = max(time.time_ns(), self._last_ts + 1)  # strictly
            self._last_ts = ts                           # increasing
            m = encode_message({"ts_ns": ts, "key": key, "value": value,
                                "headers": headers or {}})
            line = json.dumps(m, separators=(",", ":"))
            self._tail.append(m)
            self._tail_bytes += len(line)
            if self._tail_bytes >= self.flush_bytes or \
                    time.monotonic() - self._last_flush \
                    >= self.flush_seconds:
                self._flush_locked()
            return ts

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def maybe_flush(self) -> None:
        """Background-flusher entry: persist a tail that has aged past
        flush_seconds (appends alone only flush on the next append, so
        a quiet partition would otherwise hold its tail forever)."""
        with self._lock:
            if self._tail and time.monotonic() - self._last_flush \
                    >= self.flush_seconds:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._tail:
            self._last_flush = time.monotonic()
            return
        first_ts = self._tail[0]["ts_ns"]
        body = "\n".join(json.dumps(m, separators=(",", ":"))
                         for m in self._tail).encode() + b"\n"
        self.filer.put(f"{self.dir}/{first_ts:020d}.seg", body,
                       "application/x-ndjson")
        self._tail = []
        self._tail_bytes = 0
        self._last_flush = time.monotonic()

    # -- read ----------------------------------------------------------------

    def read_since(self, since_ns: int, limit: int = 1000) -> list[dict]:
        """Messages with ts_ns > since_ns: persisted segments first,
        then the in-memory tail (replay-then-tail)."""
        with self._lock:
            tail = list(self._tail)
        tail_first = tail[0]["ts_ns"] if tail else None
        out: list[dict] = []
        segs = sorted(e["name"] for e in self.filer.list_all(self.dir)
                      if e["name"].endswith(".seg"))
        # Skip whole segments older than since_ns via the next segment's
        # first-ts filename (same trick as the filer meta log).
        keep = []
        for i, name in enumerate(segs):
            nxt = int(segs[i + 1].split(".")[0]) if i + 1 < len(segs) \
                else None
            if nxt is None or nxt > since_ns:
                keep.append(name)
        for name in keep:
            with self.filer.get(f"{self.dir}/{name}") as resp:
                for raw in resp.read().splitlines():
                    if not raw.strip():
                        continue
                    m = json.loads(raw)
                    if m["ts_ns"] <= since_ns:
                        continue
                    if tail_first is not None and \
                            m["ts_ns"] >= tail_first:
                        break  # covered by the in-memory tail
                    out.append(decode_message(m))
                    if len(out) >= limit:
                        return out
        for m in tail:
            if m["ts_ns"] > since_ns:
                out.append(decode_message(m))
                if len(out) >= limit:
                    break
        return out

    def last_ts_ns(self) -> int:
        with self._lock:
            if self._last_ts or self._history_scanned:
                return self._last_ts
        # Cold partition (fresh broker): one full replay, memoized so
        # subscriber polls don't rescan every segment per request —
        # the scanned flag also memoizes the empty-partition answer.
        msgs = self.read_since(0, limit=1 << 30)
        last = msgs[-1]["ts_ns"] if msgs else 0
        with self._lock:
            self._history_scanned = True
            self._last_ts = max(self._last_ts, last)
            return self._last_ts
