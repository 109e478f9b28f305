"""Heavy-hitter tracking: space-saving top-k sketches for hot volumes,
hot needles, and hot client IPs on the volume-server data path.

At scale the operationally decisive read-path signal is SKEW — which
volumes and needles are taking disproportionate traffic (the hot-volume
/ degraded-read-storm findings of arXiv:1309.0186) — because that is
what decides where a cache or a small-file pack pays off.
Counting every key exactly is unbounded; the space-saving algorithm
(Metwally et al.) keeps a fixed table of `capacity` counters:

- a tracked key increments its counter;
- an untracked key evicts the MINIMUM counter m and enters with
  count = m + 1, error = m.

Guarantees (asserted in tests/test_slo.py):

- EXACT when distinct keys <= capacity (error = 0 for every entry);
- otherwise every reported count overestimates its key's true count by
  at most its `error` field, and error <= min-counter <= N/capacity
  for N total offers — so under a skewed (Zipf) workload the true
  heavy hitters are always present and their counts are tight.

`HotKeyTracker` bundles the six sketches the volume server feeds
(volume/needle/client x read/write) behind one lock-free-read snapshot
for `/debug/hot` and the shell's `cluster.hot`.
"""

from __future__ import annotations

import threading
import time


class SpaceSaving:
    """Fixed-size heavy-hitter counter table (space-saving)."""

    __slots__ = ("capacity", "total", "_counts", "_lock")

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.total = 0
        # key -> [count, error]
        self._counts: dict[object, list[int]] = {}
        self._lock = threading.Lock()

    def offer(self, key, inc: int = 1) -> None:
        with self._lock:
            self.total += inc
            ent = self._counts.get(key)
            if ent is not None:
                ent[0] += inc
                return
            if len(self._counts) < self.capacity:
                self._counts[key] = [inc, 0]
                return
            # Evict the minimum counter; the newcomer inherits its
            # count as upper-bound error.  O(capacity) scan — at the
            # default 128 entries this is microseconds against a
            # ~100us request, and only paid once the table is full.
            victim = min(self._counts, key=lambda k: self._counts[k][0])
            m = self._counts.pop(victim)[0]
            self._counts[key] = [m + inc, m]

    def top(self, k: int = 16) -> list[dict]:
        """Top-k entries, largest first: {key, count, error}.  `count`
        overestimates the true count by at most `error`."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: kv[1][0], reverse=True)[:k]
            return [{"key": key, "count": c, "error": e}
                    for key, (c, e) in items]

    def count(self, key) -> tuple[int, int]:
        """(count, error) for one key; (0, 0) when untracked."""
        with self._lock:
            ent = self._counts.get(key)
            return (ent[0], ent[1]) if ent is not None else (0, 0)

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self.total = 0


# The dimensions the volume server tracks, and the two op classes.
# `client` is the ORIGINATING client (the filer forwards it on the
# proxy leg via X-Weed-Client, so /debug/hot names the real caller,
# not the filer's own IP); `tenant` is the resolved principal.
DIMENSIONS = ("volume", "needle", "client", "tenant")
OPS = ("read", "write")


class HotKeyTracker:
    """volume/needle/client/tenant x read/write space-saving sketches
    for one volume server; `snapshot()` is the /debug/hot payload."""

    def __init__(self, capacity: int = 128):
        self.capacity = capacity
        self.started = time.time()
        self._sketches = {(dim, op): SpaceSaving(capacity)
                          for dim in DIMENSIONS for op in OPS}

    def _offer(self, op: str, vid: int, key: int, client: str,
               tenant: str = "") -> None:
        self._sketches[("volume", op)].offer(vid)
        self._sketches[("needle", op)].offer(f"{vid},{key:x}")
        if client:
            self._sketches[("client", op)].offer(client)
        if tenant:
            self._sketches[("tenant", op)].offer(tenant)

    def read(self, vid: int, key: int, client: str = "",
             tenant: str = "") -> None:
        self._offer("read", vid, key, client, tenant)

    def write(self, vid: int, key: int, client: str = "",
              tenant: str = "") -> None:
        self._offer("write", vid, key, client, tenant)

    def snapshot(self, k: int = 16) -> dict:
        out: dict = {"capacity": self.capacity, "started": self.started,
                     "dimensions": {}}
        for dim in DIMENSIONS:
            out["dimensions"][dim] = {
                op: {"total": self._sketches[(dim, op)].total,
                     "top": self._sketches[(dim, op)].top(k)}
                for op in OPS}
        return out

    def clear(self) -> None:
        for sk in self._sketches.values():
            sk.clear()
        self.started = time.time()
