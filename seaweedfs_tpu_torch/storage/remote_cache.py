"""Process-global read-through block cache for tiered volume reads.

A tiered volume's needle reads turn into ranged GETs against the remote
backend (weed/storage/backend/s3_backend does the same proxying).  The
per-RemoteFile OrderedDict this replaces had two problems at fleet
scale: the budget was per-file (1000 tiered volumes × 32 blocks = an
unbounded 32GB), and two concurrent readers of the same cold block each
paid a backend round-trip.  This cache is shared by every RemoteFile in
the process, bounded in BYTES (`-tier.cache.mb`), and singleflights per
block: the first reader fetches, everyone else waits on its Event and
then reads the cached block — a hot tiered needle costs ONE backend
fetch.

The cache also keeps the per-volume read clock the promotion policy
needs: `record_read` timestamps every tiered read per (spec, key), and
`hits_in_window` answers "how many reads in the last W seconds" so the
volume server can schedule a `tier_download` for a tiered volume that
turned hot again.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from ..fault import registry as _fault
from ..stats.sketch import WindowedSketch

# A follower waiting on another thread's in-flight fetch bounds its wait
# so a wedged leader (WAN partition mid-GET) can never wedge every
# reader of the block behind it.
SINGLEFLIGHT_WAIT = 30.0

# Reads queued behind the most recent PROMOTE_KEEP timestamps per key
# are enough for any plausible hits-in-window policy; older ones are
# outside every window anyway.
_PROMOTE_KEEP = 256


class RemoteBlockCache:
    """Bounded-bytes LRU of remote blocks, keyed (spec, key, block_idx),
    with per-block singleflight."""

    def __init__(self, max_bytes: int = 64 << 20):
        self._lock = threading.Lock()
        self.max_bytes = max_bytes
        self._blocks: OrderedDict[tuple, bytes] = OrderedDict()
        self._bytes = 0
        self._inflight: dict[tuple, threading.Event] = {}
        # Served-byte counters at pread granularity: a re-read of a
        # cached needle counts its full size as hit bytes, which is
        # what "second pass is free" means operationally.
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.evictions = 0
        self.fetch_latency = WindowedSketch(window=300.0)
        self._reads: dict[tuple[str, str], deque] = {}

    def configure(self, max_bytes: int) -> None:
        with self._lock:
            self.max_bytes = max(0, int(max_bytes))
            self._evict_locked()

    # -- block path ------------------------------------------------------

    def get_block(self, backend, key: str, idx: int, lo: int,
                  n: int) -> tuple[bytes, bool]:
        """Return (block bytes, served_from_cache).  Exactly one caller
        fetches a missing block; concurrent callers wait for it."""
        ck = (backend.spec, key, idx)
        while True:
            with self._lock:
                blk = self._blocks.get(ck)
                if blk is not None:
                    self._blocks.move_to_end(ck)
                    return blk, True
                ev = self._inflight.get(ck)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[ck] = ev
                    break  # we are the leader
            # Follower: bounded wait, then re-check.  If the leader
            # failed (event set, block absent) the loop elects a new
            # leader instead of failing everyone on one bad fetch.
            ev.wait(SINGLEFLIGHT_WAIT)
        try:
            if _fault.ARMED:
                _fault.hit("tier.read", key=key, spec=backend.spec)
            t0 = time.perf_counter()
            blk = backend.read_range(key, lo, n)
            self.fetch_latency.observe(time.perf_counter() - t0)
            # Read-through block fetches are remote-tier wire traffic
            # outside the rpc plane: feed the flow ledger directly.
            from ..stats import flows as _flows
            _flows.LEDGER.note("tier.down", "in", len(blk),
                               peer=backend.spec, peer_role="remote")
        except BaseException:
            with self._lock:
                self._inflight.pop(ck, None)
            ev.set()
            raise
        with self._lock:
            self._blocks[ck] = blk
            self._blocks.move_to_end(ck)
            self._bytes += len(blk)
            self._evict_locked()
            self._inflight.pop(ck, None)
        ev.set()
        return blk, False

    def _evict_locked(self) -> None:
        while self._bytes > self.max_bytes and self._blocks:
            _, old = self._blocks.popitem(last=False)
            self._bytes -= len(old)
            self.evictions += 1

    def drop_file(self, spec: str, key: str) -> None:
        """Invalidate every cached block of one remote object (called
        when a volume promotes back to local disk — the remote copy may
        be deleted and must not shadow local reads)."""
        with self._lock:
            stale = [ck for ck in self._blocks
                     if ck[0] == spec and ck[1] == key]
            for ck in stale:
                self._bytes -= len(self._blocks.pop(ck))
            self._reads.pop((spec, key), None)

    # -- accounting ------------------------------------------------------

    def record_served(self, nbytes: int, hit: bool) -> None:
        with self._lock:
            if hit:
                self.hit_bytes += nbytes
            else:
                self.miss_bytes += nbytes
        from ..stats import metrics as _metrics
        if hit:
            _metrics.tier_cache_hit_bytes_total.inc(nbytes)
        else:
            _metrics.tier_cache_miss_bytes_total.inc(nbytes)

    def record_read(self, spec: str, key: str,
                    now: float | None = None) -> None:
        """Timestamp one tiered read of (spec, key) for the promotion
        window."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            dq = self._reads.get((spec, key))
            if dq is None:
                dq = self._reads[(spec, key)] = deque(
                    maxlen=_PROMOTE_KEEP)
            dq.append(now)

    def hits_in_window(self, spec: str, key: str, window: float,
                       now: float | None = None) -> int:
        if now is None:
            now = time.monotonic()
        with self._lock:
            dq = self._reads.get((spec, key))
            if not dq:
                return 0
            return sum(1 for ts in dq if now - ts <= window)

    # -- introspection ---------------------------------------------------

    def used_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        with self._lock:
            blocks = len(self._blocks)
            used = self._bytes
            hit_b, miss_b = self.hit_bytes, self.miss_bytes
            evictions = self.evictions

        def _ms(q: float) -> float:
            v = self.fetch_latency.quantile(q)
            return round(v * 1000, 3) if v is not None else 0.0

        return {
            "max_bytes": self.max_bytes,
            "used_bytes": used,
            "blocks": blocks,
            "hit_bytes": hit_b,
            "miss_bytes": miss_b,
            "evictions": evictions,
            "fetch_ms": {"p50": _ms(0.5), "p99": _ms(0.99)},
        }

    def reset(self) -> None:
        """Test hook: empty the cache and zero the counters."""
        with self._lock:
            self._blocks.clear()
            self._bytes = 0
            self._inflight.clear()
            self.hit_bytes = 0
            self.miss_bytes = 0
            self.evictions = 0
            self._reads.clear()
            self.fetch_latency = WindowedSketch(window=300.0)


CACHE = RemoteBlockCache()
