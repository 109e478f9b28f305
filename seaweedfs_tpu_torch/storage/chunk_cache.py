"""Process-global read-through cache for filer chunk reads.

The per-ChunkStreamer OrderedDict this replaces had the same two
problems `remote_cache.py` solved for tiered volumes: the budget was
per-streamer (every FilerServer, shell command and test that built a
streamer got its own 64MB), and two concurrent readers of the same
cold chunk each paid a volume-server round-trip.  This cache is shared
by every streamer in the process, bounded in BYTES
(`-filer.cache.mb`), and singleflights per file_id: the first reader
fetches (and, for sealed chunks, decrypts — hits never re-pay the AES
pass), everyone else waits on its Event and then reads the cached
bytes.  A hot chunk — the volumes/needles `/debug/hot` names — costs
ONE downstream GET no matter how many requests land on it.

Packed small files (filer/packing.py) share a needle and therefore a
cache entry: one fetch of the pack warms every sibling file.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..stats.sketch import WindowedSketch

# Bounded follower wait, same rationale as remote_cache.py: a wedged
# leader (dead volume server mid-GET) must not wedge every reader of
# the chunk behind it — the loop re-checks and elects a new leader.
SINGLEFLIGHT_WAIT = 30.0


class FilerChunkCache:
    """Bounded-bytes LRU of opened (decrypted) chunk bytes, keyed by
    file_id, with per-chunk singleflight."""

    def __init__(self, max_bytes: int = 64 << 20):
        self._lock = threading.Lock()
        self.max_bytes = max_bytes
        self._chunks: OrderedDict[str, bytes] = OrderedDict()
        self._bytes = 0
        self._inflight: dict[str, threading.Event] = {}
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.evictions = 0
        self.fetch_latency = WindowedSketch(window=300.0)
        # Per-tenant byte cap (tenancy plane, 0 = disabled): one
        # tenant's working set may occupy at most this many cached
        # bytes, so a scan-heavy tenant evicts ITS OWN oldest chunks
        # instead of flushing everyone else's hot set.
        self.tenant_max_bytes = 0
        self._owners: dict[str, str] = {}       # file_id -> tenant
        self._tenant_bytes: dict[str, int] = {}
        self.tenant_evictions = 0

    def configure(self, max_bytes: int) -> None:
        with self._lock:
            self.max_bytes = max(0, int(max_bytes))
            self._evict_locked()

    def configure_tenant_cap(self, max_bytes: int) -> None:
        """-filer.cache.tenant.mb: uniform per-tenant occupancy cap."""
        with self._lock:
            self.tenant_max_bytes = max(0, int(max_bytes))
            for t in list(self._tenant_bytes):
                self._evict_tenant_locked(t, keep="")

    def get_or_fetch(self, file_id: str, fetch,
                     tenant: str = "") -> bytes:
        """Return the chunk bytes, fetching via `fetch()` at most once
        across concurrent callers.  `tenant` attributes the cache
        occupancy of a newly inserted chunk (first fetcher wins)."""
        while True:
            with self._lock:
                data = self._chunks.get(file_id)
                if data is not None:
                    self._chunks.move_to_end(file_id)
                    self.hit_bytes += len(data)
                    from ..stats import metrics as _metrics
                    _metrics.filer_chunk_cache_hit_bytes_total.inc(
                        len(data))
                    return data
                ev = self._inflight.get(file_id)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[file_id] = ev
                    break  # we are the leader
            ev.wait(SINGLEFLIGHT_WAIT)
        try:
            t0 = time.perf_counter()
            data = fetch()
            self.fetch_latency.observe(time.perf_counter() - t0)
        except BaseException:
            with self._lock:
                self._inflight.pop(file_id, None)
            ev.set()
            raise
        with self._lock:
            if file_id not in self._chunks:
                self._chunks[file_id] = data
                self._bytes += len(data)
                if tenant:
                    self._owners[file_id] = tenant
                    self._tenant_bytes[tenant] = \
                        self._tenant_bytes.get(tenant, 0) + len(data)
                    self._evict_tenant_locked(tenant, keep=file_id)
            self._chunks.move_to_end(file_id)
            self.miss_bytes += len(data)
            self._evict_locked()
            self._inflight.pop(file_id, None)
        from ..stats import metrics as _metrics
        _metrics.filer_chunk_cache_miss_bytes_total.inc(len(data))
        ev.set()
        return data

    def _drop_owner_locked(self, file_id: str, nbytes: int) -> None:
        t = self._owners.pop(file_id, "")
        if t:
            left = self._tenant_bytes.get(t, 0) - nbytes
            if left > 0:
                self._tenant_bytes[t] = left
            else:
                self._tenant_bytes.pop(t, None)

    def _evict_locked(self) -> None:
        while self._bytes > self.max_bytes and self._chunks:
            fid, old = self._chunks.popitem(last=False)
            self._bytes -= len(old)
            self._drop_owner_locked(fid, len(old))
            self.evictions += 1

    def _evict_tenant_locked(self, tenant: str, keep: str) -> None:
        """Tenant-first eviction: while `tenant` is over its cap, drop
        ITS oldest chunks (never `keep`, the one just inserted — a
        single over-cap chunk still gets cached once)."""
        if self.tenant_max_bytes <= 0:
            return
        while self._tenant_bytes.get(tenant, 0) > self.tenant_max_bytes:
            victim = next(
                (fid for fid in self._chunks
                 if fid != keep and self._owners.get(fid) == tenant),
                None)
            if victim is None:
                return
            old = self._chunks.pop(victim)
            self._bytes -= len(old)
            self._drop_owner_locked(victim, len(old))
            self.evictions += 1
            self.tenant_evictions += 1

    def invalidate(self, file_id: str) -> None:
        with self._lock:
            old = self._chunks.pop(file_id, None)
            if old is not None:
                self._bytes -= len(old)
                self._drop_owner_locked(file_id, len(old))

    # -- introspection ---------------------------------------------------

    def used_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def resident(self) -> list[list]:
        """[file id, bytes] of every cached chunk, least recently used
        first (the filer's /debug/cache?fids=1)."""
        with self._lock:
            return [[fid, len(data)] for fid, data in self._chunks.items()]

    def stats(self) -> dict:
        with self._lock:
            chunks = len(self._chunks)
            used = self._bytes
            hit_b, miss_b = self.hit_bytes, self.miss_bytes
            evictions = self.evictions
            tenant_rows = dict(self._tenant_bytes)
            tenant_cap = self.tenant_max_bytes
            tenant_evictions = self.tenant_evictions

        def _ms(q: float) -> float:
            v = self.fetch_latency.quantile(q)
            return round(v * 1000, 3) if v is not None else 0.0

        return {
            "max_bytes": self.max_bytes,
            "used_bytes": used,
            "chunks": chunks,
            "hit_bytes": hit_b,
            "miss_bytes": miss_b,
            "evictions": evictions,
            "fetch_ms": {"p50": _ms(0.5), "p99": _ms(0.99)},
            "tenant_max_bytes": tenant_cap,
            "tenant_evictions": tenant_evictions,
            "tenants": tenant_rows,
        }

    def reset(self) -> None:
        """Test hook: empty the cache and zero the counters."""
        with self._lock:
            self._chunks.clear()
            self._bytes = 0
            self._inflight.clear()
            self.hit_bytes = 0
            self.miss_bytes = 0
            self.evictions = 0
            self.fetch_latency = WindowedSketch(window=300.0)
            self.tenant_max_bytes = 0
            self._owners.clear()
            self._tenant_bytes.clear()
            self.tenant_evictions = 0


CACHE = FilerChunkCache()
