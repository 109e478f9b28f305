"""Per-tenant usage accounting: live counters on the data roles, a
master-side rollup, and a durable snapshot so restarts don't zero
usage.

`TenantUsage` lives on every volume server and filer: stored bytes and
object counts per (tenant, collection), plus short-window rate meters
(req/s, read/write bytes/s).  Writes increment at the moment data
lands; deletes decrement; a whole-volume teardown (TTL purge, lifecycle
vacuum, volume delete) subtracts that volume's per-tenant contribution
via the per-volume sub-ledger.  Volume servers report ABSOLUTE values
on every heartbeat — idempotent, so a dropped beat or a master
failover never double-counts.

`UsageRollup` is the master side: per-node reports merged into cluster
totals, persisted to `<meta_dir>/tenants.json` on a cadence.  After a
master restart the snapshot answers quota checks until heartbeats
repopulate the live view — without it, a freshly restarted master
would hand out assigns to tenants already over quota.
"""

from __future__ import annotations

import json
import os
import threading
import time


class RateMeter:
    """Sliding-window event rate: `note(n)` adds n events, `rate()` is
    events/second over the last `window` seconds (bucketed per second,
    so memory is O(window))."""

    __slots__ = ("window", "_buckets", "_lock")

    def __init__(self, window: int = 10):
        self.window = window
        self._buckets: dict[int, float] = {}
        self._lock = threading.Lock()

    def note(self, n: float = 1.0) -> None:
        now = int(time.monotonic())
        with self._lock:
            self._buckets[now] = self._buckets.get(now, 0.0) + n
            if len(self._buckets) > self.window + 1:
                floor = now - self.window
                for ts in [t for t in self._buckets if t < floor]:
                    del self._buckets[ts]

    def rate(self) -> float:
        now = int(time.monotonic())
        floor = now - self.window
        with self._lock:
            total = sum(n for ts, n in self._buckets.items()
                        if ts >= floor)
        return total / self.window


class TenantUsage:
    """One data role's live per-(tenant, collection) ledger."""

    def __init__(self):
        self._lock = threading.Lock()
        # (tenant, collection) -> [bytes, objects]
        self._stored: dict[tuple[str, str], list[float]] = {}
        # vid -> (tenant, collection) -> [bytes, objects]: what a
        # whole-volume teardown must subtract.
        self._by_vid: dict[int, dict[tuple[str, str], list[float]]] = {}
        # tenant -> meters (requests, read bytes, written bytes).
        self._req: dict[str, RateMeter] = {}
        self._read_bw: dict[str, RateMeter] = {}
        self._write_bw: dict[str, RateMeter] = {}

    # -- stored usage --------------------------------------------------------

    def add(self, tenant: str, collection: str, nbytes: int,
            nobjects: int = 1, vid: int = 0) -> None:
        key = (tenant, collection)
        with self._lock:
            ent = self._stored.setdefault(key, [0.0, 0.0])
            ent[0] = max(0.0, ent[0] + nbytes)
            ent[1] = max(0.0, ent[1] + nobjects)
            if ent[0] == 0.0 and ent[1] == 0.0:
                del self._stored[key]
            if vid:
                vent = self._by_vid.setdefault(vid, {}) \
                    .setdefault(key, [0.0, 0.0])
                vent[0] = max(0.0, vent[0] + nbytes)
                vent[1] = max(0.0, vent[1] + nobjects)

    def remove(self, tenant: str, collection: str, nbytes: int,
               nobjects: int = 1, vid: int = 0) -> None:
        self.add(tenant, collection, -nbytes, -nobjects)
        if vid:
            with self._lock:
                vent = self._by_vid.get(vid, {}).get(
                    (tenant, collection))
                if vent is not None:
                    vent[0] = max(0.0, vent[0] - nbytes)
                    vent[1] = max(0.0, vent[1] - nobjects)

    def drop_volume(self, vid: int) -> None:
        """A volume died wholesale (TTL purge, lifecycle vacuum,
        /admin/delete_volume): subtract everything it still held."""
        with self._lock:
            ledger = self._by_vid.pop(vid, None)
        if not ledger:
            return
        for (tenant, collection), (nbytes, nobjects) in ledger.items():
            self.add(tenant, collection, -int(nbytes), -int(nobjects))

    # -- rates ---------------------------------------------------------------

    def note_request(self, tenant: str, read_bytes: int = 0,
                     written_bytes: int = 0) -> None:
        if not tenant:
            return
        with self._lock:
            req = self._req.setdefault(tenant, RateMeter())
            rd = self._read_bw.setdefault(tenant, RateMeter())
            wr = self._write_bw.setdefault(tenant, RateMeter())
        req.note(1.0)
        if read_bytes:
            rd.note(float(read_bytes))
        if written_bytes:
            wr.note(float(written_bytes))

    # -- views ---------------------------------------------------------------

    def heartbeat_view(self) -> list[dict]:
        """Absolute stored usage rows the heartbeat carries; empty list
        when this role has never seen a tenant (the hb field is then
        omitted entirely)."""
        with self._lock:
            return [{"tenant": t, "collection": c,
                     "bytes": int(b), "objects": int(o)}
                    for (t, c), (b, o) in sorted(self._stored.items())]

    def stored_totals(self) -> dict[str, dict]:
        """Per-tenant totals across collections (gauge callbacks)."""
        with self._lock:
            out: dict[str, dict] = {}
            for (t, c), (b, o) in self._stored.items():
                ent = out.setdefault(t, {"bytes": 0, "objects": 0})
                ent["bytes"] += int(b)
                ent["objects"] += int(o)
            return out

    def snapshot(self) -> dict:
        """/debug/tenants payload: stored rows + live rates."""
        tenants = sorted(set(self._req) | {t for t, _ in self._stored})
        return {"stored": self.heartbeat_view(),
                "rates": {t: {
                    "req_s": round(self._req[t].rate(), 3)
                    if t in self._req else 0.0,
                    "read_bps": round(self._read_bw[t].rate(), 1)
                    if t in self._read_bw else 0.0,
                    "write_bps": round(self._write_bw[t].rate(), 1)
                    if t in self._write_bw else 0.0}
                    for t in tenants}}

    def clear(self) -> None:
        with self._lock:
            self._stored.clear()
            self._by_vid.clear()
            self._req.clear()
            self._read_bw.clear()
            self._write_bw.clear()


class UsageRollup:
    """Master-side merge of per-node heartbeat reports, with a durable
    JSON snapshot under meta_dir (same neighborhood as seq.dat /
    raft.json).  Node reports are absolute, so update_node simply
    replaces that node's rows; totals re-aggregate on read."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        # node url -> list of {tenant, collection, bytes, objects}
        self._nodes: dict[str, list[dict]] = {}
        self._last_save = 0.0
        if path:
            self.load()

    def update_node(self, node: str, rows: list[dict]) -> None:
        with self._lock:
            if rows:
                self._nodes[node] = rows
            else:
                self._nodes.pop(node, None)

    def forget_node(self, node: str) -> None:
        """Goodbye/dead-sweep: hold the node's last report anyway — a
        drained node's data is still on disk until rebalanced, and
        dropping it would briefly un-exceed every quota.  Kept as an
        explicit no-op hook for a future rebalance-aware drop."""

    def totals(self) -> dict[str, dict]:
        """tenant -> {bytes, objects, collections: {name: {bytes,
        objects}}} summed across nodes (replicas count per copy, like
        the disk they occupy)."""
        with self._lock:
            nodes = {n: list(rows) for n, rows in self._nodes.items()}
        out: dict[str, dict] = {}
        for rows in nodes.values():
            for r in rows:
                t = r.get("tenant", "")
                if not t:
                    continue
                ent = out.setdefault(
                    t, {"bytes": 0, "objects": 0, "collections": {}})
                ent["bytes"] += int(r.get("bytes", 0))
                ent["objects"] += int(r.get("objects", 0))
                c = r.get("collection", "")
                cent = ent["collections"].setdefault(
                    c, {"bytes": 0, "objects": 0})
                cent["bytes"] += int(r.get("bytes", 0))
                cent["objects"] += int(r.get("objects", 0))
        return out

    def usage_for(self, tenant: str) -> tuple[int, int]:
        ent = self.totals().get(tenant)
        if ent is None:
            return (0, 0)
        return (ent["bytes"], ent["objects"])

    # -- durability ----------------------------------------------------------

    def save(self, force: bool = False,
             min_interval: float = 10.0) -> bool:
        """Write-through on a cadence (called from the heartbeat path);
        atomic rename so a crash mid-save keeps the old snapshot."""
        if not self.path:
            return False
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_save < min_interval:
                return False
            self._last_save = now
            doc = {"nodes": self._nodes, "saved_at": time.time()}
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        return True

    def load(self) -> None:
        if not self.path or not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return  # corrupt snapshot: start empty, heartbeats refill
        nodes = doc.get("nodes", {})
        if isinstance(nodes, dict):
            with self._lock:
                self._nodes = {str(n): list(rows)
                               for n, rows in nodes.items()
                               if isinstance(rows, list)}
