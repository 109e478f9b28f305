"""Cross-cluster async replication shipper: tail `.rlog`s, ship batches.

The volume server owns one ReplicationShipper when `-replicate.peer`
names a standby cluster's master.  Each tick it walks the local
volumes (optionally filtered to `-replicate.collections`), enables the
durable change log on any that lack one, and ships the unacked tail of
each log as one batch:

- WRITE records carry the raw CRC-gated needle record bytes
  (Volume.read_needle_blob — the same blob `/admin/needle_raw` serves
  to the self-healing plane), so the standby stores byte-identical
  records.  A needle vacuumed or superseded since its log record was
  written ships blobless; the receiver no-ops it and a later record
  for the same needle converges the pair.
- DELETE records always ship: tombstones must propagate (a delete must
  never resurrect — the self-healing repair rule, now cross-cluster).
- The batch POSTs to the standby volume server resolved through the
  peer master's `/dir/lookup` (falling back to any live peer node for
  a volume the standby doesn't host yet), on the low-priority internal
  lane, breaker-guarded and retry-policied like every other WAN-shaped
  path (cluster/resilience.py).  Safe to retry: the receiver applies
  idempotently by seq against its own durable applied watermark.
- Only after the standby acks `{"acked_seq": N}` does the local `.rwm`
  watermark advance — a kill -9 anywhere re-ships at most one batch,
  which the receiver no-ops.

WAN fault points on the ship path (`wan.partition`, `wan.delay`,
`wan.duplicate`, `wan.reorder` — fault/registry.py) shape the chaos
suite; the `wan.duplicate` hook makes the shipper send the SAME batch
twice and the `wan.reorder` hook delivers batch n+1 BEFORE batch n, so
duplicate and out-of-order delivery are first-class tested scenarios,
not accidents.

Geo active/active (replication/lease.py): when the owning volume
server carries a `-geo.cluster.id`, the shipper runs keyed by lease
ownership — it ships only volumes whose `.lease` sidecar names THIS
cluster (the peer's shipper covers the opposite direction), stamps
every batch with `(cluster_id, epoch)` so the receiver can fence stale
holders, and adopts the receiver's lease on a 409 (a fenced old holder
demotes itself on heal).  `-replicate.compress` zlib-compresses the
record list; the receiver acks with per-batch raw/wire byte counts and
the compressed bytes are what the `rlog.ship` flow purpose meters, so
`-flows.budget rlog.ship=...` governs actual WAN spend.

The port's copy of `seaweedfs_tpu/replication/shipper.py`.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import zlib

from ..cluster import resilience, rpc
from ..events import emit as emit_event
from ..fault import registry as _fault
from ..stats import flows as _flows
from ..stats.metrics import (replication_lag_seconds,
                             replication_lag_seconds_total,
                             replication_resends_total,
                             replication_shipped_bytes_total)
from ..storage.volume import VolumeError
from ..trace import root_span
from .rlog import OP_WRITE

_TARGET_TTL = 60.0


class ReplicationShipper:
    """Background daemon tailing every mirrored volume's `.rlog`."""

    def __init__(self, store, peer: str, node: str = "",
                 collections: str = "", interval: float = 0.5,
                 batch_records: int = 128, cluster_id: str = "",
                 compress: bool = False, leases=None):
        self.store = store
        self.peer = peer if peer.startswith("http") else f"http://{peer}"
        self.node = node
        # Geo identity + the lease table that keys shipping direction
        # (replication/lease.py); both empty/None = plain
        # active/passive mode (ship everything, unfenced).
        self.cluster_id = cluster_id
        self.leases = leases
        self.compress = compress
        # Cumulative ship accounting (raw vs wire bytes): the
        # compressed-vs-raw WAN spend number /debug/replication and
        # the geo bench report.
        self.shipped = {"batches": 0, "records": 0,
                        "raw_bytes": 0, "wire_bytes": 0}
        # Per-collection opt-in: empty = mirror everything; the
        # default collection opts in as "" (spelled `default` too).
        names = {c.strip() for c in collections.split(",") if c.strip()}
        self.collections = {("" if c == "default" else c)
                            for c in names} or None
        self.interval = interval
        self.batch_records = batch_records
        self.paused = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        # vid -> (expires_at, "host:port") standby target cache,
        # invalidated on send failure so a rebalanced standby re-resolves.
        self._targets: dict[int, tuple[float, str]] = {}
        self._lag: dict[int, dict] = {}
        self._lag_lock = threading.Lock()
        self._policy = resilience.RetryPolicy(
            max_attempts=3, per_attempt_timeout=10.0,
            total_deadline=20.0)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="replication-shipper")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def kick(self) -> None:
        """Ship now instead of waiting out the tick (tests, cutover)."""
        self._wake.set()

    def _loop(self) -> None:
        # Flow identity for this daemon thread (several servers can
        # share a test process; outbound batches must attribute to
        # THIS volume server, not the process default).
        _flows.bind_thread(self.node, "volume")
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            # root_span: ship/ack/lag events journaled from this
            # daemon must carry the trace of the tick that caused them.
            with root_span("replication.tick", "replication"):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — peer down: the
                    pass           # watermark holds; next tick resumes

    # -- shipping ------------------------------------------------------------

    def _volumes(self):
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                if v.remote_file is not None:
                    continue  # tiered: readonly, nothing journals
                if self.collections is not None and \
                        (v.collection or "") not in self.collections:
                    continue
                yield v

    def tick(self) -> None:
        for v in self._volumes():
            if self.leases is not None and \
                    not self.leases.ships(v.vid):
                # The lease names the PEER as holder: its shipper
                # covers this volume in the opposite direction, and
                # shipping our (fenced, apply-only) copy back would
                # be rejected traffic at best.
                continue
            if v.rlog is None:
                v.enable_rlog()
            try:
                self._ship_volume(v)
            except (OSError, rpc.RpcError, VolumeError):
                continue  # per-volume isolation: one sick pair must
                #           not starve the others' shipping

    def _ship_volume(self, v) -> None:
        rlog = v.rlog
        self._observe_lag(v.vid, rlog)
        if self.paused:
            return
        while rlog.pending() > 0 and not self._stop.is_set():
            recs = rlog.read_from(rlog.acked_seq + 1, self.batch_records)
            if not recs:
                return
            body, nbytes = self._encode_batch(v, recs)
            target = self._resolve_target(v.vid)
            if target is None:
                return
            if _fault.ARMED:
                self._maybe_reorder(v, rlog, recs, target)
            t0 = time.perf_counter()
            try:
                out = self._post(target, v.vid, body)
            except rpc.RpcError as e:
                if e.status == 409:
                    # The receiver's fencing plane spoke: a holder
                    # with a newer epoch exists.  Adopt its lease (a
                    # partitioned old holder demotes on heal) and stop
                    # shipping this volume.
                    self._fence_from_peer(v.vid, target, e.message)
                    return
                self._targets.pop(v.vid, None)  # re-resolve next tick
                raise
            except Exception:
                self._targets.pop(v.vid, None)  # re-resolve next tick
                raise
            acked = int(out.get("acked_seq", 0))
            if acked > rlog.acked_seq:
                rlog.set_acked(acked)
            replication_shipped_bytes_total.inc(nbytes)
            raw_b = int(out.get("raw_bytes", 0) or 0)
            wire_b = int(out.get("wire_bytes", 0) or 0)
            self.shipped["batches"] += 1
            self.shipped["records"] += len(recs)
            self.shipped["raw_bytes"] += raw_b or nbytes
            self.shipped["wire_bytes"] += wire_b or nbytes
            emit_event("replication.ship", node=self.node, vid=v.vid,
                       peer=target, records=len(recs), bytes=nbytes,
                       first_seq=recs[0].seq, last_seq=recs[-1].seq,
                       seconds=round(time.perf_counter() - t0, 6))
            emit_event("replication.ack", node=self.node, vid=v.vid,
                       peer=target, acked_seq=acked,
                       applied=out.get("applied", 0),
                       skipped=out.get("skipped", 0),
                       raw_bytes=raw_b, wire_bytes=wire_b)
            self._observe_lag(v.vid, rlog)

    def _maybe_reorder(self, v, rlog, recs, target: str) -> None:
        """`wan.reorder` chaos hook: deliver batch n+1 BEFORE batch n.
        The receiver must refuse the gapped batch WITHOUT acking it —
        accepting would advance its watermark past batch n's seqs and
        those records would be skipped as duplicates forever.  The
        refusal is swallowed here; the normal loop then ships n and
        n+1 in order and everything converges."""
        try:
            _fault.hit("wan.reorder", peer=target, vid=v.vid)
        except _fault.FaultInjected:
            nxt = rlog.read_from(recs[-1].seq + 1, self.batch_records)
            if not nxt:
                return  # nothing after batch n: no reorder to inject
            nbody, _nb = self._encode_batch(v, nxt)
            replication_resends_total.inc(reason="reorder")
            try:
                self._post(target, v.vid, nbody)
            except rpc.RpcError:
                pass  # the receiver refused the gap — the invariant

    def _fence_from_peer(self, vid: int, target: str,
                         detail: str) -> None:
        """Adopt the receiver's lease after a 409: fetch its
        `.lease` row and fence our own table forward (monotonic, so a
        racing local acquire at a higher epoch still wins)."""
        row = None
        try:
            doc = rpc.call(
                f"http://{target}/admin/lease/status?volume={vid}")
            row = (doc.get("leases") or {}).get(str(vid))
        except Exception:  # noqa: BLE001 — peer gone mid-fence: the
            pass           # 409 will recur and we retry then
        if row and self.leases is not None:
            self.leases.fence(vid, str(row["cluster_id"]),
                              int(row["epoch"]))
            emit_event("lease.fence", node=self.node, severity="warn",
                       vid=vid, holder=str(row["cluster_id"]),
                       epoch=int(row["epoch"]), detail=detail)

    def _encode_batch(self, v, recs) -> tuple[dict, int]:
        out = []
        nbytes = 0
        for r in recs:
            rec = {"seq": r.seq, "op": r.op, "needle_id": r.needle_id,
                   "cookie": r.cookie, "size": r.size, "ts_ns": r.ts_ns}
            if r.op == OP_WRITE:
                try:
                    blob = v.read_needle_blob(r.needle_id)
                    rec["blob"] = base64.b64encode(blob).decode()
                    nbytes += len(blob)
                except VolumeError:
                    # Vacuumed, superseded, or locally rotten: nothing
                    # shippable for THIS seq; a later record for the
                    # needle (or the repair plane) converges the pair.
                    rec["blob"] = None
            out.append(rec)
        body = {"volume": v.vid, "collection": v.collection,
                "version": v.version,
                "replication": str(v.super_block.replica_placement),
                "ttl": str(v.super_block.ttl),
                "records": out}
        if self.cluster_id:
            # Geo fencing stamp: the receiver rejects this batch when
            # its own `.lease` knows a newer epoch for the volume.
            body["cluster_id"] = self.cluster_id
            body["epoch"] = self.leases.epoch(v.vid) \
                if self.leases is not None else 0
        if self.compress:
            # Delta-compressed shipping: the record list (blobs and
            # all) rides as one zlib stream; what goes on the WAN —
            # and what the `rlog.ship` flow purpose meters — is the
            # compressed payload.
            raw = json.dumps(out).encode()
            del body["records"]
            body["codec"] = "zlib"
            body["records_z"] = base64.b64encode(
                zlib.compress(raw)).decode()
            body["raw_bytes"] = len(raw)
        return body, nbytes

    def _post(self, target: str, vid: int, body: dict) -> dict:
        payload = json.dumps(body).encode()
        breaker = resilience.breaker_for(target)

        def send(attempt: int, timeout: float) -> dict:
            if attempt:
                replication_resends_total.inc(reason="retry")
            if not breaker.allow():
                raise resilience.BreakerOpen(target)
            try:
                if _fault.ARMED:
                    # WAN shaping on the ship path: delay models
                    # latency, partition fails the send (the batch
                    # never arrives; the watermark holds).
                    _fault.hit("wan.delay", peer=target, vid=vid)
                    _fault.hit("wan.partition", peer=target, vid=vid)
                out = rpc.call(
                    f"http://{target}/admin/replication/apply", "POST",
                    payload, timeout=timeout,
                    headers={**rpc.PRIORITY_LOW,
                             **_flows.tag("rlog.ship")})
            except Exception as e:  # noqa: BLE001 — classified below
                status = getattr(e, "status", None)
                if status is None or status >= 500:
                    breaker.record_failure()
                raise
            breaker.record_success()
            if _fault.ARMED:
                try:
                    _fault.hit("wan.duplicate", peer=target, vid=vid)
                except _fault.FaultInjected:
                    # Duplicate delivery, on purpose: the same batch
                    # lands twice and the receiver's applied watermark
                    # must no-op the replay.
                    replication_resends_total.inc(reason="duplicate")
                    rpc.call(f"http://{target}"
                             f"/admin/replication/apply", "POST",
                             payload, timeout=timeout,
                             headers={**rpc.PRIORITY_LOW,
                                      **_flows.tag("rlog.ship")})
            assert isinstance(out, dict)
            return out

        # idempotent=True: the receiver's seq watermark makes a resend
        # of bytes-that-maybe-landed a no-op, the one property plain
        # needle POSTs don't have.
        return self._policy.run(send, idempotent=True)

    # -- standby resolution --------------------------------------------------

    def _resolve_target(self, vid: int) -> str | None:
        hit = self._targets.get(vid)
        if hit and time.monotonic() < hit[0]:
            return hit[1]
        url = None
        try:
            # steered=1: ask for the peer's RAW placement.  Steering is
            # a client-read feature — a steering peer master would
            # prepend OUR region's replica the moment it sees our lag
            # cross the SLO, and the shipper would ship the backlog to
            # itself (self-apply gap-409s, shipping stalls forever).
            out = rpc.call(
                f"{self.peer}/dir/lookup?volumeId={vid}&steered=1")
            locs = out.get("locations") or []
            if locs:
                url = locs[0].get("url") or locs[0].get("publicUrl")
        except rpc.RpcError:
            pass  # standby doesn't host it yet: pick any live node
        except Exception:  # noqa: BLE001 — peer master unreachable
            return None
        if not url:
            try:
                out = rpc.call(f"{self.peer}/vol/list")
                nodes = [n["url"]
                         for dc in out.get("topology", {})
                                      .get("data_centers", [])
                         for rack in dc.get("racks", [])
                         for n in rack.get("nodes", [])
                         if n.get("url")]
                if nodes:
                    # Stable spread of new volumes across the standby;
                    # the receiver creates + heartbeats the volume, so
                    # the next resolve goes through /dir/lookup.
                    url = sorted(nodes)[vid % len(nodes)]
            except Exception:  # noqa: BLE001
                return None
        if not url:
            return None
        self._targets[vid] = (time.monotonic() + _TARGET_TTL, url)
        return url

    # -- lag accounting ------------------------------------------------------

    def _observe_lag(self, vid: int, rlog) -> None:
        lag_seq = rlog.pending()
        lag_seconds = 0.0
        if lag_seq:
            head = rlog.read_from(rlog.acked_seq + 1, 1)
            if head:
                lag_seconds = max(0.0, time.time()
                                  - head[0].ts_ns / 1e9)
        prev = self._lag.get(vid) or {}
        with self._lag_lock:
            self._lag[vid] = {
                "lag_seq": lag_seq,
                "lag_seconds": round(lag_seconds, 3),
                "last_seq": rlog.last_seq,
                "acked_seq": rlog.acked_seq,
                "paused": self.paused,
            }
        replication_lag_seconds.set(lag_seconds, volume=str(vid))
        if lag_seconds:
            replication_lag_seconds_total.inc(lag_seconds)
        # One journal row per lag episode (threshold-crossing, not
        # per-tick): the timeline shows WHEN a pair fell behind.
        if lag_seq and not prev.get("lag_seq"):
            emit_event("replication.lag", node=self.node, severity="warn",
                       vid=vid, lag_seq=lag_seq,
                       lag_seconds=round(lag_seconds, 3), peer=self.peer)

    # -- surfaces ------------------------------------------------------------

    def lag_view(self) -> dict:
        """Heartbeat payload: per-volume lag + the pairing config."""
        with self._lag_lock:
            vols = {str(vid): dict(row) for vid, row in
                    self._lag.items()}
        return {"peer": self.peer, "paused": self.paused,
                "volumes": vols}

    def status(self) -> dict:
        doc = self.lag_view()
        doc["interval"] = self.interval
        doc["batch_records"] = self.batch_records
        doc["collections"] = (sorted(c or "default"
                                     for c in self.collections)
                              if self.collections is not None else [])
        doc["cluster_id"] = self.cluster_id
        doc["compress"] = self.compress
        doc["shipped"] = dict(self.shipped)
        return doc
