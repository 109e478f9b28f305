"""Cluster event journal: typed, ring-buffered state-transition records.

The tracer answers "where did this request spend its time" and the
fault plane makes failures injectable and survivable — but a
breaker trip, a lost heartbeat, a 4-shard EC rebuild, or a rollback
after partial replication leaves no queryable record, only interleaved
glog lines per process.  This module is the missing timeline: every
cluster state transition lands as one structured record

    {ts, type, node, severity, attrs, trace_id, seq}

in a bounded per-process ring (`JOURNAL`), served by `/debug/events`
(events/routes.py), aggregated cluster-wide by the master's
`/cluster/events` and the shell's `events.ls`, and counted on every
`/metrics` scrape as `SeaweedFS_events_total{type=}`.

The catalog of event types is STATIC (`TYPES`) and the JAX package's,
letter for letter (tests/test_torch_observability.py compares them) —
like the fault-point catalog (fault/registry.py POINTS); emitting a type
that is not in the catalog raises, so a typo'd emit site fails at once
instead of silently fragmenting the timeline.  The port emits the types
of the planes it has so far; the others wait for their modules.

Cost contract: events are state transitions (elections, rebuilds,
breaker trips), not per-request traffic, and the emit path when nobody
is watching is a catalog dict check + a bounded `deque.append` + one
counter increment — no locks beyond the counter's, no I/O unless the
operator opted into JSONL persistence (`-events.file` /
SEAWEEDFS_TPU_EVENTS_FILE).  The ring's boundedness and wrap behavior
are asserted by test (tests/test_events.py).

`trace_id` links a timeline row to its `/debug/traces` spans: emit()
reads the thread's active span (trace/tracer.py), so an event raised
inside a traced request — or inside a background operation wrapped in
`tracer.root_span` (sweeps, elections, batch EC jobs) — carries the
trace id of the work that caused it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..stats.metrics import Counter
from ..trace import tracer as _tracer

# Static event-type catalog, the JAX package's whole; emitting a type
# that is not listed here raises ValueError.
TYPES: dict[str, str] = {
    "volume.assign": "a volume replica allocated onto a data node",
    "volume.grow": "volume layout grown with new writable volumes",
    "volume.readonly": "a volume switched readonly/writable",
    "volume.vacuum": "volume compaction reclaimed deleted space",
    "heartbeat.lost": "the master stopped hearing a data node",
    "heartbeat.recovered": "a data node (re)registered with the master",
    "leader.elect": "a raft node won an election",
    "leader.stepdown": "a raft leader was deposed",
    "ec.encode.start": "EC encode began (volume -> codec shard files)",
    "ec.encode.finish": "EC encode finished, with per-stage "
                        "byte/second attrs",
    "ec.rebuild.start": "EC rebuild of missing shards began",
    "ec.rebuild.finish": "EC rebuild finished, with per-stage "
                         "byte/second attrs",
    "ec.repair.local": "a shard repaired/reconstructed entirely from "
                       "its locality group (LRC 5-read path)",
    "breaker.open": "a per-host circuit breaker opened",
    "breaker.half_open": "an open breaker let a probe request through",
    "breaker.close": "a breaker closed after a successful probe",
    "replication.rollback": "a partial replication fan-out was rolled "
                            "back (zero orphans)",
    "fault.injected": "an armed fault point triggered",
    "tier.move": "a volume .dat moved between local disk and a "
                 "remote tier",
    "scrub.start": "a scrub sweep of one volume/EC volume began",
    "scrub.finish": "a scrub sweep finished, with checked/corrupt/"
                    "repaired counts",
    "needle.corrupt": "CRC verification caught a corrupt needle or "
                      "EC shard block",
    "needle.repaired": "a corrupt needle/shard block was rewritten "
                       "from a replica or by EC decode",
    "volume.quarantine": "a corrupt needle was tombstoned (repair "
                         "ticket kept) instead of serving bad bytes",
    "volume.recovered": "crash-safe mount truncated a torn tail or "
                        "regenerated a stale .idx",
    "node.draining": "a server entered draining mode: new writes are "
                     "refused (503 + Retry-After) while in-flight "
                     "requests finish",
    "node.drained": "a draining server said goodbye and the master "
                    "unregistered it immediately (no dead-sweep "
                    "window)",
    "disk.low": "free space fell below the configured reserve "
                "(-disk.reserve); local volumes flipped readonly "
                "before ENOSPC could strike",
    "disk.full": "a write hit ENOSPC; the partial record was rolled "
                 "back cleanly and the volume flipped readonly",
    "server.shed": "admission control shed requests (429) under "
                   "overload — one record per shedding episode with "
                   "the cumulative count",
    "slo.burn": "a declared SLO (-slo.read.p99 / -slo.availability) "
                "is burning its error budget at the fast-burn rate "
                "over both the 5m and 1h windows; /cluster/healthz "
                "reports the role degraded until the burn subsides",
    "replication.ship": "the mirror shipper sent one change-log batch "
                        "(records, bytes, seq range) to the standby "
                        "cluster",
    "replication.ack": "the standby acknowledged a shipped batch; the "
                       "volume's durable acked watermark advanced",
    "replication.lag": "a mirrored volume fell behind its standby "
                       "(unacked change-log records accumulated); "
                       "healthz degrades when the lag SLO is breached",
    "replication.cutover": "an operator cutover flipped the mirror "
                           "roles: the primary drained, the standby "
                           "caught up to the watermark and became "
                           "writable",
    "lifecycle.tier": "the lifecycle daemon moved a cold volume to its "
                      "rule's remote backend (readonly -> tier_upload "
                      "on the holder, throttled over the low-priority "
                      "lane)",
    "lifecycle.promote": "a tiered volume turned hot again (sustained "
                         "block-cache hits inside the promotion "
                         "window) and was downloaded back to local "
                         "disk",
    "volume.expired": "a TTL volume whose newest write is past expiry "
                      "was retired whole: remote copy deleted if "
                      "tiered, local files dropped, master unregisters "
                      "it on the next heartbeat",
    "quota.exceeded": "a tenant crossed a stored-usage quota "
                      "(max_bytes/max_objects): hard rules started "
                      "rejecting its writes with 403 QuotaExceeded, "
                      "soft rules only journal and warn on healthz",
    "tenant.throttled": "a tenant's request or write-bandwidth token "
                        "bucket ran dry and its excess is being shed "
                        "with 429 + Retry-After (one row per >=5s "
                        "episode, with the cumulative count)",
    "flows.budget": "a purpose's wire rate breached its declared "
                    "-flows.budget ceiling for the sustain window "
                    "(stats/flows.py); /cluster/healthz warns until "
                    "the rate drops back under the limit (one row "
                    "per >=5s episode)",
    "lease.acquire": "a cluster fenced itself in as a mirrored "
                     "volume's write-lease holder (epoch recorded in "
                     "the .lease sidecar); writes arriving at other "
                     "clusters now forward here",
    "lease.move": "a lease transfer completed on the old holder: rlog "
                  "drained, the sidecar demoted to the target cluster "
                  "at epoch+1 (fail-closed if the peer's explicit "
                  "acquire is unreachable — it adopts the epoch from "
                  "the data path)",
    "lease.fence": "an epoch fence fired: a shipped batch (or lease "
                   "probe) carried a stale epoch and was refused with "
                   "409 — the partitioned old holder's writes cannot "
                   "land",
    "device.slow": "device roofline collapse: a streamed EC pipeline's "
                   "device-occupancy fraction stayed below threshold "
                   "for consecutive batch groups — attrs name the "
                   "starving stage and bubble seconds",
    "shard.promote": "a filer metadata shard failed over: its primary "
                     "went dead and the master promoted the "
                     "most-caught-up follower at epoch+1 (attrs carry "
                     "shard, old/new primary, epoch)",
    "shard.move": "a filer metadata shard moved primaries on request "
                  "(demote-first, then the new primary acquires at "
                  "epoch+1 — mid-move the shard is contested and "
                  "fails closed)",
    "shard.fence": "a filer adopted a higher shard epoch (durable "
                   "before any record at that epoch is accepted) — "
                   "pushes from the deposed primary's stale epoch now "
                   "refuse with 409",
    "repair.plan": "the durability autopilot enqueued a repair: a "
                   "redundancy deficit survived hysteresis and is not "
                   "fenced by a drain (attrs carry kind, volume, risk "
                   "= surviving redundancy, have/want)",
    "repair.start": "a queued repair began executing (re-replication "
                    "copy or codec-aware EC rebuild) on the "
                    "low-priority lane",
    "repair.finish": "a repair converged: the volume is back at "
                     "declared redundancy (attrs carry wall seconds "
                     "and MTTR from degradation detection; "
                     "kind=dedupe records a surplus-copy trim after "
                     "a resurrection)",
    "repair.cancel": "a repair was abandoned: the deficit healed "
                     "(node returned), the leader was deposed, or "
                     "the executor failed (reason attr; failures "
                     "re-enter through hysteresis)",
}

SEVERITIES = ("info", "warn", "error")

events_total = Counter("SeaweedFS_events_total",
                       "cluster events by type", ("type",))


def _env_capacity() -> int:
    try:
        return int(os.environ.get("SEAWEEDFS_TPU_EVENTS_BUFFER",
                                  "") or 2048)
    except ValueError:
        return 2048


class EventJournal:
    """Bounded per-process event ring.

    `emit` is safe from any thread: the ring is a `deque(maxlen=...)`
    whose append is atomic under the GIL, so concurrent emitters never
    need a lock on the hot path; `seq` assignment rides a dedicated
    lock because it must be unique (it is the cross-process dedup key,
    with `token`, for `events.ls` / `/cluster/events` aggregation over
    roles that share one in-process journal in test stacks).
    """

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity if capacity is not None \
            else _env_capacity()
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        # Process identity for aggregation dedup: two servers in one
        # process serve the SAME journal; the (token, seq) pair lets
        # events.ls collapse those duplicates while keeping genuinely
        # distinct processes' events apart.
        self.token = os.urandom(4).hex()
        self._seq = 0
        self._seq_lock = threading.Lock()
        self.emitted = 0
        # JSONL persistence (optional): resolved lazily from the env on
        # first emit so the CLI's -events.file flag (which sets the env
        # before servers construct) wins over import order.
        self._sink_path: str | None | type(...) = ...
        self._sink_lock = threading.Lock()
        # Size-based rotation (-events.file.max_mb / -events.file.keep):
        # resolved lazily alongside the path, reset by set_sink.
        self._sink_max_bytes: int | type(...) = ...
        self._sink_keep = 3

    # -- emission ------------------------------------------------------------

    def emit(self, type_: str, node: str = "", severity: str = "info",
             **attrs) -> dict:
        """Record one event.  Unknown types and severities raise — the
        catalog is static so the timeline can be trusted and the smoke
        test can enumerate it."""
        if type_ not in TYPES:
            raise ValueError(
                f"unknown event type {type_!r} (not in events.TYPES)")
        if severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {severity!r} (one of {SEVERITIES})")
        sp = _tracer.current_span()
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
            self.emitted += 1  # under the lock: dropped = emitted -
            #                    len(ring) must not undercount on races
        ev = {"ts": time.time(), "type": type_, "node": node,
              "severity": severity, "attrs": attrs,
              "trace_id": sp.trace_id if sp is not None else "",
              "seq": seq}
        self._ring.append(ev)
        events_total.inc(type=type_)
        if self._sink_path is ...:
            self._sink_path = os.environ.get(
                "SEAWEEDFS_TPU_EVENTS_FILE") or None
        if self._sink_path:
            self._write_sink(ev)
        return ev

    def _write_sink(self, ev: dict) -> None:
        """Append one JSONL line, rotating by size first; a broken sink
        must never fail the operation that emitted the event."""
        try:
            with self._sink_lock:
                self._maybe_rotate()
                with open(self._sink_path, "a") as f:
                    f.write(json.dumps(ev) + "\n")
        except OSError:
            pass

    def _maybe_rotate(self) -> None:
        """Shift path -> path.1 -> ... -> path.N (keep N) when the live
        file exceeds -events.file.max_mb.  Caller holds _sink_lock."""
        if self._sink_max_bytes is ...:
            try:
                mb = float(os.environ.get(
                    "SEAWEEDFS_TPU_EVENTS_FILE_MAX_MB", "") or 0)
            except ValueError:
                mb = 0.0
            self._sink_max_bytes = int(mb * 1024 * 1024)
            try:
                self._sink_keep = max(1, int(os.environ.get(
                    "SEAWEEDFS_TPU_EVENTS_FILE_KEEP", "") or 3))
            except ValueError:
                self._sink_keep = 3
        if not self._sink_max_bytes:
            return  # rotation not enabled
        try:
            if os.path.getsize(self._sink_path) < self._sink_max_bytes:
                return
        except OSError:
            return  # sink doesn't exist yet: nothing to rotate
        path = self._sink_path
        oldest = f"{path}.{self._sink_keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self._sink_keep - 1, 0, -1):
            if os.path.exists(f"{path}.{i}"):
                os.replace(f"{path}.{i}", f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")

    def set_sink(self, path: str | None) -> None:
        """Override the JSONL sink (tests; runtime reconfiguration).
        Rotation config re-resolves from the env on the next write."""
        with self._sink_lock:
            self._sink_path = path
            self._sink_max_bytes = ...

    # -- queries -------------------------------------------------------------

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._ring)

    def snapshot(self, type_: str = "", since: float = 0.0,
                 severity: str = "", limit: int = 0) -> list[dict]:
        """Matching events oldest-first (a timeline reads forward).
        `limit` keeps the NEWEST matches — the tail is what an operator
        paging a live cluster wants."""
        out = [ev for ev in list(self._ring)
               if (not type_ or ev["type"] == type_)
               and (not severity or ev["severity"] == severity)
               and ev["ts"] >= since]
        return out[-limit:] if limit > 0 else out

    def clear(self) -> None:
        self._ring.clear()
        self.emitted = 0


JOURNAL = EventJournal()


def emit(type_: str, node: str = "", severity: str = "info",
         **attrs) -> dict:
    """Module-level shorthand for JOURNAL.emit — what call sites use."""
    return JOURNAL.emit(type_, node=node, severity=severity, **attrs)
