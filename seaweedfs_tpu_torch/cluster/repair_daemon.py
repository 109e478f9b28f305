"""Durability autopilot: risk-ranked automatic re-replication and EC
rebuild after node loss.

The master's dead-node sweep (``_sweep_dead_nodes``) unregisters a lost
node and broadcasts the vanished vids — and then the cluster just sits
degraded, one more failure away from data loss, until an operator runs
``volume.scrub -repair`` or ``ec.rebuild`` by hand.  At warehouse scale
the window between loss and repair is exactly the MTTDL term a human
cannot bound, so this daemon closes the loop: every sweep it joins the
live topology against the *declared* redundancy (``ReplicaPlacement``
copy counts for replicated volumes, codec geometry for EC stripes),
ranks every deficit by surviving redundancy, and drives the queue to
empty.

Design rules, in the order they matter:

- **Risk first.**  A volume on its last replica and a stripe at its
  decode minimum sort ahead of everything else (risk = number of extra
  failures survivable; 0 drains first).
- **Hysteresis.**  A deficit is only enqueued after it has persisted
  for ``delay`` seconds (default 2x the dead-sweep threshold, i.e. 4x
  the heartbeat pulse).  Transient blips — a rolling restart that beats
  the sweep, a brief partition — heal themselves without a single byte
  of repair traffic.
- **Planned maintenance never repairs.**  A node that said goodbye
  (drain) is fenced: every vid it held is suppressed until a new
  generation of that node registers.  Rolling restarts are silent.
- **Resurrection fencing.**  A dead node coming back cancels its queued
  repairs (the deficit heals, the reconcile pass drops the task).  If a
  repair already *landed* when the original holder returns, the volume
  is over-replicated; the dedupe pass trims back to placement,
  newest-placement-first, and never below the declared copy count.
- **Budget governance.**  All repair traffic rides the low-priority
  admission lane tagged ``repair.fetch`` / ``ec.gather``, so an armed
  ``-flows.budget`` paces it below user traffic; ``concurrent`` bounds
  parallel repairs and the daemon can be paused/resumed at runtime.
- **Crash safety without a ledger.**  There is no repair journal to
  corrupt: on leader change the queue is rebuilt from topology truth by
  the next scan.  An executor dying mid-copy leaves only ``.part``
  files the receiving volume server reaps at startup.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..codecs import get_codec
from ..core.replica_placement import ReplicaPlacement
from ..events import emit as emit_event
from ..stats.metrics import Counter, Histogram
from ..storage.store import VolumeInfo
from ..topology.volume_growth import VolumeGrowth
from ..trace import root_span
from ..utils import glog
from . import rpc

repairs_total = Counter(
    "SeaweedFS_repairs_total",
    "Completed automatic repair operations by kind and outcome.",
    ("kind", "outcome"))

REPAIR_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                  120.0, 300.0)

repair_seconds = Histogram(
    "SeaweedFS_repair_seconds",
    "Time from degradation detection to converged redundancy (MTTR).",
    ("kind",), buckets=REPAIR_BUCKETS)


class _Canceled(Exception):
    """Raised inside an executor when the deficit healed under it."""


@dataclass
class RepairTask:
    kind: str                # "replicate" | "ec"
    vid: int
    collection: str = ""
    risk: int = 0            # extra failures survivable; 0 drains first
    have: int = 0
    want: int = 0
    missing: tuple = ()      # EC: missing shard ids
    codec: str = ""
    replication: str = ""
    ttl: int = 0
    degraded_since: float = 0.0
    phase: str = "queued"
    started: float = 0.0
    error: str = ""

    @property
    def key(self) -> tuple:
        return (self.kind, self.vid)

    def doc(self) -> dict:
        d = {"kind": self.kind, "volume": self.vid, "risk": self.risk,
             "have": self.have, "want": self.want, "phase": self.phase}
        if self.collection:
            d["collection"] = self.collection
        if self.kind == "ec":
            d["codec"] = self.codec
            d["missing"] = list(self.missing)
        else:
            d["replication"] = self.replication
        if self.started:
            d["running_seconds"] = round(time.time() - self.started, 3)
        if self.error:
            d["error"] = self.error
        return d


class RepairDaemon:
    """Leader-only repair orchestrator, ticked by the master's sweep
    loop.  All public entry points are safe on non-leaders (no-ops);
    ``run_now`` is the synchronous operator path (shell ``cluster.repair
    run`` / ``volume.fix.replication``) and works even while disarmed
    or paused — an explicit command outranks the autopilot switch."""

    MTTR_KEEP = 200
    HISTORY_KEEP = 100

    def __init__(self, master, enabled: bool = False,
                 delay: float | None = None, concurrent: int = 2):
        self.master = master
        self.enabled = enabled
        # Hysteresis default: 2x the dead-sweep threshold (itself 2x
        # the pulse) so a node must miss the sweep AND stay gone.
        self.delay = (4.0 * master.topo.pulse_seconds
                      if delay is None else delay)
        self.concurrent = max(1, concurrent)
        self.paused = False
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._queue: list[RepairTask] = []
        self._inflight: dict[tuple, RepairTask] = {}
        self._degraded_since: dict[tuple, float] = {}
        # node_key -> vids it held when it said goodbye (drain fence)
        self._goodbye_held: dict[str, set[int]] = {}
        # vid -> [(placed_at, node_url)] — dedupe trims newest first
        self._placed: dict[int, list[tuple[float, str]]] = {}
        self._dedupe_pending = False
        self._mttr: list[tuple[str, float]] = []
        self._history: list[dict] = []
        self._mesh = None

    # ------------------------------------------------------------------
    # lifecycle hooks (called from master heartbeat / goodbye paths)

    def node_goodbyed(self, node_key: str, vids: set[int]) -> None:
        """Drain fence: vids held by a goodbyed node never enqueue."""
        with self._lock:
            self._goodbye_held[node_key] = set(vids)

    def node_returned(self, node_key: str) -> None:
        """A known-dead or goodbyed node re-registered.  Lift the drain
        fence and schedule a dedupe pass — NOT inline, because
        heartbeat.recovered fires before the returning node's volume
        list has been applied; the next tick sees settled topology."""
        with self._lock:
            self._goodbye_held.pop(node_key, None)
            self._dedupe_pending = True

    # ------------------------------------------------------------------
    # scanning

    def scan(self) -> list[RepairTask]:
        """Join topology truth against declared redundancy.  Returns
        candidate tasks sorted most-at-risk first.  Pure read — no
        queue mutation, usable for dry-run plans."""
        topo = self.master.topo
        out: list[RepairTask] = []
        with topo._lock:
            for cname, coll in topo.collections.items():
                for layout in coll.layouts.values():
                    want = layout.rp.copy_count()
                    if want <= 1:
                        continue
                    for vid, locs in layout.vid2location.items():
                        have = len(locs)
                        if 0 < have < want:
                            out.append(RepairTask(
                                kind="replicate", vid=vid,
                                collection=cname, risk=have - 1,
                                have=have, want=want,
                                replication=str(layout.rp),
                                ttl=layout.ttl.to_uint32()))
            for vid, loc in topo.ec_shard_map.items():
                codec = get_codec(loc.codec)
                present = sorted(
                    sid for sid, dns in loc.locations.items() if dns)
                missing = sorted(
                    set(range(codec.total_shards)) - set(present))
                if not missing or not present:
                    continue
                try:
                    codec.repair_plan(tuple(present), list(missing))
                except Exception:
                    continue  # unrecoverable — nothing to do
                out.append(RepairTask(
                    kind="ec", vid=vid, collection=loc.collection,
                    risk=max(0, len(present) - codec.data_shards),
                    have=len(present), want=codec.total_shards,
                    missing=tuple(missing), codec=loc.codec))
        out.sort(key=lambda t: (t.risk, t.vid, t.kind))
        return out

    def _suppressed(self, task: RepairTask) -> bool:
        """True while the deficit is explained by a drained node whose
        goodbye fence is still standing (no new generation yet)."""
        live = getattr(self.master, "_goodbye_epochs", {})
        stale = [nk for nk in self._goodbye_held if nk not in live]
        for nk in stale:
            self._goodbye_held.pop(nk, None)
        return any(task.vid in vids
                   for vids in self._goodbye_held.values())

    def reconcile(self, now: float | None = None) -> None:
        """Diff the scan against the queue: start hysteresis clocks,
        enqueue ripe deficits, cancel healed ones."""
        now = time.time() if now is None else now
        cands = {t.key: t for t in self.scan()}
        with root_span("master.repair_reconcile", "master"), \
                self._lock:
            for key in list(self._degraded_since):
                if key not in cands and key not in self._inflight:
                    self._degraded_since.pop(key)
            healed = [t for t in self._queue if t.key not in cands]
            for t in healed:
                self._queue.remove(t)
                repairs_total.inc(kind=t.kind, outcome="canceled")
                emit_event("repair.cancel", node=self.master.url(),
                           kind=t.kind, volume=t.vid, reason="healed")
            for key, t in sorted(cands.items(),
                                 key=lambda kv: (kv[1].risk,
                                                 kv[1].vid)):
                since = self._degraded_since.setdefault(key, now)
                if (key in self._inflight
                        or any(q.key == key for q in self._queue)
                        or self._suppressed(t)
                        or now - since < self.delay):
                    continue
                t.degraded_since = since
                self._enqueue(t)

    def _enqueue(self, t: RepairTask) -> None:
        self._queue.append(t)
        self._queue.sort(key=lambda x: (x.risk, x.vid, x.kind))
        emit_event("repair.plan", node=self.master.url(),
                   severity="warn", kind=t.kind, volume=t.vid,
                   risk=t.risk, have=t.have, want=t.want,
                   missing=len(t.missing), collection=t.collection)

    # ------------------------------------------------------------------
    # driving

    def tick(self) -> None:
        """Called from the master's sweep loop every pulse.  Must never
        raise — a repair bug must not take down the dead-node sweep."""
        try:
            if not self.enabled or not self.master.is_leader():
                return
            self.reconcile()
            if self._dedupe_pending:
                with self._lock:
                    self._dedupe_pending = False
                self.dedupe()
            if not self.paused:
                self._start_workers()
        except Exception as e:  # noqa: BLE001
            glog.warningf("repair tick failed: %s", e)

    def _start_workers(self) -> None:
        with self._lock:
            while self._queue and len(self._inflight) < self.concurrent:
                t = self._queue.pop(0)
                self._inflight[t.key] = t
                threading.Thread(target=self._execute, args=(t,),
                                 daemon=True,
                                 name=f"repair-{t.kind}-{t.vid}").start()

    def run_now(self, kinds: list[str] | None = None,
                timeout: float = 600.0) -> dict:
        """Synchronous drain for the operator surfaces.  Ignores the
        hysteresis delay and the pause switch (an explicit command),
        still honours the drain fence and dedupe invariants."""
        cands = self.scan()
        if kinds:
            cands = [t for t in cands if t.kind in kinds]
        with root_span("master.repair_run", "master"), self._lock:
            for t in cands:
                if (t.key in self._inflight
                        or any(q.key == t.key for q in self._queue)
                        or self._suppressed(t)):
                    continue
                t.degraded_since = self._degraded_since.setdefault(
                    t.key, time.time())
                self._enqueue(t)
            todo = [t.key for t in self._queue] + list(self._inflight)
            deadline = time.monotonic() + timeout
            while self._queue or self._inflight:
                self._start_workers_locked()
                if not self._wake.wait(timeout=1.0) \
                        and time.monotonic() > deadline:
                    break
        trimmed = self.dedupe()
        with self._lock:
            results = [h for h in self._history
                       if (h["kind"], h["volume"]) in
                       {(k[0], k[1]) for k in todo}]
        return {"ran": len(todo), "results": results,
                "trimmed": trimmed}

    def _start_workers_locked(self) -> None:
        # run_now holds the lock; _start_workers re-acquires (RLock).
        self._start_workers()

    # ------------------------------------------------------------------
    # executors

    def _execute(self, t: RepairTask) -> None:
        with root_span("master.repair", "master", kind=t.kind,
                       volume=t.vid):
            self._execute_traced(t)

    def _execute_traced(self, t: RepairTask) -> None:
        t.phase = "running"
        t.started = time.time()
        emit_event("repair.start", node=self.master.url(),
                   kind=t.kind, volume=t.vid, risk=t.risk)
        outcome = "ok"
        try:
            if not self.master.is_leader():
                raise _Canceled("deposed")
            if t.kind == "replicate":
                self._replicate(t)
            else:
                self._rebuild_ec(t)
            t.phase = "done"
            mttr = time.time() - (t.degraded_since or t.started)
            repair_seconds.observe(mttr, kind=t.kind)
            emit_event("repair.finish", node=self.master.url(),
                       kind=t.kind, volume=t.vid,
                       seconds=round(time.time() - t.started, 3),
                       mttr_seconds=round(mttr, 3))
            with self._lock:
                self._mttr.append((t.kind, mttr))
                del self._mttr[:-self.MTTR_KEEP]
        except _Canceled as e:
            outcome = "canceled"
            t.phase = "canceled"
            t.error = str(e)
            emit_event("repair.cancel", node=self.master.url(),
                       kind=t.kind, volume=t.vid, reason=str(e))
        except Exception as e:  # noqa: BLE001
            outcome = "error"
            t.phase = "failed"
            t.error = str(e)
            glog.warningf("repair %s volume %d failed: %s",
                          t.kind, t.vid, e)
            emit_event("repair.cancel", node=self.master.url(),
                       severity="warn", kind=t.kind, volume=t.vid,
                       reason="error", error=str(e))
        finally:
            repairs_total.inc(kind=t.kind, outcome=outcome)
            with self._lock:
                self._inflight.pop(t.key, None)
                # Drop the hysteresis clock: success means healed; a
                # failure restarts the clock so retries are paced, not
                # hot-looped.
                self._degraded_since.pop(t.key, None)
                self._history.append(
                    {**t.doc(), "outcome": outcome,
                     "finished_at": time.time()})
                del self._history[:-self.HISTORY_KEEP]
                self._wake.notify_all()
                # Self-draining: a finishing executor pulls the next
                # queued task instead of waiting for the next tick —
                # otherwise queue drain is paced by the sweep interval
                # and MTTR inflates by pulse-multiples per task.
                if not self.paused:
                    self._start_workers()

    def _replicate(self, t: RepairTask) -> None:
        topo = self.master.topo
        locs = topo.lookup(t.collection, t.vid)
        if not locs:
            raise RuntimeError(f"volume {t.vid}: no surviving replica")
        rp = ReplicaPlacement.parse(t.replication or "000")
        if len(locs) >= rp.copy_count():
            raise _Canceled("healed")
        src = locs[0]
        target = self._pick_target(t.vid, locs, rp)
        t.phase = "copy"
        vinfo = src.volumes.get(t.vid)
        was_readonly = bool(vinfo and vinfo.read_only)
        # Freeze the source so the copied .dat/.idx pair is a
        # consistent point-in-time snapshot, checksum-verifiable.
        rpc.call_json(f"http://{src.url()}/admin/readonly",
                      payload={"volume": t.vid, "readonly": True})
        try:
            rpc.call_json(
                f"http://{target.url()}/admin/volume/receive",
                payload={"volume": t.vid, "collection": t.collection,
                         "source": src.url()},
                timeout=600.0)
        finally:
            if not was_readonly:
                try:
                    rpc.call_json(
                        f"http://{src.url()}/admin/readonly",
                        payload={"volume": t.vid, "readonly": False})
                except Exception:  # noqa: BLE001
                    glog.warningf("repair: could not unfreeze volume "
                                  "%d on %s", t.vid, src.url())
        t.phase = "register"
        # Optimistic registration (the receiver's heartbeat confirms):
        # mirrors _allocate_volume so lookups route immediately.
        v = VolumeInfo(
            id=t.vid, collection=t.collection,
            size=vinfo.size if vinfo else 0,
            file_count=vinfo.file_count if vinfo else 0,
            delete_count=vinfo.delete_count if vinfo else 0,
            deleted_byte_count=(vinfo.deleted_byte_count
                                if vinfo else 0),
            read_only=was_readonly,
            replica_placement=rp.to_byte(),
            ttl=t.ttl,
            compact_revision=(vinfo.compact_revision if vinfo else 0))
        topo.register_volume(v, target)
        with self._lock:
            self._placed.setdefault(t.vid, []).append(
                (time.time(), target.url()))
            del self._placed[t.vid][:-8]

    def _pick_target(self, vid: int, holders, rp: ReplicaPlacement):
        """Placement-aware target choice: prefer restoring the failure
        domain diversity the placement demands, then most free space,
        deterministic tiebreak."""
        topo = self.master.topo
        held_urls = {dn.url() for dn in holders}
        held_dcs = {dn.get_data_center().id for dn in holders}
        held_racks = {dn.get_rack().id for dn in holders}
        cands = []
        with topo._lock:
            for dn in topo.leaves():
                if dn.url() in held_urls:
                    continue
                if not VolumeGrowth._node_eligible(dn):
                    continue
                cands.append(dn)
        if not cands:
            raise RuntimeError(
                f"volume {vid}: no eligible repair target")

        def score(dn):
            new_dc = dn.get_data_center().id not in held_dcs
            new_rack = dn.get_rack().id not in held_racks
            diversity = 0
            if rp.diff_data_center_count and new_dc:
                diversity -= 2
            if rp.diff_rack_count and new_rack:
                diversity -= 1
            return (diversity, -dn.free_space(), dn.url())

        return min(cands, key=score)

    def prepare(self) -> None:
        """Set up the rebuild path now, before the master serves: import
        it, build the device mesh, create each card's context and stream
        pool and load the kernels.  Done in the first repair instead (as
        the JAX package does), it held the interpreter lock long enough
        for a raft election (the pool alone 0.3-0.7 s on an H100 host,
        the election timeout 0.6-1.2 s): a follower whose topology held
        no EC volume took over, and every lookup of the volume answered
        404 until each holder beat again.  Without a device the mesh
        stays unbuilt and the first rebuild raises as before."""
        try:
            from ..parallel.cluster_rebuild import make_mesh
            mesh = make_mesh()
            if any(d.type == "cuda" for d in mesh.device_list()):
                import torch

                from ..ops import cuda_build
                from ..parallel.cluster_encode import side_streams
                torch.cuda.init()
                side_streams(mesh)
                for name in cuda_build.KERNEL_SOURCES:
                    cuda_build.load(name)
            self._mesh = mesh
        except Exception as e:  # noqa: BLE001 — a host without a card
            glog.warningf("repair: rebuild path not set up at start "
                          "(%s: %s)", type(e).__name__, e)

    def _rebuild_ec(self, t: RepairTask) -> None:
        from ..parallel.cluster_rebuild import batch_rebuild, make_mesh
        t.phase = "rebuild"
        if self._mesh is None:
            self._mesh = make_mesh()
        env = _MasterEnv(self.master)
        lines = batch_rebuild(env, vids=[t.vid], mesh=self._mesh)
        if not any("rebuilt" in ln for ln in lines):
            raise RuntimeError(
                f"volume {t.vid}: rebuild produced no shards "
                f"({'; '.join(lines) or 'no output'})")

    # ------------------------------------------------------------------
    # dedupe (resurrection resolution)

    def dedupe(self) -> list[dict]:
        """Trim over-replicated volumes back to declared placement,
        newest-placement-first, never below copy count.  Returns the
        trim records (also journalled)."""
        topo = self.master.topo
        surplus: list[tuple[int, str, int, list]] = []
        with topo._lock:
            for cname, coll in topo.collections.items():
                for layout in coll.layouts.values():
                    want = layout.rp.copy_count()
                    for vid, locs in layout.vid2location.items():
                        if len(locs) > want:
                            surplus.append(
                                (vid, cname, want, list(locs)))
        trimmed: list[dict] = []
        if not surplus:
            return trimmed
        with root_span("master.repair_dedupe", "master"):
            self._dedupe_traced(surplus, trimmed)
        return trimmed

    def _dedupe_traced(self, surplus, trimmed) -> None:
        topo = self.master.topo
        for vid, cname, want, locs in surplus:
            with self._lock:
                recency = {url: ts for ts, url
                           in self._placed.get(vid, [])}
            # Newest placement first; never-placed (original holders)
            # sort last and survive.
            locs.sort(key=lambda dn: -recency.get(dn.url(), -1.0))
            for dn in locs[:len(locs) - want]:
                try:
                    rpc.call_json(
                        f"http://{dn.url()}/admin/delete_volume",
                        payload={"volume": vid})
                except Exception as e:  # noqa: BLE001
                    glog.warningf("dedupe: drop volume %d on %s "
                                  "failed: %s", vid, dn.url(), e)
                    continue
                v = dn.volumes.get(vid)
                if v is not None:
                    topo.unregister_volume(v, dn)
                repairs_total.inc(kind="dedupe", outcome="ok")
                rec = {"volume": vid, "collection": cname,
                       "node": dn.url(), "kept": want}
                trimmed.append(rec)
                emit_event("repair.finish", node=self.master.url(),
                           kind="dedupe", volume=vid,
                           trimmed_from=dn.url())

    # ------------------------------------------------------------------
    # surfaces

    def pause(self) -> dict:
        with self._lock:
            self.paused = True
        return {"paused": True}

    def resume(self) -> dict:
        with self._lock:
            self.paused = False
        return {"paused": False}

    def queue_depth_by_risk(self) -> dict:
        with self._lock:
            depths: dict[tuple, float] = {}
            for t in self._queue:
                k = (str(t.risk),)
                depths[k] = depths.get(k, 0.0) + 1.0
            return depths

    def status(self) -> dict:
        now = time.time()
        plan = []
        for t in self.scan():
            with self._lock:
                since = self._degraded_since.get(t.key)
                d = t.doc()
                d["degraded_for"] = round(now - since, 3) if since \
                    else 0.0
                d["suppressed"] = self._suppressed(t)
            plan.append(d)
        with self._lock:
            mttrs = [s for _, s in self._mttr]
            hist = {f"le_{b}": sum(1 for s in mttrs if s <= b)
                    for b in REPAIR_BUCKETS}
            return {
                "enabled": self.enabled,
                "paused": self.paused,
                "delay_seconds": self.delay,
                "concurrent": self.concurrent,
                "queue": [t.doc() for t in self._queue],
                "inflight": [t.doc()
                             for t in self._inflight.values()],
                "plan": plan,
                "history": self._history[-20:],
                "mttr": {
                    "count": len(mttrs),
                    "mean_seconds": (round(sum(mttrs) / len(mttrs), 3)
                                     if mttrs else 0.0),
                    "max_seconds": (round(max(mttrs), 3)
                                    if mttrs else 0.0),
                    "histogram": hist,
                },
            }


class _MasterEnv:
    """Duck-typed environment adapter so the master can drive the
    shell's codec-aware ``plan_rebuilds``/``batch_rebuild`` planner
    in-process (the planner normally runs against a CommandEnv)."""

    def __init__(self, master):
        self.master = master

    def data_nodes(self) -> list[dict]:
        topo = self.master.topo
        out = []
        with topo._lock:
            for dc in topo.children.values():
                for rack in dc.children.values():
                    for dn in rack.children.values():
                        out.append({
                            "url": dn.url(),
                            "dc": dc.id,
                            "rack": rack.id,
                            "max_volume_count":
                                dn.max_volume_count,
                            "volumes": [{"id": v.id}
                                        for v in dn.volumes.values()],
                            "ec_shards": [
                                {"id": vid, "shard_bits": bits,
                                 "codec": topo.ec_codec(vid)}
                                for vid, bits in dn.ec_shards.items()],
                        })
        return out

    def ec_shard_locations(self, vid: int) -> dict:
        locs = self.master.topo.lookup_ec_shards(vid)
        if not locs:
            return {}
        # Drop shard ids whose holder list emptied out (dead node
        # unregistered): the planner treats every KEY as a survivor,
        # so a lingering empty entry hides the very deficit we are
        # here to rebuild.
        return {sid: [dn.url() for dn in dns]
                for sid, dns in locs.locations.items() if dns}

    def ec_codec(self, vid: int) -> str:
        return self.master.topo.ec_codec(vid)

    def vs_call(self, url: str, path: str, payload=None,
                timeout: float = 120.0):
        return rpc.call_json(f"http://{url}{path}", payload=payload,
                             timeout=timeout)
