"""The lifecycle daemon: the master-side loop that enforces policy.

Each scan walks the heartbeat topology, joins it with the per-node
`/debug/hot` read sketches (the hot-key tracker measures exactly
the coldness signal an idle rule needs: a volume absent from the read
top-k gained no reads since the last scan), and acts:

- `tier` rules: a cold single-copy volume is flipped readonly on its
  holder, then `/admin/tier_upload` moves its .dat to the rule's
  backend — over the low-priority lane (the admission controller sheds
  background work first), behind a scrub-style byte throttle, with
  retry/breaker protection so a flapping holder degrades the scan, not
  the master.
- `expire` rules: the collection's TTL volumes are vacuumed so expired
  needles (dead to vacuum since this PR) physically vanish; the
  holder-side sweeper (volume_server._lifecycle_tick) retires volumes
  whose NEWEST write is past expiry whole.

Leader-only under raft: a deposed master's daemon idles, exactly like
the vacuum/sweep loops.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from ..cluster import resilience, rpc
from ..events import emit as emit_event
from ..fault import registry as _fault
from ..stats import metrics as _metrics
from ..storage.scrub import RateLimiter
from .policy import Policy


class LifecycleDaemon:
    """Policy enforcement loop owned by the master (leader-only)."""

    def __init__(self, master, policy: Policy,
                 interval: float = 60.0, mbps: float = 32.0):
        self.master = master
        self.policy = policy
        self.interval = interval
        self.limiter = RateLimiter(mbps)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Per-node read totals from the previous scan: an idle decision
        # needs a baseline, so a node's first scan only observes.
        self._read_totals: dict[str, dict[int, int]] = {}
        self.scans = 0
        self.last_scan = 0.0
        self.actions = {"tier_ok": 0, "tier_error": 0, "expire_ok": 0,
                        "expire_error": 0}
        self.recent: deque = deque(maxlen=32)
        self._policy_retry = resilience.RetryPolicy(
            max_attempts=3, per_attempt_timeout=120.0,
            total_deadline=300.0)

    # -- lifecycle of the loop itself ------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="lifecycle", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if not self.master.is_leader():
                continue
            try:
                self.scan_once()
            except Exception:  # noqa: BLE001 — a scan must not kill the loop
                pass

    # -- one scan ---------------------------------------------------------

    def scan_once(self) -> dict:
        """Walk the topology, apply every rule once.  Returns a summary
        (also driven directly by tests and `cluster.lifecycle run`)."""
        out = {"tiered": [], "vacuumed": [], "errors": []}
        if not self.policy.rules:
            return out
        topo = self.master.topo
        # Holder map first: tiering is single-copy only (the remote
        # object would be shared state under two holders' feet).
        holders: dict[int, list] = {}
        for dn in list(topo.leaves()):
            for vid in dn.volumes:
                holders.setdefault(vid, []).append(dn)
        for dn in list(topo.leaves()):
            url = dn.url()
            baseline = self._read_totals.get(url)
            reads = self._node_read_totals(url)
            if reads is not None:
                self._read_totals[url] = reads
            for vid, vinfo in sorted(dn.volumes.items()):
                self._consider(dn, vid, vinfo, holders, baseline,
                               reads, out)
        self.scans += 1
        self.last_scan = time.time()
        return out

    def _node_read_totals(self, url: str) -> dict[int, int] | None:
        """Per-volume cumulative read counts from the node's /debug/hot
        sketch (None: node unreachable — no idle decisions for it)."""
        try:
            snap = rpc.call(f"http://{url}/debug/hot", "GET",
                            timeout=5.0, headers=rpc.PRIORITY_LOW)
            top = snap["dimensions"]["volume"]["read"]["top"]
            return {int(e["key"]): int(e["count"]) for e in top}
        except Exception:  # noqa: BLE001
            return None

    def _consider(self, dn, vid: int, vinfo, holders, baseline,
                  reads, out: dict) -> None:
        collection = getattr(vinfo, "collection", "")
        if getattr(vinfo, "tiered", False):
            return
        expire = self.policy.expire_rule_for(collection)
        if expire is not None and getattr(vinfo, "ttl", 0):
            self._vacuum_one(dn, vid, out)
        rule = self.policy.tier_rule_for(collection)
        if rule is None or len(holders.get(vid, ())) != 1:
            return
        now = time.time()
        modified_at = getattr(vinfo, "modified_at", 0)
        if rule.min_age:
            if not modified_at or now - modified_at < rule.min_age:
                return
        if rule.fullness:
            limit = self.master.topo.volume_size_limit
            if getattr(vinfo, "size", 0) < rule.fullness * limit:
                return
        if rule.idle_for:
            if not modified_at or now - modified_at < rule.idle_for:
                return
            # No read-count baseline yet (first sight of this node):
            # observe this scan, act the next.
            if baseline is None or reads is None:
                return
            if reads.get(vid, 0) - baseline.get(vid, 0) > 0:
                return  # gained reads since the last scan: not cold
        self._tier_one(dn, vid, vinfo, rule, out)

    # -- actions ----------------------------------------------------------

    def _tier_one(self, dn, vid: int, vinfo, rule, out: dict) -> None:
        url = dn.url()
        breaker = resilience.breaker_for(url)
        size = getattr(vinfo, "size", 0)

        def step(path: str, payload: dict):
            def send(attempt: int, timeout: float):
                if not breaker.allow():
                    raise resilience.BreakerOpen(url)
                try:
                    if _fault.ARMED:
                        # The holder may sit across a WAN from the
                        # backend AND the master; the ship-path shaping
                        # points model both legs here.
                        _fault.hit("wan.delay", peer=url, vid=vid)
                        _fault.hit("wan.partition", peer=url, vid=vid)
                    r = rpc.call(f"http://{url}{path}", "POST",
                                 json.dumps(payload).encode(),
                                 timeout=timeout,
                                 headers=rpc.PRIORITY_LOW)
                except Exception as e:  # noqa: BLE001 — classified by retry
                    status = getattr(e, "status", None)
                    if status is None or status >= 500:
                        breaker.record_failure()
                    raise
                breaker.record_success()
                return r

            # Idempotent by construction: readonly is a flag write and
            # a tier_upload re-send either re-uploads (overwrite) or
            # 400s on the already-remote volume, never duplicates data.
            return self._policy_retry.run(send, idempotent=True)

        try:
            step("/admin/readonly", {"volume": vid, "readonly": True})
            self.limiter.take(size)
            step("/admin/tier_upload", {"volume": vid,
                                        "dest": rule.dest})
        except Exception as e:  # noqa: BLE001 — scan continues
            self.actions["tier_error"] += 1
            _metrics.lifecycle_actions_total.inc(action="tier",
                                                 outcome="error")
            out["errors"].append({"volume": vid, "node": url,
                                  "error": str(e)})
            self._note("tier_error", vid, url, error=str(e))
            return
        self.actions["tier_ok"] += 1
        _metrics.lifecycle_actions_total.inc(action="tier",
                                             outcome="ok")
        out["tiered"].append(vid)
        emit_event("lifecycle.tier", vid=vid, node=url,
                   dest=rule.dest, bytes=size,
                   collection=getattr(vinfo, "collection", ""))
        self._note("tier", vid, url, dest=rule.dest)

    def _vacuum_one(self, dn, vid: int, out: dict) -> None:
        url = dn.url()
        try:
            rpc.call(f"http://{url}/admin/vacuum", "POST",
                     json.dumps({"volume": vid}).encode(),
                     timeout=120.0, headers=rpc.PRIORITY_LOW)
        except Exception as e:  # noqa: BLE001
            self.actions["expire_error"] += 1
            _metrics.lifecycle_actions_total.inc(action="expire",
                                                 outcome="error")
            out["errors"].append({"volume": vid, "node": url,
                                  "error": str(e)})
            return
        self.actions["expire_ok"] += 1
        _metrics.lifecycle_actions_total.inc(action="expire",
                                             outcome="ok")
        out["vacuumed"].append(vid)

    def _note(self, kind: str, vid: int, node: str, **extra) -> None:
        self.recent.append({"at": round(time.time(), 3), "kind": kind,
                            "volume": vid, "node": node, **extra})

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        return {
            "enabled": bool(self.policy.rules),
            "rules": self.policy.to_dict()["rules"],
            "interval": self.interval,
            "scans": self.scans,
            "last_scan_age": (round(time.time() - self.last_scan, 3)
                              if self.last_scan else None),
            "actions": dict(self.actions),
            "recent": list(self.recent),
        }
