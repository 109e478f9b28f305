"""Workload SLO plane: live quantiles with trace exemplars + multi-window
burn-rate health for every server role.

The request histograms (cluster/rpc.py via stats/metrics.py) are
cumulative — fine for Prometheus, useless for "is the p99 burning RIGHT
NOW".  This module sits behind the rpc middleware's per-request
observation and keeps, per (endpoint-family, status-class):

- a sliding-window quantile sketch (stats/sketch.py — log-bucketed,
  mergeable, bounded memory, documented alpha relative-error bound),
  exported as `SeaweedFS_request_quantile_seconds{q="0.5|0.95|0.99"}`
  on /metrics and aggregated cluster-wide on /cluster/healthz (volume
  servers ship their read/write sketches in every heartbeat; the
  master merges them — merge is exact bucket addition);
- trace EXEMPLARS: every observation slower than the SLO threshold
  records {ts, family, status, seconds, trace_id} in a bounded ring,
  served by /debug/slow — a p99 spike links directly to its
  /debug/traces spans instead of being a number with no story;
- a multi-window BURN-RATE engine over declared objectives
  (-slo.read.p99 latency target, -slo.availability): error budget
  consumption measured over a short (5m) and long (1h) window, Google
  SRE-workbook style — fast burn (>= 14.4x budget in both windows)
  degrades /cluster/healthz and emits the `slo.burn` event; slow burn
  (>= 6x) is reported without degrading.

Objectives are OPT-IN: with no -slo.* flags the tracker still measures
quantiles and records exemplars (threshold defaults to 250ms, the
tracer's slow-span default), but never computes burn or degrades
healthz — a cluster that declared no objective cannot violate one.

This module must not import cluster.rpc (rpc imports it); route
handlers return plain (status, dict) tuples like trace/fault/events
routes do.
"""

from __future__ import annotations

import threading
import time

from ..trace import tracer as _tracer
from ..utils import env_float as _env_float
from .sketch import QuantileSketch, WindowedSketch

# Exemplar threshold when no latency objective is declared: matches the
# tracer's always-sample-slow default (SEAWEEDFS_TPU_TRACE_SLOW_MS).
DEFAULT_EXEMPLAR_THRESHOLD = 0.25

# Burn-rate thresholds (SRE workbook: 14.4x burns a 30-day budget in
# ~2 days — page; 6x in ~5 days — ticket).
FAST_BURN = 14.4
SLOW_BURN = 6.0

QUANTILES = (0.5, 0.95, 0.99)

# Phase-sketch subsampling: every K-th request feeds the per-phase
# windowed sketches (slow requests always do) — see observe().
PHASE_SAMPLE_EVERY = 8

# Families that are cluster control/introspection traffic, excluded
# from the aggregate read/write sketches and the burn windows: a
# failing admin call is an operator's problem, not an SLO violation,
# and healthz polling must not dilute the data-plane tail.
_CONTROL_PREFIXES = ("/debug", "/admin", "/cluster", "/heartbeat",
                     "/metrics", "/vol/", "/col/", "/.meta", "/.kv",
                     "/.ui", "/ui")


def data_plane(family: str) -> bool:
    return not family.startswith(_CONTROL_PREFIXES)


class SloObjectives:
    """Declared objectives for one role.  `availability` is a fraction
    (0.999) — values > 1 are treated as percent (99.9 -> 0.999) so the
    flag reads naturally either way.  `read_p99` is seconds."""

    __slots__ = ("read_p99", "availability")

    def __init__(self, read_p99: float | None = None,
                 availability: float | None = None):
        if availability is not None and availability > 1.0:
            availability = availability / 100.0
        if availability is not None and not 0.0 < availability < 1.0:
            raise ValueError(
                f"-slo.availability {availability} must be in (0, 1) "
                f"(or a percent like 99.9)")
        if read_p99 is not None and read_p99 <= 0:
            raise ValueError(f"-slo.read.p99 {read_p99} must be > 0")
        self.read_p99 = read_p99
        self.availability = availability

    @property
    def declared(self) -> bool:
        return self.read_p99 is not None or self.availability is not None

    def to_dict(self) -> dict:
        return {"read_p99": self.read_p99,
                "availability": self.availability}


class _CounterRing:
    """Sliding-window counters (total/bad/slow/reads/shed) with the
    same whole-slice expiry and injected clock as WindowedSketch.
    `total` counts EXECUTED data-plane requests; sheds (429 refused
    before execution) ride their own column so they neither dilute the
    error rate nor masquerade as fast requests."""

    __slots__ = ("window", "slices", "slice_seconds", "clock", "_ring",
                 "_lock")

    def __init__(self, window: float, slices: int = 6,
                 clock=time.monotonic):
        self.window = window
        self.slices = slices
        self.slice_seconds = window / slices
        self.clock = clock
        # [epoch, total, bad, slow, reads, shed]
        self._ring: list[list | None] = [None] * slices
        self._lock = threading.Lock()

    def _slot(self) -> list:
        epoch = int(self.clock() // self.slice_seconds)
        idx = epoch % self.slices
        slot = self._ring[idx]
        if slot is None or slot[0] != epoch:
            slot = self._ring[idx] = [epoch, 0, 0, 0, 0, 0]
        return slot

    def add(self, bad: bool, slow: bool, read: bool) -> None:
        with self._lock:
            slot = self._slot()
            slot[1] += 1
            if bad:
                slot[2] += 1
            if slow:
                slot[3] += 1
            if read:
                slot[4] += 1

    def add_shed(self) -> None:
        with self._lock:
            self._slot()[5] += 1

    def totals(self) -> tuple[int, int, int, int, int]:
        """(total, bad, slow, reads, shed) over the live window."""
        newest = int(self.clock() // self.slice_seconds)
        out = [0, 0, 0, 0, 0]
        with self._lock:
            for slot in self._ring:
                if slot is not None and newest - slot[0] < self.slices:
                    for i in range(5):
                        out[i] += slot[i + 1]
        return tuple(out)


class SloTracker:
    """Per-role request SLO state: windowed quantile sketches keyed by
    (endpoint-family, status-class), aggregate read/write sketches for
    cross-process aggregation, slow-request exemplars, and the
    burn-rate engine.  One instance per JsonHttpServer, created by
    enable_metrics; servers declare objectives with set_objectives()."""

    # Burn is meaningless on a handful of requests: below this many
    # data-plane requests in the short window the engine reports
    # rates but never flips fast/slow burn.
    MIN_WINDOW_REQUESTS = 10

    def __init__(self, role: str, node: str = "",
                 objectives: SloObjectives | None = None,
                 clock=time.monotonic,
                 short_window: float | None = None,
                 long_window: float | None = None,
                 slices: int = 6,
                 exemplar_capacity: int = 256,
                 alpha: float = 0.01):
        from collections import deque
        # The canonical SRE windows (5m fast / 1h slow), overridable by
        # env for harnesses that must drive a burn inside seconds
        # (bench_load.py) — never something a test sleeps through.
        if short_window is None:
            short_window = _env_float(
                "SEAWEEDFS_TPU_SLO_SHORT_WINDOW", 300.0)
        if long_window is None:
            long_window = _env_float(
                "SEAWEEDFS_TPU_SLO_LONG_WINDOW", 3600.0)
        self.role = role
        self.node = node
        self.objectives = objectives or SloObjectives()
        self.clock = clock
        self.short_window = short_window
        self.long_window = long_window
        self.slices = slices
        self.alpha = alpha
        self._lock = threading.Lock()
        # (family, status_class) -> WindowedSketch over the short window
        self._sketches: dict[tuple[str, str], WindowedSketch] = {}
        # Time-attribution plane (stats/phases.py): (family, phase) ->
        # WindowedSketch of that phase's per-request seconds.  Bounded:
        # families are bounded by the route table, phases by
        # phases.PHASES.  Fed by a 1-in-PHASE_SAMPLE_EVERY subsample
        # (slow requests always included), so the sketches skew toward
        # the tail they exist to explain while the per-request cost
        # stays flat.
        self._phase_sketches: dict[tuple[str, str], WindowedSketch] = {}
        self._phase_tick = 0
        # Aggregate data-plane sketches by op class — what heartbeats
        # ship and healthz merges.
        self._agg = {op: WindowedSketch(alpha=alpha, window=short_window,
                                        slices=slices, clock=clock)
                     for op in ("read", "write")}
        self._burn_short = _CounterRing(short_window, slices, clock)
        self._burn_long = _CounterRing(long_window, slices, clock)
        self._exemplars: "deque[dict]" = deque(maxlen=exemplar_capacity)
        self.exemplars_recorded = 0
        self._burning = False

    # -- configuration -------------------------------------------------------

    def set_objectives(self, read_p99: float | None = None,
                       availability: float | None = None) -> None:
        self.objectives = SloObjectives(read_p99, availability)
        self._burning = False

    def exemplar_threshold(self) -> float:
        return self.objectives.read_p99 or DEFAULT_EXEMPLAR_THRESHOLD

    # -- observation (rpc middleware hot path) -------------------------------

    def observe(self, family: str, method: str, status: int,
                seconds: float, trace_id: str = "",
                phases: dict | None = None) -> None:
        sc = f"{status // 100}xx"
        key = (family, sc)
        sk = self._sketches.get(key)
        if sk is None:
            with self._lock:
                sk = self._sketches.setdefault(
                    key, WindowedSketch(alpha=self.alpha,
                                        window=self.short_window,
                                        slices=self.slices,
                                        clock=self.clock))
        sk.observe(seconds)
        # Hoisted once: the threshold feeds both the phase-sketch
        # sample condition and the exemplar branch below.  (Distinct
        # from the burn engine's read-SLO `slow` flag computed in the
        # data-plane block.)
        exemplar_slow = seconds > (self.objectives.read_p99
                                   or DEFAULT_EXEMPLAR_THRESHOLD)
        phase_dict = None
        if phases is not None:
            # `phases` is a stats.phases.Ledger (rpc middleware) or a
            # plain dict (tests / direct callers); the Ledger is
            # materialized LAZILY — only for the consumers below.
            # Phase sketches are fed from a deterministic 1-in-K
            # uniform subsample: quantiles of a uniform subsample are
            # unbiased, and at per-request rates the 3-4 extra sketch
            # observes would be the plane's single biggest tax.  Slow
            # exemplars and trace spans carry FULL budgets regardless
            # — only the aggregate quantile feed is thinned.
            self._phase_tick += 1
            if exemplar_slow or \
                    self._phase_tick >= PHASE_SAMPLE_EVERY:
                self._phase_tick = 0
                phase_dict = phases.to_dict() \
                    if hasattr(phases, "to_dict") else phases
                for phase, p_seconds in phase_dict.items():
                    pkey = (family, phase)
                    psk = self._phase_sketches.get(pkey)
                    if psk is None:
                        with self._lock:
                            psk = self._phase_sketches.setdefault(
                                pkey, WindowedSketch(
                                    alpha=self.alpha,
                                    window=self.short_window,
                                    slices=self.slices,
                                    clock=self.clock))
                    psk.observe(p_seconds)
        if data_plane(family):
            read = method in ("GET", "HEAD")
            if status == 429:
                # Shed before execution: its "latency" is queue wait,
                # not service time — keep it OUT of the aggregate
                # read/write tails (a shedding storm must not make the
                # cluster p50 look better) and out of the error rate's
                # denominator; the burn windows track it separately.
                self._burn_short.add_shed()
                self._burn_long.add_shed()
            else:
                self._agg["read" if read else "write"].observe(seconds)
                bad = status >= 500
                slow = (read and self.objectives.read_p99 is not None
                        and seconds > self.objectives.read_p99)
                self._burn_short.add(bad, slow, read)
                self._burn_long.add(bad, slow, read)
        if exemplar_slow:
            self.exemplars_recorded += 1
            doc = {
                "ts": time.time(), "family": family, "method": method,
                "status": status, "seconds": round(seconds, 6),
                "trace_id": trace_id}
            if phases is not None:
                # The slow request's time budget rides the exemplar:
                # /debug/slow answers "slow doing WHAT" inline instead
                # of sending the operator to cross-reference a trace.
                if phase_dict is None:
                    phase_dict = phases.to_dict() \
                        if hasattr(phases, "to_dict") else phases
                doc["phases"] = {k: round(v, 6)
                                 for k, v in phase_dict.items()}
            self._exemplars.append(doc)

    # -- burn-rate engine ----------------------------------------------------

    @staticmethod
    def _window_rates(breaching: int, denom: int, shed: int,
                      budget: float) -> dict:
        rate = (breaching / denom) if denom else 0.0
        return {"total": denom, "breaching": breaching,
                "rate": round(rate, 6), "shed": shed,
                "burn": round(rate / budget, 3)}

    def burn_state(self) -> dict:
        """Evaluate the declared objectives over both windows; emits
        `slo.burn` (once per episode) when fast burn flips on.  Called
        from heartbeats, healthz, /debug/slo, and the burn gauge — no
        background thread needed."""
        obj = self.objectives
        out: dict = {"declared": obj.declared, "fast_burn": False,
                     "slow_burn": False}
        if not obj.declared:
            return out
        # (total, bad, slow, reads, shed) per window.
        short = self._burn_short.totals()
        long_ = self._burn_long.totals()
        fast = slow_burn = False
        worst: tuple[str, float] | None = None
        if obj.availability is not None:
            budget = 1.0 - obj.availability
            avail = {"objective": obj.availability, "budget": budget,
                     "short": self._window_rates(short[1], short[0],
                                                 short[4], budget),
                     "long": self._window_rates(long_[1], long_[0],
                                                long_[4], budget)}
            out["availability"] = avail
            b = min(avail["short"]["burn"], avail["long"]["burn"])
            if short[0] >= self.MIN_WINDOW_REQUESTS:
                if b >= FAST_BURN:
                    fast = True
                elif b >= SLOW_BURN:
                    slow_burn = True
            if worst is None or b > worst[1]:
                worst = ("availability", b)
        if obj.read_p99 is not None:
            # A p99 objective budgets 1% of READS above the threshold:
            # the denominator is reads, not all requests — a write-
            # heavy workload must not dilute a read-latency collapse
            # below the burn thresholds.
            budget = 0.01
            lat = {"objective_p99": obj.read_p99, "budget": budget,
                   "short": self._window_rates(short[2], short[3],
                                               short[4], budget),
                   "long": self._window_rates(long_[2], long_[3],
                                              long_[4], budget)}
            out["latency"] = lat
            b = min(lat["short"]["burn"], lat["long"]["burn"])
            if short[3] >= self.MIN_WINDOW_REQUESTS:
                if b >= FAST_BURN:
                    fast = True
                elif b >= SLOW_BURN:
                    slow_burn = True
            if worst is None or b > worst[1]:
                worst = ("latency", b)
        out["fast_burn"] = fast
        out["slow_burn"] = slow_burn
        # Episode flag flips under the lock: burn_state runs from
        # scrapes, heartbeats, and healthz on different threads, and
        # `slo.burn` must fire exactly once per episode.
        emit = False
        with self._lock:
            if fast and not self._burning:
                self._burning = True
                emit = True
            elif not fast:
                self._burning = False
        if emit:
            self._emit_burn(out, worst)
        return out

    def _emit_burn(self, state: dict, worst) -> None:
        from ..events import emit as emit_event
        slo_kind, burn = worst if worst else ("availability", 0.0)
        detail = state.get(slo_kind) or {}
        with _tracer.root_span("slo.burn", self.role):
            emit_event("slo.burn", node=self.node or self.role,
                       severity="warn", role=self.role, slo=slo_kind,
                       burn=burn,
                       short_rate=detail.get("short", {}).get("rate", 0.0),
                       long_rate=detail.get("long", {}).get("rate", 0.0),
                       short_total=detail.get("short", {}).get("total", 0))

    # -- exports -------------------------------------------------------------

    def quantile_gauge_values(self) -> dict:
        """Gauge callback for SeaweedFS_request_quantile_seconds
        {role, family, status, q} — only live (windowed) series."""
        out: dict[tuple, float] = {}
        with self._lock:
            items = list(self._sketches.items())
        for (family, sc), wsk in items:
            merged = wsk.merged()
            if merged.count == 0:
                continue
            for q in QUANTILES:
                out[(self.role, family, sc, f"{q:g}")] = \
                    merged.quantile(q)
        return out

    def phase_gauge_values(self) -> dict:
        """Gauge callback for SeaweedFS_request_phase_seconds
        {role, family, phase, q} — live windowed phase-time quantiles
        (the per-role answer to "where does request time go")."""
        out: dict[tuple, float] = {}
        with self._lock:
            items = list(self._phase_sketches.items())
        for (family, phase), wsk in items:
            merged = wsk.merged()
            if merged.count == 0:
                continue
            for q in QUANTILES:
                out[(self.role, family, phase, f"{q:g}")] = \
                    merged.quantile(q)
        return out

    def phase_quantiles(self) -> dict:
        """JSON view of the live phase sketches, grouped by family —
        the /debug/slo `phases` section and the bench's p99 breakdown
        source."""
        with self._lock:
            items = list(self._phase_sketches.items())
        out: dict[str, dict] = {}
        for (family, phase), wsk in items:
            merged = wsk.merged()
            if merged.count == 0:
                continue
            out.setdefault(family, {})[phase] = {
                "count": merged.count,
                **{f"p{int(q * 100)}": merged.quantile(q)
                   for q in QUANTILES}}
        return out

    def burn_gauge_values(self) -> dict:
        """Gauge callback for SeaweedFS_slo_burn_rate{role, slo,
        window}; empty when no objective is declared."""
        state = self.burn_state()
        out: dict[tuple, float] = {}
        for slo_kind in ("availability", "latency"):
            detail = state.get(slo_kind)
            if not detail:
                continue
            for window in ("short", "long"):
                out[(self.role, slo_kind, window)] = \
                    detail[window].get("burn", 0.0)
        return out

    def exemplars(self, limit: int = 50) -> list[dict]:
        out = list(self._exemplars)
        return out[-limit:][::-1]  # newest first

    def agg_quantiles(self, op: str) -> dict:
        merged = self._agg[op].merged()
        qs = {f"p{int(q * 100)}": merged.quantile(q)
              for q in QUANTILES}
        qs["count"] = merged.count
        return qs

    def heartbeat_view(self) -> dict:
        """Compact per-beat state: burn verdict + the mergeable
        aggregate sketches, so the master can fold every node into one
        cluster-wide quantile without a per-node scrape."""
        state = self.burn_state()
        return {"declared": state["declared"],
                "fast_burn": state["fast_burn"],
                "slow_burn": state["slow_burn"],
                "read": self._agg["read"].to_dict(),
                "write": self._agg["write"].to_dict()}

    def snapshot(self) -> dict:
        """Full /debug/slo payload."""
        with self._lock:
            items = list(self._sketches.items())
        families = {}
        for (family, sc), wsk in items:
            merged = wsk.merged()
            if merged.count == 0:
                continue
            families[f"{family} {sc}"] = {
                "count": merged.count,
                **{f"p{int(q * 100)}": merged.quantile(q)
                   for q in QUANTILES}}
        return {"role": self.role, "node": self.node,
                "objectives": self.objectives.to_dict(),
                "exemplar_threshold": self.exemplar_threshold(),
                "exemplars_recorded": self.exemplars_recorded,
                "burn": self.burn_state(),
                "families": families,
                "phases": self.phase_quantiles(),
                "read": {"quantiles": self.agg_quantiles("read"),
                         "sketch": self._agg["read"].to_dict()},
                "write": {"quantiles": self.agg_quantiles("write"),
                          "sketch": self._agg["write"].to_dict()}}


def merge_sketch_dicts(dicts: list[dict]) -> QuantileSketch | None:
    """Fold wire-format sketches (heartbeat_view / /debug/slo payloads)
    into one QuantileSketch — the /cluster/healthz aggregation.  Skips
    parameter-mismatched sketches (mixed-version clusters) rather than
    corrupting the estimate; returns None when nothing merged."""
    out: QuantileSketch | None = None
    for d in dicts:
        if not isinstance(d, dict) or "buckets" not in d:
            continue
        try:
            sk = QuantileSketch.from_dict(d)
        except (ValueError, TypeError, AttributeError, KeyError):
            # Malformed wire payloads (mixed-version or buggy peers:
            # buckets as a list, non-numeric fields) must degrade to
            # "skipped", never 500 the healthz handler.
            continue
        if out is None:
            out = sk
        else:
            try:
                out.merge(sk)
            except ValueError:
                continue
    return out


# -- routes ------------------------------------------------------------------

def setup_slo_routes(server) -> None:
    """Mount /debug/slow (exemplars) + /debug/slo (full SLO state) on a
    server whose enable_metrics created a tracker.  Mounted by the
    cluster roles (master/volume/filer) next to the other /debug
    surfaces; gateways keep their user-facing namespace clean."""

    def _slow(query: dict, body: bytes):
        tr = getattr(server, "slo", None)
        if tr is None:
            return (404, {"error": "slo tracking not enabled"})
        try:
            limit = int(query.get("limit", 50) or 50)
        except ValueError:
            return (400, {"error": "limit must be a number"})
        return {"role": tr.role, "node": tr.node,
                "threshold_seconds": tr.exemplar_threshold(),
                "recorded": tr.exemplars_recorded,
                "exemplars": tr.exemplars(limit)}

    def _slo(query: dict, body: bytes):
        tr = getattr(server, "slo", None)
        if tr is None:
            return (404, {"error": "slo tracking not enabled"})
        return tr.snapshot()

    server.route("GET", "/debug/slow", _slow)
    server.route("GET", "/debug/slo", _slo)
