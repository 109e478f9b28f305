"""Quantile sketches: log-bucketed (DDSketch-style) estimators with a
sliding window, mergeable across processes.

The cumulative request histograms (stats/metrics.py) answer "how many
requests were ever slower than X" — useless for live tail latency: a
p99 over a process's whole lifetime is dominated by history, and fixed
bucket edges quantize the answer.  This module is the measured-tails
half of the SLO plane (stats/slo.py):

- `QuantileSketch`: log-spaced buckets with ratio gamma = (1+a)/(1-a).
  A value x lands in bucket i = ceil(log_gamma(x/min_value)); the
  bucket's representative value 2*gamma^i/(gamma+1)*min_value is
  within RELATIVE ERROR `alpha` of every value in the bucket.  So the
  DOCUMENTED ACCURACY BOUND is: for any rank r, the reported
  r-quantile q' and the true r-quantile q satisfy |q' - q| <= alpha*q
  (values below `min_value` collapse to one zero-bucket reported as
  `min_value`; sub-microsecond request latencies do not exist on this
  stack).  Tests (tests/test_slo.py) assert this bound against
  numpy.percentile on adversarial (bimodal, heavy-tailed)
  distributions.
- Buckets are a sparse dict, so memory is O(distinct buckets) — about
  ~700 possible buckets across 1us..1000s at the default alpha=0.01,
  a few dozen occupied in practice.
- Merging two sketches with the same (alpha, min_value) is exact bucket
  addition: the merged sketch is IDENTICAL to the sketch of the
  concatenated streams, which is what lets per-process sketches ride a
  heartbeat and aggregate into one cluster-wide quantile on
  /cluster/healthz.
- `WindowedSketch` slices time into `slices` ring segments of
  window/slices seconds each and drops whole segments as they expire:
  quantiles cover at least `window - window/slices` and at most
  `window` seconds of history.  The clock is injected so tests advance
  windows deterministically — no sleeps in the tier-1 suite.
"""

from __future__ import annotations

import math
import threading
import time

DEFAULT_ALPHA = 0.01
DEFAULT_MIN_VALUE = 1e-6


class QuantileSketch:
    """Mergeable log-bucketed quantile estimator (relative error
    `alpha` on the value at any rank — see module docstring)."""

    __slots__ = ("alpha", "min_value", "_gamma", "_log_gamma",
                 "count", "sum", "_buckets", "_zero")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 min_value: float = DEFAULT_MIN_VALUE):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha {alpha} not in (0, 1)")
        self.alpha = alpha
        self.min_value = min_value
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self._gamma)
        self.count = 0
        self.sum = 0.0
        self._buckets: dict[int, int] = {}
        self._zero = 0  # observations <= min_value

    def observe(self, value: float, n: int = 1) -> None:
        self.count += n
        self.sum += value * n
        if value <= self.min_value:
            self._zero += n
            return
        i = math.ceil(math.log(value / self.min_value) / self._log_gamma)
        self._buckets[i] = self._buckets.get(i, 0) + n

    def _value_of(self, index: int) -> float:
        # Midpoint estimate: within alpha of every value in
        # (gamma^(i-1), gamma^i] * min_value.
        return (2.0 * self._gamma ** index / (self._gamma + 1.0)
                * self.min_value)

    def quantile(self, q: float) -> float | None:
        """The q-quantile (0 <= q <= 1) of the observed stream, or None
        when empty.  Nearest-rank: rank = ceil(q * count)."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        seen = self._zero
        if rank <= seen:
            return self.min_value
        for i in sorted(self._buckets):
            seen += self._buckets[i]
            if rank <= seen:
                return self._value_of(i)
        return self._value_of(max(self._buckets))  # float-rounding tail

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Add `other`'s buckets into this sketch (exact: equals the
        sketch of the concatenated streams).  Parameter mismatch raises
        — merging across different gammas would silently mis-bucket."""
        if (other.alpha, other.min_value) != (self.alpha, self.min_value):
            raise ValueError(
                f"cannot merge sketches with different parameters: "
                f"({self.alpha}, {self.min_value}) vs "
                f"({other.alpha}, {other.min_value})")
        self.count += other.count
        self.sum += other.sum
        self._zero += other._zero
        for i, n in other._buckets.items():
            self._buckets[i] = self._buckets.get(i, 0) + n
        return self

    # -- wire format (heartbeats, /debug/slo) --------------------------------

    def to_dict(self) -> dict:
        return {"alpha": self.alpha, "min_value": self.min_value,
                "count": self.count, "sum": round(self.sum, 9),
                "zero": self._zero,
                "buckets": {str(i): n
                            for i, n in sorted(self._buckets.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        sk = cls(alpha=float(d.get("alpha", DEFAULT_ALPHA)),
                 min_value=float(d.get("min_value", DEFAULT_MIN_VALUE)))
        sk.count = int(d.get("count", 0))
        sk.sum = float(d.get("sum", 0.0))
        sk._zero = int(d.get("zero", 0))
        sk._buckets = {int(i): int(n)
                       for i, n in d.get("buckets", {}).items()}
        return sk


class WindowedSketch:
    """Sliding-window QuantileSketch: a ring of `slices` sub-sketches,
    each covering window/slices seconds; expired slices are dropped
    whole.  Bounded memory, thread-safe, injected clock (tests advance
    time without sleeping)."""

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 min_value: float = DEFAULT_MIN_VALUE,
                 window: float = 300.0, slices: int = 6,
                 clock=time.monotonic):
        if slices < 1:
            raise ValueError("slices must be >= 1")
        self.alpha = alpha
        self.min_value = min_value
        self.window = window
        self.slices = slices
        self.slice_seconds = window / slices
        self.clock = clock
        self._lock = threading.Lock()
        # ring[i] = (slice_epoch, sketch); slice_epoch identifies which
        # wall slice the entry belongs to, so expiry is a comparison,
        # not a scan of timestamps.
        self._ring: list[tuple[int, QuantileSketch] | None] = \
            [None] * slices

    def _epoch(self, now: float) -> int:
        return int(now // self.slice_seconds)

    def _current_locked(self, now: float) -> QuantileSketch:
        epoch = self._epoch(now)
        idx = epoch % self.slices
        slot = self._ring[idx]
        if slot is None or slot[0] != epoch:
            sk = QuantileSketch(self.alpha, self.min_value)
            self._ring[idx] = (epoch, sk)
            return sk
        return slot[1]

    def observe(self, value: float) -> None:
        now = self.clock()
        with self._lock:
            self._current_locked(now).observe(value)

    def merged(self) -> QuantileSketch:
        """One sketch over every live (non-expired) slice."""
        now = self.clock()
        newest = self._epoch(now)
        out = QuantileSketch(self.alpha, self.min_value)
        with self._lock:
            for slot in self._ring:
                if slot is not None and newest - slot[0] < self.slices:
                    out.merge(slot[1])
        return out

    def quantile(self, q: float) -> float | None:
        return self.merged().quantile(q)

    def count(self) -> int:
        return self.merged().count

    def to_dict(self) -> dict:
        return self.merged().to_dict()
