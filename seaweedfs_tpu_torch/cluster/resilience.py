"""Unified RPC resilience policy: retry/backoff + per-host circuit
breakers.

Before this module every call site hand-rolled (or omitted) its own
retry.  Now there is ONE policy object (`RetryPolicy`: exponential
backoff with full jitter, a per-attempt timeout under a total deadline
budget, idempotency-aware classification) and ONE per-host breaker
(`CircuitBreaker`: closed → open after K consecutive connect/5xx
failures, half-open probe after a cooldown), and the degraded paths —
`WeedClient.upload` re-assign, replication fan-out, the EC rebuild
shard gather — route through them.

Idempotency rule (extends rpc._request's stale-keep-alive rule): a
non-idempotent body must NEVER be re-sent after bytes may have hit the
wire.  The transport marks the one failure class where that is provably
safe — `ConnectError`, raised when the dial itself failed — and
`RetryPolicy.run` retries non-idempotent calls only on it (and on
`BreakerOpen`, which fails before any socket work at all).

This module deliberately imports nothing from cluster.rpc (rpc imports
it); classification is by exception type and a duck-typed `.status`
attribute.

Knobs (env, read at import as defaults; server flags in README):

- SEAWEEDFS_TPU_BREAKER_THRESHOLD  consecutive failures to open
                                   (default 5; 0 disables breakers)
- SEAWEEDFS_TPU_BREAKER_COOLDOWN   seconds open before a half-open
                                   probe (default 2.0)
"""

from __future__ import annotations

import random
import threading
import time

from ..stats.metrics import Counter, Gauge
from ..utils import env_float as _env_float


class ConnectError(ConnectionError):
    """Failure before any request bytes hit the wire (dial/TLS
    handshake).  Always safe to retry, idempotent or not."""


class BreakerOpen(ConnectionError):
    """Fast-fail: the per-host circuit breaker is open.  No socket was
    touched, so retrying (elsewhere, or after the cooldown) is safe."""


rpc_retries_total = Counter(
    "SeaweedFS_rpc_retries_total",
    "RPC retries by failure class", ("reason",))


# -- circuit breaker ---------------------------------------------------------

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}


BREAKER_THRESHOLD = int(_env_float("SEAWEEDFS_TPU_BREAKER_THRESHOLD", 5))
BREAKER_COOLDOWN = _env_float("SEAWEEDFS_TPU_BREAKER_COOLDOWN", 2.0)


class CircuitBreaker:
    """Per-host breaker guarding the client pool's dials.

    closed: all traffic flows; K consecutive failures (connect errors,
    or 5xx answers other than 503 — a 503 is a live server saying "go
    elsewhere", not a sick one) open it.  open: every acquire fails
    fast with BreakerOpen until `cooldown` elapses.  half-open: ONE
    probe request is let through; success closes the breaker, failure
    re-opens it for another cooldown.
    """

    __slots__ = ("threshold", "cooldown", "host", "_state", "_failures",
                 "_opened_at", "_probe_at", "_lock")

    def __init__(self, threshold: int = BREAKER_THRESHOLD,
                 cooldown: float = BREAKER_COOLDOWN, host: str = ""):
        self.threshold = threshold
        self.cooldown = cooldown
        self.host = host
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_at = 0.0
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        return _STATE_NAMES[self._state]

    def _emit(self, type_: str, **attrs) -> None:
        """Journal a state transition — called OUTSIDE the breaker lock
        (the journal is cheap but must never nest under it)."""
        from ..events import emit as emit_event
        emit_event(type_, severity="warn" if type_ == "breaker.open"
                   else "info", host=self.host, **attrs)

    def allow(self) -> bool:
        # Hot path: a closed breaker (the universal steady state) is one
        # lock-free attribute check.
        if self._state == CLOSED or self.threshold <= 0:
            return True
        now = time.monotonic()
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now - self._opened_at < self.cooldown:
                    return False
                self._state = HALF_OPEN
                self._probe_at = now
                half_open = True
            else:
                # HALF_OPEN: one probe in flight.  If the prober died
                # without recording an outcome, let a new probe through
                # after another cooldown rather than staying stuck open.
                if now - self._probe_at >= self.cooldown:
                    self._probe_at = now
                    return True
                return False
        if half_open:
            self._emit("breaker.half_open")
        return True  # the half-open probe

    def record_success(self) -> None:
        if self._state == CLOSED and self._failures == 0:
            return  # lock-free steady state
        with self._lock:
            closed = self._state != CLOSED
            self._state = CLOSED
            self._failures = 0
        if closed:
            self._emit("breaker.close")

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        opened = reopened = False
        with self._lock:
            if self._state == HALF_OPEN:
                self._state = OPEN
                self._opened_at = time.monotonic()
                opened = reopened = True
            else:
                self._failures += 1
                if self._failures >= self.threshold:
                    opened = self._state != OPEN
                    self._state = OPEN
                    self._opened_at = time.monotonic()
        if opened:
            self._emit("breaker.open", failures=self.threshold,
                       probe_failed=reopened)


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(hostport: str) -> CircuitBreaker:
    b = _breakers.get(hostport)
    if b is None:
        with _breakers_lock:
            b = _breakers.setdefault(hostport,
                                     CircuitBreaker(host=hostport))
    return b


def reset_breakers() -> None:
    """Forget all breaker state (tests; config reload)."""
    with _breakers_lock:
        _breakers.clear()


def _breaker_states() -> dict:
    with _breakers_lock:
        return {(hp,): float(b._state) for hp, b in _breakers.items()}


breaker_state_gauge = Gauge(
    "SeaweedFS_rpc_breaker_state",
    "per-host circuit breaker state (0 closed, 1 half-open, 2 open)",
    ("server",), callback=_breaker_states)


# -- retry policy ------------------------------------------------------------

class RetryPolicy:
    """Exponential backoff with full jitter under a total deadline.

    run(fn, idempotent=...) calls fn(attempt, timeout) up to
    max_attempts times.  `timeout` is the per-attempt budget, clipped
    to whatever remains of total_deadline — a dead peer costs one
    bounded attempt, never the whole deadline.

    Classification (which failures are retried):

    - ConnectError / BreakerOpen: no bytes hit the wire — retried
      always ("connect").
    - .status == 429 (admission shed — refused before the handler
      ran): retried always ("shed"), honoring the server's
      Retry-After pacing hint.
    - exceptions with .status in retry_statuses (5xx): the server
      answered — retried only when `idempotent` ("status").
    - other OSError/ConnectionError (reset mid-exchange, timeout):
      bytes may have been processed — retried only when `idempotent`
      ("io").

    Everything else (4xx answers, application errors) raises
    immediately.
    """

    def __init__(self, max_attempts: int = 3,
                 base_delay: float = 0.05, max_delay: float = 2.0,
                 per_attempt_timeout: float = 10.0,
                 total_deadline: float | None = None,
                 retry_statuses: tuple[int, ...] = (429, 500, 502,
                                                    503, 504),
                 rng: random.Random | None = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.per_attempt_timeout = per_attempt_timeout
        self.total_deadline = total_deadline
        self.retry_statuses = retry_statuses
        self._rng = rng or random

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay before retry number `attempt`+1: uniform
        in [0, min(max_delay, base * 2^attempt)] — decorrelates a
        thundering herd of clients retrying the same dead server."""
        cap = min(self.max_delay, self.base_delay * (2 ** attempt))
        return self._rng.uniform(0.0, cap)

    def classify(self, exc: BaseException,
                 idempotent: bool) -> str | None:
        """Retry reason for `exc`, or None = do not retry."""
        if isinstance(exc, (ConnectError, BreakerOpen)):
            return "connect"
        status = getattr(exc, "status", None)
        if status is not None:
            if status == 429 and 429 in self.retry_statuses:
                # Admission shed: the server refused BEFORE running
                # the handler, so retrying never replays a
                # non-idempotent body — safe like ConnectError.
                return "shed"
            if status in self.retry_statuses and idempotent:
                return "status"
            return None
        if isinstance(exc, (OSError, ConnectionError)) and idempotent:
            return "io"
        return None

    def run(self, fn, idempotent: bool = True, on_retry=None):
        """fn(attempt, timeout) with retries.  `on_retry(exc, attempt)`
        is called before each backoff sleep (logging hooks)."""
        deadline = (time.monotonic() + self.total_deadline
                    if self.total_deadline else None)
        last: BaseException | None = None
        for attempt in range(self.max_attempts):
            timeout = self.per_attempt_timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                timeout = min(timeout, remaining)
            try:
                return fn(attempt, timeout)
            except BaseException as e:  # noqa: BLE001 — reclassified
                reason = self.classify(e, idempotent)
                if reason is None or attempt == self.max_attempts - 1:
                    raise
                last = e
                rpc_retries_total.inc(reason=reason)
                if on_retry is not None:
                    on_retry(e, attempt)
                delay = self.backoff(attempt)
                # A 429/503 answer may carry the server's own pacing
                # hint (Retry-After from admission sheds and drain
                # refusals): honor it as a floor under the jittered
                # backoff, capped at the per-attempt budget so a
                # hostile/buggy header can't park the client.
                retry_after = getattr(e, "retry_after", None)
                if retry_after:
                    delay = max(delay, min(float(retry_after),
                                           self.per_attempt_timeout))
                if deadline is not None:
                    delay = min(delay,
                                max(0.0, deadline - time.monotonic()))
                time.sleep(delay)
        if last is not None:
            raise last
        raise TimeoutError(
            f"retry deadline {self.total_deadline}s exhausted before "
            "the first attempt")
