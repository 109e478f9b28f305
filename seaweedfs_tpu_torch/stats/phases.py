"""Per-request phase ledger: where did a request's wall time go?

The SLO plane (stats/slo.py) answers *which* requests are slow and
*whether* the tail is burning; this module answers *why* — how one
request's wall time splits across named phases:

  queue           admission-lane wait before dispatch (cluster/rpc.py)
  lock            time blocked on instrumented hot locks
                  (stats/contention.py feeds this automatically)
  disk            pread/pwrite/sendfile in the volume engine
  device          execution-fenced EC kernel/device legs
                  (stats.metrics.observe_ec_stage feeds this)
  rpc_downstream  outbound RPC round-trips (rpc.call and friends)
  handler         the residual: handler execution time not claimed by
                  any other phase (mostly CPU + GIL wait)

The rpc middleware opens a ledger on the serving thread before the
handler runs and closes it at response time; instrumentation points
anywhere below (storage, EC, client pool, metered locks) accumulate
into whatever ledger is active on their thread — zero coordination,
and zero cost when no ledger is active (one thread-local read).

The closed ledger rides three surfaces:

- `SeaweedFS_request_phase_seconds{role,family,phase,q}` windowed
  quantile gauges (SloTracker machinery) on /metrics;
- the `phases` field of every /debug/slow exemplar, so a slow trace
  shows its time budget inline;
- a `phases` attribute on the request's server span in /debug/traces.

Because `handler` is computed as the residual of the dispatch wall,
the non-queue phases always sum to the observed request seconds — the
"budget sums to the wall" invariant tests and BENCH_load gate on.

Cost design — this runs on EVERY request, so the plane must price in
low single-digit microseconds (the BENCH_load_r02 <3% gate):

- one Ledger per serving THREAD, reused across its keep-alive
  requests (no per-request allocation); phases accumulate into a
  fixed 6-slot float list reset with one C-speed slice assignment;
- nothing materializes a dict on the fast path — `Ledger.to_dict()`
  runs only for the consumers that actually read the budget (a slow
  exemplar, a recorded trace span, the 1-in-K phase-sketch sample).

Kill switch: SEAWEEDFS_TPU_PHASES=0 disables ledger creation entirely
(instrumentation points then see no active ledger and pay only the
thread-local read).  Toggleable at runtime via `phases.ENABLED` /
POST /debug/attribution.
"""

from __future__ import annotations

import os
import threading
import time

# Canonical phase names in slot order.  `queue` happens before the
# ledger opens (the middleware measured it at the admission gate) and
# is seeded in; `handler` is the closing residual.
PHASES = ("queue", "lock", "handler", "disk", "device",
          "rpc_downstream")
_IDX = {name: i for i, name in enumerate(PHASES)}
_QUEUE, _HANDLER = _IDX["queue"], _IDX["handler"]
# Public slot indices for inline hot-path accounting
# (`ledger.arr[IDX_DISK] += dt` skips the name lookup note() does).
IDX_LOCK = _IDX["lock"]
IDX_DISK = _IDX["disk"]
IDX_DEVICE = _IDX["device"]
IDX_RPC = _IDX["rpc_downstream"]
_ZEROS = [0.0] * len(PHASES)

ENABLED = os.environ.get("SEAWEEDFS_TPU_PHASES", "") not in ("0",
                                                             "false")

_local = threading.local()


class Ledger:
    """One request's phase accumulator.  Not thread-safe by design: a
    ledger belongs to exactly one serving thread (fan-out work on
    worker threads is accounted as `rpc_downstream` at the dispatch
    site, the same boundary the trace spans draw), and the thread
    reuses its ledger across keep-alive requests — consumers that
    outlive the request take a to_dict() copy, never the ledger."""

    __slots__ = ("t0", "arr")

    def __init__(self):
        self.t0 = 0.0
        self.arr = list(_ZEROS)

    def note(self, phase: str, seconds: float) -> None:
        self.arr[_IDX[phase]] += seconds

    def finish(self) -> None:
        """Close the ledger: the dispatch wall not claimed by a named
        phase becomes `handler`, so sum(non-queue phases) == wall."""
        arr = self.arr
        elapsed = time.perf_counter() - self.t0
        inner = sum(arr) - arr[_QUEUE]
        arr[_HANDLER] = max(0.0, elapsed - inner)

    def to_dict(self) -> dict[str, float]:
        """Materialize the nonzero phases — only consumers call this
        (exemplars, recorded spans, sampled sketches)."""
        arr = self.arr
        return {name: arr[i] for i, name in enumerate(PHASES)
                if arr[i] > 0.0}


def start(queue_seconds: float = 0.0) -> Ledger | None:
    """Open (reset) this thread's ledger (rpc middleware).  Returns
    None when the plane is disabled; callers skip finish() then."""
    if not ENABLED:
        return None
    ledger = getattr(_local, "spare", None)
    if ledger is None:
        ledger = _local.spare = Ledger()
    arr = ledger.arr
    arr[:] = _ZEROS
    if queue_seconds > 0.0:
        arr[_QUEUE] = queue_seconds
    ledger.t0 = time.perf_counter()
    _local.ledger = ledger
    return ledger


def finish(ledger: Ledger) -> Ledger:
    """Close this thread's ledger (handler residual computed) and
    detach it.  Returns the ledger for lazy to_dict() consumption —
    valid until this thread's next start()."""
    _local.ledger = None
    ledger.finish()
    return ledger


def active() -> Ledger | None:
    return getattr(_local, "ledger", None)


def note(phase: str, seconds: float) -> None:
    """Accumulate into the active ledger, if any — the hook for
    instrumentation that already measured its own elapsed time
    (metered locks, EC stage timers)."""
    ledger = getattr(_local, "ledger", None)
    if ledger is not None:
        ledger.arr[_IDX[phase]] += seconds


class phase:
    """Context manager accounting its body into the active ledger:

        with phases.phase("disk"):
            os.pread(...)

    When no ledger is active (no request on this thread, or the plane
    is disabled) the cost is one thread-local read — no perf_counter
    calls, no arithmetic.

    Lock waits noted INSIDE the window (a contended MeteredLock under
    an rpc_downstream call, e.g. the client conn pool) are subtracted
    from this phase's elapsed: each second of request wall belongs to
    exactly one phase, or the budget would sum past the wall."""

    __slots__ = ("idx", "_ledger", "_t0", "_lock0")

    def __init__(self, name: str):
        self.idx = _IDX[name]

    def __enter__(self):
        self._ledger = getattr(_local, "ledger", None)
        if self._ledger is not None:
            self._lock0 = self._ledger.arr[IDX_LOCK]
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ledger = self._ledger
        if ledger is not None:
            elapsed = time.perf_counter() - self._t0 - \
                (ledger.arr[IDX_LOCK] - self._lock0)
            if elapsed > 0.0:
                ledger.arr[self.idx] += elapsed
            self._ledger = None
        return False
