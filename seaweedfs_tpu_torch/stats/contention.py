"""Lock-contention metering: named instrumented locks + /debug/locks.

The phase ledger (stats/phases.py) attributes a slow request's time to
`lock` only if something measures the waits; this module is that
something.  A `MeteredLock` wraps a threading.Lock/RLock under a
bounded, operator-meaningful name ("volume.write", "integrity.ecc",
"admission.read", "rpc.pool") and records:

- `SeaweedFS_lock_wait_seconds{lock=}`  — histogram of CONTENDED
  acquire waits (the uncontended path never touches the histogram);
- `SeaweedFS_lock_hold_seconds{lock=}`  — histogram of hold times;
- the wait is also fed to the active request's phase ledger, so lock
  time shows up in /debug/slow exemplars without extra plumbing.

`/debug/locks` (setup_contention_routes) lists every registered lock
with its current holder and waiters — thread names AND stacks, pulled
lazily from sys._current_frames() at snapshot time, so the acquire
path never formats a stack.

Cost contract (asserted by tests/test_attribution.py, same stance as
the fault registry's disarmed guarantee):

- disarmed (ENABLED=False / SEAWEEDFS_TPU_LOCK_METER=0): one module-
  global truthiness check, then the raw lock — no timing, no dicts;
- armed + uncontended: a try-acquire, two attribute stores and one
  perf_counter read on acquire; one perf_counter read and a histogram
  observe on release.  No extra locks are taken on the acquire side.

Contended acquires (the case worth measuring) pay the histogram and
the waiter-table upkeep.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
import weakref

from . import phases as _phases
from .metrics import Histogram

ENABLED = os.environ.get("SEAWEEDFS_TPU_LOCK_METER", "") not in (
    "0", "false")

# Wait buckets skew low: a 100µs convoy on a per-request lock is
# already interesting; holds reuse the same shape.
_LOCK_BUCKETS = (0.00001, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
                 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 10.0)

lock_wait_seconds = Histogram(
    "SeaweedFS_lock_wait_seconds",
    "contended lock acquire wait time by lock name", ("lock",),
    buckets=_LOCK_BUCKETS)

lock_hold_seconds = Histogram(
    "SeaweedFS_lock_hold_seconds",
    "lock hold time by lock name", ("lock",),
    buckets=_LOCK_BUCKETS)

# Every live MeteredLock, for the /debug/locks snapshot.  WeakSet so
# short-lived locks (per-volume ecc locks of deleted volumes) don't
# accumulate forever.  Registration and snapshot iteration serialize
# on _REGISTRY_LOCK: a /debug/locks walk racing a fresh lock's
# construction would otherwise RuntimeError mid-iteration.
_REGISTRY: "weakref.WeakSet[MeteredLock]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()


def _registered() -> "list[MeteredLock]":
    with _REGISTRY_LOCK:
        return list(_REGISTRY)


class MeteredLock:
    """A named lock with wait/hold metering.  Wraps threading.Lock by
    default; pass lock=threading.RLock() for reentrant use — nested
    acquires by the holder are counted by depth and the hold is
    measured outermost-acquire to outermost-release.

    hold_observe_min: holds shorter than this skip the hold histogram
    (they still update the live holder view and the acquire counter).
    Per-request locks guarding two counter increments (admission
    lanes, the client pool) set it to 1ms: their nanosecond holds are
    histogram noise that would cost more to record than they teach,
    while a pathological hold (someone sleeping under the lane lock)
    still lands."""

    __slots__ = ("name", "_lock", "_holder", "_depth", "_since",
                 "_waiters", "contended", "acquired",
                 "hold_observe_min", "_wait_series", "_hold_series",
                 "__weakref__")

    def __init__(self, name: str, lock=None,
                 hold_observe_min: float = 0.0):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()
        self._holder = 0          # thread ident, 0 = unheld
        self._depth = 0           # reentrancy depth (RLock inner)
        self._since = 0.0         # perf_counter at outermost acquire
        # ident -> wall-clock wait start; plain dict mutated only by
        # the waiting thread itself (GIL-serialized item ops).
        self._waiters: dict[int, float] = {}
        self.contended = 0        # lifetime contended-acquire count
        self.acquired = 0         # lifetime acquire count (armed only)
        self.hold_observe_min = hold_observe_min
        # Pre-resolved series handles: label work happens once, not
        # per observe — the armed-uncontended release path must stay
        # microseconds (asserted by test).
        self._wait_series = lock_wait_seconds.series(lock=name)
        self._hold_series = lock_hold_seconds.series(lock=name)
        with _REGISTRY_LOCK:
            _REGISTRY.add(self)

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if not ENABLED:
            return self._lock.acquire(blocking, timeout)
        me = threading.get_ident()
        if self._holder == me:
            # Reentrant fast path (RLock inner): never contended.
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                self._depth += 1
                self.acquired += 1
            return ok
        if self._lock.acquire(False):
            self._holder = me
            self._depth = 1
            self._since = time.perf_counter()
            self.acquired += 1
            return True
        if not blocking:
            return False
        self._waiters[me] = time.time()
        t0 = time.perf_counter()
        try:
            ok = self._lock.acquire(True, timeout)
        finally:
            self._waiters.pop(me, None)
        wait = time.perf_counter() - t0
        self.contended += 1
        self._wait_series.observe(wait)
        _phases.note("lock", wait)
        if ok:
            self._holder = me
            self._depth = 1
            self._since = time.perf_counter()
            self.acquired += 1
        return ok

    def release(self) -> None:
        if not ENABLED:
            # Disarmed fast path — but if metering was disarmed
            # MID-HOLD (the runtime /debug/attribution toggle), the
            # armed acquire's bookkeeping must still settle: a stale
            # _holder would turn this thread's next acquire into a
            # phantom reentrant path and show a forever-held lock on
            # /debug/locks.  _holder is 0 in the common case, so this
            # stays one attr truthiness check.
            if self._holder and \
                    self._holder == threading.get_ident():
                self._depth -= 1
                if self._depth <= 0:
                    self._holder = 0
            self._lock.release()
            return
        if self._holder != threading.get_ident():
            # The acquire happened while disarmed: raw release.
            self._lock.release()
            return
        self._depth -= 1
        if self._depth > 0:
            self._lock.release()
            return
        hold = time.perf_counter() - self._since
        self._holder = 0
        self._lock.release()
        if hold >= self.hold_observe_min:
            self._hold_series.observe(hold)

    # `with lock:` binds __enter__ directly to acquire (the bool
    # return is fine — `with` discards it): one Python call saved on
    # the hottest path in the module.
    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        locked = getattr(self._lock, "locked", None)
        if locked is not None:
            return locked()
        # RLock has no locked(); the holder field is our view.
        return self._holder != 0

    # -- introspection -------------------------------------------------------

    def snapshot(self, frames=None,
                 threads=None) -> dict | None:
        """State for /debug/locks; None when idle (unheld, no
        waiters) so the surface lists only what matters."""
        holder, since = self._holder, self._since
        waiters = dict(self._waiters)
        if not holder and not waiters:
            return None
        out: dict = {"lock": self.name, "contended": self.contended}
        if holder:
            out["holder"] = _thread_view(holder, frames, threads)
            out["held_seconds"] = round(
                time.perf_counter() - since, 6)
        now = time.time()
        out["waiters"] = [
            dict(_thread_view(ident, frames, threads),
                 waiting_seconds=round(now - t0, 6))
            for ident, t0 in waiters.items()]
        return out


def _thread_view(ident: int, frames, threads) -> dict:
    out: dict = {"thread_id": ident}
    if threads is not None:
        th = threads.get(ident)
        if th is not None:
            out["thread"] = th.name
    if frames is not None:
        frame = frames.get(ident)
        if frame is not None:
            out["stack"] = [
                line.rstrip("\n")
                for line in traceback.format_stack(frame)[-12:]]
    return out


def wrap_rwlock_write(rwlock, name: str) -> None:
    """Arm an utils.rwlock.RWLock's write side with wait/hold metering
    under `name` (the volume engine's dataFileAccessLock analog).  The
    read side stays unmetered — readers are the uncontended common
    case and must never pay a histogram."""
    rwlock._meter_name = name


def snapshot_all() -> list[dict]:
    """Current holders/waiters across every registered lock — the
    /debug/locks payload.  Stacks are resolved here, once per
    snapshot, never on the acquire path."""
    frames = sys._current_frames()
    threads = {th.ident: th for th in threading.enumerate()}
    out = []
    for lk in _registered():
        try:
            snap = lk.snapshot(frames, threads)
        except Exception:  # noqa: BLE001 — a racing release mid-walk
            continue
        if snap is not None:
            out.append(snap)
    out.sort(key=lambda d: d["lock"])
    return out


def totals() -> list[dict]:
    """Lifetime acquire/contended counters per lock name (merged
    across instances sharing a name, e.g. per-volume ecc locks)."""
    agg: dict[str, list[int]] = {}
    for lk in _registered():
        row = agg.setdefault(lk.name, [0, 0])
        row[0] += lk.acquired
        row[1] += lk.contended
    return [{"lock": name, "acquired": a, "contended": c}
            for name, (a, c) in sorted(agg.items())]


# -- routes ------------------------------------------------------------------

def set_plane_enabled(on: bool, feature: str = "") -> None:
    """Arm/disarm the time-attribution plane at runtime — all of it,
    or one feature ("locks" | "phases" | "profiler") for overhead
    bisection.  The profiler is paused, not destroyed — its ring
    survives a disarm.  The per-request instrumentation points read
    these flags dynamically, so the flip is immediate and
    restart-free."""
    global ENABLED
    from ..utils import pprof
    from . import phases as _ph
    if feature in ("", "locks"):
        ENABLED = on
    if feature in ("", "phases"):
        _ph.ENABLED = on
    if feature in ("", "profiler"):
        prof = pprof.PROFILER
        if prof is not None:
            prof.start() if on else prof.stop()


def setup_contention_routes(server) -> None:
    """Mount GET /debug/locks: live holders/waiters with stacks plus
    lifetime per-lock counters.  Mounted unconditionally on the
    cluster roles beside /debug/slow — the surface is read-only and
    cheap (stacks resolve per request, not per acquire).

    Also mounts POST /debug/attribution?enabled=0|1 — the restart-free
    kill switch for the whole plane (lock metering + phase ledger +
    continuous profiler).  Operationally: disarm to rule the plane out
    while chasing a regression; it is also how BENCH_load_r02 prices
    the plane A/B on ONE cluster instance, immune to instance-level
    variance (allocator layout, ASLR) that dwarfs a 2% effect."""

    def _locks(query: dict, body: bytes):
        return {"metering": ENABLED,
                "active": snapshot_all(),
                "locks": totals()}

    def _toggle(query: dict, body: bytes):
        on = query.get("enabled", "1") not in ("0", "false")
        feature = query.get("feature", "")
        if feature not in ("", "locks", "phases", "profiler"):
            return (400, {"error": f"unknown feature {feature!r}"})
        set_plane_enabled(on, feature)
        from . import phases as _ph
        from ..utils import pprof
        return {"enabled": on,
                "lock_meter": ENABLED,
                "phases": _ph.ENABLED,
                "profiler_running": bool(pprof.PROFILER is not None
                                         and pprof.PROFILER.running)}

    server.route("GET", "/debug/locks", _locks)
    server.route("POST", "/debug/attribution", _toggle)
