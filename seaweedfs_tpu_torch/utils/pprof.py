"""Profiling hooks — the reference's pprof plane, Python-native.

Reference: weed/util/grace/pprof.go:17-29 (`-cpuprofile/-memprofile`
flags writing profiles at graceful exit) and the `net/http/pprof`
debug handlers.  Equivalents here:

- setup_profiling(cpuprofile, memprofile): a 100Hz ALL-THREADS stack
  sampler from launch, dumped at exit in collapsed-stack format
  (flamegraph.pl / speedscope compatible); tracemalloc for the heap.
- enable_pprof_routes(server): /debug/pprof/{profile,heap,threads} —
  ring-buffered or on-demand sampling, heap ranking (with ?stop),
  live thread stacks.
- ContinuousProfiler: an ALWAYS-ON low-rate (default ~19Hz — prime,
  so it can't phase-lock with periodic work) background sampler
  feeding a ring of 60s collapsed-stack windows.
  `/debug/pprof/profile?window=N` answers instantly from the last N
  windows; `?seconds=S` still takes a live high-rate sample.  The
  profiler also tracks a runnable-thread gauge
  (`SeaweedFS_runnable_threads`): how many sampled threads were NOT
  parked in a known wait — on CPython a direct GIL-pressure proxy.

Sampling (sys._current_frames) rather than cProfile because cProfile
instruments only the thread that enables it — useless for servers
whose work runs on handler threads; a sampler sees every thread.

The routes are mounted only when SEAWEEDFS_TPU_PPROF=1: they are
unauthenticated by design (like net/http/pprof) and heap tracing taxes
every allocation, so exposing them is an operator decision.  With the
routes mounted the continuous profiler starts too (that is the
"always-on" in the always-on cluster profiler);
SEAWEEDFS_TPU_PPROF_CONTINUOUS=0 keeps the routes but not the
sampler, =1 starts the sampler even without routes.  Knobs:
SEAWEEDFS_TPU_PPROF_HZ (default 19) and SEAWEEDFS_TPU_PPROF_WINDOW
(window seconds, default 60; ring holds 30 windows).
"""

from __future__ import annotations

import atexit
import math
import os
import sys
import threading
import time
import traceback
from collections import Counter, deque

from ..stats.metrics import Gauge


def _collect_stacks(exclude_thread: int | None) -> list[tuple[str, ...]]:
    """One sample: the collapsed stack of every live thread."""
    out = []
    for tid, frame in sys._current_frames().items():
        if tid == exclude_thread:
            continue
        stack = []
        f = frame
        while f is not None:
            code = f.f_code
            stack.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
            f = f.f_back
        out.append(tuple(reversed(stack)))
    return out


# Innermost frames that mean "parked, not runnable": waiting on a
# lock/condition/queue, blocked in select/poll or a socket read, or
# sleeping.  Everything else counts as runnable — i.e. holding or
# contending for the GIL.
_WAIT_FUNCS = frozenset({
    "wait", "wait_for", "acquire", "sleep", "select", "poll", "epoll",
    "kqueue", "accept", "recv", "recv_into", "recvfrom", "read",
    "readline", "readinto", "get", "join", "_recv", "do_handshake",
    "flowinfo", "getaddrinfo", "_wait_for_tstate_lock",
})
_WAIT_FILES = ("threading.py", "selectors.py", "queue.py", "ssl.py",
               "socket.py")  # matched as exact basenames by the
#                              cached collector below


def _collect_stacks_cached(exclude_thread: int | None,
                           frame_cache: dict,
                           thread_cache: dict
                           ) -> list[tuple[tuple, bool]]:
    """Cheap all-threads sample for the ALWAYS-ON sampler; two caches:

    - frame_cache: code object -> (label, is_wait).  Labels render
      once per code object using its static co_firstlineno — no
      per-tick f_lineno computation or f-string work.  The trade is
      function-granularity line numbers, which is what a flamegraph
      shows anyway; the live `?seconds=` sampler keeps the exact-line
      collector.
    - thread_cache: tid -> (frame id, code id, f_lasti, stack, wait).
      A PARKED thread's innermost frame is the same object at the
      same bytecode offset tick after tick, so its whole stack walk
      is skipped — and parked threads are the majority on a server.
      The identity check is (id(frame), id(code), f_lasti); an
      address-reuse collision would need a freed frame's address
      recycled for a frame of the same code paused at the same
      offset, at which point the cached stack is almost certainly
      right anyway — an acceptable heuristic for a SAMPLING profile
      (the same one py-spy-class profilers lean on).

    Returns [(stack, leaf_is_waiting), ...]."""
    out = []
    frames = sys._current_frames()
    for tid, frame in frames.items():
        if tid == exclude_thread:
            continue
        code = frame.f_code
        key = (id(frame), id(code), frame.f_lasti)
        hit = thread_cache.get(tid)
        if hit is not None and hit[0] == key:
            out.append((hit[1], hit[2]))
            continue
        leaf_ent = None
        stack = []
        f = frame
        while f is not None:
            c = f.f_code
            ent = frame_cache.get(c)
            if ent is None:
                fn = c.co_filename.rsplit("/", 1)[-1]
                label = f"{c.co_name} ({fn}:{c.co_firstlineno})"
                ent = frame_cache[c] = (
                    label,
                    c.co_name in _WAIT_FUNCS or fn in _WAIT_FILES)
            if leaf_ent is None:
                leaf_ent = ent
            stack.append(ent[0])
            f = f.f_back
        tup = tuple(reversed(stack))
        waiting = leaf_ent[1] if leaf_ent else True
        thread_cache[tid] = (key, tup, waiting)
        out.append((tup, waiting))
    # Thread churn (conn threads come and go): drop dead tids once
    # the cache outgrows the live set.
    if len(thread_cache) > 2 * len(frames):
        for tid in list(thread_cache):
            if tid not in frames:
                del thread_cache[tid]
    return out


def sample_stacks(seconds: float, hz: float = 100.0,
                  stop_event: threading.Event | None = None
                  ) -> tuple[Counter, int, float]:
    """Sample all threads (except the caller) for `seconds`; returns
    (Counter of collapsed stacks, total samples, measured elapsed).

    Drift-compensated: each tick is scheduled on an absolute grid
    (t0 + k/hz) instead of sleeping a full interval AFTER collection —
    with many threads the old full-interval sleep under-delivered the
    advertised rate by the (unbounded) collection cost per tick.
    Callers report the MEASURED rate (samples / elapsed), never the
    nominal one."""
    me = threading.get_ident()
    counts: Counter = Counter()
    samples = 0
    interval = 1.0 / hz
    t0 = time.monotonic()
    deadline = t0 + seconds
    next_tick = t0
    while True:
        now = time.monotonic()
        if now >= deadline or (stop_event is not None
                               and stop_event.is_set()):
            break
        for stack in _collect_stacks(me):
            counts[stack] += 1
        samples += 1
        next_tick += interval
        now = time.monotonic()
        if next_tick > now:
            # Clamp at 0: when the collection pass ends inside the
            # (deadline, next_tick) window — a re-anchored grid, or a
            # `seconds` that isn't a multiple of the interval —
            # deadline-now is negative and a raw sleep would raise.
            time.sleep(max(0.0, min(next_tick - now, deadline - now)))
        elif next_tick < now - 1.0:
            # Hopelessly behind (a multi-second GC/GIL stall): re-anchor
            # instead of machine-gunning catch-up samples.
            next_tick = now
    return counts, samples, time.monotonic() - t0


class ContinuousProfiler:
    """Always-on low-rate sampler feeding a ring of collapsed-stack
    windows.  One per process (PROFILER below); window merges are
    cheap Counter additions, so `?window=N` answers instantly."""

    def __init__(self, hz: float | None = None,
                 window_seconds: float | None = None,
                 windows: int = 30):
        from ..utils import env_float as _env_float
        self.hz = hz if hz is not None else \
            _env_float("SEAWEEDFS_TPU_PPROF_HZ", 19.0)
        self.window_seconds = window_seconds if window_seconds \
            is not None else _env_float("SEAWEEDFS_TPU_PPROF_WINDOW",
                                        60.0)
        # ring of (end_unix_ts, Counter, samples, elapsed_seconds)
        self._ring: "deque[tuple[float, Counter, int, float]]" = \
            deque(maxlen=windows)
        self._cur: Counter = Counter()
        self._cur_samples = 0
        self._cur_t0 = 0.0
        self._lock = threading.Lock()
        # Lifecycle guard (separate from _lock: stop() joins the loop
        # thread, which takes _lock — holding it across the join
        # would deadlock).  Serializes concurrent start/stop pairs
        # from racing /debug/attribution toggles.
        self._life = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Recent runnable-thread sample values (~last 256 ticks) for
        # the saturation gauge.
        self._runnable: "deque[int]" = deque(maxlen=256)
        self.started_at = 0.0

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        with self._life:
            if self.running:
                return
            self._stop.clear()
            self.started_at = time.time()
            # A resume starts a FRESH partial window: the old one's
            # clock stopped while paused, and carrying its samples
            # against a restarted _cur_t0 would overstate the
            # measured rate.  (Closed ring windows are untouched.)
            with self._lock:
                self._cur = Counter()
                self._cur_samples = 0
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="pprof-continuous")
            self._thread.start()

    def stop(self) -> None:
        with self._life:
            thread = self._thread
            if thread is None:
                return
            self._stop.set()
            thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        me = threading.get_ident()
        interval = 1.0 / self.hz
        frame_cache: dict = {}
        thread_cache: dict = {}
        self._cur_t0 = time.monotonic()
        window_end = self._cur_t0 + self.window_seconds
        next_tick = self._cur_t0
        while not self._stop.is_set():
            sampled = _collect_stacks_cached(me, frame_cache,
                                             thread_cache)
            runnable = sum(1 for _s, waiting in sampled
                           if not waiting)
            with self._lock:
                for stack, _waiting in sampled:
                    self._cur[stack] += 1
                self._cur_samples += 1
                self._runnable.append(runnable)
                now = time.monotonic()
                if now >= window_end:
                    self._ring.append(
                        (time.time(), self._cur, self._cur_samples,
                         now - self._cur_t0))
                    self._cur = Counter()
                    self._cur_samples = 0
                    self._cur_t0 = now
                    window_end = now + self.window_seconds
            next_tick += interval
            now = time.monotonic()
            if next_tick > now:
                self._stop.wait(next_tick - now)
            elif next_tick < now - 1.0:
                next_tick = now

    # -- reads ---------------------------------------------------------------

    def merged(self, windows: int = 5) -> tuple[Counter, int, float]:
        """Last `windows` closed windows + the in-progress one, merged:
        (counts, samples, covered_seconds).  Instant — no sampling."""
        with self._lock:
            take = list(self._ring)[-windows:] if windows > 0 else []
            counts: Counter = Counter()
            samples = 0
            elapsed = 0.0
            for _ts, c, n, el in take:
                counts.update(c)
                samples += n
                elapsed += el
            if self._cur_samples:
                counts.update(self._cur)
                samples += self._cur_samples
                elapsed += time.monotonic() - self._cur_t0
        return counts, samples, elapsed

    def runnable_avg(self) -> float:
        """Mean runnable-thread count over the recent sample window —
        >1 sustained means threads are queueing on the GIL."""
        with self._lock:
            if not self._runnable:
                return 0.0
            return sum(self._runnable) / len(self._runnable)


PROFILER: ContinuousProfiler | None = None
_PROFILER_LOCK = threading.Lock()


def ensure_continuous_profiler() -> ContinuousProfiler:
    """Process-wide singleton, started on first call."""
    global PROFILER
    with _PROFILER_LOCK:
        if PROFILER is None:
            PROFILER = ContinuousProfiler()
        if not PROFILER.running:
            PROFILER.start()
        return PROFILER


def _runnable_gauge_value() -> float:
    p = PROFILER
    return p.runnable_avg() if p is not None and p.running else 0.0


# Registered on every role's scrape by rpc.enable_metrics: 0.0 until
# the continuous profiler runs (the gauge itself is always cheap).
runnable_threads = Gauge(
    "SeaweedFS_runnable_threads",
    "mean concurrently-runnable (non-waiting) threads over the "
    "profiler's recent samples — a GIL-pressure proxy; 0 when the "
    "continuous profiler is off",
    callback=_runnable_gauge_value)


def setup_profiling(cpuprofile: str = "",
                    memprofile: str = "") -> None:
    """grace.SetupProfiling: begin profiling now, write at exit."""
    if cpuprofile:
        stop = threading.Event()
        counts: Counter = Counter()
        state = {"samples": 0}

        def sampler() -> None:
            while not stop.is_set():
                c, n, _elapsed = sample_stacks(1.0, stop_event=stop)
                counts.update(c)
                state["samples"] += n

        sampler_thread = threading.Thread(target=sampler, daemon=True,
                                          name="cpu-sampler")
        sampler_thread.start()

        def dump_cpu() -> None:
            stop.set()
            # Join before reading: a concurrent counts.update() while
            # iterating would RuntimeError and lose the whole profile.
            sampler_thread.join(timeout=2.0)
            with open(cpuprofile, "w") as f:
                for stack, n in counts.most_common():
                    f.write(";".join(stack) + f" {n}\n")
            print(f"cpu profile ({state['samples']} samples, all "
                  f"threads, collapsed-stack format — feed to "
                  f"flamegraph.pl/speedscope) written to {cpuprofile}",
                  file=sys.stderr)
        atexit.register(dump_cpu)
    if memprofile:
        import tracemalloc
        tracemalloc.start(16)

        def dump_mem() -> None:
            snap = tracemalloc.take_snapshot()
            with open(memprofile, "w") as f:
                for stat in snap.statistics("lineno")[:200]:
                    f.write(f"{stat}\n")
            print(f"heap profile written to {memprofile}",
                  file=sys.stderr)
        atexit.register(dump_mem)


def _bad_request(msg: str):
    return (400, {"error": msg})


def _parse_float(query: dict, key: str) -> float | None:
    """Parse a finite float query param; raises ValueError with the
    offending text on garbage INCLUDING NaN/inf — `?seconds=NaN` must
    400, not propagate through min/max clamps unordered."""
    raw = query.get(key)
    if raw in (None, ""):
        return None
    val = float(raw)          # ValueError -> caller 400s
    if math.isnan(val) or math.isinf(val):
        raise ValueError(raw)
    return val


def _render_profile(counts: Counter, samples: int, elapsed: float,
                    query: dict, source: str):
    """Ranked human text, or raw collapsed-stack lines for
    ?format=collapsed (flamegraph.pl / speedscope / cluster.profile
    input)."""
    if query.get("format") == "collapsed":
        lines = [f"{';'.join(stack)} {n}"
                 for stack, n in counts.most_common()]
        return (200, ("\n".join(lines) + "\n").encode() if lines
                else b"", {"Content-Type": "text/plain; charset=utf-8",
                           "X-Pprof-Samples": str(samples),
                           "X-Pprof-Seconds": f"{elapsed:.3f}"})
    rate = samples / elapsed if elapsed > 0 else 0.0
    lines = [f"{samples} samples over {elapsed:.1f}s at "
             f"{rate:.1f}Hz measured ({source}), all threads "
             f"(collapsed stacks; count = samples seen)",
             ""]
    for stack, n in counts.most_common(100):
        lines.append(f"{n:6d}  {';'.join(stack)}")
    return (200, ("\n".join(lines) + "\n").encode(),
            {"Content-Type": "text/plain; charset=utf-8"})


def _profile_handler(query: dict, body: bytes):
    """CPU profile.  `?window=N` merges the last N ring windows of the
    continuous profiler (instant); `?seconds=S` (clamped to [0.1, 30])
    takes a live ~100Hz sample; with neither, the ring is preferred
    when the continuous profiler runs, else a live 5s sample."""
    try:
        seconds = _parse_float(query, "seconds")
    except ValueError:
        return _bad_request(
            f"seconds={query.get('seconds')!r} is not a finite number")
    try:
        window = _parse_float(query, "window")
    except ValueError:
        return _bad_request(
            f"window={query.get('window')!r} is not a finite number")
    prof = PROFILER
    if seconds is None and window is None:
        if prof is not None and prof.running:
            window = 5.0
        else:
            seconds = 5.0
    if window is not None:
        if prof is None or not prof.running:
            return (404, {"error":
                          "continuous profiler not running "
                          "(SEAWEEDFS_TPU_PPROF_CONTINUOUS=0?) — "
                          "use ?seconds= for a live sample"})
        n = max(1, int(window))
        counts, samples, elapsed = prof.merged(n)
        return _render_profile(
            counts, samples, elapsed, query,
            f"ring: last {n} windows of {prof.window_seconds:g}s "
            f"at ~{prof.hz:g}Hz")
    seconds = min(max(seconds, 0.1), 30.0)
    counts, samples, elapsed = sample_stacks(seconds)
    return _render_profile(counts, samples, elapsed, query,
                           "live sample")


# tracemalloc is process-global with a start/stop world switch; two
# concurrent /debug/pprof/heap calls racing start against take_snapshot
# (or stop) can die inside the tracer.  One handler at a time.
_HEAP_LOCK = threading.Lock()


def _heap_handler(query: dict, body: bytes):
    """Heap ranking via tracemalloc.  First call starts tracing (which
    taxes every allocation); ?stop=true turns it back off."""
    import tracemalloc
    try:
        top_n = int(query.get("top", 50) or 50)
    except ValueError:
        return _bad_request(f"top={query.get('top')!r} is not a number")
    top_n = min(max(top_n, 1), 1000)
    with _HEAP_LOCK:
        if query.get("stop") == "true":
            if tracemalloc.is_tracing():
                tracemalloc.stop()
            return (200, b"tracemalloc stopped\n",
                    {"Content-Type": "text/plain"})
        if not tracemalloc.is_tracing():
            tracemalloc.start(16)
            return (200, b"tracemalloc started; call again for a "
                         b"ranking, ?stop=true to disable\n",
                    {"Content-Type": "text/plain"})
        snap = tracemalloc.take_snapshot()
        cur, peak = tracemalloc.get_traced_memory()
    top = snap.statistics("lineno")[:top_n]
    lines = [f"traced: current {cur / 1e6:.1f}MB peak {peak / 1e6:.1f}MB",
             ""]
    lines += [str(s) for s in top]
    return (200, ("\n".join(lines) + "\n").encode(),
            {"Content-Type": "text/plain; charset=utf-8"})


def _threads_handler(query: dict, body: bytes):
    """Stacks of every live thread (the goroutine-dump analog)."""
    frames = sys._current_frames()
    out = []
    for th in threading.enumerate():
        frame = frames.get(th.ident)
        out.append(f"--- {th.name} (daemon={th.daemon}, "
                   f"alive={th.is_alive()}) ---")
        if frame is not None:
            out.append("".join(traceback.format_stack(frame)))
    return (200, ("\n".join(out) + "\n").encode(),
            {"Content-Type": "text/plain; charset=utf-8"})


def enable_pprof_routes(server) -> None:
    """Mount /debug/pprof handlers — ONLY when the operator opted in
    via SEAWEEDFS_TPU_PPROF=1 (they are unauthenticated and heap
    tracing is expensive; same operator-choice stance as exposing Go's
    net/http/pprof).  Starting the routes also starts the process's
    continuous profiler (SEAWEEDFS_TPU_PPROF_CONTINUOUS=0 opts out)."""
    continuous = os.environ.get("SEAWEEDFS_TPU_PPROF_CONTINUOUS", "")
    if os.environ.get("SEAWEEDFS_TPU_PPROF", "") in ("1", "true"):
        server.route("GET", "/debug/pprof/profile", _profile_handler)
        server.route("GET", "/debug/pprof/heap", _heap_handler)
        server.route("GET", "/debug/pprof/threads", _threads_handler)
        if continuous not in ("0", "false"):
            ensure_continuous_profiler()
    elif continuous in ("1", "true"):
        ensure_continuous_profiler()
