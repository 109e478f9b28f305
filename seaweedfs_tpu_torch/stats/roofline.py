"""Device roofline plane: per-kernel work accounting and achieved
fraction of the device's measured peaks.

The port's counterpart of seaweedfs_tpu/stats/roofline.py, with the
same catalog keys, cost model, ledger rows and occupancy docs, so a
benchmark can read a kernel's share of its roofline from the same work
whichever package ran it:

- an analytic per-invocation cost model — bit-matrix geometry
  (out_rows, in_rows, n, batch) -> bytes moved, GF(2) MACs,
  arithmetic intensity — the algebra the JAX package's Pallas kernels
  declare in their cost estimate;
- `probe_peaks(device)`, a once-per-process micro-bench on the device
  the accounted tensors live on (int8 and bf16 matmul peaks, on-device
  memory bandwidth, host-to-device and device-to-host copies, host
  stream bandwidth), cached to disk keyed by backend + device kind;
- a bounded invocation ring + windowed achieved-fraction sketches
  keyed by (kernel, codec, dtype, geometry), fed by every kernel call
  of `ops/coder_cuda.py` and of the batched path;
- pipeline occupancy: `cluster_encode`/`cluster_rebuild` hand their
  per-batch stage spans (stack | dispatch | device | drain) to
  `note_pipeline()`, which keeps recent gantts, publishes the
  device-occupancy fraction, names the stage that starved the device,
  and emits a `device.slow` event on sustained occupancy collapse.

What `seconds` means differs from the JAX package.  There a call is
fenced with block_until_ready and `seconds` is host wall time to the
fence.  Here the C launcher of a call on a card records a pooled CUDA
event pair on the launching stream right before and right after the
kernel (`KernelTimer`), and `seconds` is the device time between them:
the kernel's as it ran on the path, plus on an idle stream the
microseconds the launch takes to reach the card.  A kernel launched on
a card that has idled (a single-volume path between its coder calls)
runs slower than the same kernel in a filled queue, and its rows say
so.  The pair is read only once its end event has completed — at the
caller's own host copy (`ops.erasure.host_array`), after the pipeline's
event wait (`parallel.sharded_codec.Step.wait`), on a later timed call,
or when the ledger is read (`settle`) — so no hook adds a device
synchronisation.  On a CPU tensor `seconds` is the host time of the
kernel's plain version.

`record` never probes: it reads the roof from peaks already in hand
(`known_peaks`: probed in this process, or the disk cache), and leaves
`achieved` None until `probe_peaks` has run for the device.  A probe
synchronises the card and allocates gigabytes, so entry points and
readers (`debug_doc`) run it, never a pipeline thread.

The port's kernels mix bits with packed-mask AND/XOR on 32-bit words
and have no matmul dtype: their rows carry dtype "int8", so
`roofline_floor_seconds` divides their GF(2) operations by the probed
int8 matmul peak — the same roof the kernel table of PERF.md divides
single-bit operations by (the 1979 TOP/s int8 rate of the data sheet).

Like the other planes the kernel catalog is closed (recording an
uncataloged kernel raises), the ledger is a process singleton with
absolute rows, and the kill switch (SEAWEEDFS_TPU_ROOFLINE=0, shared
with the JAX package) reduces every call site to one module-flag check.

The conservation gate: analytic bytes per invocation must match the
ledger-measured bytes within max(1%, 4KB) — a cost model that drifts
from what the kernels actually move is worse than no model.
"""

from __future__ import annotations

import functools
import json
import os
import platform
import threading
import time
from collections import deque

from .metrics import Counter, Gauge
from .sketch import WindowedSketch

# -- arming ------------------------------------------------------------------
# One module-level flag; disarmed call sites pay exactly this check
# (same discipline as fault points and metered locks, asserted by
# tests/test_roofline.py).

ARMED = os.environ.get("SEAWEEDFS_TPU_ROOFLINE", "1") not in ("0", "false")


def set_armed(on: bool) -> None:
    global ARMED
    ARMED = bool(on)


# -- kernel catalog ----------------------------------------------------------
# Closed set, like events/journal.py TYPES and flows.PURPOSES:
# RooflineLedger.record() raises on anything not listed here, so a new
# device kernel cannot ship without declaring itself (and getting a
# cost model + tests).

KERNELS = {
    "encode_kernel":
        "single-volume parity encode: K1 (csrc/rs_bitmatrix.cu, "
        "rs_fixed<4,10> for RS(10,4), generic otherwise) on the stacked "
        "data shards (ops/coder_cuda.py CudaCoder.encode, encode_all, "
        "verify)",
    "encode_crc_kernel":
        "fused encode + per-tile CRC32-C partials in one launch: K2 "
        "(csrc/rs_bitmatrix_crc.cu, the single-volume 10->4 "
        "instantiation, generic otherwise) "
        "(ops/coder_cuda.py CudaCoder.encode_with_crc)",
    "reconstruct_kernel":
        "decode masks rebuilding missing shards from survivors: K1 "
        "(rs_fixed<4,10> for 4 lost of RS, rs_fixed<1,10> for one, "
        "generic<=16 for LRC's 5-row local repair) "
        "(ops/coder_cuda.py CudaCoder.reconstruct)",
    "batch_encode":
        "multi-volume encode, one launch per step and device with a "
        "volume axis: K2 with fused CRC, K1 without "
        "(parallel/sharded_codec.py encode_step, recorded by "
        "parallel/cluster_encode.py)",
    "batch_reconstruct":
        "multi-volume rebuild, one launch per step and device with a "
        "volume axis: K2 with the decode masks and fused CRC, K1 without "
        "(parallel/sharded_codec.py reconstruct_step, recorded by "
        "parallel/cluster_rebuild.py)",
}

PIPELINE_STAGES = ("stack", "dispatch", "device", "drain")

kernel_seconds_total = Counter(
    "SeaweedFS_kernel_seconds_total",
    "device kernel seconds (CUDA-event device time on a card, host "
    "time of the plain version on the CPU)",
    ("kernel", "codec", "dtype"))

kernel_bytes_total = Counter(
    "SeaweedFS_kernel_bytes_total",
    "analytic bytes moved by device kernels (cost-model bytes; the "
    "conservation check pins these to ledger-measured bytes)",
    ("kernel", "codec", "dtype"))

kernel_work_total = Counter(
    "SeaweedFS_kernel_work_total",
    "analytic GF(2) MACs performed by device kernels",
    ("kernel", "codec", "dtype"))

device_occupancy = Gauge(
    "SeaweedFS_device_occupancy",
    "fraction of the streamed-pipeline window each stage kept the "
    "device busy (stage=device is the occupancy headline; other "
    "stages show where the wall went)",
    ("stage",))


def validate(kernel: str) -> str:
    if kernel not in KERNELS:
        raise ValueError(
            f"unknown roofline kernel {kernel!r}; cataloged: "
            f"{sorted(KERNELS)}")
    return kernel


# -- analytic cost model -----------------------------------------------------
# The bit-matrix kernels multiply an (8*out_rows x 8*in_rows) GF(2)
# matrix against 8*in_rows bit-rows of n bytes each: the same algebra
# the JAX package's Pallas kernels declare in their cost estimate —
# flops = 2 * (8*out) * (8*in) * n,
# bytes = (in + out) * n.  The fused-CRC variant folds a second
# (8*(in+out) x 32)-bit matrix over every input AND output row.


def cost_model(out_rows: int, in_rows: int, n: int, *, batch: int = 1,
               crc: bool = False) -> dict:
    """Analytic work for one kernel invocation.

    Returns bytes moved (read + written payload), GF(2) MACs (one MAC
    = one AND+XOR bit op on a byte lane), flops (2*MACs, the matmul
    convention the probe and the Pallas cost estimate both use), and
    arithmetic intensity (flops per byte)."""
    b = int(batch)
    nbytes = (in_rows + out_rows) * n * b
    macs = 8 * out_rows * 8 * in_rows * n * b
    if crc:
        # CRC fold: 32 output bits from 8*(in+out) input bits, per
        # byte column (matches the kernel's declared estimate).
        macs += 8 * (in_rows + out_rows) * 32 * n * b
    flops = 2 * macs
    return {
        "bytes": nbytes,
        "macs": macs,
        "flops": flops,
        "intensity": flops / nbytes if nbytes else 0.0,
    }


def geometry_key(out_rows: int, in_rows: int, n: int,
                 batch: int = 1) -> str:
    if batch > 1:
        return f"{out_rows}x{in_rows}x{n}b{batch}"
    return f"{out_rows}x{in_rows}x{n}"


# -- GF(2) work: dense vs post-elimination -----------------------------------
# The bench publishes effective (post-elimination) XOR work beside the
# dense count per codec, so matrix-scheduling work (arxiv 2108.02692,
# arxiv 1312.5155) lands against an already-published baseline column.


def dense_gf2_work(bitmatrix) -> int:
    """XOR count of the naive schedule: each output bit-row of weight
    w costs w-1 XORs (w ANDs are free against constant 0/1 entries)."""
    import numpy as np
    bm = (np.asarray(bitmatrix) & 1).astype(np.uint8)
    weights = bm.sum(axis=1)
    return int(np.maximum(weights.astype(np.int64) - 1, 0).sum())


def effective_gf2_work(bitmatrix, max_rounds: int = 100000) -> int:
    """XOR count after greedy common-subexpression elimination (Paar's
    algorithm): repeatedly factor out the column pair shared by the
    most output rows.  Deterministic (ties break to the smallest
    pair), exact on the matrices we ship (tens of rows/columns)."""
    import numpy as np
    bm = (np.asarray(bitmatrix) & 1).astype(np.uint8)
    rows = [set(np.flatnonzero(r).tolist()) for r in bm]
    next_col = bm.shape[1]
    extracted = 0
    for _ in range(max_rounds):
        counts: dict[tuple[int, int], int] = {}
        for r in rows:
            rs = sorted(r)
            for i in range(len(rs)):
                for j in range(i + 1, len(rs)):
                    p = (rs[i], rs[j])
                    counts[p] = counts.get(p, 0) + 1
        if not counts:
            break
        best = max(counts.values())
        if best < 2:
            break
        pair = min(p for p, c in counts.items() if c == best)
        a, b = pair
        for r in rows:
            if a in r and b in r:
                r.discard(a)
                r.discard(b)
                r.add(next_col)
        next_col += 1
        extracted += 1
    return extracted + sum(max(len(r) - 1, 0) for r in rows)


# -- peak probing ------------------------------------------------------------
# Peaks are probed on the device the accounted tensors live on: a CPU
# caller probes the CPU, a card caller the card.  The probes are library
# calls (torch._int_mm, a bf16 matmul, an elementwise add, copies): they
# measure what the device offers, not a kernel of this package.

_PEAKS_VERSION = 2
_PROBE_DTYPES = ("int8", "bf16")
_peaks_lock = threading.Lock()
# (backend, device kind) -> peaks doc
_peaks: dict[tuple[str, str], dict] = {}

# Probe sizes and timed repetitions per device type.  On a card one
# 256^3 product lasts microseconds, so a timed run there must last about
# a millisecond or more, or it reads launch latency instead of a peak;
# on the CPU the JAX package's small sizes keep a probe to a second.
PROBE_SIZES = {
    "cuda": {"m": 8192, "membw_bytes": 1 << 30, "copy_bytes": 1 << 28,
             "reps": 10},
    "cpu": {"m": 256, "membw_bytes": 1 << 23, "copy_bytes": 1 << 23,
            "reps": 3},
}


def _cache_dir() -> str:
    d = os.environ.get("SEAWEEDFS_TPU_ROOFLINE_CACHE", "")
    if d:
        return d
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "seaweedfs_tpu_torch")


def _cache_path(backend: str, kind: str) -> str:
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in f"{backend}_{kind}")
    return os.path.join(_cache_dir(), f"torch_roofline_peaks_{safe}.json")


def _resolve(device):
    """torch.device for `device`; None means the card when one is
    present, else the CPU."""
    import torch
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_kind(dev) -> str:
    """The name peaks are cached under: torch.cuda.get_device_name for
    a card, the machine architecture for the CPU."""
    if dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return platform.machine() or "cpu"


def _best_of(fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _seconds_per_call(fn, dev, reps: int) -> float:
    """Seconds of one `fn()` on `dev` after a warm-up call: on a card,
    CUDA events around `reps` back-to-back calls; on the CPU, the best
    host-clock time of `reps` calls."""
    fn()
    if dev.type != "cuda":
        return _best_of(fn, reps)
    import torch
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _probe_matmul(dev, dtype: str, m: int = 256, reps: int = 3) -> float:
    """Measured matmul operations/s for one dtype: int8 accumulating to
    int32 (torch._int_mm), or bf16 (accumulated in f32 by the library).
    The int8 product takes its second operand column-major (a transposed
    view), the layout the library's int8 tensor-core path is built for."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == "int8":
        a = torch.randint(-8, 8, (m, m), dtype=torch.int8, device=dev,
                          generator=gen)
        b = a.t()

        def fn():
            return torch._int_mm(a, b)
    else:
        a = torch.randn((m, m), dtype=torch.bfloat16, device=dev,
                        generator=gen)

        def fn():
            return torch.matmul(a, a)
    return 2.0 * m ** 3 / max(_seconds_per_call(fn, dev, reps), 1e-9)


def _probe_membw(dev, nbytes: int = 1 << 23, reps: int = 3) -> float:
    """On-device streaming bandwidth: `v + 1` over a uint8 tensor, one
    read and one write pass."""
    import torch
    v = torch.ones(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty_like(v)
    t = _seconds_per_call(lambda: torch.add(v, 1, out=out), dev, reps)
    return 2.0 * nbytes / max(t, 1e-9)


def _probe_transfers(dev, nbytes: int = 1 << 23, reps: int = 3) -> tuple:
    """(host->device, device->host, host stream) bytes/s.  On a card the
    host side is pinned and the copies asynchronous; on the CPU both
    copies are host memcpys."""
    import numpy as np
    import torch
    pin = dev.type == "cuda"
    host = torch.ones(nbytes, dtype=torch.uint8, pin_memory=pin)
    on_dev = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    h2d = nbytes / max(_seconds_per_call(
        lambda: on_dev.copy_(host, non_blocking=pin), dev, reps), 1e-9)
    d2h = nbytes / max(_seconds_per_call(
        lambda: host.copy_(on_dev, non_blocking=pin), dev, reps), 1e-9)
    arr = np.ones(nbytes, np.uint8)
    stream = 2.0 * nbytes / max(_best_of(arr.copy), 1e-9)
    return h2d, d2h, stream


def _zeroed(backend: str, kind: str, error: str) -> dict:
    return {"version": _PEAKS_VERSION, "backend": backend,
            "device_kind": kind, "matmul_flops": {}, "membw_bps": 0.0,
            "h2d_bps": 0.0, "d2h_bps": 0.0, "host_stream_bps": 0.0,
            "error": error}


def _read_cache(backend: str, kind: str) -> dict | None:
    """The disk-cached peaks of a device kind, or None when absent or
    stale."""
    try:
        with open(_cache_path(backend, kind), encoding="utf-8") as f:
            doc = json.load(f)
    except Exception:  # noqa: BLE001 — absent/unreadable cache
        return None
    return doc if doc.get("version") == _PEAKS_VERSION else None


@functools.lru_cache(maxsize=32)
def _device_key(device) -> tuple[str, str]:
    """(backend, device kind) of `device`, looked up once per device."""
    dev = _resolve(device)
    return dev.type, device_kind(dev)


# Device kinds whose disk cache was looked for and not found (known_peaks
# looks once; probe_peaks clears the mark).
_uncached: set = set()


def known_peaks(device=None) -> dict | None:
    """The peaks of `device` already in hand — probed in this process or
    read from the disk cache — without measuring anything; None when
    there are none yet.  What `RooflineLedger.record` reads its roof
    from, on whatever thread records."""
    try:
        key = _device_key(device)
    except Exception:  # noqa: BLE001 — no usable device stack
        return None
    doc = _peaks.get(key)
    if doc is not None or key in _uncached:
        return doc
    with _peaks_lock:
        if key in _peaks:
            return _peaks[key]
        doc = _read_cache(*key)
        if doc is None:
            _uncached.add(key)
        else:
            _peaks[key] = doc
        return doc


def probe_peaks(device=None, force: bool = False) -> dict:
    """Measured peaks of `device` (None: the card when one is present,
    else the CPU), once per process and device kind, disk-cached so
    restarts skip the micro-bench.  The first call for a card runs for
    about a second, allocates about 2.3 GiB and synchronises it, so it
    belongs at an entry point or a reader, before any pipeline starts;
    the ledger never calls it.  Failures degrade to a zeroed doc carrying
    `error` rather than taking the caller down."""
    try:
        dev = _resolve(device)
        backend, kind = dev.type, device_kind(dev)
    except Exception as e:  # noqa: BLE001 — no usable device stack
        return _zeroed("none", "none", f"{type(e).__name__}: {e}")
    key = (backend, kind)
    with _peaks_lock:
        if key in _peaks and not force:
            return _peaks[key]
        path = _cache_path(backend, kind)
        if not force:
            doc = _read_cache(backend, kind)
            if doc is not None:
                _peaks[key] = doc
                return doc

        sizes = PROBE_SIZES.get(backend, PROBE_SIZES["cpu"])
        reps = sizes["reps"]
        t_start = time.perf_counter()
        doc = _zeroed(backend, kind, "")
        del doc["error"]
        try:
            for dt in _PROBE_DTYPES:
                doc["matmul_flops"][dt] = _probe_matmul(
                    dev, dt, sizes["m"], reps)
            doc["membw_bps"] = _probe_membw(dev, sizes["membw_bytes"],
                                            reps)
            h2d, d2h, stream = _probe_transfers(dev, sizes["copy_bytes"],
                                                reps)
            doc["h2d_bps"], doc["d2h_bps"] = h2d, d2h
            doc["host_stream_bps"] = stream
        except Exception as e:  # noqa: BLE001 — probes are best-effort
            doc["error"] = f"{type(e).__name__}: {e}"
        finally:
            if backend == "cuda":
                import torch
                torch.cuda.empty_cache()
        doc["probe_seconds"] = round(time.perf_counter() - t_start, 3)

        try:
            if "error" in doc:
                raise OSError("a failed probe is not cached")
            os.makedirs(_cache_dir(), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — read-only home is fine
            pass
        _peaks[key] = doc
        _uncached.discard(key)
        return doc


# -- kernel timing without a synchronisation ---------------------------------


class _Pending:
    """Timed launches whose end event has not been seen complete yet,
    each with the callback that takes its seconds."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: list = []

    def add(self, timer: "KernelTimer", done) -> None:
        with self._lock:
            self._items.append((timer, done))

    def settle(self) -> None:
        """Hand every launch whose end event has completed to its
        callback.  Event.query() never waits for the device."""
        with self._lock:
            if not self._items:
                return
            ready, waiting = [], []
            for timer, done in self._items:
                s = timer.seconds()
                if s is None:
                    waiting.append((timer, done))
                else:
                    ready.append((done, s))
            self._items = waiting
        for done, s in ready:
            try:
                done(s)
            except Exception:  # noqa: BLE001 — accounting must never
                pass           # take the encode path down

    def clear(self) -> None:
        with self._lock:
            self._items.clear()


_PENDING = _Pending()


def settle() -> None:
    """Account every timed launch whose end event has completed (never
    waits for the device).  The ledger's readers call it; a reader that
    must see every launch synchronises the device first."""
    _PENDING.settle()


class _EventPool:
    """Timing event pairs per card, reused once read: a launch takes a
    pair and `KernelTimer.seconds` gives it back, so the armed path
    creates no CUDA event after the first few launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: dict = {}  # device -> [(start, end), ...]

    def take(self, device) -> tuple:
        with self._lock:
            free = self._free.get(device)
            if free:
                return free.pop()
        return self._new_pair(device)

    def give(self, device, pair: tuple) -> None:
        with self._lock:
            self._free.setdefault(device, []).append(pair)

    @staticmethod
    def _new_pair(device) -> tuple:
        """Two timing events, each recorded once on the device's current
        stream so the CUDA event exists and its handle can go to a
        launcher."""
        import torch
        stream = torch.cuda.current_stream(device)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        for ev in pair:
            ev.record(stream)
        return pair


_EVENTS = _EventPool()


class KernelTimer:
    """The time of one kernel launch on `device`, without waiting for it.

    On a card the wrapper hands `events()` — a pooled CUDA event pair —
    to the C launcher, which records the pair on the launching stream
    right before and right after the kernel; `seconds()` reads it once
    the end event has completed: device time.  Where the stream is busy
    at the start event (the batched path's input copy) that is the
    kernel's time; on an idle stream (a single-volume coder call, whose
    input copy has returned) it also holds the microseconds from the
    start event's record to the launch reaching the card.  Either way it
    is the kernel as it ran: launched on a card that has idled, a kernel
    runs slower than in a filled queue.  On the CPU the wrapper calls
    `start()` and `end()`, the host clock around the plain version."""

    __slots__ = ("_device", "_pair", "_t0", "_seconds")

    def __init__(self, device) -> None:
        self._device = device
        self._pair = None
        self._t0 = 0.0
        self._seconds = None

    def events(self) -> tuple:
        """(start, end) CUDA events for a launcher to record around its
        launch, taken from the device's pool."""
        self._pair = _EVENTS.take(self._device)
        return self._pair

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def end(self) -> None:
        self._seconds = time.perf_counter() - self._t0

    def seconds(self) -> float | None:
        """The launch's seconds, or None while its end event has not
        completed (never waits).  Reading them gives the pair back to the
        pool."""
        pair = self._pair
        if self._seconds is None and pair is not None and pair[1].query():
            self._seconds = pair[0].elapsed_time(pair[1]) / 1e3
            self._pair = None
            _EVENTS.give(self._device, pair)
        return self._seconds

    def then(self, done) -> None:
        """`done(seconds)`: at once when they are known (the CPU), else
        from `settle` once the end event has completed (a launch just
        made is not asked: it has hardly ever finished)."""
        if self._seconds is not None:
            done(self._seconds)
        else:
            _PENDING.add(self, done)


def roofline_floor_seconds(flops: float, nbytes: float,
                           peaks: dict, dtype: str) -> float | None:
    """The roofline lower bound on wall time: compute-limited OR
    bandwidth-limited, whichever binds.  None when the probe failed
    (an achieved fraction against a made-up peak is noise)."""
    pf = (peaks.get("matmul_flops") or {}).get(dtype) or 0.0
    bw = peaks.get("membw_bps") or 0.0
    if pf <= 0.0 or bw <= 0.0:
        return None
    return max(flops / pf, nbytes / bw)


# -- occupancy collapse detection --------------------------------------------

_COLLAPSE_OCCUPANCY = 0.35  # device-busy fraction below this ...
_COLLAPSE_STREAK = 3        # ... for this many consecutive batches
_EMIT_EVERY = 5.0           # one device.slow event per this many s

# -- the ledger --------------------------------------------------------------

_RING_MAX = 256        # recent invocations kept for /debug/device
_PIPELINES_MAX = 16    # recent pipeline occupancy docs
_GANTT_LAST = 8        # batches of gantt carried per pipeline doc


class RooflineLedger:
    """Process-global per-kernel accounting: bounded invocation ring,
    absolute per-series totals, windowed achieved-fraction sketches,
    and recent pipeline-occupancy docs.

    The clock is injected (tests advance sketch windows and collapse
    streaks without sleeping); `record()` is the single kernel entry
    point and `note_pipeline()` the single occupancy entry point."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=_RING_MAX)
        # (kernel, codec, dtype, geometry) ->
        #   [count, seconds, bytes, macs, WindowedSketch]
        self._series: dict[tuple, list] = {}
        self._pipelines: deque = deque(maxlen=_PIPELINES_MAX)
        self._streak: dict[str, int] = {}
        self._collapsed: dict[str, bool] = {}
        self._last_emit = 0.0

    # -- kernel records ---------------------------------------------

    def record(self, kernel: str, codec: str, dtype: str, *,
               out_rows: int, in_rows: int, n: int, batch: int = 1,
               crc: bool = False, seconds: float,
               measured_bytes: int | None = None,
               node: str = "", device=None) -> dict:
        """One timed kernel invocation (its seconds from a
        `KernelTimer`); this only does the bookkeeping.  `device` is
        where the accounted tensors live: its peaks are the roof (None:
        the card when one is present, else the CPU), read from
        `known_peaks` — never probed here, so `achieved` is None until
        `probe_peaks` has run for the device."""
        validate(kernel)
        cost = cost_model(out_rows, in_rows, n, batch=batch, crc=crc)
        geom = geometry_key(out_rows, in_rows, n, batch)
        secs = max(float(seconds), 1e-9)

        peaks = known_peaks(device)
        floor = None if peaks is None else roofline_floor_seconds(
            cost["flops"], cost["bytes"], peaks, dtype)
        achieved = None if floor is None else min(floor / secs, 1.0)

        row = {"ts": round(self.clock(), 6), "kernel": kernel,
               "codec": codec, "dtype": dtype, "geometry": geom,
               "seconds": round(secs, 9), "bytes": cost["bytes"],
               "macs": cost["macs"], "intensity":
                   round(cost["intensity"], 3),
               "achieved": None if achieved is None
                   else round(achieved, 6),
               "measured_bytes": measured_bytes, "node": node}
        key = (kernel, codec, dtype, geom)
        with self._lock:
            self._ring.append(row)
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = [
                    0, 0.0, 0, 0,
                    WindowedSketch(min_value=1e-6, clock=self.clock)]
            series[0] += 1
            series[1] += secs
            series[2] += cost["bytes"]
            series[3] += cost["macs"]
            if achieved is not None:
                series[4].observe(achieved)

        kernel_seconds_total.inc(secs, kernel=kernel, codec=codec,
                                 dtype=dtype)
        kernel_bytes_total.inc(cost["bytes"], kernel=kernel,
                               codec=codec, dtype=dtype)
        kernel_work_total.inc(cost["macs"], kernel=kernel, codec=codec,
                              dtype=dtype)
        return row

    # -- pipeline occupancy -----------------------------------------

    def note_pipeline(self, kind: str, recorder, node: str = "") -> dict:
        """Fold one streamed run's recorder into the ledger: keep the
        occupancy doc + recent gantt, publish the occupancy gauge, and
        emit `device.slow` when the device-busy fraction stays
        collapsed for _COLLAPSE_STREAK consecutive runs."""
        occ = recorder.device_occupancy()
        bubbles = recorder.bubble_attribution()
        doc = {"ts": round(self.clock(), 6), "kind": kind,
               "node": node, "occupancy": occ, "bubbles": bubbles,
               "gantt": recorder.gantt(last=_GANTT_LAST)}
        frac = occ.get("fraction")
        with self._lock:
            self._pipelines.append(doc)
            collapsed = False
            if frac is not None:
                if frac < _COLLAPSE_OCCUPANCY:
                    self._streak[kind] = self._streak.get(kind, 0) + 1
                else:
                    self._streak[kind] = 0
                collapsed = self._streak[kind] >= _COLLAPSE_STREAK
                self._collapsed[kind] = collapsed
            now = self.clock()
            should_emit = (collapsed
                           and now - self._last_emit >= _EMIT_EVERY)
            if should_emit:
                self._last_emit = now

        if frac is not None:
            device_occupancy.set(frac, stage="device")
            for stage, share in (occ.get("stages") or {}).items():
                if stage != "device":
                    device_occupancy.set(share, stage=stage)
        if should_emit:
            self._emit_slow(kind, node, frac, bubbles)
        return doc

    def _emit_slow(self, kind: str, node: str, frac: float,
                   bubbles: dict) -> None:
        try:
            from ..events import emit
            from ..trace import root_span
            with root_span("device.slow", "roofline"):
                emit("device.slow", node=node, severity="warn",
                     pipeline=kind,
                     occupancy=round(float(frac), 4),
                     threshold=_COLLAPSE_OCCUPANCY,
                     streak=self._streak.get(kind, 0),
                     starving_stage=bubbles.get("starving_stage", ""),
                     bubble_seconds=round(
                         float(bubbles.get("bubble_seconds", 0.0)), 6))
        except Exception:  # noqa: BLE001 — accounting must never
            pass           # take the encode path down

    # -- conservation -----------------------------------------------

    def conservation(self) -> dict:
        """Analytic bytes vs ledger-measured bytes, per invocation in
        the ring, within max(1%, 4KB) — the cost-model correctness
        gate, in the wire-flow plane's style."""
        settle()
        checked = 0
        violations = []
        with self._lock:
            rows = list(self._ring)
        for row in rows:
            mb = row.get("measured_bytes")
            if mb is None:
                continue
            checked += 1
            tol = max(0.01 * mb, 4096.0)
            if abs(row["bytes"] - mb) > tol:
                if len(violations) < 8:
                    violations.append(
                        {"kernel": row["kernel"],
                         "geometry": row["geometry"],
                         "analytic": row["bytes"], "measured": mb})
        return {"ok": not violations, "checked": checked,
                "violations": violations}

    # -- read side ---------------------------------------------------

    def kernel_table(self) -> list[dict]:
        """Absolute per-series rollup (idempotent heartbeat rows)."""
        settle()
        with self._lock:
            items = sorted(self._series.items())
            out = []
            for (kernel, codec, dtype, geom), s in items:
                sk = s[4]
                out.append({"kernel": kernel, "codec": codec,
                            "dtype": dtype, "geometry": geom,
                            "count": s[0],
                            "seconds": round(s[1], 6),
                            "bytes": s[2], "work": s[3],
                            "achieved_p50": _rq(sk, 0.5),
                            "achieved_p95": _rq(sk, 0.95)})
        return out

    def recent(self, n: int = 32) -> list[dict]:
        settle()
        with self._lock:
            return list(self._ring)[-n:]

    def pipelines(self, n: int = 4) -> list[dict]:
        with self._lock:
            return list(self._pipelines)[-n:]

    def occupancy_summary(self) -> dict:
        """Latest occupancy per pipeline kind + the collapse verdicts
        the healthz warning keys on."""
        with self._lock:
            docs = list(self._pipelines)
            collapsed = dict(self._collapsed)
            streaks = dict(self._streak)
        latest: dict[str, dict] = {}
        for doc in docs:
            occ = doc.get("occupancy") or {}
            latest[doc["kind"]] = {
                "fraction": occ.get("fraction"),
                "starving_stage":
                    (doc.get("bubbles") or {}).get("starving_stage", ""),
                "ts": doc.get("ts")}
        return {"latest": latest, "collapsed": collapsed,
                "streaks": streaks,
                "any_collapsed": any(collapsed.values())}

    def heartbeat_view(self) -> dict:
        """What a volume server ships under hb["device"]: absolute
        kernel rows (merge is idempotent) + the occupancy summary."""
        return {"kernels": self.kernel_table(),
                "occupancy": self.occupancy_summary()}

    def reset(self) -> None:
        """Drop every row, doc and streak, and the timed launches not
        yet accounted."""
        _PENDING.clear()
        with self._lock:
            self._ring.clear()
            self._series.clear()
            self._pipelines.clear()
            self._streak.clear()
            self._collapsed.clear()
            self._last_emit = 0.0


def _rq(sketch, q: float):
    v = sketch.quantile(q)
    return None if v is None else round(v, 6)


LEDGER = RooflineLedger()


def _device_memory_stats() -> list[dict]:
    """torch.cuda.memory_stats of every visible card, best-effort (no
    rows without a card)."""
    out = []
    try:
        import torch
        if not torch.cuda.is_available():
            return out
        for i in range(torch.cuda.device_count()):
            row = {"id": i, "kind": torch.cuda.get_device_name(i),
                   "platform": "cuda"}
            try:
                ms = torch.cuda.memory_stats(i)
                row["bytes_in_use"] = ms.get("allocated_bytes.all.current")
                row["bytes_limit"] = \
                    torch.cuda.get_device_properties(i).total_memory
            except Exception:  # noqa: BLE001 — stats are best-effort
                pass
            out.append(row)
    except Exception:  # noqa: BLE001 — no device stack, no rows
        pass
    return out


def debug_doc(node: str, role: str) -> dict:
    """GET /debug/device payload: measured peaks (of the card when one
    is present, else the CPU), the per-kernel
    roofline table, recent invocations, recent pipeline gantts with
    bubble attribution, the conservation verdict, and device memory
    stats."""
    return {"node": node, "role": role, "armed": ARMED,
            "peaks": probe_peaks(),
            "kernels": LEDGER.kernel_table(),
            "recent": LEDGER.recent(16),
            "pipelines": LEDGER.pipelines(4),
            "occupancy": LEDGER.occupancy_summary(),
            "conservation": LEDGER.conservation(),
            "devices": _device_memory_stats()}
