"""Prometheus-style metrics: counters, gauges, histograms + exposition.

Reference: weed/stats/metrics.go:21-118 — request counters and latency
histograms for filer/volume/S3, volume-count and disk-size gauges, and
LoopPushingMetric (:140) which POSTs to a push gateway whose address is
distributed from master configuration.  No prometheus_client package in
the image, so the exposition format is emitted directly.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time
import urllib.request
from contextlib import contextmanager
from typing import Callable

DEFAULT_BUCKETS = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt_num(v: float) -> str:
    """Full-precision exposition: %g would truncate counters past 1e6
    (a stuck-looking counter) and byte gauges past ~6 digits."""
    f = float(v)
    if f.is_integer() and abs(f) < 2**63:
        return str(int(f))
    return repr(f)


def _esc_label_value(v) -> str:
    # Prometheus exposition requires all three escapes: backslash first
    # (or the others' escapes would be double-escaped), then quote, then
    # newline — an unescaped \n in a label value splits the sample line
    # and corrupts the whole line-oriented scrape.
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = ""

    def __init__(self, name: str, help_: str,
                 label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple:
        # Hot path (every request observes): build the key directly and
        # let a KeyError/length mismatch fall into the slow error path
        # instead of constructing two sets per call.
        try:
            if len(labels) == len(self.label_names):
                return tuple(str(labels[k]) for k in self.label_names)
        except KeyError:
            pass
        raise ValueError(
            f"{self.name}: labels {sorted(labels)} != declared "
            f"{sorted(self.label_names)}")

    def _labels_of(self, key: tuple) -> dict[str, str]:
        return dict(zip(self.label_names, key))


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str,
                 label_names: tuple[str, ...] = ()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            out.append(f"{self.name}"
                       f"{_fmt_labels(self._labels_of(key))} "
                       f"{_fmt_num(v)}")
        return out


class Gauge(_Metric):
    """A settable value, or a callback sampled at scrape time (the
    reference computes volume counts/disk sizes on collect)."""

    kind = "gauge"

    def __init__(self, name: str, help_: str,
                 label_names: tuple[str, ...] = (),
                 callback: Callable[[], float | dict] | None = None):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}
        self.callback = callback

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        if self.callback is not None:
            sampled = self.callback()
            if isinstance(sampled, dict):
                # {labels-tuple-or-dict: value}
                for labels, v in sorted(
                        sampled.items(), key=lambda kv: str(kv[0])):
                    if isinstance(labels, tuple):
                        labels = dict(zip(self.label_names, labels))
                    out.append(f"{self.name}{_fmt_labels(labels)} "
                               f"{_fmt_num(v)}")
            else:
                out.append(f"{self.name} {_fmt_num(sampled)}")
            return out
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            out.append(f"{self.name}"
                       f"{_fmt_labels(self._labels_of(key))} "
                       f"{_fmt_num(v)}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 label_names: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        # Per-bucket (non-cumulative) counts + bisect: one increment
        # per observation instead of a 15-bucket scan — this runs on
        # every request.  expose() converts to Prometheus cumulative.
        k = self._key(labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.buckets) + 1))
            counts[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1

    def count(self, **labels) -> int:
        """Observation count of one series (0 when never observed)."""
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def series(self, **labels):
        """Pre-resolved single-series observe handle for hot paths
        (per-request lock metering): label validation, key building,
        and slot allocation happen ONCE here; each observe() is then
        a bisect + one locked list/float update — ~3x cheaper than
        the labeled observe().  Exposition reads the same storage."""
        k = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.buckets) + 1))
            self._sums.setdefault(k, 0.0)
            self._totals.setdefault(k, 0)
        hist = self

        class _Series:
            __slots__ = ()

            @staticmethod
            def observe(value: float) -> None:
                i = bisect.bisect_left(hist.buckets, value)
                with hist._lock:
                    counts[i] += 1
                    hist._sums[k] += value
                    hist._totals[k] += 1
        return _Series()

    def time(self, **labels):
        """Context manager: observe elapsed seconds."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self  # nestable with other context managers

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)
        return _Timer()

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            keys = sorted(self._counts)
            counts = {k: list(v) for k, v in self._counts.items()}
            sums = dict(self._sums)
            totals = dict(self._totals)
        for key in keys:
            labels = self._labels_of(key)
            running = 0
            for i, b in enumerate(self.buckets):
                running += counts[key][i]
                lb = dict(labels)
                lb["le"] = f"{b:g}"
                out.append(f"{self.name}_bucket{_fmt_labels(lb)} "
                           f"{running}")
            lb = dict(labels)
            lb["le"] = "+Inf"
            out.append(f"{self.name}_bucket{_fmt_labels(lb)} "
                       f"{totals[key]}")
            out.append(f"{self.name}_sum{_fmt_labels(labels)} "
                       f"{_fmt_num(sums[key])}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} "
                       f"{totals[key]}")
        return out


class Registry:
    def __init__(self) -> None:
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def register_once(self, metric: _Metric):
        """register() for shared singletons: a second registration into
        the same registry is a no-op instead of a duplicate exposition
        block (which would fail promcheck)."""
        with self._lock:
            if metric not in self._metrics:
                self._metrics.append(metric)
        return metric

    def counter(self, name: str, help_: str,
                label_names: tuple[str, ...] = ()) -> Counter:
        return self.register(Counter(name, help_, label_names))

    def gauge(self, name: str, help_: str,
              label_names: tuple[str, ...] = (),
              callback=None) -> Gauge:
        return self.register(Gauge(name, help_, label_names, callback))

    def histogram(self, name: str, help_: str,
                  label_names: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self.register(Histogram(name, help_, label_names,
                                       buckets))

    def expose(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            try:
                lines.extend(m.expose())
            except Exception:  # noqa: BLE001 — one broken callback
                continue       # must not kill the whole scrape
        return "\n".join(lines) + "\n"


global_registry = Registry()


# -- EC pipeline stage instruments ------------------------------------------
# Process-global singletons every EC code path observes into — the
# CUDA coder's kernel timings (ops/coder_cuda.py; device time from a
# CUDA event pair on a card, host time of the plain version on the CPU),
# the batched mesh encode's fetch/device/scatter stages
# (parallel/cluster_encode.py), and the volume server's distributed
# reconstruction ladder (shard gather, device solve, host staging).
# Servers register the SAME objects into their scrape registry
# (Registry.register accepts an existing metric), so kernel time, host
# staging, and network fan-out are separately visible on /metrics
# wherever EC work runs.  Buckets extend past the request-latency
# defaults: a batched multi-volume encode legitimately takes minutes.

EC_STAGE_BUCKETS = DEFAULT_BUCKETS + (30.0, 60.0, 120.0)

ec_stage_seconds = Histogram(
    "SeaweedFS_ec_stage_seconds",
    "EC pipeline stage wall time (device stages are execution-fenced)",
    ("stage",), buckets=EC_STAGE_BUCKETS)

ec_stage_bytes = Counter(
    "SeaweedFS_ec_stage_bytes_total",
    "bytes processed per EC pipeline stage", ("stage",))


def observe_ec_stage(stage: str, seconds: float, nbytes: int = 0) -> None:
    ec_stage_seconds.observe(seconds, stage=stage)
    # Unconditional: a zero-byte observation must still materialize the
    # stage's series (rate() over a family that only appears under load
    # reads as a counter reset, and per-stage byte totals silently
    # under-count stages whose first calls carry nbytes=0).
    ec_stage_bytes.inc(nbytes, stage=stage)
    # Time-attribution: execution-fenced device legs observed while a
    # request ledger is active (a degraded read's EC reconstruction,
    # an inline repair's decode) land in that request's `device`
    # phase; host staging / fan-out stages stay in `handler`/`rpc`.
    if "kernel" in stage or "device" in stage:
        from . import phases as _phases
        _phases.note("device", seconds)


# -- data-integrity instruments ---------------------------------------------
# Process-global singletons the scrub/self-healing pipeline observes
# into (storage/scrub.py, cluster/volume_server.py); the volume server
# registers the same objects on its /metrics scrape.

scrub_checked_total = Counter(
    "SeaweedFS_scrub_checked_total",
    "items CRC-verified by the scrubber", ("kind",))  # needle|shard_block

scrub_bytes_total = Counter(
    "SeaweedFS_scrub_bytes_total",
    "bytes read and CRC-verified by the scrubber")

scrub_corrupt_total = Counter(
    "SeaweedFS_scrub_corrupt_total",
    "corruptions detected by the scrubber", ("kind",))

scrub_sweeps_total = Counter(
    "SeaweedFS_scrub_sweeps_total", "completed scrub sweeps")

needle_repairs_total = Counter(
    "SeaweedFS_needle_repairs_total",
    "self-healing repairs by source", ("source",))  # replica|ec

# Repair bandwidth, the dominant EC operating cost at scale (arxiv
# 1309.0186): every shard byte read to rebuild/reconstruct EC data,
# labeled by codec so the LRC-vs-RS saving is a PromQL ratio.  Fed by
# the local rebuild (ec/encoder.py), the volume server's degraded-read
# / repair ladder, and the cluster batch-rebuild planner.
ec_repair_read_bytes_total = Counter(
    "SeaweedFS_ec_repair_read_bytes_total",
    "shard bytes read to repair or reconstruct EC data", ("codec",))


# -- cross-cluster replication instruments -----------------------------------
# Process-global singletons the rlog shipper observes into
# (replication/shipper.py); the volume server registers the same
# objects on its /metrics scrape (promcheck-gated in tests).

replication_shipped_bytes_total = Counter(
    "SeaweedFS_replication_shipped_bytes_total",
    "change-log payload bytes acked by the standby cluster")

replication_resends_total = Counter(
    "SeaweedFS_replication_resends_total",
    "replication batches re-sent (WAN retries + injected duplicate "
    "delivery) — every resend is a no-op at the receiver's watermark",
    ("reason",))  # retry|duplicate

replication_lag_seconds_total = Counter(
    "SeaweedFS_replication_lag_seconds_total",
    "observed replication lag integrated over shipper ticks (a "
    "burn-style counter: its rate IS the average lag in seconds)")

replication_lag_seconds = Gauge(
    "SeaweedFS_replication_lag_seconds",
    "age of the oldest unacked change-log record, per volume",
    ("volume",))


# -- tiering / lifecycle instruments -----------------------------------------
# Process-global singletons the tier plane observes into: the shared
# remote block cache (storage/remote_cache.py, served-byte accounting
# at pread granularity), the tier movers (storage/tier.py), vacuum's
# TTL reclaim, and the master's lifecycle daemon.  The volume server
# and master register the same objects on their /metrics scrape.

tier_cache_hit_bytes_total = Counter(
    "SeaweedFS_tier_cache_hit_bytes_total",
    "tiered-read bytes served from the remote block cache")

tier_cache_miss_bytes_total = Counter(
    "SeaweedFS_tier_cache_miss_bytes_total",
    "tiered-read bytes that had to be fetched from the remote backend")

tier_moved_bytes_total = Counter(
    "SeaweedFS_tier_moved_bytes_total",
    "volume .dat bytes moved across the tier boundary",
    ("direction",))  # upload|download

ttl_expired_bytes_total = Counter(
    "SeaweedFS_ttl_expired_bytes_total",
    "bytes reclaimed from TTL-expired needles",
    ("via",))  # vacuum|volume_retire

lifecycle_actions_total = Counter(
    "SeaweedFS_lifecycle_actions_total",
    "lifecycle daemon actions by kind and outcome",
    ("action", "outcome"))  # tier|expire|promote x ok|error

# -- front door (netcore / filer hot-path) instruments ----------------------
# The filer chunk cache (storage/chunk_cache.py) and small-file packer
# (filer/packing.py); connection-plane counters live in
# netcore/registry.py beside the registry that feeds them.

filer_chunk_cache_hit_bytes_total = Counter(
    "SeaweedFS_filer_chunk_cache_hit_bytes_total",
    "filer chunk-read bytes served from the process chunk cache")

filer_chunk_cache_miss_bytes_total = Counter(
    "SeaweedFS_filer_chunk_cache_miss_bytes_total",
    "filer chunk-read bytes fetched from volume servers")

filer_packed_files_total = Counter(
    "SeaweedFS_filer_packed_files_total",
    "small files packed into shared needles on filer upload")

filer_packed_needles_total = Counter(
    "SeaweedFS_filer_packed_needles_total",
    "shared pack needles written (files-per-needle = files/needles)")

filer_packed_bytes_total = Counter(
    "SeaweedFS_filer_packed_bytes_total",
    "payload bytes stored via the small-file packer")

# Metadata-HA shard plane (filer/metaha.py): journal appends on the
# shard primary, replicated applies on followers, and epoch-fence
# refusals (the metadata split-brain guard).

filer_shard_journal_records_total = Counter(
    "SeaweedFS_filer_shard_journal_records_total",
    "metadata mutations framed into a shard .mlog on the primary",
    ("shard",))

filer_shard_apply_total = Counter(
    "SeaweedFS_filer_shard_apply_total",
    "replicated shard records applied on followers, by result "
    "(applied / duplicate)",
    ("shard", "result"))

filer_shard_fences_total = Counter(
    "SeaweedFS_filer_shard_fences_total",
    "stale-epoch shard operations refused (the metadata split-brain "
    "fence)",
    ("shard",))


def observe_batch_stage(stages: dict, stage: str, seconds: float,
                        nbytes: int) -> None:
    """observe_ec_stage plus a per-batch accumulator: the batched EC
    encode/rebuild report per-stage totals on their finish events
    (events/journal.py), not just in the process histograms.  `stages`
    maps stage -> [seconds, bytes]."""
    observe_ec_stage(stage, seconds, nbytes)
    acc = stages.setdefault(stage, [0.0, 0])
    acc[0] += seconds
    acc[1] += nbytes


@contextmanager
def profiler_range(name: str):
    """A `torch.profiler.record_function(name)` range around the block
    while a profiler collects (the flag is process-wide, so from any
    thread), else nothing: the range puts the block on a profiler
    trace's clock, beside the card's records."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextmanager
def ec_stage(stage: str, nbytes: int = 0, stages: dict | None = None):
    """Time the block into the EC stage histograms as `stage` (never a
    name with `kernel` or `device` in it: those count as a request's
    device time), added to the `stages` accumulator when one is given
    (observe_batch_stage), and as the profiler range `ec.<stage>`.  A
    block that raises is not observed."""
    with profiler_range("ec." + stage):
        t0 = time.perf_counter()
        yield
        seconds = time.perf_counter() - t0
    if stages is None:
        observe_ec_stage(stage, seconds, nbytes)
    else:
        observe_batch_stage(stages, stage, seconds, nbytes)


def stage_attrs(stages: dict) -> dict:
    """Flatten an observe_batch_stage accumulator into event attrs:
    {<stage>_seconds, <stage>_bytes}."""
    out = {}
    for stage, (seconds, nbytes) in stages.items():
        out[f"{stage}_seconds"] = round(seconds, 6)
        out[f"{stage}_bytes"] = int(nbytes)
    return out


class MetricsPusher:
    """LoopPushingMetric (stats/metrics.go:140): periodically POST the
    exposition text to a push gateway."""

    def __init__(self, registry: Registry, gateway_url: str, job: str,
                 instance: str, interval_seconds: float = 15.0):
        self.registry = registry
        self.url = (f"{gateway_url.rstrip('/')}/metrics/job/{job}"
                    f"/instance/{instance}")
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-push")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop, wait for any in-flight push (bounded — the
        push itself has a 10s timeout), then flush one final exposition
        so a short-lived process doesn't lose its last interval."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=15.0)
        try:
            self.push_once()
        except Exception:  # noqa: BLE001 — gateway down; best effort
            pass

    def push_once(self) -> None:
        body = self.registry.expose().encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "text/plain"})
        urllib.request.urlopen(req, timeout=10).read()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.push_once()
            except Exception:  # noqa: BLE001 — gateway down; retry
                pass
