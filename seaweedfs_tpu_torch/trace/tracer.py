"""Distributed request tracing: W3C-`traceparent` context + span buffer.

The multi-hop hot paths (filer write -> chunk upload -> replication
fan-out, read-redirect lookup, distributed EC reconstruction) cross
three server roles; request counters and latency histograms say *that*
a request was slow, never *where*.  This module is the missing piece:

- `SpanContext` rides the standard `traceparent` header
  (`00-<32hex trace>-<16hex span>-<2hex flags>`) on every internal
  HTTP hop (injected by `cluster/rpc._request`, extracted by the
  server middleware in `cluster/rpc.JsonHttpServer._serve_one`) and as
  gRPC metadata on the master facade.
- Completed spans land in a bounded in-process ring buffer (`BUFFER`),
  exported by `/debug/traces` (trace/routes.py) and the shell's
  `trace.ls` / `trace.get`.
- Head-based sampling: the root server span (no incoming context)
  flips a coin at SEAWEEDFS_TPU_TRACE_SAMPLE (default 1.0) and the
  decision propagates downstream in the flags byte, so one request is
  either traced on every hop or on none.
- Always-sample slow-request trigger: a span slower than
  SEAWEEDFS_TPU_TRACE_SLOW_MS (default 250) is recorded even when the
  head decision was "no" — only the slow span itself (its children
  already finished unrecorded), which is the head-sampling compromise:
  you always learn *which hop* was slow, at zero per-request cost.

Spans are process-global: an in-process test stack (master + volume +
filer in one interpreter) serves the fully-stitched trace from any
role's `/debug/traces`; a real multi-process deployment serves each
process's own spans and `trace.get` aggregates across servers.

Recording is enabled only when a consumer is (the /debug/traces
endpoint via SEAWEEDFS_TPU_TRACES=1, or SEAWEEDFS_TPU_TRACE=1 for
in-process readers); SEAWEEDFS_TPU_TRACE=0 is the kill switch.

Trust boundary: an incoming traceparent's sampled flag is honored (a
trace must be all-or-nothing across hops), so it is only meaningful on
the internal cluster plane — master/volume/filer, the servers that run
this middleware.  The untrusted edges (S3/WebDAV gateways) do not; a
hostile client of the internal plane could force sampling and churn
the bounded ring, which is the same stance as the unauthenticated
/debug endpoints: enable tracing on networks you trust.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager

from ..utils import env_float as _env_float

TRACEPARENT_HEADER = "traceparent"

_local = threading.local()


def enabled() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_TRACE", "") not in ("0", "false")


def recording_on() -> bool:
    """A consumer exists: the /debug/traces endpoint is mounted or
    recording was forced — the gate entry points that bypass the
    JsonHttpServer middleware (the gRPC facade) must apply themselves;
    the middleware applies it at setup via trace/routes.py."""
    env = os.environ.get("SEAWEEDFS_TPU_TRACE", "")
    if env in ("0", "false"):
        return False
    return env in ("1", "true") or \
        os.environ.get("SEAWEEDFS_TPU_TRACES", "") in ("1", "true")


def sample_rate() -> float:
    return _env_float("SEAWEEDFS_TPU_TRACE_SAMPLE", 1.0)


def slow_threshold_seconds() -> float:
    return _env_float("SEAWEEDFS_TPU_TRACE_SLOW_MS", 250.0) / 1000.0


def parse_traceparent(header: str) -> tuple[str, str, bool] | None:
    """`00-<trace>-<span>-<flags>` -> (trace_id, span_id, sampled).
    Malformed headers are ignored (a trace must never fail a request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 \
            or len(flags) != 2 or version == "ff":
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        sampled = bool(int(flags, 16) & 1)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, sampled


class Span:
    """One timed operation.  Server spans come from the rpc middleware;
    internal/client spans from the `span()` context manager."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "kind", "sampled", "start", "_t0", "duration", "attrs",
                 "status", "_prev")

    def __init__(self, trace_id: str, parent_id: str, name: str,
                 service: str, kind: str, sampled: bool):
        self.trace_id = trace_id
        self.span_id = os.urandom(8).hex()
        self.parent_id = parent_id
        self.name = name
        self.service = service
        self.kind = kind
        self.sampled = sampled
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.duration = 0.0
        self.attrs: dict = {}
        self.status = "ok"
        self._prev = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def traceparent(self) -> str:
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "service": self.service, "kind": self.kind,
                "start": self.start, "duration_ms": self.duration * 1e3,
                "status": self.status, "attrs": self.attrs}


class _NoopSpan:
    """Stand-in when no trace is active — instrumentation points call
    set()/traceparent() unconditionally."""

    __slots__ = ()
    sampled = False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def traceparent(self) -> str:
        return ""


NOOP = _NoopSpan()


class TraceBuffer:
    """Bounded ring of completed spans grouped by trace id.  Traces are
    evicted FIFO by first-seen once `max_traces` is reached; a single
    trace is capped at `max_spans` (a runaway fan-out must not evict
    every other trace's history)."""

    def __init__(self, max_traces: int = 512, max_spans: int = 512):
        self.max_traces = max_traces
        self.max_spans = max_spans
        self._traces: "OrderedDict[str, list[dict]]" = OrderedDict()
        self._lock = threading.Lock()
        self.dropped = 0

    def record(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                    self.dropped += 1
                spans = self._traces[span.trace_id] = []
            elif len(spans) >= self.max_spans:
                self.dropped += 1  # truncation must be visible on
                return             # /debug/traces, not silent
            spans.append(d)

    def get(self, trace_id: str) -> list[dict] | None:
        with self._lock:
            spans = self._traces.get(trace_id)
            return list(spans) if spans is not None else None

    def summaries(self, limit: int = 100) -> list[dict]:
        """Newest-first trace summaries for `/debug/traces` / trace.ls."""
        with self._lock:
            items = [(tid, list(spans))
                     for tid, spans in self._traces.items()]
        out = []
        for tid, spans in reversed(items[-limit:] if limit else items):
            root = next((s for s in spans if not s["parent_id"]), None)
            first = min(spans, key=lambda s: s["start"])
            end = max(s["start"] + s["duration_ms"] / 1e3 for s in spans)
            head = root or first
            out.append({
                "trace_id": tid,
                "start": first["start"],
                "duration_ms": (end - first["start"]) * 1e3,
                "spans": len(spans),
                "services": sorted({s["service"] for s in spans}),
                "root": f"{head['service']}: {head['name']}",
            })
        return out

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self.dropped = 0


BUFFER = TraceBuffer()


def _finish(span: Span) -> None:
    span.duration = time.perf_counter() - span._t0
    if span.sampled or span.duration >= slow_threshold_seconds():
        BUFFER.record(span)


def current_span():
    return getattr(_local, "span", None)


def current_traceparent() -> str | None:
    """Header value for the active span, or None — what outbound
    clients inject (rpc._request, filer/client.py, gRPC metadata)."""
    sp = getattr(_local, "span", None)
    return sp.traceparent() if sp is not None else None


def begin_server_span(service: str, method: str, path: str,
                      traceparent: str) -> Span | None:
    """Middleware entry (rpc._serve_one): continue the incoming context
    or head-sample a fresh root.  Returns None when tracing is off."""
    if not enabled():
        return None
    ctx = parse_traceparent(traceparent)
    if ctx is None:
        trace_id = os.urandom(16).hex()
        parent_id = ""
        sampled = random.random() < sample_rate()
    else:
        trace_id, parent_id, sampled = ctx
    sp = Span(trace_id, parent_id, f"{method} {path}", service,
              "server", sampled)
    sp._prev = getattr(_local, "span", None)
    _local.span = sp
    return sp


def end_server_span(span: Span | None, status: int = 200) -> None:
    if span is None:
        return
    _local.span = span._prev
    span.attrs.setdefault("http.status", status)
    if status >= 500:
        span.status = "error"
    _finish(span)


@contextmanager
def root_span(name: str, service: str, **attrs):
    """Root span for background operations that start outside any
    request — the master's dead-node sweep, raft elections, batch EC
    encode/rebuild jobs.  Gives the operation a trace id so the events
    it emits (events/journal.py) link to a /debug/traces timeline, and
    the operation itself shows up as a trace.  Inside an existing trace
    this degrades to a plain child span; with tracing disabled it is
    the usual no-op."""
    if not enabled():
        yield NOOP
        return
    prev = getattr(_local, "span", None)
    if prev is not None:
        with span(name, **attrs) as sp:
            yield sp
        return
    sp = Span(os.urandom(16).hex(), "", name, service, "internal",
              recording_on())
    sp.attrs.update(attrs)
    _local.span = sp
    try:
        yield sp
    except BaseException as e:
        sp.status = "error"
        sp.attrs["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _local.span = None
        _finish(sp)


@contextmanager
def span(name: str, **attrs):
    """Child span of whatever is active on this thread.  With no active
    trace this is a no-op — traces begin at server spans, so free-
    standing client code (benchmarks, unit tests) pays nothing."""
    parent = getattr(_local, "span", None)
    if parent is None or not enabled():
        yield NOOP
        return
    sp = Span(parent.trace_id, parent.span_id, name, parent.service,
              "internal", parent.sampled)
    sp.attrs.update(attrs)
    sp._prev = parent
    _local.span = sp
    try:
        yield sp
    except BaseException as e:
        sp.status = "error"
        sp.attrs["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _local.span = parent
        _finish(sp)
