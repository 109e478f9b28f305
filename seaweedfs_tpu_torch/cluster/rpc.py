"""HTTP/JSON control plane.

The reference runs gRPC (control) + HTTP (data) between roles
(weed/pb/*.proto, SURVEY §2.4).  This build keeps the same service shapes
— Assign/Lookup/heartbeat/allocate/EC RPCs with the same field names — but
carries them as JSON over HTTP: zero-dependency, debuggable with curl, and
swappable for gRPC later without touching the handlers.  The bulk EC
compute plane is the CUDA kernels (ops/, parallel/), not these RPCs.
The port's copy of seaweedfs_tpu/cluster/rpc.py: `RpcError` is also the
error the fault plane raises for an armed ``status`` spec.

Both halves are hand-rolled for per-request CPU, because on the write/read
hot path the HTTP framing IS the workload (the storage op itself is
~0.13ms): the server is a thread-per-connection keep-alive loop with a
~30-line parser (http.server's BaseHTTPRequestHandler burns ~0.3ms/request
in email.parser), and the client is a raw-socket keep-alive pool
(http.client spends ~0.25ms/request the same way).  The reference's Go
net/http does the equivalent in microseconds; this is the Python analog of
its pooled transports (operation/upload_content.go:67).

TLS: pass an ssl.SSLContext as JsonHttpServer(ssl_context=...) to serve
https, and install the client side with set_client_ssl_context()
(security.toml plane, reference weed/security/tls.go).
"""

from __future__ import annotations

import json
import os
import select
import socket
import struct
import threading
import time
import urllib.parse
import weakref
from typing import Callable

from ..events import journal as _events
from ..fault import registry as _fault
from ..netcore.bufio import SockReader
from ..netcore.registry import ConnRegistry, CountedConn, \
    conns_reaped_total
from ..stats import contention as _contention
from ..stats import flows as _flows
from ..stats import phases as _phases
from ..stats.metrics import Counter, Gauge, Histogram
from ..tenancy import context as _tenant_ctx
from ..trace import tracer as _tracer
from . import resilience as _res

# Transport selection for every JsonHttpServer in the process that is
# not given an explicit transport= (the -transport flag): "threads" is
# the thread-per-connection keep-alive loop, "aio" the netcore event
# loop.  The env override lets the whole test suite run on aio in one
# line: SEAWEEDFS_TPU_TRANSPORT=aio pytest tests/.
TRANSPORTS = ("threads", "aio")


def default_transport() -> str:
    t = os.environ.get("SEAWEEDFS_TPU_TRANSPORT", "").strip().lower()
    return t if t in TRANSPORTS else "threads"

_REASONS = {200: "OK", 201: "Created", 204: "No Content",
            206: "Partial Content", 301: "Moved Permanently",
            302: "Found", 304: "Not Modified", 307: "Temporary Redirect",
            400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
            404: "Not Found", 405: "Method Not Allowed",
            406: "Not Acceptable", 409: "Conflict",
            412: "Precondition Failed", 414: "URI Too Long",
            416: "Range Not Satisfiable", 423: "Locked",
            429: "Too Many Requests",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable",
            507: "Insufficient Storage"}

# Internal cluster traffic (replication fan-out, scrub repair fetches,
# EC rebuild shard gathers/scatters) marks itself with this header so
# the receiving server's admission control routes it through the
# lower-priority `internal` lane — a repair storm must never starve
# user reads (the operational lesson of arXiv:1309.0186).
PRIORITY_HEADER = "X-Weed-Priority"
PRIORITY_LOW = {PRIORITY_HEADER: "low"}


import re as _re

_RANGE_RE = _re.compile(r"^bytes=([0-9]*)-([0-9]*)$")

# A needle fid path: `/3,0172cb7d…` (optionally `/vid,fid/name.ext`).
_FID_PATH_RE = _re.compile(r"^/\d+,")


def endpoint_family(path: str, literal: bool) -> str:
    """Bounded-cardinality endpoint label for the request histogram and
    the SLO plane.  Literal routes (the static route table — which is
    how every real /admin/* endpoint is mounted, so the admin surface
    keeps its literal paths) keep their path; the per-needle data plane
    (`/3,0172…`) collapses to `/needle`; everything else (filer user
    paths, S3 objects, probes of unmounted paths — unbounded,
    client-chosen namespaces) collapses to `/other`.  The label set is
    therefore bounded by the route table + 3.  There is deliberately
    NO startswith("/admin/") carve-out: on a gateway whose / namespace
    is user-controlled, a client could mint unlimited /admin/<x> paths
    and grow the label set (and the SLO sketch table) without bound."""
    if literal:
        return path
    if _FID_PATH_RE.match(path):
        return "/needle"
    if path.startswith("/debug/"):
        return "/debug/*"
    return "/other"


def parse_byte_range(rng: str, size: int) -> tuple[int, int] | None:
    """Single-range 'bytes=' header -> (lo, hi) inclusive; None means
    serve the whole payload (RFC 7233 lets a server ignore unparseable
    or multi-part ranges — matching processRangeRequest's single-range
    fast path, weed/server/common.go:233).  A lo past the end raises
    RpcError(416)."""
    # Digits only, exactly one dash, at least one side present — like
    # Go's parseRange; Python's int() would otherwise accept '+5',
    # '1_0', or whitespace, and 'bytes=--10' would misparse as a
    # suffix range with a negative length.
    m = _RANGE_RE.match(rng)
    if m is None:
        return None
    lo_s, hi_s = m.group(1), m.group(2)
    if not lo_s and not hi_s:
        return None
    if lo_s:
        lo = int(lo_s)
        hi = int(hi_s) if hi_s else size - 1
    else:  # suffix form: bytes=-N
        lo = max(size - int(hi_s), 0)
        hi = size - 1
    if lo >= size:
        if size == 0 and not lo_s:
            return None  # suffix range of an empty body: serve it all
        raise RpcError(416, f"range {rng} beyond size {size}")
    hi = min(hi, size - 1)
    if hi < lo:  # reversed/negative range: unsatisfiable (Go's
        return None  # parseRange rejects start > end; serve it all)
    return lo, hi


class RpcError(Exception):
    def __init__(self, status: int, message: str,
                 headers: dict | None = None,
                 retry_after: float | None = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        # Extra response headers a handler wants on its error answer
        # (Retry-After on 429/503 sheds and drain refusals).
        self.headers = dict(headers or {})
        # Parsed Retry-After from a server's answer (client side):
        # RetryPolicy honors it as a backoff floor on 429/503.
        self.retry_after = retry_after


# -- admission control --------------------------------------------------------
# Per-role overload protection: bounded concurrency in three lanes
# (read / write / internal) with a bounded wait queue per lane.  A
# request that finds its lane full AND its queue full (or waits out the
# queue timeout) is shed with 429 + Retry-After instead of queueing the
# server into collapse.  Internal traffic (PRIORITY_HEADER: low —
# replication, scrub repair, EC rebuilds) runs in its own smaller lane
# so a repair storm cannot starve user traffic.  With max_concurrent=0
# nothing is ever shed, but in-flight requests are still counted — the
# graceful-drain path waits on that count.

# Like the breaker/retry/fault instruments, these are process-global:
# roles sharing one process (`weed server`, test stacks) report merged
# numbers on every scrape — the established convention for this
# codebase's RPC-plane instruments (see enable_metrics).
requests_shed_total = Counter(
    "SeaweedFS_requests_shed_total",
    "requests shed (429) by admission control", ("lane",))

_admission_instances: "weakref.WeakSet[AdmissionControl]" = \
    weakref.WeakSet()


def _inflight_values() -> dict:
    out = {("read",): 0.0, ("write",): 0.0, ("internal",): 0.0}
    for adm in list(_admission_instances):
        for lane in adm.lanes.values():
            out[(lane.name,)] += float(lane.inflight)
    return out


inflight_requests = Gauge(
    "SeaweedFS_inflight_requests",
    "admitted requests currently executing", ("lane",),
    callback=_inflight_values)


def _queue_depth_values() -> dict:
    out = {("read",): 0.0, ("write",): 0.0, ("internal",): 0.0}
    for adm in list(_admission_instances):
        for lane in adm.lanes.values():
            out[(lane.name,)] += float(lane.waiting)
    return out


# Per-lane queue pressure: the signal worker-pool autoscaling (and an
# operator eyeballing a saturated role) needs BEFORE sheds start — a
# nonzero depth with zero sheds is the early-warning band.
admission_queue_depth = Gauge(
    "SeaweedFS_admission_queue_depth",
    "admission waiters currently queued per lane", ("lane",),
    callback=_queue_depth_values)

# Realized queue wait per lane (admitted AND timed-out waits): the
# companion latency signal to the depth gauge above.
admission_wait_seconds = Histogram(
    "SeaweedFS_admission_wait_seconds",
    "time spent waiting in the admission queue", ("lane",))

# Per-tenant QoS throttles (tenancy/qos.py token buckets): an
# over-rate tenant's 429s, named — the flooding principal is visible
# on any role's scrape, distinct from lane sheds which blame no one.
tenant_throttled_total = Counter(
    "SeaweedFS_tenant_throttled_total",
    "requests throttled (429) by per-tenant QoS token buckets",
    ("tenant",))


class _Lane:
    """One admission lane: a concurrency cap plus a bounded wait queue.

    cap == 0 means unlimited (count in-flight only, never shed).  The
    queue is bounded in BOTH dimensions: at most `queue_depth` waiters,
    each waiting at most `queue_timeout` seconds — so under sustained
    overload latency stays bounded and the excess is shed immediately
    instead of building an unbounded backlog that outlives the burst.
    """

    __slots__ = ("name", "cap", "queue_depth", "queue_timeout", "_sem",
                 "inflight", "waiting", "shed", "_lock",
                 "_last_shed_emit", "_drr")

    def __init__(self, name: str, cap: int, queue_depth: int,
                 queue_timeout: float, weight_for=None):
        from ..tenancy.qos import DrrQueue
        self.name = name
        self.cap = cap
        self.queue_depth = queue_depth
        self.queue_timeout = queue_timeout
        self._sem = threading.BoundedSemaphore(cap) if cap > 0 else None
        # Per-tenant sub-queues inside this lane: freed slots are
        # handed out deficit-round-robin across tenants (weighted by
        # quota-rule weight=), so one flooding tenant's backlog cannot
        # monopolize the queue.  Untenanted traffic shares the ""
        # sub-queue — with a single tenant (or none) this degrades to
        # the plain FIFO the lane always had.
        self._drr = DrrQueue(weight_for=weight_for)
        self.inflight = 0
        self.waiting = 0
        self.shed = 0
        # Metered (stats/contention.py) only when a concurrency cap is
        # configured: with cap=0 this lock guards a bare in-flight
        # counter on EVERY request and admission can never queue or
        # shed — wrapping it would stretch a ~100ns critical section
        # into ~1µs of Python bookkeeping under the GIL (a measured
        # ~5% throughput tax at 4k req/s) for a lock whose contention
        # explains nothing.  With a cap, lane behavior IS the
        # front-door story and the metering earns its cost.
        # hold_observe_min: the normal hold is two counter increments;
        # only pathological holds deserve histogram rows.
        self._lock = _contention.MeteredLock(
            f"admission.{name}", hold_observe_min=1e-3) \
            if cap > 0 else threading.Lock()
        self._last_shed_emit = 0.0

    def enter(self, tenant: str = "") -> bool:
        """Admit (possibly after a bounded wait) or shed; True = admitted
        (the caller MUST pair it with exit()).

        The wait queue is per-tenant DRR: a waiter parks in its
        tenant's sub-queue and is woken by exit() handing it a freed
        slot directly (the semaphore is bypassed on handoff, so queued
        waiters can never be barged by fast-path newcomers — a free
        permit only exists while nobody waits)."""
        if self._sem is None:
            with self._lock:
                self.inflight += 1
            return True
        if self._sem.acquire(blocking=False):
            with self._lock:
                self.inflight += 1
            return True
        with self._lock:
            queue_full = self.waiting >= self.queue_depth
            if not queue_full:
                w = self._drr.push(tenant)
                self.waiting += 1
        if queue_full:
            self._record_shed()
            return False
        t0 = time.perf_counter()
        granted = w.event.wait(self.queue_timeout)
        admission_wait_seconds.observe(time.perf_counter() - t0,
                                       lane=self.name)
        with self._lock:
            self.waiting -= 1
            if not granted and w.event.is_set():
                # Lost race: exit() handed us the slot between the wait
                # timing out and this lock — the handoff is already
                # made, so refusing it would leak a permit.
                granted = True
            if granted:
                self.inflight += 1
            else:
                self._drr.discard(w)
        if not granted:
            self._record_shed()
        return granted

    def exit(self) -> None:
        with self._lock:
            self.inflight -= 1
            if self._sem is None:
                return
            w = self._drr.pop()
            if w is not None:
                # Direct handoff: the permit moves to the waiter.  Set
                # INSIDE the lock — a waiter timing out concurrently
                # rechecks is_set() under this same lock, so the slot
                # is either visibly handed or still poppable, never
                # handed to a corpse.
                w.event.set()
                return
        self._sem.release()

    def _record_shed(self) -> None:
        requests_shed_total.inc(lane=self.name)
        with self._lock:
            self.shed += 1
            now = time.monotonic()
            emit = now - self._last_shed_emit >= 5.0
            if emit:
                self._last_shed_emit = now
            shed_total = self.shed
        if emit:
            # Events are state transitions, not per-request traffic:
            # one journal row per shedding episode (>=5s apart), with
            # the cumulative count so the timeline still quantifies it.
            with _tracer.root_span("admission.shed", "rpc"):
                _events.emit("server.shed", severity="warn",
                             lane=self.name, shed_total=shed_total,
                             cap=self.cap,
                             queue_depth=self.queue_depth)


# Paths never queued or shed: operator/introspection surfaces must stay
# reachable exactly when the server is overloaded or draining (which is
# when they are needed), heartbeats keep the master's liveness view
# honest, and long-lived push streams (/cluster/watch) would pin a lane
# slot forever.  The /debug/ PREFIX exemption below covers the whole
# profiling plane (/debug/pprof/*, /debug/locks, /debug/slow, ...):
# a 30s blocking profile runs exactly when the server is saturated —
# the one moment it must not occupy a read-lane slot and compete with
# the traffic being diagnosed (asserted by
# tests/test_attribution.py's saturated-server profile test).
_ADMISSION_EXEMPT = {"/metrics", "/cluster/healthz", "/heartbeat",
                     "/filer/heartbeat", "/admin/drain",
                     "/admin/status", "/cluster/watch"}


def _admission_exempt(path: str) -> bool:
    return path in _ADMISSION_EXEMPT or path.startswith("/debug/")


class AdmissionControl:
    """Admission state for one server role (-max.concurrent).

    read / write lanes each get `max_concurrent` slots; the internal
    lane (PRIORITY_HEADER: low, and ?type=replicate fan-outs) gets a
    quarter of that, so background repair/replication pressure is
    capped below user traffic.  queue_depth defaults to 2x the lane's
    concurrency."""

    LANES = ("read", "write", "internal")

    def __init__(self, max_concurrent: int = 0,
                 queue_depth: int | None = None,
                 queue_timeout: float = 2.0,
                 internal_concurrent: int | None = None,
                 retry_after: float = 1.0,
                 tenant_policy=None):
        from ..tenancy.qos import TenantBuckets
        self.max_concurrent = max_concurrent
        if queue_depth is None:
            queue_depth = 2 * max_concurrent
        if internal_concurrent is None:
            internal_concurrent = max(1, max_concurrent // 4) \
                if max_concurrent else 0
        self.retry_after = retry_after
        # Tenancy QoS (-tenant.rules): per-tenant req/s + write-MB/s
        # token buckets at the gate, and DRR weights inside the lane
        # queues.  No policy = no throttling, weight 1 for everyone.
        self.tenant_policy = tenant_policy
        self.tenant_buckets = TenantBuckets(tenant_policy)
        weight_for = tenant_policy.weight_for if tenant_policy \
            is not None else None
        self._last_throttle_emit: dict[str, float] = {}
        self.lanes = {
            "read": _Lane("read", max_concurrent, queue_depth,
                          queue_timeout, weight_for),
            "write": _Lane("write", max_concurrent, queue_depth,
                           queue_timeout, weight_for),
            "internal": _Lane("internal", internal_concurrent,
                              max(1, queue_depth // 2)
                              if internal_concurrent else 0,
                              queue_timeout, weight_for),
        }
        _admission_instances.add(self)

    def throttle(self, tenant: str, nbytes: int = 0) -> float:
        """Per-tenant token-bucket check: 0.0 = admitted, else the
        Retry-After to surface on the 429.  Counts + journals the
        throttle (one `tenant.throttled` row per tenant per >=5s
        episode, like the lane-shed event)."""
        if not tenant:
            return 0.0
        retry = self.tenant_buckets.admit(tenant, nbytes)
        if retry <= 0.0:
            return 0.0
        tenant_throttled_total.inc(tenant=tenant)
        now = time.monotonic()
        if now - self._last_throttle_emit.get(tenant, 0.0) >= 5.0:
            self._last_throttle_emit[tenant] = now
            with _tracer.root_span("tenant.throttled", "rpc"):
                _events.emit(
                    "tenant.throttled", severity="warn", tenant=tenant,
                    retry_after=round(retry, 3),
                    throttled_total=int(
                        tenant_throttled_total.value(tenant=tenant)))
        return retry

    def lane_for(self, method: str, headers: dict,
                 query: dict) -> _Lane:
        if headers.get("x-weed-priority") == "low" or \
                query.get("type") == "replicate":
            return self.lanes["internal"]
        if method in ("GET", "HEAD"):
            return self.lanes["read"]
        return self.lanes["write"]

    def inflight_total(self) -> int:
        return sum(lane.inflight for lane in self.lanes.values())

    def snapshot(self) -> dict:
        out = {}
        for name, lane in self.lanes.items():
            with lane._lock:  # DrrQueue is lane-lock serialized
                queued = lane._drr.tenants()
            out[name] = {"cap": lane.cap, "inflight": lane.inflight,
                         "waiting": lane.waiting, "shed": lane.shed,
                         "queued_tenants": queued}
        return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _LineTooLong(Exception):
    """A request/header line exceeded the 64KB cap (maps to 414/431)."""


def _read_headers(rf) -> dict[str, str]:
    """Read header lines into a lowercase-keyed dict.

    EOF mid-headers is a connection error, not end-of-headers — a
    truncated request must never be parsed as a complete one.  A line
    missing its newline at the 64KB cap raises _LineTooLong instead of
    being silently truncated (and then misparsed)."""
    headers: dict[str, str] = {}
    while True:
        line = rf.readline(65537)
        if line in (b"\r\n", b"\n"):
            return headers
        if not line:
            raise ConnectionError("eof in headers")
        if not line.endswith(b"\n"):
            # A newline-less line shorter than the cap is EOF truncation
            # (peer died mid-line); only a full-cap line is too long.
            if len(line) < 65537:
                raise ConnectionError("eof mid-header line")
            raise _LineTooLong("header line exceeds 64KB")
        i = line.find(b":")
        if i > 0:
            headers[line[:i].decode("latin-1").strip().lower()] = \
                line[i + 1:].decode("latin-1").strip()


def _iter_chunks(rf):
    """Transfer-Encoding: chunked parser — yields each chunk's payload.
    The single implementation behind both the server's one-shot body
    read and the client's incremental response reader."""
    while True:
        line = rf.readline(65537)
        if not line:
            raise ConnectionError("eof in chunked body")
        size = int(line.split(b";")[0].strip() or b"0", 16)
        if size == 0:
            # trailers until blank line
            while rf.readline(65537) not in (b"\r\n", b"\n", b""):
                pass
            return
        piece = rf.read(size)
        if len(piece) < size:
            raise ConnectionError("eof in chunked body")
        yield piece
        rf.read(2)  # CRLF


def _chunk_pump(chunk_iter, buf: bytes, n: int):
    """Pull up to n bytes (all when n<0) from a chunk iterator with a
    carry buffer — the one chunked-read state machine shared by request
    (BodyReader) and response (_Resp) sides.  Returns
    (data, leftover_buf, exhausted)."""
    out = bytearray()
    exhausted = False
    while n < 0 or len(out) < n:
        if not buf:
            try:
                buf = next(chunk_iter)
            except StopIteration:
                exhausted = True
                break
        take = len(buf) if n < 0 else min(n - len(out), len(buf))
        out += buf[:take]
        buf = buf[take:]
    return bytes(out), buf, exhausted


class EventStream:
    """Unbounded push channel served as a chunked response — the
    HTTP-plane analog of the reference's long-lived gRPC streams
    (KeepConnected, SubscribeMetadata).  A handler returns one of
    these; producer threads push() JSON-able docs, each going out as
    one NDJSON line.  Blank-line heartbeats flow every `heartbeat`
    seconds so a dead peer is detected by the send failing; close()
    (run by the response writer on disconnect or end()) fires the
    registered cleanups (unsubscribe hooks)."""

    # A consumer that stops reading must not buffer the producer's
    # events forever: past this bound the stream terminates and the
    # client reconnects, resuming from its cursor (offsets make every
    # push channel resumable, so ending early is always safe).
    MAX_QUEUED = 65536

    def __init__(self, heartbeat: float = 10.0):
        import queue
        self._q: "queue.Queue[bytes]" = queue.Queue()
        self._empty = queue.Empty
        self.heartbeat = heartbeat
        self._cleanups: list = []
        self._closed = False
        self._overflowed = False

    def push(self, doc: dict) -> None:
        self.push_raw(json.dumps(doc).encode() + b"\n")

    def push_raw(self, line: bytes) -> None:
        if self._overflowed:
            return
        if self._q.qsize() >= self.MAX_QUEUED:
            self._overflowed = True
            self._q.put(b"")  # end: the slow consumer redials
            return
        self._q.put(line)

    def end(self) -> None:
        """Terminate the stream from the producer side."""
        self._q.put(b"")

    def on_close(self, fn) -> None:
        self._cleanups.append(fn)

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            return b""
        try:
            return self._q.get(timeout=self.heartbeat)
        except self._empty:
            return b"\n"  # heartbeat keeps dead-peer detection alive

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._closed = True
        for fn in self._cleanups:
            try:
                fn()
            except Exception:  # noqa: BLE001
                pass
        return False


class BodyReader:
    """Incremental request-body reader for stream_body routes.

    Handlers call read(n) for bounded pieces (exactly n bytes until
    EOF) or read() for the remainder; the server drains anything left
    over so keep-alive framing survives handlers that bail early.  A
    peer that dies mid-body raises ConnectionError — a short body must
    never be mistaken for a complete one."""

    def __init__(self, rf, length: int | None, chunked: bool):
        self._rf = rf
        self._remaining = length or 0
        self._chunk_iter = _iter_chunks(rf) if chunked else None
        self._buf = b""
        self.truncated = False
        # Declared size; None for chunked bodies (handlers that want to
        # forward with a Content-Length check this).
        self.length = None if chunked else length
        # Wire-flow attribution: set by _serve_one so consumed bytes
        # (handler reads AND the post-dispatch drain) count as the
        # request's "in" leg.
        self.flow_note = None

    def read(self, n: int = -1) -> bytes:
        if self._chunk_iter is not None:
            return self._read_chunked(n)
        want = self._remaining if n < 0 else min(n, self._remaining)
        out = bytearray()
        while len(out) < want:
            piece = self._rf.read(want - len(out))
            if not piece:
                self.truncated = True
                raise ConnectionError(
                    f"request body truncated: {self._remaining - len(out)}"
                    f" bytes missing")
            out += piece
        self._remaining -= len(out)
        if out and self.flow_note is not None:
            self.flow_note(len(out))
        return bytes(out)

    def _read_chunked(self, n: int) -> bytes:
        try:
            data, self._buf, exhausted = _chunk_pump(
                self._chunk_iter, self._buf, n)
        except Exception:  # malformed/truncated framing mid-body
            self.truncated = True
            raise ConnectionError(
                "chunked request body truncated") from None
        if exhausted:
            self._chunk_iter = None
            self._remaining = 0
        if data and self.flow_note is not None:
            self.flow_note(len(data))
        return data

    def drain(self) -> None:
        while True:
            if not self.read(1 << 20):
                return


def _read_chunked(rf) -> bytes:
    """Minimal Transfer-Encoding: chunked body reader (whole body)."""
    return b"".join(_iter_chunks(rf))


def _drain_then_fin(conn, rf, limit: int = 1 << 20) -> None:
    """Graceful error-close: signal FIN and drain the peer's unread
    request bytes (bounded) so the kernel doesn't RST away the error
    response we just sent."""
    try:
        conn.shutdown(socket.SHUT_WR)
        conn.settimeout(2.0)
        while limit > 0:
            data = rf.read(min(65536, limit))
            if not data:
                return
            limit -= len(data)
    except OSError:
        pass


class JsonHttpServer:
    """Route table -> threaded keep-alive HTTP server.

    Handlers: fn(query: dict, body: bytes) -> dict | bytes | tuple.
    Returning bytes sends application/octet-stream; a (status, dict)
    tuple sets the status code; a 3-tuple adds extra headers; a
    file-like payload is streamed.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 pass_headers: bool = False, ssl_context=None,
                 idle_timeout: float = 120.0,
                 admission: AdmissionControl | None = None,
                 transport: str | None = None,
                 stall_timeout: float | None = None,
                 workers: int = 0):
        self.host = host
        self.port = port or free_port()
        self.pass_headers = pass_headers
        self.ssl_context = ssl_context
        # Per-connection socket timeout: a peer that stalls mid-request
        # (slow-loris) or goes silent is reaped after this many idle
        # seconds, freeing its thread + (if admitted) its lane slot.
        self.idle_timeout = idle_timeout
        # Mid-request stall deadline (aio transport): a peer with a
        # request IN FLIGHT that goes silent is a slow-loris, not an
        # idle keep-alive conn — it is reaped much harder than
        # idle_timeout.  The threaded transport cannot tell the two
        # apart (its kernel SO_RCVTIMEO covers both).
        self.stall_timeout = stall_timeout if stall_timeout is not None \
            else min(idle_timeout, max(1.0, idle_timeout / 4.0))
        self.transport = (transport or default_transport()).lower()
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"(want one of {TRANSPORTS})")
        self.workers = workers or 16
        # Long-lived push-stream routes: under aio these are diverted
        # to dedicated threads at dispatch so they never pin worker
        # slots (a /cluster/watch stream lives for the peer's lifetime).
        self.stream_paths = {"/cluster/watch", "/.meta/subscribe"}
        # Live-connection registry, shared by both transports: feeds
        # GET /debug/conns and SeaweedFS_open_connections{role,state}.
        self.conns = ConnRegistry()
        self._aio = None  # netcore.loop.EventLoopTransport when aio
        # Overload protection (AdmissionControl).  Always present so
        # in-flight accounting works even with no concurrency cap —
        # graceful drain waits on it.
        self.admission = admission or AdmissionControl(0)
        self.routes: dict[tuple[str, str], Callable] = {}
        self.prefix_routes: list[tuple[str, str, Callable]] = []
        self.metrics = None  # (Registry, Counter, Histogram) when on
        self.slo = None      # stats.slo.SloTracker once metrics are on
        # Wire-flow attribution (stats/flows.py): the role this server
        # answers X-Weed-Role with ("master"/"volume"/"filer"/...),
        # set by enable_metrics from its subsystem name.
        self.flow_role = ""
        # Service name for the tracing middleware; set by
        # trace.setup_server_tracing — None means no server spans.
        self.trace_service: str | None = None
        self._metrics_route = False
        self._sock: socket.socket | None = None
        self._running = False
        # Live accepted connections, severed on stop(): closing only
        # the listener leaves idle keep-alive threads free to serve
        # one more request each, and a thread blocked in accept()
        # keeps the kernel listener itself alive past close().
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        # C10k observability on every role (literal routes win over a
        # filer's "/" prefix route, same precedence as /metrics).
        self.route("GET", "/debug/conns", self._debug_conns)
        # Wire-flow attribution: this process's per-purpose byte
        # ledger + budget verdicts (admission-exempt via /debug/).
        self.route("GET", "/debug/flows", lambda q, b: _flows.debug_doc(
            f"{self.host}:{self.port}", self.flow_role))
        # Device roofline (stats/roofline.py): per-kernel achieved
        # fractions, pipeline occupancy, probed peaks — on every role
        # (any process can run EC kernels in-process).
        self.route("GET", "/debug/device", self._debug_device)

    def _debug_device(self, query: dict, body) -> dict:
        from ..stats import roofline as _roofline
        return _roofline.debug_doc(f"{self.host}:{self.port}",
                                   self.flow_role)

    def _debug_conns(self, query: dict, body) -> dict:
        """Per-connection state from the live registry: age, lane,
        lifecycle state, request count, bytes — the event loop reports
        precise idle/reading/handling, threaded conns report "open"."""
        try:
            limit = int(query.get("limit", 256))
        except ValueError:
            limit = 256
        return {
            "transport": self.transport,
            "open": len(self.conns),
            "states": self.conns.state_counts(),
            "idle_timeout": self.idle_timeout,
            "stall_timeout": self.stall_timeout,
            "conns": self.conns.snapshot(limit),
        }

    def serve_metrics_route(self, registry) -> None:
        """Route GET /metrics -> the registry's text exposition."""
        self._metrics_route = True
        self.route("GET", "/metrics", lambda q, b: (
            200, registry.expose().encode(),
            {"Content-Type": "text/plain; version=0.0.4"}))

    def enable_metrics(self, subsystem: str, registry=None,
                       serve_route: bool = True):
        """Record per-request count + latency (stats/metrics.go request
        vectors) and, unless serve_route=False (gateways whose URL
        namespace is user-controlled serve /metrics on a separate
        port, like the reference's metricsHttpPort), expose /metrics.
        Returns the Registry for the caller to add its own gauges.

        Idempotent: a second call returns the existing registry instead
        of stacking a second counter/histogram family (a duplicate
        exposition block fails the promtool validator — the
        rolling-restart / re-init regression in tests/test_slo.py)."""
        from ..stats import slo as _slo
        from ..stats.metrics import Registry
        if self.metrics is not None:
            return self.metrics[0]
        reg = registry or Registry()
        counter = reg.counter(
            f"SeaweedFS_{subsystem}_request_total",
            f"{subsystem} request count", ("type",))
        # The latency histogram separates error tails from success
        # tails: status-class (2xx/4xx/5xx) and a bounded
        # endpoint-family label (endpoint_family) beside the method.
        hist = reg.histogram(
            f"SeaweedFS_{subsystem}_request_seconds",
            f"{subsystem} request latency",
            ("type", "family", "status"))
        self.metrics = (reg, counter, hist)
        # SLO plane (stats/slo.py): live windowed quantiles + exemplars
        # for every role, burn rates once objectives are declared
        # (set_objectives).  The gauges are PER-TRACKER, registered
        # into this (fresh) registry — process-global singletons below
        # use register_once so re-registration can never duplicate an
        # exposition family.
        self.slo = _slo.SloTracker(subsystem,
                                   node=f"{self.host}:{self.port}")
        reg.gauge("SeaweedFS_request_quantile_seconds",
                  "live request-latency quantiles over the sliding "
                  "window (sketch relative error documented in "
                  "stats/sketch.py)",
                  ("role", "family", "status", "q"),
                  callback=self.slo.quantile_gauge_values)
        reg.gauge("SeaweedFS_slo_burn_rate",
                  "error-budget burn rate per declared SLO and window "
                  "(fast burn >= 14.4 degrades /cluster/healthz)",
                  ("role", "slo", "window"),
                  callback=self.slo.burn_gauge_values)
        # Time-attribution plane (stats/phases.py): live windowed
        # quantiles of each request phase — where the wall time of
        # this role's requests actually goes, per endpoint family.
        reg.gauge("SeaweedFS_request_phase_seconds",
                  "live request phase-time quantiles over the sliding "
                  "window (queue/lock/handler/disk/device/"
                  "rpc_downstream; same sketch bounds as the request "
                  "quantiles)",
                  ("role", "family", "phase", "q"),
                  callback=self.slo.phase_gauge_values)
        # RPC-plane resilience instruments are process-global singletons
        # (every role's outbound client shares the pool + breakers);
        # registering them here puts retry counts, breaker states, and
        # injected-fault counts on every role's /metrics scrape.
        reg.register_once(_res.rpc_retries_total)
        reg.register_once(_res.breaker_state_gauge)
        reg.register_once(_fault.faults_injected_total)
        reg.register_once(_events.events_total)
        # Overload-protection instruments (admission control): shed
        # counts by lane and the live in-flight gauge.
        reg.register_once(requests_shed_total)
        reg.register_once(inflight_requests)
        # Tenancy & QoS instruments: live per-lane queue depth, time
        # spent waiting for admission, and per-tenant throttle counts.
        reg.register_once(admission_queue_depth)
        reg.register_once(admission_wait_seconds)
        reg.register_once(tenant_throttled_total)
        # Front-door instruments: live connections by lifecycle state
        # (per-server registry, sampled at scrape) and event-loop reap
        # counts (process-global — kinds in netcore/registry.py).
        reg.gauge("SeaweedFS_open_connections",
                  "live server connections by transport lifecycle "
                  "state (aio: idle/reading/handling; threads: open)",
                  ("role", "state"),
                  callback=lambda: self.conns.gauge_values(subsystem))
        reg.register_once(conns_reaped_total)
        # Wire-flow attribution: every role exposes the per-purpose
        # wire-byte counter (process-global singleton — both the
        # client and server choke points observe into it) and
        # self-identifies on request/response headers so peers'
        # ledgers attribute links by node, not bare IP.
        self.flow_role = _flows.role_of(subsystem)
        _flows.set_process_identity(f"{self.host}:{self.port}",
                                    self.flow_role)
        reg.register_once(_flows.wire_bytes_total)
        # Lock-contention metering (stats/contention.py) and the
        # continuous profiler's runnable-threads gauge — process-global
        # singletons like the breaker/fault instruments above.
        reg.register_once(_contention.lock_wait_seconds)
        reg.register_once(_contention.lock_hold_seconds)
        from ..utils.pprof import runnable_threads as _runnable
        reg.register_once(_runnable)
        if serve_route:
            self.serve_metrics_route(reg)
        return reg

    def route(self, method: str, path: str, fn: Callable,
              stream_body: bool = False) -> None:
        self.routes[(method, path)] = (fn, stream_body)

    def prefix_route(self, method: str, prefix: str, fn: Callable,
                     stream_body: bool = False) -> None:
        """fn(path, query, body) for paths starting with prefix.  With
        stream_body=True the handler receives a BodyReader instead of
        bytes — a multi-GB PUT is consumed incrementally instead of
        ballooning RSS (the reference streams uploads,
        filer_server_handlers_write_autochunk.go:188)."""
        self.prefix_routes.append((method, prefix, fn, stream_body))

    def url(self) -> str:
        scheme = "https" if self.ssl_context else "http"
        return f"{scheme}://{self.host}:{self.port}"

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        import sys as _sys
        if _sys.getswitchinterval() > 0.001:
            # Thread-per-connection + the default 5ms GIL switch
            # interval convoys request latency to ~5ms p50 under
            # concurrent load; 1ms keeps handler threads responsive.
            _sys.setswitchinterval(0.001)
        self._sock = socket.create_server((self.host, self.port),
                                          backlog=512)
        self._running = True
        if self.transport == "aio":
            from ..netcore.loop import EventLoopTransport
            self._aio = EventLoopTransport(self)
            self._aio.start()
            return
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"http:{self.port}").start()

    def stop(self) -> None:
        self._running = False
        if self._aio is not None:
            self._aio.stop()
        sock, self._sock = self._sock, None
        if sock is not None:
            # shutdown() wakes a thread blocked in accept(); a bare
            # close() does not, and the in-progress syscall then pins
            # the kernel listener open — the "stopped" server keeps
            # accepting, and a pinned-port restart gets EADDRINUSE.
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        # Sever live keep-alive connections too: their threads sit in
        # readline() and would otherwise serve one more request each
        # after "stop" (standby-death chaos relies on stop = stopped).
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn,
                             args=(conn, addr[0] if addr else ""),
                             daemon=True).start()

    # -- connection loop -----------------------------------------------------

    def _serve_conn(self, conn: socket.socket, peer_ip: str = "") -> None:
        raw = conn  # pre-TLS socket: shutdown() severs either way
        with self._conns_lock:
            self._conns.add(raw)
        info = self.conns.add(peer_ip, "threads"
                              if self.transport == "threads" else "tls")
        info.state = "open"  # thread blocks in readline: idle-vs-
        #                      handling is invisible without per-read
        #                      bookkeeping the hot path shouldn't pay
        try:
            if self.ssl_context is not None:
                # Handshake in the connection thread so a slow/bogus
                # client can't stall the accept loop.
                conn = self.ssl_context.wrap_socket(conn, server_side=True)
                conn.settimeout(self.idle_timeout)
            else:
                # Kernel-enforced timeouts keep the socket in blocking
                # mode: Python's settimeout() makes every read a
                # poll+recv syscall pair; SO_RCVTIMEO keeps it one
                # recv.  A timed-out recv surfaces as EAGAIN, which
                # BufferedReader maps to b"" — _serve_one treats that
                # as peer-gone and closes the connection, the right
                # outcome for a 120s-idle conn.  (The CLIENT pool must
                # NOT use this trick: there b"" would trigger the
                # stale-keep-alive retry and re-send a non-idempotent
                # RPC on a mere timeout.)
                tv = struct.pack("ll", int(self.idle_timeout),
                                 int(self.idle_timeout % 1 * 1e6))
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
            rf = conn.makefile("rb", buffering=1 << 16)
            conn = CountedConn(conn, info)
            while self._running:
                if not self._serve_one(conn, rf, peer_ip, info):
                    return
                info.requests += 1
                info.touch()
        except Exception:  # noqa: BLE001 — peer reset / TLS failure / ...
            pass
        finally:
            self.conns.remove(info)
            with self._conns_lock:
                self._conns.discard(raw)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_conn_buffered(self, conn: socket.socket, peer_ip: str,
                             prefix: bytes, info) -> None:
        """Dedicated-thread serve for a connection the aio loop already
        read `prefix` bytes from — long-lived push streams
        (stream_paths) whose handlers block for the peer's lifetime
        and must not pin event-loop worker slots."""
        try:
            tv = struct.pack("ll", int(self.idle_timeout),
                             int(self.idle_timeout % 1 * 1e6))
            conn.setblocking(True)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
            rf = SockReader(prefix, conn, info)
            cc = CountedConn(conn, info)
            info.state = "handling"
            while self._running:
                if not self._serve_one(cc, rf, peer_ip, info):
                    return
                info.requests += 1
                info.touch()
        except Exception:  # noqa: BLE001 — peer reset mid-stream
            pass
        finally:
            self.conns.remove(info)
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_one(self, conn, rf, peer_ip: str = "", info=None) -> bool:
        """Handle one request; returns False when the connection is done."""
        line = rf.readline(65537)
        if not line:
            return False
        if not line.endswith(b"\n"):
            if len(line) < 65537:
                return False  # EOF mid-request-line: peer died
            self._respond(conn, "GET", 414, {"error": "URI too long"},
                          None, close=True)
            _drain_then_fin(conn, rf)
            return False
        try:
            method, target, version = \
                line.decode("latin-1").rstrip("\r\n").split(" ", 2)
        except ValueError:
            self._respond(conn, "GET", 400, {"error": "bad request line"},
                          None, close=True)
            return False
        try:
            headers = _read_headers(rf)
        except _LineTooLong:
            self._respond(conn, method, 431,
                          {"error": "header line too long"}, None,
                          close=True)
            _drain_then_fin(conn, rf)
            return False
        except ConnectionError:
            return False  # truncated request: never route it
        if headers.get("expect", "").lower() == "100-continue":
            conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
        chunked = headers.get("transfer-encoding", "").lower() == "chunked"
        keep = (version == "HTTP/1.1"
                and headers.get("connection", "").lower() != "close")

        # Fast path for the common hot-path target shape (`/vid,fid` —
        # no query string): skip urlparse + parse_qs entirely; they
        # cost ~15µs/request, which is real money at 10k req/core-sec.
        # Absolute-form targets (RFC 7230 §5.3.2 `GET http://h/p`) and
        # anything else not starting with "/" take the urlparse path.
        if "?" in target or not target.startswith("/"):
            parsed = urllib.parse.urlparse(target)
            raw_query = parsed.query
            req_path = parsed.path
            # keep_blank_values: S3-style flag params (?uploads,
            # ?tagging, ?delete) have no '=value'.  Underscore-prefixed
            # keys are RESERVED for header-derived values below — a
            # client must not be able to forge e.g.
            # ?_content_encoding=gzip and get a plaintext needle stored
            # with the compressed flag.
            query = {k: v[0] for k, v in urllib.parse.parse_qs(
                raw_query, keep_blank_values=True).items()
                if not k.startswith("_")}
        else:
            req_path = target
            raw_query = ""
            query = {}
        # Select request headers handlers care about (Range for partial
        # reads, Content-Type for upload mime) ride along in the query
        # dict under reserved keys.
        if peer_ip:
            # Peer address for the heavy-hitter tracker (hot client
            # IPs, stats/hotkeys.py) — reserved key, unforgeable like
            # the header-derived ones.
            query["_remote_addr"] = peer_ip
        if "range" in headers:
            query["_range_header"] = headers["range"]
        if "if-none-match" in headers:
            query["_if_none_match"] = headers["if-none-match"]
        if "if-modified-since" in headers:
            query["_if_modified_since"] = headers["if-modified-since"]
        if "content-type" in headers:
            query["_content_type"] = headers["content-type"]
        # Compression negotiation (volume server gzip path): the upload
        # side declares pre-compressed bodies, the read side declares
        # whether it can take gzip back.
        if "content-encoding" in headers:
            query["_content_encoding"] = headers["content-encoding"]
        if "accept-encoding" in headers:
            query["_accept_encoding"] = headers["accept-encoding"]
        if self.pass_headers:
            # Full header dict + raw query string for handlers that
            # authenticate requests (S3 sig v4 needs the exact header
            # set and query encoding).
            query["_headers"] = headers
            query["_raw_query"] = raw_query
            query["_method"] = method

        hit = self.routes.get((method, req_path))
        fn, stream = hit if hit else (None, False)
        prefix_args = None
        if fn is None:
            for m, prefix, pfn, pstream in self.prefix_routes:
                if m == method and req_path.startswith(prefix):
                    fn, stream = pfn, pstream
                    prefix_args = req_path
                    break
        # Wire-flow attribution (stats/flows.py): resolve the peer's
        # identity (self-declared node/role headers, else bare IP +
        # "client") and the transfer purpose (explicit header from our
        # own client > ?type=replicate > path heuristic) ONCE, bind
        # this thread's local identity so outbound hops made while
        # handling attribute to this server, and park the per-request
        # context for _respond's response-leg note.
        flow_peer = headers.get("x-weed-node", "") or peer_ip or "?"
        flow_peer_role = headers.get("x-weed-role", "") or "client"
        flow_purpose = _flows.resolve(
            method, req_path, headers.get("x-weed-purpose", ""),
            query.get("type", ""),
            headers.get("x-weed-priority", "") == "low")
        _flows.bind_thread(f"{self.host}:{self.port}",
                           self.flow_role or "server")
        _flows.begin_request(flow_peer, flow_peer_role, flow_purpose)
        # Read (or wrap) the body only after routing so a streaming
        # route never sees it buffered.
        if stream:
            body = BodyReader(rf,
                              None if chunked
                              else int(headers.get("content-length") or 0),
                              chunked)
            # Streamed request bodies count as the handler (and the
            # post-dispatch drain) consumes them; the op lands now.
            body.flow_note = \
                lambda n: _flows.LEDGER.note(
                    flow_purpose, "in", n, peer=flow_peer,
                    peer_role=flow_peer_role, ops=0)
            _flows.LEDGER.note(flow_purpose, "in", 0, peer=flow_peer,
                               peer_role=flow_peer_role)
        elif chunked:
            body = _read_chunked(rf)
        else:
            clen = int(headers.get("content-length") or 0)
            body = rf.read(clen) if clen else b""
            if clen and len(body) < clen:
                return False  # truncated request
        if not stream:
            _flows.LEDGER.note(flow_purpose, "in", len(body),
                               peer=flow_peer,
                               peer_role=flow_peer_role)
        args = (prefix_args, query, body) if prefix_args is not None \
            else (query, body)
        if fn is None:
            self._respond(conn, method, 404,
                          {"error": f"no route {method} {req_path}"},
                          None, close=not keep)
            return keep

        # Principal resolution (tenancy/): the tenant is the
        # X-Weed-Tenant header (stamped by the S3 gateway from the
        # authenticated identity, or set explicitly by a client), else
        # the collection as fallback; the originating client rides
        # X-Weed-Client on proxy legs (filer→volume) so hot-key
        # attribution names the real caller, not the proxy's IP.
        # Resolved ONCE here, parked in reserved query keys for the
        # handlers and in the thread-local principal context so every
        # outbound hop this thread makes auto-forwards it (same model
        # as the traceparent).
        tenant = headers.get("x-weed-tenant", "") \
            or query.get("collection", "")
        client = headers.get("x-weed-client", "") \
            or query.get("_remote_addr", "")
        query["_tenant"] = tenant
        if client:
            query["_client"] = client
        _tenant_ctx.set_principal(tenant, client)

        # Admission gate: classify into a lane (read / write /
        # internal) and acquire a slot — or shed with 429 +
        # Retry-After when the lane AND its bounded wait queue are
        # full.  The body was already read (or is drained below), so
        # keep-alive framing survives a shed.  Exempt paths
        # (introspection, heartbeats, push streams) skip the gate.
        lane = None
        queue_wait = 0.0
        if not _admission_exempt(req_path):
            lane = self.admission.lane_for(method, headers, query)
            if info is not None:
                info.lane = lane.name
            # Per-tenant QoS at the gate (token buckets): over-rate
            # tenants are refused BEFORE touching the lane, so their
            # excess never competes for queue slots.  Internal cluster
            # traffic is tenant-exempt, like the low-priority lane.
            if tenant and lane.name != "internal":
                wbytes = len(body) if isinstance(
                    body, (bytes, bytearray)) and \
                    method not in ("GET", "HEAD") else 0
                retry = self.admission.throttle(tenant, wbytes)
                if retry > 0.0:
                    if not self._finish_stream_body(body):
                        keep = False
                    self._observe_request(method, req_path, 429, 0.0)
                    self._respond(
                        conn, method, 429,
                        {"error": f"tenant {tenant!r} over rate "
                                  f"quota; retry"},
                        {"Retry-After": f"{retry:.3g}"},
                        close=not keep)
                    return keep
            t_gate = time.perf_counter()
            if not lane.enter("" if lane.name == "internal"
                              else tenant):
                if not self._finish_stream_body(body):
                    keep = False
                # Sheds are part of the error tail: count them in the
                # request histogram (status-class 4xx, with the REAL
                # time spent waiting in the bounded queue) and the SLO
                # burn windows' dedicated `shed` column — the tracker
                # keeps them out of the latency sketches, where a
                # refused request would fake a fast one.
                self._observe_request(method, req_path, 429,
                                      time.perf_counter() - t_gate)
                self._respond(
                    conn, method, 429,
                    {"error": f"overloaded: {lane.name} lane and its "
                              f"wait queue are full; retry"},
                    {"Retry-After":
                     f"{self.admission.retry_after:g}"},
                    close=not keep)
                return keep
            # Admitted (possibly after a bounded wait): the wait is
            # the request's `queue` phase — seeded into the ledger so
            # slow exemplars show admission pressure, not mystery wall.
            queue_wait = time.perf_counter() - t_gate
        try:
            return self._dispatch(conn, method, req_path, headers,
                                  query, body, fn, args, keep,
                                  queue_wait)
        finally:
            if lane is not None:
                lane.exit()
            # Keep-alive threads serve many requests: a stale
            # principal must not leak into the next one.
            _tenant_ctx.clear_principal()
            _flows.end_request()

    def _observe_request(self, method: str, req_path: str, status: int,
                         seconds: float, trace_id: str = "",
                         phases: dict | None = None) -> None:
        """One request observed: request counter + the labeled latency
        histogram (method / endpoint-family / status-class) + the SLO
        plane (windowed quantiles, burn windows, slow exemplars, the
        per-phase time budget).  Excludes the scrape endpoint where
        /metrics IS the scrape."""
        if self._metrics_route and req_path == "/metrics":
            return
        metrics = self.metrics
        if metrics is None:
            return
        family = endpoint_family(req_path,
                                 (method, req_path) in self.routes)
        _reg, counter, hist = metrics
        counter.inc(type=method)
        hist.observe(seconds, type=method, family=family,
                     status=f"{status // 100}xx")
        if self.slo is not None:
            self.slo.observe(family, method, status, seconds, trace_id,
                             phases)

    def _dispatch(self, conn, method: str, req_path: str,
                  headers: dict, query: dict, body, fn, args,
                  keep: bool, queue_wait: float = 0.0) -> bool:
        """Run the routed handler and write its response — the back
        half of _serve_one, split out so the admission gate can wrap
        it in one try/finally slot release."""
        t0 = time.perf_counter()
        # Tracing middleware: one server span per routed request,
        # continuing the caller's traceparent context (or head-sampling
        # a fresh root).  Scrape/debug endpoints are not traced — a
        # trace of the trace endpoint is pure noise — but only when the
        # path actually IS such a mounted route: on the filer, paths
        # like /metrics or /debug/build.log are user files (served by
        # prefix routes) and must trace like any other request (same
        # route-aware stance as the metrics exclusion below).  Every
        # exit path below MUST end the span: handler threads serve many
        # keep-alive requests, and a leaked thread-local span would
        # mis-parent every later request on the connection.
        tspan = None
        skip_trace = (self._metrics_route and req_path == "/metrics") \
            or (req_path.startswith("/debug/")
                and (method, req_path) in self.routes)
        if self.trace_service is not None and not skip_trace:
            tspan = _tracer.begin_server_span(
                self.trace_service, method, req_path,
                headers.get("traceparent", ""))
            if tspan is not None and query.get("_tenant"):
                tspan.attrs["tenant"] = query["_tenant"]
        # Phase ledger (stats/phases.py): opened on this thread for
        # the handler's lifetime; instrumentation anywhere below
        # (metered locks, disk wrappers, EC device timers, outbound
        # rpc) accumulates into it.  Seeded with the admission wait.
        ledger = _phases.start(queue_wait)

        def _observe(status: int) -> None:
            # Status is known at every exit (unlike the pre-SLO finally
            # block, which observed before the handler's tuple was
            # parsed) — that is what makes the status-class label and
            # the exemplar's trace id possible.  The ledger closes
            # FIRST (computing the `handler` residual) and rides the
            # span — phases must land before end_server_span snapshots
            # the span into the trace ring — then the SLO observation.
            # Materialization is LAZY: the budget dict is built only
            # for spans that will actually be recorded (sampled, or
            # slow enough for the always-sample trigger); fast
            # unsampled requests never pay it here, and the SLO layer
            # materializes on its own only for exemplars/sketch
            # samples.
            seconds = time.perf_counter() - t0
            ph = _phases.finish(ledger) if ledger is not None else None
            if tspan is not None and ph is not None and (
                    tspan.sampled
                    or seconds >= _tracer.slow_threshold_seconds()):
                tspan.attrs["phases"] = ph.to_dict()
            _tracer.end_server_span(tspan, status)
            self._observe_request(
                method, req_path, status, seconds,
                tspan.trace_id if tspan is not None else "", ph)

        try:
            result = fn(*args)
        except _fault.DropConnection:
            # Injected mid-exchange disconnect (fault `drop` kind): no
            # response bytes, just a dead connection — the client sees
            # EOF exactly as if the process was killed.
            _observe(500)
            return False
        except RpcError as e:
            _observe(e.status)
            if not self._finish_stream_body(body):
                keep = False
            self._respond(conn, method, e.status, {"error": e.message},
                          e.headers or None, close=not keep)
            return keep
        except ConnectionError as e:
            _observe(500)
            if isinstance(body, BodyReader) and body.truncated:
                # Truncated streaming body: the wire framing is gone,
                # no reliable response is possible.
                return False
            # Otherwise this is an UPSTREAM peer failure (a dead
            # master/volume behind rpc.call) — the client deserves a
            # 500, exactly as before streaming existed.
            if not self._finish_stream_body(body):
                keep = False
            self._respond(conn, method, 500,
                          {"error": f"{type(e).__name__}: {e}"},
                          None, close=not keep)
            return keep
        except Exception as e:  # noqa: BLE001
            _observe(500)
            if not self._finish_stream_body(body):
                keep = False
            self._respond(conn, method, 500,
                          {"error": f"{type(e).__name__}: {e}"},
                          None, close=not keep)
            return keep

        if not self._finish_stream_body(body):
            keep = False
        extra = None
        if isinstance(result, tuple):
            if len(result) == 3:
                status, payload, extra = result
            else:
                status, payload = result
        else:
            status, payload = 200, result
        # Span end covers handler execution, not the response write (a
        # slow reader streaming a 30GB body is not server time) — and
        # the histogram/SLO observation matches that boundary.
        _observe(status)
        self._respond(conn, method, status, payload, extra,
                      close=not keep)
        return keep

    @staticmethod
    def _finish_stream_body(body) -> bool:
        """Drain whatever a streaming handler left unread so the next
        keep-alive request parses; False = connection unusable."""
        if not isinstance(body, BodyReader):
            return True
        try:
            body.drain()
            return not body.truncated
        except ConnectionError:
            return False

    def _respond(self, conn, method: str, status: int, payload,
                 extra=None, close: bool = False) -> None:
        extra = dict(extra or {})
        reason = _REASONS.get(status, "Unknown")
        head = [f"HTTP/1.1 {status} {reason}"]
        if self.flow_role:
            # Self-identify so the client's flow ledger labels this
            # link's peer_role — paired with X-Weed-Node on requests.
            head.append(f"{_flows.ROLE_HEADER}: {self.flow_role}")

        # Response leg of the flow ledger: body/payload bytes only
        # (headers + chunked framing excluded on BOTH sides, so A->B
        # sent matches B<-A received).  Early error responses that
        # predate purpose resolution (bad request line, 414) have no
        # request context and are skipped.
        _req_flow = _flows.current_request()

        def _note_out(n: int, ops: int = 0,
                      _rq=_req_flow) -> None:
            if _rq is not None:
                _flows.LEDGER.note(_rq[2], "out", n, peer=_rq[0],
                                   peer_role=_rq[1], ops=ops)

        if hasattr(payload, "read"):
            # Stream any file-like payload (open file, upstream HTTP
            # response, or an unbounded push channel) without buffering
            # it: O(1MB) memory per in-flight large read.  Payloads
            # with a known size go out under Content-Length; sizeless
            # ones (no fileno — e.g. a live event stream) use chunked
            # transfer-encoding and end when read() returns b"".
            ctype = extra.pop("Content-Type", "application/octet-stream")
            size = extra.pop("Content-Length", None)
            if size is None and hasattr(payload, "fileno"):
                size = str(os.fstat(payload.fileno()).st_size)
            head.append(f"Content-Type: {ctype}")
            chunked = size is None
            if chunked:
                head.append("Transfer-Encoding: chunked")
            else:
                head.append(f"Content-Length: {size}")
            for k, v in extra.items():
                head.append(f"{k}: {v}")
            if close:
                head.append("Connection: close")
            # Header send happens INSIDE the payload's context: a peer
            # that RSTs before/during the head must still run
            # payload.close() (a NeedleSlice owns an fd).
            with payload:
                conn.sendall(("\r\n".join(head) + "\r\n\r\n")
                             .encode("latin-1"))
                _note_out(0, ops=1)
                if method != "HEAD":
                    sf = getattr(payload, "sendfile_to", None)
                    if sf is not None and not chunked \
                            and self.ssl_context is None:
                        # Zero-copy: the payload (a NeedleSlice or a
                        # spliced proxy body) moves its bytes
                        # kernel-side with os.sendfile/os.splice; TLS
                        # and chunked responses take the read loop.
                        # The flow note rides INTO the syscall loop —
                        # these bytes never transit userspace, so the
                        # ledger counts the syscall-returned totals.
                        sf(conn, note=_note_out)
                        nt = getattr(conn, "note_tx", None)
                        if nt is not None:
                            nt(int(size))
                    else:
                        # A sized payload sends exactly the bytes it
                        # announced, even from a file that grows while
                        # it streams: more would desync the peer's
                        # next keep-alive response.
                        left = None if chunked else int(size)
                        while left is None or left > 0:
                            chunk = payload.read(
                                1 << 20 if left is None
                                else min(1 << 20, left))
                            if not chunk:
                                break
                            if left is not None:
                                left -= len(chunk)
                            _note_out(len(chunk))
                            if chunked:
                                conn.sendall(b"%x\r\n" % len(chunk)
                                             + chunk + b"\r\n")
                            else:
                                conn.sendall(chunk)
                if chunked:
                    conn.sendall(b"0\r\n\r\n")
            return

        if isinstance(payload, (bytes, bytearray)):
            data = bytes(payload)
            ctype = extra.pop("Content-Type", "application/octet-stream")
        else:
            data = json.dumps(payload or {}).encode()
            ctype = extra.pop("Content-Type", "application/json")
        head.append(f"Content-Type: {ctype}")
        # HEAD handlers advertise the real body size without
        # materializing it.
        head.append(f"Content-Length: {extra.pop('Content-Length', None) or len(data)}")
        for k, v in extra.items():
            head.append(f"{k}: {v}")
        if close:
            head.append("Connection: close")
        buf = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
        if method != "HEAD":
            buf += data
        _note_out(len(data) if method != "HEAD" else 0, ops=1)
        conn.sendall(buf)


# -- pooled HTTP client ------------------------------------------------------
# The reference's hot path assumes connection reuse (its Go http.Client
# pools transport connections; operation/upload_content.go:67).  A fresh
# TCP handshake per RPC capped the write path at ~360 req/s in bench_e2e,
# and http.client's email.parser header handling costs another
# ~0.25ms/request; this is a raw-socket keep-alive pool.

_client_ssl_context = None
_force_https = False


def set_client_ssl_context(ctx, force_https: bool = False) -> None:
    """Install the ssl.SSLContext used for https:// RPCs (security.toml
    TLS plane — see utils/security).  With force_https=True every
    outgoing http:// URL is dialed over TLS instead: cluster code builds
    addresses as `http://host:port`, and like the reference's gRPC dial
    options (security/tls.go LoadClientTLS) the transport — not each
    call site — decides whether the wire is encrypted.  Pass ctx=None to
    reset (plaintext)."""
    global _client_ssl_context, _force_https
    # Connections negotiated under the previous plane must not outlive
    # it: close everything idle AND bump the pool generation so
    # in-flight connections are dropped (not re-pooled) when released.
    # Context swap and generation bump happen under the pool lock so
    # acquire() can snapshot (ctx, gen) atomically — a dial racing the
    # rotation can't get the old identity stamped with the new gen.
    with _pool._lock:
        _client_ssl_context = ctx
        _force_https = bool(ctx) and force_https
        _pool.gen += 1
        for conns in _pool._idle.values():
            for conn in conns:
                conn.close()
        _pool._idle.clear()


class _Conn:
    """One pooled keep-alive connection."""

    __slots__ = ("sock", "rf", "key", "gen", "timeout")

    def __init__(self, sock: socket.socket, key: tuple, gen: int = 0,
                 timeout: float | None = None):
        self.sock = sock
        self.rf = sock.makefile("rb", buffering=1 << 16)
        self.key = key
        self.gen = gen
        self.timeout = timeout  # last settimeout applied (skip repeats)

    def close(self) -> None:
        # Shut the socket down FIRST: a reader blocked in recv() on
        # another thread holds the buffered-reader lock, and rf.close()
        # would wait for it (tens of seconds on an idle push stream);
        # shutdown() forces that recv to return immediately.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.rf.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _Resp:
    """Response with lazily-read body (callers stream or read())."""

    __slots__ = ("status", "reason", "headers", "_rf", "_remaining",
                 "_chunks", "_chunk_iter", "_chunk_buf", "will_close",
                 "_done", "flow_note")

    def __init__(self, status, reason, headers, rf):
        self.status = status
        self.reason = reason
        self.headers = headers
        self._rf = rf
        # Wire-flow attribution: set by _request so body bytes count
        # as the call's "in" leg as the caller consumes them (the
        # spliced proxy path feeds the same note with its syscall
        # totals — see client.ProxiedBody._splice_to).
        self.flow_note = None
        self.will_close = headers.get("connection", "").lower() == "close"
        self._chunks = headers.get("transfer-encoding",
                                   "").lower() == "chunked"
        self._chunk_iter = None
        self._chunk_buf = b""
        if self._chunks:
            self._remaining = -1
        else:
            clen = headers.get("content-length")
            if clen is None:
                self.will_close = True  # read-until-close body
                self._remaining = -1
            else:
                self._remaining = int(clen)
        self._done = False

    def getheader(self, name: str, default=None):
        return self.headers.get(name.lower(), default)

    def read(self, n: int = -1) -> bytes:
        if self._done:
            return b""
        if self._chunks:
            data = self._read_chunked_n(n)
            if data and self.flow_note is not None:
                self.flow_note(len(data))
            return data
        if self._remaining < 0:  # until close
            data = self._rf.read() if n < 0 else self._rf.read(n)
            if not data or n < 0:
                self._done = True
            if data and self.flow_note is not None:
                self.flow_note(len(data))
            return data
        want = self._remaining if n < 0 else min(n, self._remaining)
        data = self._rf.read(want) if want else b""
        self._remaining -= len(data)
        if data and self.flow_note is not None:
            self.flow_note(len(data))
        if self._remaining == 0:
            self._done = True
        elif len(data) < want:
            # Early peer close with Content-Length unsatisfied is a
            # failed transfer, never a short success (http.client raised
            # IncompleteRead here; so do we).
            raise ConnectionError(
                f"incomplete read: peer closed with {self._remaining} "
                f"of {self.headers.get('content-length')} bytes unread")
        return data

    def read_any(self) -> bytes:
        """Next available piece — for live push streams, where read(n)
        would block accumulating n bytes that may never come.  Returns
        one chunked frame (or buffered leftover), b"" at end."""
        if self._done:
            return b""
        if self._chunks:
            if self._chunk_iter is None:
                self._chunk_iter = _iter_chunks(self._rf)
            if self._chunk_buf:
                out, self._chunk_buf = self._chunk_buf, b""
            else:
                try:
                    out = next(self._chunk_iter)
                except StopIteration:
                    self._done = True
                    return b""
            if out and self.flow_note is not None:
                self.flow_note(len(out))
            return out
        return self.read(65536)

    def _read_chunked_n(self, n: int) -> bytes:
        """Incremental chunked-body reader honoring the requested size
        (so call_to_file keeps its 1MB streaming for chunked upstreams),
        driven by the shared _chunk_pump state machine."""
        if self._chunk_iter is None:
            self._chunk_iter = _iter_chunks(self._rf)
        data, self._chunk_buf, exhausted = _chunk_pump(
            self._chunk_iter, self._chunk_buf, n)
        if exhausted:
            self._done = True
        return data


class _ConnPool:
    def __init__(self, max_idle_per_host: int = 32):
        self.max_idle = max_idle_per_host
        self._idle: dict[tuple, list[_Conn]] = {}
        # Metered (stats/contention.py): every outbound RPC takes this
        # lock at least once; a convoy here serializes the whole
        # client plane, so it must show up in the wait histogram.
        # Holds are dict pushes/pops — histogram only the pathological.
        self._lock = _contention.MeteredLock("rpc.pool",
                                             hold_observe_min=1e-3)
        # Bumped on TLS-plane changes: connections from an older
        # generation are never re-pooled, so a rotated client identity
        # can't keep riding sessions negotiated under the old one.
        self.gen = 0

    def acquire(self, scheme: str, host: str, port: int,
                timeout: float, fresh: bool = False):
        """Returns (conn, was_reused).  `fresh` skips the idle pool and
        dials a new connection.

        An idle connection is handed out only while its server still
        holds it open: servers close idle keep-alive connections after
        one shared idle timeout (and all of them when they stop), so the
        pool's connections to a host tend to die together.  A socket
        that is readable while idle has the server's FIN (or stray
        bytes) waiting, and is closed instead; one zero-timeout poll per
        reuse, outside the pool lock.

        Client sockets keep Python-level settimeout (NOT the server's
        SO_RCVTIMEO trick): with a kernel timeout, a slow server is
        indistinguishable from a closed connection (readline returns
        b"" either way), and _request's stale-keep-alive retry would
        re-send non-idempotent RPCs on a mere timeout — exactly the
        case its comment forbids.  A Python timeout raises
        socket.timeout, which takes the no-retry path.  The timeout is
        only re-armed when it differs from the connection's last one
        (a setsockopt saved per pooled reuse).

        Per-host circuit breaker: an open breaker fails the acquire
        fast (BreakerOpen, before any socket work — even pooled reuse,
        whose idle conns likely predate the partition that opened it);
        connect failures feed it, and _request records the 5xx/success
        outcomes.  The rpc.connect fault point fires on every acquire —
        pooled or fresh — so an armed fault behaves like the host being
        unreachable, not like a pool-state lottery."""
        key = (scheme, host, port)
        hostport = f"{host}:{port}"
        breaker = _res.breaker_for(hostport)
        if not breaker.allow():
            raise _res.BreakerOpen(
                f"{hostport}: circuit breaker open")
        if _fault.ARMED:
            try:
                _fault.hit("rpc.connect", host=hostport)
            except Exception:
                breaker.record_failure()
                raise
        while True:
            with self._lock:
                pool = None if fresh else self._idle.get(key)
                if not pool:
                    # Snapshot the TLS plane atomically with its
                    # generation: if a rotation lands during our
                    # handshake below, this conn keeps the OLD gen and
                    # release() will drop it.
                    ctx, gen = _client_ssl_context, self.gen
                    break
                conn = pool.pop()
            if _peer_closed(conn):
                conn.close()
                continue
            if conn.timeout != timeout:
                conn.sock.settimeout(timeout)
                conn.timeout = timeout
            return conn, True
        try:
            sock = socket.create_connection((host, port),
                                            timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if scheme == "https":
                import ssl
                ctx = ctx or ssl.create_default_context()
                sock = ctx.wrap_socket(sock, server_hostname=host)
        except OSError as e:
            breaker.record_failure()
            # No request bytes hit the wire: mark the failure as
            # always-safe-to-retry for the RetryPolicy classifier.
            raise _res.ConnectError(f"{hostport}: {e}") from e
        return _Conn(sock, key, gen, timeout), False

    def release(self, conn: _Conn) -> None:
        with self._lock:
            if conn.gen == self.gen:
                pool = self._idle.setdefault(conn.key, [])
                if len(pool) < self.max_idle:
                    pool.append(conn)
                    return
        conn.close()


def _peer_closed(conn: _Conn) -> bool:
    """True when an idle connection has something to read: the server's
    FIN, a reset, or bytes no request asked for.  Either way it cannot
    carry the next request."""
    p = select.poll()
    p.register(conn.sock, select.POLLIN)
    return bool(p.poll(0))


_pool = _ConnPool()


def _request(url: str, method: str, body, timeout: float,
             max_redirects: int = 3, req_headers: dict | None = None):
    """One pooled request; returns (_Resp, _Conn) with the body NOT yet
    read (callers stream or read()).  Retries exactly once on a stale
    reused keep-alive connection (failure before any response bytes),
    on a new connection."""
    # Trace-context propagation: every outbound hop carries the active
    # span's traceparent so the downstream server span links to it.  An
    # explicit header wins — fan-out paths that run on worker threads
    # (replication, EC shard gather) pass their captured context in.
    tp = _tracer.current_traceparent()
    if tp and (req_headers is None or
               _tracer.TRACEPARENT_HEADER not in req_headers):
        req_headers = {**(req_headers or {}),
                       _tracer.TRACEPARENT_HEADER: tp}
    # Principal propagation rides the same way: the thread's resolved
    # tenant/client forward on every outbound hop so proxy legs
    # (filer→volume, volume→replica) keep the ORIGINAL attribution.
    _t = _tenant_ctx.current_tenant()
    if _t and (req_headers is None or
               "X-Weed-Tenant" not in req_headers):
        req_headers = {**(req_headers or {}), "X-Weed-Tenant": _t}
    _c = _tenant_ctx.current_client()
    if _c and (req_headers is None or
               "X-Weed-Client" not in req_headers):
        req_headers = {**(req_headers or {}), "X-Weed-Client": _c}
    # Manual split on the hot path: urlsplit costs ~7µs/request and
    # its internal cache misses on per-fid URLs.  Anything unusual
    # (IPv6 brackets, userinfo, missing scheme, query-with-no-path)
    # falls back to urlsplit.
    if url.startswith("http://"):
        scheme, rest = "http", url[7:]
    elif url.startswith("https://"):
        scheme, rest = "https", url[8:]
    else:
        scheme, rest = "", url
    slash = rest.find("/")
    netloc, path = (rest[:slash], rest[slash:]) if slash >= 0 \
        else (rest, "/")
    if not scheme or "@" in netloc or "[" in netloc or "?" in netloc:
        u = urllib.parse.urlsplit(url)
        scheme = u.scheme or "http"
        if scheme == "http" and _force_https:
            scheme = "https"  # before the port default: dial 443
        host = u.hostname or "127.0.0.1"
        port = u.port or (443 if scheme == "https" else 80)
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
    else:
        if scheme == "http" and _force_https:
            scheme = "https"
        host, _, port_s = netloc.rpartition(":")
        if host and port_s.isdigit():
            port = int(port_s)
        else:
            host = netloc or "127.0.0.1"
            port = 443 if scheme == "https" else 80
    # Wire-flow attribution: resolve this call's purpose — an explicit
    # call-site header wins (validated loudly: our own call sites must
    # not ship typos), else the thread's purpose context, else the
    # path heuristic — and ALWAYS stamp it, so the server attributes
    # the same purpose and conservation holds by construction.  The
    # local identity (this process's server, when it has one) rides
    # X-Weed-Node/X-Weed-Role so the master's matrix pairs the link.
    flow_purpose = (req_headers or {}).get(_flows.PURPOSE_HEADER)
    if flow_purpose is not None:
        _flows.validate(flow_purpose)
    else:
        flow_purpose = _flows.current_purpose()
    if flow_purpose is None:
        flow_purpose = _flows.resolve(
            method, path, "", "",
            (req_headers or {}).get(PRIORITY_HEADER) == "low")
    if req_headers is None or _flows.PURPOSE_HEADER not in req_headers:
        req_headers = {**(req_headers or {}),
                       _flows.PURPOSE_HEADER: flow_purpose}
    flow_local = _flows.local_identity()[0]
    if flow_local and _flows.NODE_HEADER not in req_headers:
        req_headers = {**req_headers,
                       _flows.NODE_HEADER: flow_local,
                       _flows.ROLE_HEADER: _flows.local_identity()[1]}
    extra = ""
    for k, v in (req_headers or {}).items():
        extra += f"{k}: {v}\r\n"
    req = (f"{method} {path} HTTP/1.1\r\n"
           f"Host: {host}:{port}\r\n"
           f"Content-Length: {len(body) if body else 0}\r\n"
           f"{extra}"
           "\r\n").encode("latin-1")
    if body:
        req += body
    for attempt in (0, 1):
        # The retry dials: any other idle connection to this host went
        # idle as long as the one that failed, and the server's idle
        # timeout closes them alike.
        conn, reused = _pool.acquire(scheme, host, port, timeout,
                                     fresh=attempt > 0)
        try:
            # Fault points fire INSIDE the retry loop's try: an armed
            # `fail` surfaces as a peer reset and takes the exact
            # stale-keep-alive path a real one would.
            if _fault.ARMED:
                _fault.hit("rpc.send", host=f"{host}:{port}", url=url)
            if _fault.ARMED and "net.slow_client" in _fault.ARMED:
                # Slow-loris injector: send half the request, fire the
                # fault (a `delay:S` spec stalls here mid-request), then
                # send the rest.  A server whose idle timeout is shorter
                # than the stall reaps the connection, and the second
                # sendall/read surfaces it as a peer reset.
                half = max(1, len(req) // 2)
                conn.sock.sendall(req[:half])
                _fault.hit("net.slow_client", host=f"{host}:{port}",
                           url=url)
                conn.sock.sendall(req[half:])
            else:
                conn.sock.sendall(req)
            if _fault.ARMED:
                _fault.hit("rpc.recv", host=f"{host}:{port}", url=url)
            line = conn.rf.readline(65537)
            if not line:
                raise ConnectionResetError("server closed connection")
            parts = line.decode("latin-1").rstrip("\r\n").split(" ", 2)
            status = int(parts[1])
            reason = parts[2] if len(parts) > 2 else ""
            headers = _read_headers(conn.rf)
        except (ConnectionResetError, BrokenPipeError):
            # A reused keep-alive the server closed between our
            # requests: safe to retry once.  NOT for timeouts — a slow
            # server may still be processing, and a re-send would run a
            # non-idempotent RPC twice.
            conn.close()
            if reused and attempt == 0:
                continue
            raise
        except Exception:
            conn.close()
            raise
        while status == 100:  # ignore interim responses
            line = conn.rf.readline(65537)
            parts = line.decode("latin-1").rstrip("\r\n").split(" ", 2)
            status = int(parts[1])
            reason = parts[2] if len(parts) > 2 else ""
            headers = _read_headers(conn.rf)
        # Breaker bookkeeping: a 5xx answer (other than 503 — a live
        # server redirecting load, e.g. a follower master, is not a
        # sick one) counts toward opening the host's breaker; anything
        # else closes it.
        breaker = _res.breaker_for(f"{host}:{port}")
        if status >= 500 and status != 503:
            breaker.record_failure()
        else:
            breaker.record_success()
        resp = _Resp(status, reason, headers, conn.rf)
        # Flow ledger, client side: the request body went out (one
        # op), the response body counts in as the caller reads it.
        # Error-status bodies count too — their bytes crossed the
        # wire like any other.  Redirect legs each count separately.
        flow_peer = f"{host}:{port}"
        flow_prole = headers.get(_flows.ROLE_HEADER.lower(), "") \
            or "server"
        _flows.LEDGER.note(flow_purpose, "out",
                           len(body) if body else 0, peer=flow_peer,
                           peer_role=flow_prole, local=flow_local)
        _flows.LEDGER.note(flow_purpose, "in", 0, peer=flow_peer,
                           peer_role=flow_prole, local=flow_local)
        resp.flow_note = \
            lambda n, _p=flow_purpose, _peer=flow_peer, \
            _pr=flow_prole, _l=flow_local: \
            _flows.LEDGER.note(_p, "in", n, peer=_peer, peer_role=_pr,
                               local=_l, ops=0)
        if status in (301, 302, 307, 308) and max_redirects > 0:
            location = resp.getheader("location")
            if location:
                try:
                    resp.read()
                    _finish(conn, resp)
                except Exception:  # noqa: BLE001 — truncated redirect body
                    conn.close()
                return _request(
                    urllib.parse.urljoin(url, location), method, body,
                    timeout, max_redirects - 1, req_headers)
        return resp, conn
    raise AssertionError("unreachable")


def _finish(conn: _Conn, resp: _Resp) -> None:
    """Return a fully-read connection to the pool (or close it)."""
    if resp.will_close or not resp._done:
        conn.close()
    else:
        _pool.release(conn)


def _raise_rpc_error(resp: _Resp, data: bytes) -> None:
    try:
        message = json.loads(data or b"{}").get(
            "error", f"HTTP Error {resp.status}: {resp.reason}")
    except Exception:  # noqa: BLE001
        message = f"HTTP Error {resp.status}: {resp.reason}"
    # Surface the server's pacing hint (admission sheds, drain
    # refusals): RetryPolicy uses it as a backoff floor on 429/503.
    retry_after = None
    ra = resp.getheader("retry-after")
    if ra:
        try:
            retry_after = float(ra)
        except ValueError:
            pass
    raise RpcError(resp.status, message, retry_after=retry_after)


def call(url: str, method: str = "GET", body: bytes | None = None,
         timeout: float = 10.0, headers: dict | None = None):
    """HTTP call returning parsed JSON (dict) or raw bytes."""
    # Phase attribution: a handler blocked here is waiting on a
    # downstream server, not burning its own CPU — the whole
    # round-trip (send + response body) lands in `rpc_downstream`.
    with _phases.phase("rpc_downstream"):
        resp, conn = _request(url, method, body, timeout,
                              req_headers=headers)
        try:
            if method == "HEAD":
                data = b""        # no body follows a HEAD response
                resp._done = True  # even when Content-Length says so
            else:
                data = resp.read()
        except Exception:
            conn.close()
            raise
        _finish(conn, resp)
    if resp.status >= 400:
        _raise_rpc_error(resp, data)
    if (resp.getheader("content-type") or "").startswith(
            "application/json"):
        return json.loads(data or b"{}")
    return data


def call_status(url: str, method: str = "GET",
                body: bytes | None = None, timeout: float = 10.0,
                headers: dict | None = None):
    """Like call() but returns (status, parsed-body) without raising on
    HTTP errors — for endpoints whose status code IS the answer and
    whose error responses carry a full JSON document
    (/cluster/healthz)."""
    with _phases.phase("rpc_downstream"):
        resp, conn = _request(url, method, body, timeout,
                              req_headers=headers)
        try:
            data = resp.read()
        except Exception:
            conn.close()
            raise
        _finish(conn, resp)
    if (resp.getheader("content-type") or "").startswith(
            "application/json"):
        try:
            return resp.status, json.loads(data or b"{}")
        except ValueError:
            pass
    return resp.status, data


def call_to_file(url: str, path: str, timeout: float = 600.0,
                 headers: dict | None = None) -> int:
    """Stream a GET response to a file in chunks; returns byte count.
    Bulk transfers (volume/shard copies) must never buffer a 30GB .dat
    in memory (the reference streams CopyFile in chunks too).  Writes
    land in a `.dl.tmp` sibling renamed into place only on a complete
    transfer, so a truncated download never masquerades as a valid
    shard/volume file at the destination path."""
    with _phases.phase("rpc_downstream"):
        resp, conn = _request(url, "GET", None, timeout,
                              req_headers=headers)
        if resp.status >= 400:
            try:
                data = resp.read()
            except Exception:
                conn.close()
                raise
            _finish(conn, resp)
            _raise_rpc_error(resp, data)
        tmp = path + ".dl.tmp"
        try:
            with open(tmp, "wb") as f:
                total = 0
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
                    total += len(chunk)
            clen = resp.getheader("content-length")
            if clen is not None and total != int(clen):
                raise ConnectionError(
                    f"incomplete download: got {total} of {clen} bytes")
        except Exception:
            conn.close()
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        os.replace(tmp, path)
        _finish(conn, resp)
        return total


class StreamHandle:
    """A live NDJSON push stream (EventStream consumer side): iterate
    `.events()` for parsed docs; `.close()` tears the connection down
    IMMEDIATELY from any thread (urllib's close would block draining
    the endless body).  An optional stop_event makes shutdown
    deterministic even if close() races the handle's creation: the
    server's ≤heartbeat-interval blank lines wake the reader, which
    checks the event on every wakeup — not just on data."""

    def __init__(self, resp, conn, stop_event=None):
        self._resp = resp
        self._conn = conn
        self._stop = stop_event
        self._closed = False

    def close(self) -> None:
        self._closed = True
        self._conn.close()

    def _should_stop(self) -> bool:
        return self._closed or (self._stop is not None
                                and self._stop.is_set())

    def events(self):
        buf = b""
        try:
            while not self._should_stop():
                chunk = self._resp.read_any()
                if not chunk or self._should_stop():
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        yield json.loads(line)
        except (OSError, ConnectionError, ValueError):
            return  # closed mid-read (including via close())
        finally:
            self._conn.close()


def call_stream(url: str, timeout: float = 60.0,
                stop_event=None) -> StreamHandle:
    """Open a long-lived push stream (EventStream server side)."""
    resp, conn = _request(url, "GET", None, timeout)
    if resp.status >= 400:
        data = resp.read()
        conn.close()
        _raise_rpc_error(resp, data)
    return StreamHandle(resp, conn, stop_event)


def call_json(url: str, method: str = "POST", payload: dict | None = None,
              timeout: float = 10.0) -> dict:
    body = json.dumps(payload or {}).encode()
    out = call(url, method, body, timeout)
    assert isinstance(out, dict)
    return out
