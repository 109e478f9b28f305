"""Wire-flow attribution plane: per-purpose byte accounting.

Every byte that crosses a socket is attributed to a *purpose* from the
static catalog below — the question "how many bytes moved over which
link, for what" that traces, events, and latency SLOs cannot answer.
The plane has one choke point (cluster/rpc.py counts request and
response bodies on both the client and server side of every RPC,
including the zero-copy sendfile/splice legs, whose syscall-returned
totals never transit userspace) plus direct feeds for traffic that
bypasses the RPC plane entirely (tier backend uploads/downloads).

Like the event catalog (events/journal.py), the purpose catalog is
closed: noting an uncataloged purpose raises, so a new traffic class
cannot ship without declaring itself here (and the anti-rot test in
tests/test_flows.py drives every entry through its real code path).

Surfaces: `GET /debug/flows` per node, heartbeat-carried rows merged
into the master's cluster traffic matrix at `GET /cluster/flows`, the
`SeaweedFS_wire_bytes_total{purpose,direction,peer_role}` instrument on
every role, and declarative per-purpose bandwidth budgets
(`-flows.budget repair.fetch=50MB/s`) that emit a `flows.budget` event
and a healthz warning on sustained breach.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager

from .metrics import Counter

# -- purpose catalog ---------------------------------------------------------
# Closed set, like events/journal.py TYPES: FlowLedger.note() raises on
# anything not listed here.  Wire headers with an unknown purpose fall
# back to the path heuristic instead (a foreign client must not be able
# to 500 a server by sending garbage).

PURPOSES = {
    "user.read":
        "client-facing reads: needle GETs, filer file serves",
    "user.write":
        "client-facing writes: needle POSTs/DELETEs, filer uploads",
    "replicate.fanout":
        "synchronous write fan-out to sibling replica holders",
    "ec.gather":
        "EC reads pulled for encode/rebuild/degraded reads: source "
        "volume files, remote shards, shard intervals",
    "ec.scatter":
        "EC shard placement pushes: encode spread, rebuilt-shard push",
    "repair.fetch":
        "self-healing fetches: intact replica needle reads that heal "
        "a quarantined copy",
    "rlog.ship":
        "cross-cluster change-log shipping to the standby",
    "tier.up":
        "cold volume data uploaded to a remote tier backend",
    "tier.down":
        "remote tier downloads: promotion copy-back, read-through "
        "block fills",
    "proxy":
        "filer->volume proxy legs serving a user request",
    "control":
        "control plane: heartbeats, lookups, assigns, admin verbs, "
        "introspection",
}

# Stamped by rpc._request on every outbound hop (an explicit call-site
# header wins) so the receiving server attributes the same purpose —
# conservation (A->B sent == B<-A received, per purpose) holds by
# construction, not by parallel heuristics agreeing.
PURPOSE_HEADER = "X-Weed-Purpose"
# Self-identification: the caller's "host:port" and role ride every
# hop so the master's traffic matrix can pair A's "out" rows with B's
# "in" rows into per-link cells.
NODE_HEADER = "X-Weed-Node"
ROLE_HEADER = "X-Weed-Role"

DIRECTIONS = ("in", "out")

wire_bytes_total = Counter(
    "SeaweedFS_wire_bytes_total",
    "wire bytes by transfer purpose and direction (HTTP body bytes, "
    "framing excluded; zero-copy sendfile/splice legs count "
    "syscall-returned totals)",
    ("purpose", "direction", "peer_role"))


def validate(purpose: str) -> str:
    if purpose not in PURPOSES:
        raise ValueError(
            f"unknown flow purpose {purpose!r}; cataloged: "
            f"{sorted(PURPOSES)}")
    return purpose


def tag(purpose: str) -> dict:
    """Request-header dict a call site merges into its rpc headers to
    declare the transfer's purpose (worker-thread fan-outs can't rely
    on the thread-local purpose context)."""
    return {PURPOSE_HEADER: validate(purpose)}


# -- purpose resolution ------------------------------------------------------

_CONTROL_PREFIXES = ("/dir/", "/cluster/", "/admin/", "/debug/",
                     "/col/", "/vol/", "/stats", "/raft", "/ui")
_CONTROL_PATHS = ("/heartbeat", "/metrics", "/status", "/dir", "/vol",
                  "/cluster", "/admin", "/debug")


def resolve(method: str, path: str, header_purpose: str = "",
            query_type: str = "", low_priority: bool = False) -> str:
    """Best-effort purpose for a request that did not declare one.

    A valid explicit header always wins (an UNKNOWN header value falls
    through — heuristic, never a 500); `?type=replicate` is the legacy
    fan-out marker; control-plane paths and low-priority internal
    traffic are `control`; what remains is a user read or write."""
    if header_purpose in PURPOSES:
        return header_purpose
    if query_type == "replicate":
        return "replicate.fanout"
    p = path.split("?", 1)[0]
    if p.startswith(_CONTROL_PREFIXES) or p in _CONTROL_PATHS:
        return "control"
    if low_priority:
        return "control"
    return "user.read" if method in ("GET", "HEAD") else "user.write"


# -- local identity + per-request context ------------------------------------

_tls = threading.local()
_proc_lock = threading.Lock()
_proc_node = ""
_proc_role = "client"

_ROLE_OF_SUBSYSTEM = {"volumeServer": "volume"}


def role_of(subsystem: str) -> str:
    return _ROLE_OF_SUBSYSTEM.get(subsystem, subsystem)


def set_process_identity(node: str, role: str) -> None:
    """Default identity for threads that never bound one (daemons,
    pool workers).  First server wins: a single-role process (the
    deployed case) self-identifies correctly; multi-role in-process
    test stacks bind per-thread instead."""
    global _proc_node, _proc_role
    with _proc_lock:
        if not _proc_node:
            _proc_node, _proc_role = node, role


def bind_thread(node: str, role: str) -> None:
    """This thread's outbound RPCs originate from `node` (a server's
    handler thread, a heartbeat loop, the replication shipper)."""
    _tls.node, _tls.role = node, role


def clear_thread() -> None:
    _tls.node = _tls.role = None


def local_identity() -> tuple[str, str]:
    node = getattr(_tls, "node", None)
    if node:
        return node, getattr(_tls, "role", "") or "client"
    return _proc_node, _proc_role


@contextmanager
def purpose(p: str):
    """Thread-local purpose context: outbound RPCs under this block
    are attributed to `p` (same-thread call sites; worker-thread
    fan-outs pass tag() headers instead)."""
    validate(p)
    prev = getattr(_tls, "purpose", None)
    _tls.purpose = p
    try:
        yield
    finally:
        _tls.purpose = prev


def current_purpose() -> str | None:
    return getattr(_tls, "purpose", None)


def begin_request(peer: str, peer_role: str, req_purpose: str) -> None:
    """Server side: park the resolved (peer, peer_role, purpose) for
    the request this thread is handling, so _respond can note the
    response leg without re-threading the values through dispatch."""
    _tls.req = (peer, peer_role, req_purpose)


def current_request() -> tuple | None:
    return getattr(_tls, "req", None)


def end_request() -> None:
    _tls.req = None


# -- bandwidth budgets -------------------------------------------------------

_UNITS = {"B": 1, "KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30}


def parse_rate(spec: str) -> float:
    """'50MB/s' / '512KB' / '1.5GB/s' -> bytes per second."""
    s = spec.strip()
    if s.endswith("/s"):
        s = s[:-2]
    s = s.strip().upper()
    for suffix in ("GB", "MB", "KB", "B"):
        if s.endswith(suffix):
            num = s[:-len(suffix)].strip()
            return float(num) * _UNITS[suffix]
    return float(s)


def parse_budgets(spec: str) -> dict[str, float]:
    """'-flows.budget repair.fetch=50MB/s,rlog.ship=1MB/s' grammar:
    comma-separated purpose=rate pairs; unknown purposes raise at
    startup, not at breach time."""
    out: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"flows budget {part!r}: expected purpose=rate")
        p, rate = part.split("=", 1)
        out[validate(p.strip())] = parse_rate(rate)
    return out


# -- the ledger --------------------------------------------------------------

# Rate window: bytes summed over the last _RATE_WINDOW seconds of
# 1-second buckets.  Short on purpose — budgets are about sustained
# pressure NOW, not lifetime averages.
_RATE_WINDOW = 2.0
_EMIT_EVERY = 5.0  # one flows.budget event per episode per this many s


class FlowLedger:
    """Per-process byte/op accounting keyed by
    (local, peer_addr, peer_role, purpose, direction).

    `local` is the originating endpoint ("host:port" of the server the
    noting thread belongs to, "" for a bare client process) — it keeps
    attribution per-node when several roles share one process (test
    stacks), and is the key the heartbeat filters on when a volume
    server ships its rows to the master."""

    def __init__(self):
        self._lock = threading.Lock()
        # key -> [bytes, ops]
        self._rows: dict[tuple, list] = {}
        # (local, purpose, direction) -> deque of [epoch-sec, bytes]
        self._buckets: dict[tuple, deque] = {}
        self._budgets: dict[str, float] = {}
        self._sustain = 2.0
        self._breach: dict[tuple, float] = {}  # bucket key -> since ts
        self._last_emit: dict[str, float] = {}
        self._env_loaded = False

    # -- configuration ----------------------------------------------

    def set_budgets(self, budgets: dict[str, float],
                    sustain: float | None = None) -> None:
        for p in budgets:
            validate(p)
        with self._lock:
            self._budgets = dict(budgets)
            if sustain is not None:
                self._sustain = float(sustain)
            self._env_loaded = True
            self._breach.clear()
            self._last_emit.clear()

    def _ensure_env(self) -> None:
        # -flows.budget reaches servers as an env var (command/
        # __init__.py) — loaded lazily so import order never matters.
        if self._env_loaded:
            return
        self._env_loaded = True
        spec = os.environ.get("SEAWEEDFS_TPU_FLOWS_BUDGET", "")
        sus = os.environ.get("SEAWEEDFS_TPU_FLOWS_SUSTAIN", "")
        try:
            if spec:
                self._budgets = parse_budgets(spec)
            if sus:
                self._sustain = float(sus)
        except ValueError:
            # A bad spec must not take the data path down; the flag
            # parser validates loudly at startup.
            pass

    # -- the single entry point -------------------------------------

    def note(self, purpose_: str, direction: str, nbytes: int, *,
             peer: str = "", peer_role: str = "", local: str | None = None,
             ops: int = 1) -> None:
        validate(purpose_)
        if direction not in DIRECTIONS:
            raise ValueError(f"flow direction {direction!r} not in "
                             f"{DIRECTIONS}")
        if local is None:
            local = local_identity()[0]
        n = int(nbytes)
        key = (local, peer, peer_role, purpose_, direction)
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                row = self._rows[key] = [0, 0]
            row[0] += n
            row[1] += ops
        if n:
            wire_bytes_total.inc(n, purpose=purpose_,
                                 direction=direction,
                                 peer_role=peer_role or "client")
            self._pace(local, purpose_, direction, n)

    # -- budget pacing ----------------------------------------------

    def _pace(self, local: str, purpose_: str, direction: str,
              n: int) -> None:
        self._ensure_env()
        now = time.time()
        key = (local, purpose_, direction)
        with self._lock:
            dq = self._buckets.get(key)
            if dq is None:
                dq = self._buckets[key] = deque(maxlen=8)
            sec = int(now)
            if dq and dq[-1][0] == sec:
                dq[-1][1] += n
            else:
                dq.append([sec, n])
            limit = self._budgets.get(purpose_)
        if limit is None:
            return
        rate = self.rate(local, purpose_, direction, now=now)
        if rate <= limit:
            self._breach.pop(key, None)
            return
        since = self._breach.setdefault(key, now)
        if now - since < self._sustain:
            return
        last = self._last_emit.get(purpose_, 0.0)
        if now - last < _EMIT_EVERY:
            return
        self._last_emit[purpose_] = now
        self._emit_breach(local, purpose_, direction, rate, limit,
                          now - since)

    @staticmethod
    def _emit_breach(local: str, purpose_: str, direction: str,
                     rate: float, limit: float, sustained: float) -> None:
        try:
            from ..events import emit
            from ..trace import root_span
            with root_span("flows.budget", "flows"):
                emit("flows.budget", node=local, severity="warn",
                     purpose=purpose_, direction=direction,
                     rate_bps=int(rate), limit_bps=int(limit),
                     sustained_seconds=round(sustained, 3))
        except Exception:  # noqa: BLE001 — accounting must never
            pass           # take the data path down

    def rate(self, local: str, purpose_: str, direction: str,
             now: float | None = None) -> float:
        """Bytes/second over the trailing window for one
        (local, purpose, direction)."""
        now = time.time() if now is None else now
        lo = now - _RATE_WINDOW
        with self._lock:
            dq = self._buckets.get((local, purpose_, direction))
            if not dq:
                return 0.0
            total = sum(b for sec, b in dq if sec >= lo)
        return total / _RATE_WINDOW

    # -- read side ---------------------------------------------------

    def snapshot(self, local: str | None = None) -> list[dict]:
        """Cumulative rows (absolute values — the heartbeat rollup is
        idempotent, a dropped beat never double-counts)."""
        with self._lock:
            items = sorted(self._rows.items())
        return [{"local": k[0], "peer": k[1], "peer_role": k[2],
                 "purpose": k[3], "direction": k[4],
                 "bytes": v[0], "ops": v[1]}
                for k, v in items
                if local is None or k[0] == local]

    def totals(self, purpose_: str | None = None,
               direction: str | None = None,
               local: str | None = None,
               peer: str | None = None) -> tuple[int, int]:
        """(bytes, ops) summed over matching rows — the cross-assert
        hook tests compare legacy per-subsystem counters against."""
        b = o = 0
        with self._lock:
            for (loc, pr, _role, purp, d), (nb, no) in \
                    self._rows.items():
                if purpose_ is not None and purp != purpose_:
                    continue
                if direction is not None and d != direction:
                    continue
                if local is not None and loc != local:
                    continue
                if peer is not None and pr != peer:
                    continue
                b += nb
                o += no
        return b, o

    def budget_status(self, local: str | None = None) -> dict:
        """Per budgeted purpose: configured limit, the worst live rate
        across directions, and whether the breach has sustained past
        the threshold (the healthz-warning condition)."""
        self._ensure_env()
        now = time.time()
        with self._lock:
            budgets = dict(self._budgets)
            bucket_keys = list(self._buckets)
            sustain = self._sustain
        out: dict[str, dict] = {}
        for p, limit in sorted(budgets.items()):
            worst_rate = 0.0
            worst_dir = ""
            breached = False
            for key in bucket_keys:
                loc, purp, d = key
                if purp != p or (local is not None and loc != local):
                    continue
                r = self.rate(loc, purp, d, now=now)
                if r > worst_rate:
                    worst_rate, worst_dir = r, d
                since = self._breach.get(key)
                if since is not None and now - since >= sustain \
                        and r > limit:
                    breached = True
            out[p] = {"limit_bps": limit,
                      "rate_bps": round(worst_rate, 1),
                      "direction": worst_dir, "breached": breached}
        return out

    def reset(self) -> None:
        """Test hook: fresh ledger AND fresh budget config (env
        re-read on next note)."""
        with self._lock:
            self._rows.clear()
            self._buckets.clear()
            self._budgets = {}
            self._sustain = 2.0
            self._breach.clear()
            self._last_emit.clear()
            self._env_loaded = False


LEDGER = FlowLedger()


def debug_doc(node: str, role: str) -> dict:
    """GET /debug/flows payload: this process's full ledger (every
    local identity it has noted under), budget verdicts, and the
    catalog itself (so the shell can validate -purpose filters)."""
    return {"node": node, "role": role,
            "purposes": {p: PURPOSES[p] for p in sorted(PURPOSES)},
            "rows": LEDGER.snapshot(),
            "budgets": LEDGER.budget_status()}
