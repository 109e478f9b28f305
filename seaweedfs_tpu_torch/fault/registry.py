"""Fault-injection registry: named fault points armed to fail on demand.

A fault point is a named place in the code (`rpc.connect`,
`volume.write`, `ec.fetch_shard`, ...) where an armed spec can inject a
failure: raise a connection error N times, sleep, kill the connection
with no response, or answer with a given HTTP status.  The catalog of
points is static (`POINTS`) so a smoke test can assert every one of
them is actually reachable — a hook that silently rots is worse than no
hook at all.

Zero cost when disarmed — this is the contract the hot paths rely on.
Call sites guard every hit with the module-global dict:

    from ..fault import registry as _fault
    ...
    if _fault.ARMED:
        _fault.hit("rpc.connect", host=hostport)

`ARMED` is empty unless something is armed, so the disarmed hot path is
a single dict truthiness check: no locks, no allocation, no call.

Arming:

- env, at import: ``SEAWEEDFS_TPU_FAULTS="rpc.connect=fail*2;volume.write=delay:0.2"``
- programmatically (tests): ``registry.arm("rpc.connect", "fail*2")``
- at runtime over HTTP: ``POST /debug/faults?point=...&spec=...`` (routes.py)
  and the ``fault.ls`` / ``fault.set`` shell commands.

Spec grammar (documented in README "Robustness"):

    spec  := kind [ ":" arg ] [ "*" times ] [ "@" prob ] [ "~" match ]
    kind  := "fail" | "delay" | "status" | "drop"

- ``fail``      raise FaultInjected (a ConnectionResetError — armed
                network points surface exactly like a peer reset)
- ``delay:S``   sleep S seconds, then proceed normally
- ``status:N``  raise RpcError(N) — a server that answers with N
- ``drop``      raise DropConnection — the server kills the connection
                with no response bytes (client sees EOF mid-exchange)
- ``*times``    trigger at most `times` times, then auto-disarm
                (default: unlimited)
- ``@prob``     trigger with probability `prob` per hit, deterministic
                from SEAWEEDFS_TPU_FAULTS_SEED (default seed 0) — the
                same seed replays the same chaos run
- ``~match``    only trigger when `match` is a substring of one of the
                hit's context values (e.g. a host:port), so one point
                can fail for a single server while others stay healthy

Points are separated by ";" (or ",") in SEAWEEDFS_TPU_FAULTS.
"""

from __future__ import annotations

import os
import random
import threading
import time

from ..stats.metrics import Counter

# Static fault-point catalog, the JAX package's whole (the port hooks
# the points of the modules it has so far; the others wait for theirs).
POINTS: dict[str, str] = {
    "rpc.connect": "client pool acquire — dialing (or reusing a "
                   "connection to) a host",
    "rpc.send": "client request send, before bytes hit the wire",
    "rpc.recv": "client response read, after the request was sent",
    "volume.write": "volume server needle write handler",
    "volume.read": "volume server needle read handler",
    "volume.replicate": "replication fan-out send to one sibling "
                        "replica",
    "ec.fetch_shard": "EC shard/volume fetch (rebuild gather, encode "
                      "pull, degraded read)",
    "ec.scatter": "EC shard push to a rebuilt/encoded shard target",
    "master.heartbeat": "volume server heartbeat POST to its master",
    "volume.corrupt": "bit-rot injector: the guarded write site flips "
                      "a data bit in the record/shard bytes as they "
                      "are written to disk (the write still succeeds)",
    "disk.read": "volume .dat pread — an armed fail surfaces as an "
                 "OSError, like a failing disk sector",
    "disk.full": "volume .dat append — an armed fail surfaces as "
                 "ENOSPC after HALF the record landed (a real torn "
                 "write), exercising the clean rollback path",
    "net.slow_client": "client request send — an armed delay:S stalls "
                       "mid-request after half the bytes, like a "
                       "slow-loris client; the server's idle timeout "
                       "should reap the connection",
    "wan.partition": "cross-cluster ship-path batch POST — an armed "
                     "fail is a WAN partition: the batch never "
                     "reaches the standby, the acked watermark holds, "
                     "and shipping resumes from it after heal",
    "wan.delay": "cross-cluster ship-path batch POST — an armed "
                 "delay:S models WAN round-trip latency, growing the "
                 "replication lag healthz watches",
    "wan.duplicate": "cross-cluster ship path, after a successful "
                     "send — an armed fail makes the shipper deliver "
                     "the SAME batch twice; the receiver's applied-seq "
                     "watermark must no-op the replay",
    "wan.reorder": "cross-cluster ship path, before a batch send — an "
                   "armed fail makes the shipper deliver batch n+1 "
                   "BEFORE batch n; the receiver must refuse the "
                   "gapped batch unacked so in-order re-delivery "
                   "converges with nothing skipped",
    "tier.read": "remote-tier ranged GET (the block-cache fetch leg) "
                 "— an armed fail is a WAN-partitioned backend; the "
                 "needle read path must answer a bounded 503, never "
                 "hang",
}

KINDS = ("fail", "delay", "status", "drop")


class FaultInjected(ConnectionResetError):
    """Failure injected by an armed `fail` spec.  Subclasses
    ConnectionResetError so network-plane fault points take exactly the
    code paths a real peer reset would."""


class DropConnection(ConnectionError):
    """Injected by an armed `drop` spec: the server-side request loop
    (`rpc.JsonHttpServer._serve_one`) catches this and closes the
    connection without writing any response — the client experiences a
    mid-exchange disconnect.  Subclasses ConnectionError so a `drop`
    armed on a CLIENT-side point (rpc.send, ec.fetch_shard, ...) still
    rides the normal failover/except paths instead of escaping as an
    error no real network failure could produce."""


faults_injected_total = Counter(
    "SeaweedFS_faults_injected_total",
    "fault-point triggers by point name", ("point",))


def _seed() -> int:
    try:
        return int(os.environ.get("SEAWEEDFS_TPU_FAULTS_SEED", "0"))
    except ValueError:
        return 0


class FaultSpec:
    """One armed fault point."""

    __slots__ = ("point", "raw", "kind", "arg", "times", "prob",
                 "match", "hits", "triggered", "_rng", "_lock")

    def __init__(self, point: str, raw: str):
        self.point = point
        self.raw = raw
        rest = raw.strip()
        self.match = ""
        if "~" in rest:
            rest, self.match = rest.split("~", 1)
        self.prob = 1.0
        if "@" in rest:
            rest, p = rest.rsplit("@", 1)
            self.prob = float(p)
            if not 0.0 < self.prob <= 1.0:
                raise ValueError(f"prob {self.prob} not in (0, 1]")
        self.times = -1  # unlimited
        if "*" in rest:
            rest, n = rest.rsplit("*", 1)
            self.times = int(n)
            if self.times <= 0:
                raise ValueError(f"times {self.times} must be positive")
        self.arg = 0.0
        if ":" in rest:
            rest, a = rest.split(":", 1)
            self.arg = float(a)
        self.kind = rest.strip()
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {KINDS})")
        if self.kind == "status" and not 400 <= int(self.arg) <= 599:
            raise ValueError(f"status {self.arg:g} not an error status")
        # Deterministic chaos: the stream of @prob decisions is a pure
        # function of (seed, point, spec), so a run replays from its
        # seed.
        self._rng = random.Random(f"{_seed()}:{point}:{raw}")
        self._lock = threading.Lock()
        self.hits = 0        # times the armed point was reached
        self.triggered = 0   # times it actually injected

    def describe(self) -> dict:
        return {"point": self.point, "spec": self.raw,
                "kind": self.kind, "remaining": self.times,
                "hits": self.hits, "triggered": self.triggered}

    def fire(self, ctx: dict) -> None:
        """Called from `hit` when this point is armed."""
        if self.match and not any(
                self.match in str(v) for v in ctx.values()):
            return
        with self._lock:
            self.hits += 1
            if self.prob < 1.0 and self._rng.random() >= self.prob:
                return
            if self.times == 0:
                return  # exhausted; a racing disarm is on its way
            if self.times > 0:
                self.times -= 1
                if self.times == 0:
                    disarm(self.point)
            self.triggered += 1
        faults_injected_total.inc(point=self.point)
        from ..events import emit as emit_event
        emit_event("fault.injected", severity="warn", point=self.point,
                   kind=self.kind, spec=self.raw,
                   **{k: str(v) for k, v in ctx.items()
                      if k not in ("point", "kind", "spec", "node")})
        where = f"{self.point}" + (f" {ctx}" if ctx else "")
        if self.kind == "delay":
            time.sleep(self.arg)
            return
        if self.kind == "status":
            from ..cluster import rpc  # lazy: rpc imports this module
            raise rpc.RpcError(int(self.arg),
                               f"injected fault at {where}")
        if self.kind == "drop":
            raise DropConnection(where)
        raise FaultInjected(f"injected fault at {where}")


# point name -> FaultSpec.  Plain dict: the disarmed hot-path check is
# `if ARMED:` — call sites must never pay a lock or a call for it.
ARMED: dict[str, FaultSpec] = {}
_arm_lock = threading.Lock()


def arm(point: str, spec: str) -> FaultSpec:
    """Arm one fault point.  `spec` follows the grammar above."""
    if point not in POINTS:
        raise ValueError(
            f"unknown fault point {point!r} (see fault.ls / POINTS)")
    fs = FaultSpec(point, spec)
    with _arm_lock:
        ARMED[point] = fs
    return fs


def disarm(point: str) -> None:
    with _arm_lock:
        ARMED.pop(point, None)


def disarm_all() -> None:
    with _arm_lock:
        ARMED.clear()


def hit(point: str, **ctx) -> None:
    """Trigger an armed fault at `point`.  Call sites guard with
    `if ARMED:` so this function never runs disarmed."""
    spec = ARMED.get(point)
    if spec is not None:
        spec.fire(ctx)


def snapshot() -> list[dict]:
    """Catalog + armed state, for /debug/faults and fault.ls."""
    armed = dict(ARMED)
    out = []
    for name in sorted(POINTS):
        row = {"point": name, "doc": POINTS[name], "armed": False}
        spec = armed.get(name)
        if spec is not None:
            row.update(spec.describe(), armed=True)
        out.append(row)
    return out


def arm_from_env(value: str | None = None) -> list[str]:
    """Parse SEAWEEDFS_TPU_FAULTS ("point=spec;point=spec") and arm.
    Returns the list of armed points; unknown points/specs raise so a
    typo'd chaos run fails loudly instead of testing nothing."""
    if value is None:
        value = os.environ.get("SEAWEEDFS_TPU_FAULTS", "")
    armed = []
    for part in value.replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad fault spec {part!r} (want point=spec)")
        point, spec = part.split("=", 1)
        arm(point.strip(), spec.strip())
        armed.append(point.strip())
    return armed


# Env arming happens at import so every process in a chaos run — server
# roles, shell, benchmarks — arms the same faults before serving.
if os.environ.get("SEAWEEDFS_TPU_FAULTS"):
    arm_from_env()
