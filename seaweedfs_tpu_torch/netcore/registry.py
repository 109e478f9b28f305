"""Per-connection registry — the C10k observability the SLO plane
lacked: who is connected, in which lifecycle state, on which lane,
and how many bytes have moved.  Both transports feed it; `aio` conns
get precise idle/reading/handling states from the event loop, threaded
conns report the coarser "open" (their thread blocks inside readline,
so idle-vs-handling is invisible without per-read bookkeeping the hot
path should not pay)."""

from __future__ import annotations

import threading
import time

from ..stats.metrics import Counter

# Reaps by kind: "idle" = keep-alive conn past -idle.timeout,
# "stalled" = mid-request stall (slow-loris) past the harder stall
# deadline, "overflow" = dispatch queue full (raw 503, pre-admission).
# Only the aio loop can attribute kinds; the threaded transport reaps
# via kernel SO_RCVTIMEO where idle and stalled are indistinguishable.
conns_reaped_total = Counter(
    "SeaweedFS_conns_reaped_total",
    "server connections reaped by the aio event loop, by kind "
    "(idle keep-alive, mid-request stall, dispatch overflow)",
    ("kind",))


class ConnInfo:
    """One live server connection.  Mutated lock-free from the owning
    loop/worker/conn thread; snapshot readers tolerate torn reads
    (diagnostic data, monotonic per field)."""

    __slots__ = ("peer", "transport", "created", "last_activity",
                 "state", "lane", "requests", "bytes_in", "bytes_out")

    def __init__(self, peer: str, transport: str):
        now = time.monotonic()
        self.peer = peer
        self.transport = transport
        self.created = now
        self.last_activity = now
        self.state = "idle"          # idle | reading | handling | open
        self.lane = ""               # last admission lane this conn used
        self.requests = 0
        self.bytes_in = 0
        self.bytes_out = 0

    def touch(self) -> None:
        self.last_activity = time.monotonic()

    def to_dict(self, now: float) -> dict:
        return {
            "peer": self.peer,
            "transport": self.transport,
            "state": self.state,
            "lane": self.lane,
            "age_s": round(now - self.created, 3),
            "idle_s": round(now - self.last_activity, 3),
            "requests": self.requests,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
        }


class ConnRegistry:
    """The set of live ConnInfos for one server."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._conns: set[ConnInfo] = set()

    def add(self, peer: str, transport: str) -> ConnInfo:
        info = ConnInfo(peer, transport)
        with self._lock:
            self._conns.add(info)
        return info

    def remove(self, info: ConnInfo) -> None:
        with self._lock:
            self._conns.discard(info)

    def __len__(self) -> int:
        with self._lock:
            return len(self._conns)

    def state_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            out[c.state] = out.get(c.state, 0) + 1
        return out

    def gauge_values(self, role: str) -> dict:
        """Callback payload for SeaweedFS_open_connections{role,state}."""
        return {(role, st): n for st, n in self.state_counts().items()}

    def snapshot(self, limit: int = 256) -> list[dict]:
        now = time.monotonic()
        with self._lock:
            conns = list(self._conns)
        conns.sort(key=lambda c: c.created)
        return [c.to_dict(now) for c in conns[:limit]]


class CountedConn:
    """Thin socket proxy that attributes egress bytes to a ConnInfo.
    Everything except sendall delegates to the real socket (sendfile
    and splice move bytes kernel-side through fileno(); those paths
    report via note_tx)."""

    __slots__ = ("_sock", "_info")

    def __init__(self, sock, info: ConnInfo):
        self._sock = sock
        self._info = info

    def __getattr__(self, name):
        return getattr(self._sock, name)

    def sendall(self, data) -> None:
        self._sock.sendall(data)
        self._info.bytes_out += len(data)

    def note_tx(self, n: int) -> None:
        self._info.bytes_out += int(n)

    def fileno(self) -> int:
        return self._sock.fileno()
