"""QoS fairness primitives for the admission plane: per-tenant token
buckets (req/s + write MB/s) and a deficit-round-robin scheduler over
per-tenant sub-queues.

The admission lanes (cluster/rpc.py `_Lane`) bound CONCURRENCY per
role; these primitives bound it per PRINCIPAL inside each lane:

- `TokenBucket` / `TenantBuckets`: an over-rate tenant is refused at
  the gate with 429 + Retry-After sized to when its bucket refills —
  other tenants never even see the request in their queue.
- `DrrQueue`: when a lane's slots are full, waiters park in per-tenant
  FIFOs and freed slots are handed out deficit-round-robin (Shreedhar
  & Varghese), weighted by the tenant's quota-rule `weight=`.  A
  tenant with 50 queued requests and a tenant with 1 each get served
  in proportion to weight, not arrival count — the flood can only
  starve itself.

Request cost is 1 per pop (the lanes schedule admissions, not bytes);
the deficit mechanics still matter because weights are fractional.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from .quota import QuotaPolicy


class TokenBucket:
    """Classic token bucket on the monotonic clock.  `try_take` never
    blocks: it returns 0.0 on admit, else the seconds until the bucket
    holds enough tokens — the Retry-After the caller surfaces."""

    __slots__ = ("rate", "burst", "_tokens", "_last", "_lock")

    def __init__(self, rate: float, burst: float | None = None):
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = rate
        self.burst = burst if burst is not None else max(rate, 1.0)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last)
                               * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return max((n - self._tokens) / self.rate, 0.05)


class TenantBuckets:
    """Per-tenant request-rate and write-bandwidth buckets, built
    lazily from the quota policy.  `admit` returns 0.0 or the largest
    Retry-After of the buckets that refused.  Tenants without a
    max_rps/max_mbps rule (and untenanted traffic) pass free."""

    def __init__(self, policy: QuotaPolicy | None = None):
        self.policy = policy or QuotaPolicy()
        self._rps: dict[str, TokenBucket] = {}
        self._bw: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def admit(self, tenant: str, nbytes: int = 0) -> float:
        rule = self.policy.rule_for(tenant)
        if rule is None:
            return 0.0
        retry = 0.0
        if rule.max_rps:
            with self._lock:
                b = self._rps.get(tenant)
                if b is None:
                    b = self._rps[tenant] = TokenBucket(
                        rule.max_rps, burst=max(rule.max_rps, 4.0))
            retry = max(retry, b.try_take(1.0))
        if rule.max_mbps and nbytes > 0:
            rate = rule.max_mbps * (1 << 20)
            with self._lock:
                b = self._bw.get(tenant)
                if b is None:
                    b = self._bw[tenant] = TokenBucket(
                        rate, burst=max(rate, float(nbytes)))
            retry = max(retry, b.try_take(float(nbytes)))
        return retry

    def snapshot(self) -> dict:
        with self._lock:
            return {"rps_tenants": sorted(self._rps),
                    "bw_tenants": sorted(self._bw)}


class _Waiter:
    """One parked admission request.  `event` is set by the lane's
    exit() when a freed slot is handed DIRECTLY to this waiter (the
    semaphore is bypassed); `cancelled` marks a timed-out waiter so the
    scheduler skips its corpse."""

    __slots__ = ("tenant", "event", "cancelled")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.event = threading.Event()
        self.cancelled = False


class DrrQueue:
    """Deficit-round-robin over per-tenant FIFOs.  NOT internally
    locked: the owning lane serializes push/pop/depth under its own
    lock, which also orders handoffs against timeouts."""

    def __init__(self, quantum: float = 1.0,
                 weight_for=None):
        self.quantum = quantum
        self._weight_for = weight_for or (lambda tenant: 1.0)
        # tenant -> FIFO of waiters; insertion order is the DRR ring.
        self._queues: "OrderedDict[str, deque[_Waiter]]" = OrderedDict()
        self._deficit: dict[str, float] = {}
        self._depth = 0

    def push(self, tenant: str) -> _Waiter:
        w = _Waiter(tenant)
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._deficit.setdefault(tenant, 0.0)
        q.append(w)
        self._depth += 1
        return w

    def _drop(self, tenant: str) -> None:
        self._queues.pop(tenant, None)
        self._deficit.pop(tenant, None)

    def pop(self) -> _Waiter | None:
        """Next live waiter by DRR, or None when empty.  Each full ring
        rotation adds quantum x weight to every deficit, so a
        fractional-weight tenant is served every few rotations instead
        of never."""
        while self._queues:
            tenant, q = next(iter(self._queues.items()))
            while q and q[0].cancelled:
                q.popleft()
                self._depth -= 1
            if not q:
                self._drop(tenant)
                continue
            if self._deficit[tenant] < 1.0:
                self._deficit[tenant] += \
                    self.quantum * self._weight_for(tenant)
                if self._deficit[tenant] < 1.0:
                    self._queues.move_to_end(tenant)  # rotate the ring
                    continue
            self._deficit[tenant] -= 1.0
            w = q.popleft()
            self._depth -= 1
            if not q:
                self._drop(tenant)
            elif self._deficit[tenant] < 1.0:
                # Deficit spent: rotate the ring.  While deficit
                # remains, the tenant stays at the front and the next
                # pop serves it again — that consecutive-serve run is
                # what makes weight=4 worth 4x, not just a different
                # refill rate.
                self._queues.move_to_end(tenant)
            return w
        return None

    def discard(self, w: _Waiter) -> None:
        """Timed-out waiter: mark it so pop() skips the corpse (the
        caller already holds the lane lock)."""
        w.cancelled = True

    def __len__(self) -> int:
        return self._depth

    def tenants(self) -> dict[str, int]:
        return {t: sum(1 for w in q if not w.cancelled)
                for t, q in self._queues.items()}
