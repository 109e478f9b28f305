"""MetaAggregator: unified metadata change stream across filer peers.

Reference: weed/filer/meta_aggregator.go:31-151 — in a multi-filer
deployment every filer subscribes to each peer's *local* meta log and
merges the per-peer streams into one aggregated feed, so any single
filer can serve a cluster-wide SubscribeMetadata.

Each peer is tailed over the filer's LONG-LIVED PUSH STREAM
(``/.meta/subscribe?tail=true`` — the SubscribeLocalMetadata gRPC
stream analog): events arrive the moment they commit on the peer, no
polling; `reconnect_interval` only paces redials after a peer drops.
Per-peer resume offsets survive reconnects; merged events are
delivered to local subscribers tagged with the originating peer URL.
"""

from __future__ import annotations

import threading
from typing import Callable

from .client import FilerProxy
from .filer import MetaEvent


class MetaAggregator:
    def __init__(self, peers: list[str], reconnect_interval: float = 1.0,
                 self_signature: int = 0,
                 poll_interval: float | None = None):
        self.peers = [p.rstrip("/") for p in peers]
        # poll_interval kept as a deprecated alias (pre-push-stream
        # callers tuned it); it now paces reconnects only.
        self.reconnect_interval = poll_interval \
            if poll_interval is not None else reconnect_interval
        self.self_signature = self_signature
        self._offsets: dict[str, int] = {p: 0 for p in self.peers}
        self._subscribers: list[Callable[[str, MetaEvent], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._streams: dict[str, object] = {}

    def subscribe(self, fn: Callable[[str, MetaEvent], None]) -> None:
        """fn(peer_url, event) on every aggregated mutation."""
        with self._lock:
            self._subscribers.append(fn)

    def start(self, since_ns: int = 0) -> None:
        for p in self.peers:
            self._offsets[p] = since_ns
            t = threading.Thread(target=self._tail_peer, args=(p,),
                                 daemon=True,
                                 name=f"meta-aggregator-{p}")
            t.start()
            self._threads.append(t)

    def _tail_peer(self, peer: str) -> None:
        proxy = FilerProxy(peer)
        while not self._stop.is_set():
            try:
                resp, events = proxy.meta_stream(
                    since_ns=self._offsets[peer],
                    exclude_signature=self.self_signature,
                    stop_event=self._stop)
                self._streams[peer] = resp
                for d in events:
                    if self._stop.is_set():
                        break
                    if d.get("_cursor_only"):
                        self._offsets[peer] = d["ts_ns"]
                        continue
                    ev = MetaEvent.from_dict(d)
                    with self._lock:
                        subs = list(self._subscribers)
                    for fn in subs:
                        try:
                            fn(peer, ev)
                        except Exception:  # noqa: BLE001 — a bad
                            pass           # subscriber can't stall peers
                    self._offsets[peer] = ev.ts_ns
            except Exception:  # noqa: BLE001 — peer down; redial
                pass
            finally:
                self._streams.pop(peer, None)
            self._stop.wait(self.reconnect_interval)

    def drain(self, timeout: float = 5.0) -> None:
        """Testing aid: wait until every peer tail is caught up to the
        peer's current last_ns."""
        import time
        deadline = time.monotonic() + timeout
        for p in self.peers:
            proxy = FilerProxy(p)
            target = proxy.meta_info()["last_ns"]
            while self._offsets[p] < target and \
                    time.monotonic() < deadline:
                time.sleep(0.05)

    def stop(self) -> None:
        self._stop.set()
        # Closing the live responses unblocks threads waiting on the
        # wire immediately (heartbeats alone would take seconds).
        for resp in list(self._streams.values()):
            try:
                resp.close()
            except Exception:  # noqa: BLE001
                pass
        for t in self._threads:
            t.join(timeout=2)


class ShardMetaAggregator:
    """Cluster-wide metadata stream over the SHARDED filer fleet.

    Where MetaAggregator tails fixed peers by local timestamp, this
    tails each shard's journal by (shard, seq) — exact, replicated
    cursors that survive a primary failover: when a tail drops, the
    shard map is re-fetched from the master and the stream resumes on
    the promoted primary at the same seq (the new primary serves the
    same numbering the old one acked; unacked suffixes were unwound
    by rejoin repair, so nothing the cursor saw can disappear).

    Subscribers get fn(shard, seq, record) for every journaled
    logical op (set / del / ren) in order per shard."""

    def __init__(self, master_url: str | list[str],
                 reconnect_interval: float = 1.0):
        from .client import ShardedFilerClient
        self.client = ShardedFilerClient(master_url)
        self.reconnect_interval = reconnect_interval
        self.cursors: dict[int, int] = {}
        self._subscribers: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def subscribe(self, fn) -> None:
        """fn(shard, seq, record) on every aggregated journal record."""
        with self._lock:
            self._subscribers.append(fn)

    def start(self, cursors: dict | None = None) -> None:
        self.cursors = {int(k): int(v)
                        for k, v in (cursors or {}).items()}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="shard-meta-aggregator")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                recs, self.cursors = self.client.poll_events(
                    self.cursors)
            except Exception:  # noqa: BLE001 — master/primaries down:
                recs = []      # back off and re-resolve next round
            with self._lock:
                subs = list(self._subscribers)
            for r in recs:
                for fn in subs:
                    try:
                        fn(r["shard"], r["seq"], r["record"])
                    except Exception:  # noqa: BLE001 — a bad
                        pass           # subscriber can't stall the tail
            # Poll pacing: an empty round sleeps; a full page loops
            # immediately to drain the backlog.
            if not recs:
                self._stop.wait(self.reconnect_interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
