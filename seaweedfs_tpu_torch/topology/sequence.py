"""File-id sequencers (weed/sequence/): monotonically increasing needle keys.

MemorySequencer mirrors the reference's default: in-memory counter,
optionally checkpointed to a metadata file in steps of 100 so a restart
never hands out a key twice (sequence.go / memory_sequencer.go).
"""

from __future__ import annotations

import os
import threading

STEP = 100


class MemorySequencer:
    def __init__(self, meta_path: str | None = None):
        self._lock = threading.Lock()
        self.meta_path = meta_path
        self.counter = 1
        self._ceiling = 0
        if meta_path and os.path.exists(meta_path):
            with open(meta_path) as f:
                try:
                    self.counter = int(f.read().strip() or 1)
                except ValueError:
                    self.counter = 1
        self._maybe_checkpoint()

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self.counter
            self.counter += count
            self._maybe_checkpoint()
            return start

    def set_max(self, seen: int) -> None:
        """Raise the counter past ids observed in heartbeats."""
        with self._lock:
            if seen >= self.counter:
                self.counter = seen + 1
                self._maybe_checkpoint()

    def peek(self) -> int:
        with self._lock:
            return self.counter

    def _maybe_checkpoint(self) -> None:
        if self.meta_path and self.counter >= self._ceiling:
            self._ceiling = self.counter + STEP
            tmp = self.meta_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(self._ceiling))
            os.replace(tmp, self.meta_path)


class RaftSequencer:
    """Consensus-replicated block sequencer — the HA analog of the
    reference's etcd sequencer (weed/sequence/etcd_sequencer.go: a
    shared counter advanced in blocks through etcd).  Here the blocks
    ride the master's own raft log: the leader commits a new ceiling
    before handing out ids below it, so after a failover no committed
    id range can ever be handed out again — even before the first heartbeat's
    max_file_key arrives to raise the floor.

    `alloc_fn(min_start, n) -> start` must commit `start + n` as the new
    cluster ceiling (with `start >= min_start`) through consensus and
    return the block start; only the raft leader can succeed.
    """

    BLOCK = 10_000

    def __init__(self, alloc_fn, block: int = BLOCK):
        self._alloc = alloc_fn
        self.block = block
        self._lock = threading.Lock()
        self._alloc_lock = threading.Lock()
        self._lo = 0    # next id to hand out
        self._hi = 0    # end of the committed block (exclusive)
        self._floor = 1  # ids at/below floor-1 are burned (heartbeats)

    def next_file_id(self, count: int = 1) -> int:
        # _lock is only ever held for field flips, NEVER across the
        # consensus call: set_max is called from the heartbeat path
        # while topo._lock is held, and the raft applier needs
        # topo._lock — holding _lock through alloc_fn's barrier would
        # close that loop into a three-way deadlock.
        while True:
            with self._lock:
                if self._lo < self._floor:
                    self._lo = min(self._floor, self._hi)
                if self._lo + count <= self._hi:
                    out = self._lo
                    self._lo += count
                    return out
                floor = max(self._floor, self._lo)
            with self._alloc_lock:  # one allocation in flight
                with self._lock:
                    if self._lo + count <= self._hi:
                        continue  # another thread refilled meanwhile
                n = max(self.block, count)
                start = self._alloc(floor, n)
                with self._lock:
                    self._lo, self._hi = start, start + n
                # Loop: the floor may have risen during the alloc; the
                # re-check clamps before handing anything out.

    def set_max(self, seen: int) -> None:
        """Heartbeat floor (topology.go adopting max_file_key): ids up
        to `seen` exist somewhere in the cluster."""
        with self._lock:
            if seen + 1 > self._floor:
                self._floor = seen + 1

    def peek(self) -> int:
        with self._lock:
            return max(self._lo, self._floor)
