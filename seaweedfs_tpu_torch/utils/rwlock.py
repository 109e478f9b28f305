"""A simple writer-preferring readers-writer lock.

The volume engine's read path (O(1) pread) must run concurrently across
readers while write batches / vacuum file swaps get exclusivity — the same
discipline as the reference's `dataFileAccessLock` RWMutex
(weed/storage/volume.go:36).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from ..stats import contention as _contention
from ..stats import phases as _phases


class RWLock:
    def __init__(self, name: str | None = None):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        # Optional contention metering of the WRITE side (the volume
        # engine names its file lock, stats/contention.py): write
        # wait/hold land in the lock histograms + the request phase
        # ledger.  The read side stays unmetered — concurrent readers
        # are the uncontended common case.  Set post-construction via
        # contention.wrap_rwlock_write too.
        self._meter_name = name
        self._write_since = 0.0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        metered = self._meter_name is not None and _contention.ENABLED
        t0 = None
        with self._cond:
            self._writers_waiting += 1
            if self._writer or self._readers:
                # Contended: measure the wait (only then — the
                # uncontended pass stays condition-check cheap).
                if metered:
                    t0 = time.perf_counter()
                while self._writer or self._readers:
                    self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
            if metered:
                self._write_since = time.perf_counter()
            elif self._meter_name is not None:
                self._write_since = 0.0  # disarmed: no hold to settle
        # Histogram/ledger work happens OUTSIDE the condition: readers
        # and other writers must never queue behind metrics (the same
        # stance as MeteredLock.release observing after the release).
        if t0 is not None:
            wait = self._write_since - t0
            _contention.lock_wait_seconds.observe(
                wait, lock=self._meter_name)
            _phases.note("lock", wait)

    def release_write(self) -> None:
        name = self._meter_name
        if name is not None and _contention.ENABLED and \
                self._write_since:
            hold = time.perf_counter() - self._write_since
            _contention.lock_hold_seconds.observe(hold, lock=name)
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
