"""Small-file packing: group-commit sub-threshold uploads into shared
needles.

A needle costs a master assign round-trip, an index entry, and disk
metadata — for a 2KB file the overhead dwarfs the payload, and a
million tiny objects cost a million needles.  The packer batches
concurrent small uploads per (collection, ttl, replication): each file
appends its bytes to the open pack and waits; when the pack reaches
`max_bytes` or `linger` seconds elapse it is uploaded as ONE needle,
and every waiter gets a FileChunk pointing at the same fid with its
own [sub_offset, sub_offset+size) window (the reference's
"super-large-file / small file packing" direction; chunk subranges
ride filer.proto-style sparse fields so old entries are unaffected).

Consequences, by design:

- Deletes of a packed file remove only filer metadata — the shared
  needle must survive for its siblings (`Filer` skips packed fids in
  chunk GC).  Space comes back when the pack's TTL expires or the
  collection is dropped; size-bounded packs keep the stranded-bytes
  cost of a deleted sibling small.
- A TTL pack holds only files of the SAME ttl, so whole-needle expiry
  (vacuum / volume retire) is correct for every file in it.
- Cipher-enabled filers skip packing (per-file keys need per-file
  needles).

Packing is OFF by default (`-filer.pack.threshold=0`); enabling it is
a per-filer deployment choice.
"""

from __future__ import annotations

import hashlib
import threading
import time

from ..stats import metrics as _metrics
from .entry import FileChunk


class _Pack:
    __slots__ = ("key", "buf", "count", "done", "fid", "error",
                 "sealed", "timer")

    def __init__(self, key: tuple):
        self.key = key
        self.buf = bytearray()
        self.count = 0
        self.done = threading.Event()
        self.fid = ""
        self.error: Exception | None = None
        self.sealed = False
        self.timer: threading.Timer | None = None


class SmallFilePacker:
    """Group-commit packer for sub-threshold filer uploads."""

    def __init__(self, client, threshold: int = 0,
                 max_bytes: int = 1 << 20, linger: float = 0.008):
        self.client = client
        self.threshold = int(threshold)
        self.max_bytes = int(max_bytes)
        self.linger = float(linger)
        self._lock = threading.Lock()
        self._open: dict[tuple, _Pack] = {}

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def add(self, data: bytes, collection: str = "",
            replication: str | None = None,
            ttl: str = "") -> FileChunk | None:
        """Pack `data` into a shared needle; returns its FileChunk, or
        None when the payload is ineligible or the pack upload failed
        (caller falls back to a plain per-file upload)."""
        if not self.enabled or not data or len(data) > self.threshold:
            return None
        key = (collection, ttl, replication or "")
        flush_now = None
        with self._lock:
            pack = self._open.get(key)
            if pack is None:
                pack = _Pack(key)
                self._open[key] = pack
                pack.timer = threading.Timer(
                    self.linger, self._flush, (pack,))
                pack.timer.daemon = True
                pack.timer.start()
            sub_offset = len(pack.buf)
            pack.buf += data
            pack.count += 1
            if len(pack.buf) >= self.max_bytes:
                flush_now = pack
        if flush_now is not None:
            self._flush(flush_now)
        elif not pack.done.wait(max(5.0, self.linger * 100 + 5.0)):
            # Wedged flush (dead master/volume behind the upload):
            # don't hang the request — fall back to a plain upload.
            return None
        if pack.error is not None or not pack.fid:
            return None
        _metrics.filer_packed_files_total.inc()
        _metrics.filer_packed_bytes_total.inc(len(data))
        return FileChunk(
            file_id=pack.fid, offset=0, size=len(data),
            mtime=time.time_ns(),
            etag=hashlib.md5(data).hexdigest(),
            sub_offset=sub_offset, packed=True)

    def _flush(self, pack: _Pack) -> None:
        with self._lock:
            if pack.sealed:
                return
            pack.sealed = True
            if self._open.get(pack.key) is pack:
                del self._open[pack.key]
            if pack.timer is not None:
                pack.timer.cancel()
            payload = bytes(pack.buf)
        collection, ttl, replication = pack.key
        try:
            # One needle for the whole pack.  Never needle-gzipped:
            # sibling reads slice the pack at arbitrary offsets, which
            # a compressed needle cannot serve (same rule as chunks).
            r = self.client.upload(payload, collection=collection,
                                   replication=replication or None,
                                   ttl=ttl, compress=False)
            pack.fid = r["fid"]
            _metrics.filer_packed_needles_total.inc()
        except Exception as e:  # noqa: BLE001 — waiters fall back
            pack.error = e
        pack.done.set()

    def flush_all(self) -> None:
        """Flush every open pack now (shutdown / test hook)."""
        with self._lock:
            packs = list(self._open.values())
        for p in packs:
            self._flush(p)
