"""Meta cache: local entry cache kept fresh by the filer's meta stream.

Reference: weed/filesys/meta_cache/ — a local store of filer entries
(leveldb there, dict here) populated on first directory visit and
invalidated/updated by SubscribeMetadata events
(meta_cache_subscribe.go), so repeated lookups/getattrs don't hit the
filer.
"""

from __future__ import annotations

import threading

from ..filer.client import FilerProxy
from ..filer.filer import MetaEvent


class MetaCache:
    def __init__(self, filer_url: str, poll_interval: float = 0.25):
        self.proxy = FilerProxy(filer_url)
        self.poll_interval = poll_interval
        self._entries: dict[str, dict | None] = {}  # path -> entry dict
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._offset = 0
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._offset = self.proxy.meta_info()["last_ns"]
        self._thread = threading.Thread(
            target=self._subscribe_loop, daemon=True, name="meta-cache")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    # -- reads ---------------------------------------------------------------

    def lookup(self, path: str) -> dict | None:
        """Entry dict for path, or None if it does not exist.  Negative
        results are cached too (shells stat nonexistent paths a lot)."""
        with self._lock:
            if path in self._entries:
                return self._entries[path]
        entry = self.proxy.meta(path)
        with self._lock:
            # A subscription event that landed during the fetch is newer
            # than what we just read — never clobber it with the stale
            # fetch result.
            if path in self._entries:
                return self._entries[path]
            self._entries[path] = entry
        return entry

    def list_dir(self, path: str) -> list[dict]:
        """Summaries of a directory's children, caching each entry."""
        entries = self.proxy.list_all(path)
        with self._lock:
            for e in entries:
                # Listing summaries lack chunks; cache name+type only
                # and let lookup() fill in full entries on demand.
                p = e["FullPath"]
                if p not in self._entries or \
                        self._entries[p] is None:
                    self._entries.pop(p, None)
        return entries

    # -- invalidation --------------------------------------------------------

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._entries.pop(path, None)

    def upsert(self, path: str, entry: dict | None) -> None:
        with self._lock:
            self._entries[path] = entry

    def _subscribe_loop(self) -> None:
        """Tail the filer's meta stream; apply each event to the cache
        (meta_cache_subscribe.go)."""
        while not self._stop.is_set():
            try:
                out = self.proxy.meta_events(since_ns=self._offset)
                for d in out.get("events", []):
                    ev = MetaEvent.from_dict(d)
                    old_p = ev.old_entry.path if ev.old_entry else None
                    new_p = ev.new_entry.path if ev.new_entry else None
                    with self._lock:
                        if old_p and old_p != new_p:
                            self._entries[old_p] = None
                        if new_p:
                            self._entries[new_p] = \
                                ev.new_entry.to_dict()
                self._offset = out.get("last_ns", self._offset)
            except Exception:  # noqa: BLE001 — filer hiccup; retry
                pass
            self._stop.wait(self.poll_interval)
