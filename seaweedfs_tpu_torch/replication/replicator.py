"""Replicator: route one meta event to a replication sink.

Reference: weed/replication/replicator.go:17-72 — translate an
EventNotification under a source path prefix into sink
create/update/delete calls, fetching file content from the source
cluster when the sink needs bytes.
"""

from __future__ import annotations

from ..filer.client import FilerProxy
from .sink import ReplicationSink


class Replicator:
    def __init__(self, source_filer_url: str, source_dir: str,
                 sink: ReplicationSink):
        self.source = FilerProxy(source_filer_url)
        self.source_dir = "/" + source_dir.strip("/")
        self.sink = sink

    def _key(self, path: str) -> str | None:
        """Source path -> sink-relative key; None if outside the
        replicated prefix (replicator.go Replicate key check)."""
        root = self.source_dir.rstrip("/")
        if not (path + "/").startswith(root + "/"):
            return None
        return path[len(root):].lstrip("/") or "/"

    def _read(self, entry: dict) -> bytes | None:
        """Current content of the source file, or None if it has since
        vanished (the event is stale; a later delete event follows)."""
        if entry.get("is_directory") or not entry.get("chunks"):
            return b"" if not entry.get("is_directory") else None
        import urllib.error
        try:
            with self.source.get(entry["path"]) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def replicate(self, event: dict) -> bool:
        """Apply one EventNotification dict; True if it hit the sink."""
        old, new = event.get("old_entry"), event.get("new_entry")
        path = (new or old or {}).get("path", "")
        key = self._key(path)
        if key is None or key == "/":
            return False
        if new and not old:
            data = self._read(new)
            if data is None and not new.get("is_directory"):
                return False  # source file already gone; its delete
            self.sink.create_entry(key, new, data)  # event follows
        elif old and not new:
            self.sink.delete_entry(key, old.get("is_directory", False))
        elif old and new:
            if new.get("is_directory"):
                # Attribute-only change on a directory: re-create (an
                # idempotent mkdir).  Routing it through update_entry's
                # delete+create would wipe the subtree at the sink.
                self.sink.create_entry(key, new, None)
            else:
                data = self._read(new)
                if data is None:
                    return False  # stale update on a vanished file
                self.sink.update_entry(key, new, data)
        else:
            return False
        return True
