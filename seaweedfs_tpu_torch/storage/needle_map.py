"""MemDb: the sorted key -> entry map `.ecx` files are built from
(weed/storage/needle_map/memdb.go).  The live needle maps of a mounted
volume wait for the storage-engine slice."""

from __future__ import annotations

import io

from ..core import idx as idx_mod
from ..core import types as t


class MemDb:
    """Sorted key -> entry map used for .ecx generation."""

    def __init__(self):
        self._m: dict[int, tuple[int, int]] = {}

    def set(self, key: int, offset: int, size: int) -> None:
        self._m[key] = (offset, size)

    def delete(self, key: int) -> None:
        self._m.pop(key, None)

    def get(self, key: int) -> tuple[int, int] | None:
        return self._m.get(key)

    def ascending_visit(self, fn) -> None:
        for key in sorted(self._m):
            off, size = self._m[key]
            fn(t.NeedleMapEntry(key, off, size))

    @classmethod
    def from_idx(cls, readable) -> "MemDb":
        """Load .idx applying deletions (readNeedleMap, ec_encoder.go:289)."""
        db = cls()
        for e in idx_mod.iter_index(readable):
            if e.offset > 0 and e.size != t.TOMBSTONE_FILE_SIZE:
                db.set(e.key, e.offset, e.size)
            else:
                db.delete(e.key)
        return db

    def to_sorted_bytes(self) -> bytes:
        """Serialize ascending — the exact .ecx payload."""
        out = io.BytesIO()
        self.ascending_visit(lambda e: out.write(e.to_bytes()))
        return out.getvalue()
