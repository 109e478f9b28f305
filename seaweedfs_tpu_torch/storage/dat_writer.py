"""Append-only `.dat` + `.idx` writer.

Writes the superblock, then each needle record at the next 8-byte
aligned offset, and one `.idx` entry per record — the same bytes
`seaweedfs_tpu.storage.volume.Volume.write_needle` produces for the
same needles.  It is the minimal producer of a volume for the EC path,
with no needle map, lock or recovery pass; the mounted-volume engine
(reads, deletes, vacuum, crash recovery) is storage/volume.py.
"""

from __future__ import annotations

import time

from ..core import idx as idx_mod
from ..core import types as t
from ..core.needle import CURRENT_VERSION, Needle
from ..core.super_block import SuperBlock


class DatWriter:
    """Create `<base>.dat` and `<base>.idx` and append needles to them."""

    def __init__(self, base_file_name: str,
                 super_block: SuperBlock | None = None):
        self.base_file_name = base_file_name
        self.super_block = super_block or SuperBlock(version=CURRENT_VERSION)
        self._dat = open(base_file_name + ".dat", "wb")
        try:
            self._idx = open(base_file_name + ".idx", "wb")
        except OSError:
            self._dat.close()
            raise
        head = self.super_block.to_bytes()
        self._dat.write(head)
        self._append_at = len(head)

    @property
    def version(self) -> int:
        return self.super_block.version

    @property
    def size(self) -> int:
        """Bytes in the .dat so far (where the next record goes)."""
        return self._append_at

    def write_needle(self, n: Needle) -> tuple[int, int]:
        """Append one record. Returns (offset, n.size), as
        Volume.write_needle does."""
        offset = self._append_at
        pad = offset % t.NEEDLE_PADDING_SIZE
        if pad:
            offset += t.NEEDLE_PADDING_SIZE - pad
            self._dat.write(bytes(t.NEEDLE_PADDING_SIZE - pad))
        if offset >= t.MAX_POSSIBLE_VOLUME_SIZE:
            raise ValueError(f"{self.base_file_name}.dat exceeds max size")
        if n.append_at_ns == 0:
            n.append_at_ns = time.time_ns()
        blob = n.to_bytes(self.version)
        self._dat.write(blob)
        idx_mod.append_entry(self._idx, n.id, offset, n.size)
        self._append_at = offset + len(blob)
        return offset, n.size

    def close(self) -> None:
        self._dat.close()
        self._idx.close()

    def __enter__(self) -> "DatWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
