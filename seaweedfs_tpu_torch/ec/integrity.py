"""Shard-level integrity sidecar: per-block CRC32-C checksums (`.ecc`).

Needle records carry their own CRC, but an EC shard file is opaque
striped bytes — a flipped bit in a parity shard corrupts nothing a
needle read would ever check until a rebuild silently propagates it.
The `.ecc` sidecar closes that gap: one CRC32-C per `BLOCK`-sized block
of each shard file, computed from the bytes the encoder *intended* to
write (before they hit the disk), so anything that diverges later is
detectable without reading any other shard.

Format (JSON, atomic tmp+rename like the other sidecars):

    {"block": 1048576, "shards": {"0": ["9ae1f203", ...], ...}}
"""

from __future__ import annotations

import json
import os
import threading

from . import SMALL_BLOCK_SIZE
from ..core.crc import crc32c
from ..stats.contention import MeteredLock

# Sidecar updates are load-modify-save: every writer must serialize per
# volume base or concurrent savers lose each other's entries.  Metered
# (stats/contention.py) under one shared label for every volume's lock,
# SeaweedFS_lock_wait_seconds{lock="integrity.ecc"}, so cardinality
# stays flat.
_ECC_LOCKS: dict[str, MeteredLock] = {}
_ECC_LOCKS_GUARD = threading.Lock()


def ecc_lock(base_file_name: str) -> MeteredLock:
    """The process-wide lock guarding one volume's `.ecc` sidecar."""
    with _ECC_LOCKS_GUARD:
        return _ECC_LOCKS.setdefault(base_file_name,
                                     MeteredLock("integrity.ecc"))


# Checksum granularity: one CRC per small-block row keeps the sidecar
# tiny (8 hex chars per MB) while localizing damage to a single
# reconstructable interval.
BLOCK = SMALL_BLOCK_SIZE

ECC_EXT = ".ecc"


class BlockCrcAccumulator:
    """Streaming per-block CRC32-C: feed() arbitrary write-sized
    buffers, get one CRC per BLOCK bytes out.  Used by the encoder to
    checksum shard bytes as they stream past — no second read pass."""

    def __init__(self, block: int = BLOCK):
        self.block = block
        self._crcs: list[int] = []
        self._cur = 0
        self._fill = 0

    def feed(self, buf: bytes) -> None:
        mv = memoryview(buf)
        while len(mv):
            take = min(self.block - self._fill, len(mv))
            self._cur = crc32c(bytes(mv[:take]), self._cur)
            self._fill += take
            mv = mv[take:]
            if self._fill == self.block:
                self._crcs.append(self._cur)
                self._cur = 0
                self._fill = 0

    def finalize(self) -> list[int]:
        if self._fill:
            self._crcs.append(self._cur)
            self._cur = 0
            self._fill = 0
        return list(self._crcs)


def file_block_crcs(path: str, block: int = BLOCK) -> list[int]:
    """Per-block CRCs of an existing shard file."""
    acc = BlockCrcAccumulator(block)
    with open(path, "rb") as f:
        while True:
            buf = f.read(block)
            if not buf:
                break
            acc.feed(buf)
    return acc.finalize()


class ShardChecksums:
    """The `.ecc` sidecar of one EC volume base name."""

    def __init__(self, base_file_name: str, block: int = BLOCK,
                 shards: dict[int, list[int]] | None = None):
        self.base = base_file_name
        self.block = block
        self.shards: dict[int, list[int]] = shards or {}

    @property
    def path(self) -> str:
        return self.base + ECC_EXT

    @classmethod
    def load(cls, base_file_name: str) -> "ShardChecksums":
        """Load the sidecar; a missing or unparseable file yields an
        empty set."""
        path = base_file_name + ECC_EXT
        try:
            with open(path) as f:
                doc = json.load(f)
            shards = {int(sid): [int(c, 16) for c in crcs]
                      for sid, crcs in doc.get("shards", {}).items()}
            return cls(base_file_name, block=int(doc.get("block", BLOCK)),
                       shards=shards)
        except (OSError, ValueError, KeyError):
            return cls(base_file_name)

    def get(self, sid: int) -> list[int] | None:
        return self.shards.get(sid)

    def set_shard(self, sid: int, crcs: list[int]) -> None:
        self.shards[sid] = list(crcs)

    def save(self) -> None:
        doc = {"block": self.block,
               "shards": {str(sid): [f"{c:08x}" for c in crcs]
                          for sid, crcs in sorted(self.shards.items())}}
        # Unique temp per writer: a crashed writer's stale staging file
        # must never be renamed over by (or collide with) a later one.
        tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        finally:
            try:
                os.remove(tmp)
            except FileNotFoundError:
                pass
