"""Volume superblock: the 8-byte header of every `.dat` file.

Reference: weed/storage/super_block/super_block.go:12-31.
Byte 0 version, byte 1 replica placement, bytes 2-3 TTL, bytes 4-5
compaction revision, bytes 6-7 length of an optional protobuf extra.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import types as t
from .needle import CURRENT_VERSION
from .replica_placement import ReplicaPlacement
from .ttl import TTL

SUPER_BLOCK_SIZE = 8


@dataclass
class SuperBlock:
    version: int = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    compaction_revision: int = 0
    extra: bytes = b""  # serialized SuperBlockExtra protobuf, if any

    def block_size(self) -> int:
        if self.version >= 2 and self.extra:
            return SUPER_BLOCK_SIZE + len(self.extra)
        return SUPER_BLOCK_SIZE

    def to_bytes(self) -> bytes:
        header = bytearray(SUPER_BLOCK_SIZE)
        header[0] = self.version
        header[1] = self.replica_placement.to_byte()
        header[2:4] = self.ttl.to_bytes()
        header[4:6] = t.put_uint16(self.compaction_revision)
        if self.extra:
            if len(self.extra) > 256 * 256 - 2:
                raise ValueError("super block extra too large")
            header[6:8] = t.put_uint16(len(self.extra))
            return bytes(header) + self.extra
        return bytes(header)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("superblock too short")
        version = b[0]
        if not 1 <= version <= 3:
            raise ValueError(f"unsupported superblock version {version}")
        sb = cls(
            version=version,
            replica_placement=ReplicaPlacement.from_byte(b[1]),
            ttl=TTL.from_bytes(b[2:4]),
            compaction_revision=t.get_uint16(b, 4),
        )
        extra_size = t.get_uint16(b, 6)
        if extra_size:
            sb.extra = bytes(b[SUPER_BLOCK_SIZE:SUPER_BLOCK_SIZE + extra_size])
        return sb
