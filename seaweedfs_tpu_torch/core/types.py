"""Fixed-width storage types: needle ids, offsets, sizes, cookies.

Byte-layout compatible with SeaweedFS (all big-endian):
- NeedleId: 8 bytes (weed/storage/types/needle_id_type.go)
- Offset:   4 bytes, stored in units of NEEDLE_PADDING_SIZE (8) =>
            32GB max volume (weed/storage/types/offset_4bytes.go)
- Size:     4 bytes signed; -1 is the tombstone
            (weed/storage/types/needle_types.go:15-22,39)
- Cookie:   4 bytes random, guards against guessed ids

Only the 4-byte offset layout is carried here; the 5-byte (8TB) flavor
waits for the storage-engine slice.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4
SIZE_SIZE = 4
COOKIE_SIZE = 4
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
NEEDLE_CHECKSUM_SIZE = 4

TOMBSTONE_FILE_SIZE = -1  # Size(-1)

MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32GB (4-byte offsets)


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


# -- scalar codecs (big-endian, like weed/util/bytes.go) --------------------

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_U16 = struct.Struct(">H")
_I32 = struct.Struct(">i")


def put_uint64(v: int) -> bytes:
    return _U64.pack(v & 0xFFFFFFFFFFFFFFFF)


def get_uint64(b: bytes, off: int = 0) -> int:
    return _U64.unpack_from(b, off)[0]


def put_uint32(v: int) -> bytes:
    return _U32.pack(v & 0xFFFFFFFF)


def get_uint32(b: bytes, off: int = 0) -> int:
    return _U32.unpack_from(b, off)[0]


def put_uint16(v: int) -> bytes:
    return _U16.pack(v & 0xFFFF)


def get_uint16(b: bytes, off: int = 0) -> int:
    return _U16.unpack_from(b, off)[0]


# -- Offset: stored /8, 4 bytes ---------------------------------------------


def offset_to_bytes(actual_offset: int) -> bytes:
    """Actual byte offset (multiple of 8) -> big-endian u32 of /8 units."""
    return put_uint32(actual_offset // NEEDLE_PADDING_SIZE)


def offset_from_bytes(b: bytes, off: int = 0) -> int:
    """Stored form -> actual byte offset."""
    return get_uint32(b, off) * NEEDLE_PADDING_SIZE


# -- Size: int32, may be negative (tombstone) -------------------------------


def size_to_bytes(size: int) -> bytes:
    return _I32.pack(size)


def size_from_bytes(b: bytes, off: int = 0) -> int:
    return _I32.unpack_from(b, off)[0]


# -- Needle map entry (the 16-byte .idx / .ecx record) ----------------------


@dataclass(frozen=True)
class NeedleMapEntry:
    key: int          # needle id
    offset: int       # actual byte offset in .dat (already *8)
    size: int         # payload Size (int32; -1 = tombstone)

    def to_bytes(self) -> bytes:
        return put_uint64(self.key) + offset_to_bytes(self.offset) + \
            size_to_bytes(self.size)

    @classmethod
    def from_bytes(cls, b: bytes, off: int = 0) -> "NeedleMapEntry":
        return cls(key=get_uint64(b, off),
                   offset=offset_from_bytes(b, off + NEEDLE_ID_SIZE),
                   size=size_from_bytes(b, off + NEEDLE_ID_SIZE + OFFSET_SIZE))
