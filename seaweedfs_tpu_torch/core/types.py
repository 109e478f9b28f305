"""Fixed-width storage types: needle ids, offsets, sizes, cookies.

Byte-layout compatible with SeaweedFS (all big-endian):
- NeedleId: 8 bytes (weed/storage/types/needle_id_type.go)
- Offset:   4 bytes, stored in units of NEEDLE_PADDING_SIZE (8) =>
            32GB max volume (weed/storage/types/offset_4bytes.go)
- Size:     4 bytes signed; -1 is the tombstone
            (weed/storage/types/needle_types.go:15-22,39)
- Cookie:   4 bytes random, guards against guessed ids
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


def set_offset_flavor(nbytes: int) -> None:
    """Select the offset width, the analog of SeaweedFS's
    5BytesOffset BUILD flavor (weed/storage/types/offset_5bytes.go:9-16
    vs offset_4bytes.go — a compile tag there, a process-wide config
    here, set before any volume is opened).

    4 bytes: 32GB max volume (the default).  5 bytes: the stored form
    grows to 4 big-endian low bytes + 1 high byte (SeaweedFS's b4),
    widening `.idx`/`.ecx` records to 17 bytes and raising the cap to
    8TB.  Like SeaweedFS's build flavors, the two layouts are not
    cross-readable — pick one per deployment.
    """
    global OFFSET_SIZE, NEEDLE_MAP_ENTRY_SIZE, MAX_POSSIBLE_VOLUME_SIZE
    if nbytes not in (4, 5):
        raise ValueError(f"offset flavor must be 4 or 5, got {nbytes}")
    OFFSET_SIZE = nbytes
    NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE
    MAX_POSSIBLE_VOLUME_SIZE = (
        4 * 1024 * 1024 * 1024 * 8 * (256 if nbytes == 5 else 1))


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


# -- scalar codecs (big-endian, like weed/util/bytes.go) --------------------

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_U16 = struct.Struct(">H")


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
    """Actual byte offset (multiple of 8) -> stored form.

    4-byte flavor: big-endian u32 of the /8 units.  5-byte flavor:
    the same 4 bytes followed by the high byte (bits 32-39 of the
    units) — offset_5bytes.go OffsetToBytes puts b4 LAST."""
    units = actual_offset // NEEDLE_PADDING_SIZE
    if OFFSET_SIZE == 4:
        return put_uint32(units)
    return put_uint32(units & 0xFFFFFFFF) + bytes(((units >> 32) & 0xFF,))


def offset_from_bytes(b: bytes, off: int = 0) -> int:
    """Stored form -> actual byte offset."""
    units = get_uint32(b, off)
    if OFFSET_SIZE == 5:
        units |= b[off + 4] << 32
    return units * NEEDLE_PADDING_SIZE


def offset_is_zero(actual_offset: int) -> bool:
    return actual_offset == 0


# -- Size: int32, may be negative (tombstone) -------------------------------

_I32 = struct.Struct(">i")


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


# -- public file ids: "vid,needleIdHexCookieHex" ----------------------------


def format_file_id(volume_id: int, key: int, cookie: int) -> str:
    """Matches needle.Needle.String(): trimmed hex key + 8-hex cookie."""
    key_hex = f"{key:x}"
    if key == 0:
        key_hex = "0"
    return f"{volume_id},{key_hex}{cookie:08x}"


def parse_file_id(fid: str) -> tuple[int, int, int]:
    """'3,01637037d6' -> (volume_id, key, cookie).

    Mirrors ParseNeedleIdCookie (weed/storage/needle/needle.go:144-161):
    the last 8 hex chars are the cookie, the rest is the id.
    """
    comma = fid.find(",")
    if comma < 0:
        raise ValueError(f"invalid file id {fid!r}: missing comma")
    volume_id = int(fid[:comma])
    key_cookie = fid[comma + 1:]
    if len(key_cookie) <= 8:
        raise ValueError(f"invalid file id {fid!r}: key+cookie too short")
    key = int(key_cookie[:-8], 16)
    cookie = int(key_cookie[-8:], 16)
    return volume_id, key, cookie
