"""Needle record codec — the on-disk object format of a volume `.dat` file.

Byte-exact reimplementation of the reference wire format
(weed/storage/needle/needle.go:24-44, needle_read_write.go:31-120):

Version 1:  [cookie 4][id 8][size 4][data size][checksum 4][padding]
Version 2:  [cookie 4][id 8][size 4][dataSize 4][data][flags 1]
            [nameSize 1 name][mimeSize 1 mime][lastModified 5][ttl 2]
            [pairsSize 2 pairs][checksum 4][padding]
Version 3:  v2 + [appendAtNs 8] before padding.

`size` for v2/v3 is the *body* length (4 + dataSize + 1 + optional
sections); records are padded so the next record starts at a multiple of 8.

Compatibility quirk, reproduced deliberately: the reference builds records
by reusing one 24-byte scratch header, so the padding bytes appended after
the checksum are not zeros — for v2 they are the leading bytes of the
big-endian needle id (scratch[4:12]), for v3 the leading bytes of the
big-endian size field followed by zeros (scratch[12:24]).  Reproducing this
makes our `.dat` files byte-identical to reference-written ones for the
same inputs, which in turn makes EC shard files byte-identical.

Padding is 1..8 bytes (a fully-aligned record still gets 8 — Go's
`NeedlePaddingSize - (x % NeedlePaddingSize)` is 8 when x%8==0).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import crc as crc_mod
from . import types as t
from .ttl import TTL

# cookie(4) + id(8) + size(4), big-endian — the fixed needle header.
_HEADER = struct.Struct(">IQI")

VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED_DATE = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES_LENGTH = 5
TTL_BYTES_LENGTH = 2


def padding_length(needle_size: int, version: int) -> int:
    """1..8 bytes of padding; version 3 includes the 8-byte timestamp."""
    if version == VERSION3:
        return t.NEEDLE_PADDING_SIZE - (
            (t.NEEDLE_HEADER_SIZE + needle_size + t.NEEDLE_CHECKSUM_SIZE +
             t.TIMESTAMP_SIZE) % t.NEEDLE_PADDING_SIZE)
    return t.NEEDLE_PADDING_SIZE - (
        (t.NEEDLE_HEADER_SIZE + needle_size + t.NEEDLE_CHECKSUM_SIZE) %
        t.NEEDLE_PADDING_SIZE)


def needle_body_length(needle_size: int, version: int) -> int:
    if version == VERSION3:
        return (needle_size + t.NEEDLE_CHECKSUM_SIZE + t.TIMESTAMP_SIZE +
                padding_length(needle_size, version))
    return (needle_size + t.NEEDLE_CHECKSUM_SIZE +
            padding_length(needle_size, version))


def get_actual_size(size: int, version: int) -> int:
    """Total on-disk bytes of a record with payload Size `size`."""
    return t.NEEDLE_HEADER_SIZE + needle_body_length(size, version)


@dataclass
class Needle:
    """One stored object.  Field names mirror the reference struct."""

    cookie: int = 0
    id: int = 0
    size: int = 0          # body size (set by encode)

    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""     # serialized extra headers (JSON in reference)
    last_modified: int = 0  # unix seconds, stored as low 5 bytes
    ttl: TTL = field(default_factory=TTL)

    checksum: int = 0      # masked CRC32-C of data (set on encode/decode)
    append_at_ns: int = 0  # v3 only

    # -- flag helpers ------------------------------------------------------

    def has_name(self) -> bool:
        return bool(self.flags & FLAG_HAS_NAME)

    def has_mime(self) -> bool:
        return bool(self.flags & FLAG_HAS_MIME)

    def has_last_modified_date(self) -> bool:
        return bool(self.flags & FLAG_HAS_LAST_MODIFIED_DATE)

    def has_ttl(self) -> bool:
        return bool(self.flags & FLAG_HAS_TTL)

    def has_pairs(self) -> bool:
        return bool(self.flags & FLAG_HAS_PAIRS)

    def is_compressed(self) -> bool:
        return bool(self.flags & FLAG_IS_COMPRESSED)

    def is_chunked_manifest(self) -> bool:
        return bool(self.flags & FLAG_IS_CHUNK_MANIFEST)

    def set_is_compressed(self) -> None:
        self.flags |= FLAG_IS_COMPRESSED

    def set_name(self, name: bytes) -> None:
        self.name = name[:255]
        self.flags |= FLAG_HAS_NAME

    def set_mime(self, mime: bytes) -> None:
        self.mime = mime
        self.flags |= FLAG_HAS_MIME

    def set_last_modified(self, ts: int) -> None:
        self.last_modified = ts
        self.flags |= FLAG_HAS_LAST_MODIFIED_DATE

    def set_ttl(self, ttl: TTL) -> None:
        self.ttl = ttl
        if ttl.count:
            self.flags |= FLAG_HAS_TTL

    def set_pairs(self, pairs: bytes) -> None:
        self.pairs = pairs
        self.flags |= FLAG_HAS_PAIRS

    # -- encode ------------------------------------------------------------

    def _body_size_v2(self) -> int:
        if len(self.data) == 0:
            return 0
        size = 4 + len(self.data) + 1
        if self.has_name():
            size += 1 + min(len(self.name), 255)
        if self.has_mime():
            size += 1 + len(self.mime)
        if self.has_last_modified_date():
            size += LAST_MODIFIED_BYTES_LENGTH
        if self.has_ttl():
            size += TTL_BYTES_LENGTH
        if self.has_pairs():
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = CURRENT_VERSION) -> bytes:
        """prepareWriteBuffer equivalent; sets self.size/self.checksum."""
        self.checksum = crc_mod.needle_checksum(self.data)
        if version == VERSION1:
            self.size = len(self.data)
            out = bytearray()
            out += t.put_uint32(self.cookie)
            out += t.put_uint64(self.id)
            out += t.put_uint32(self.size)
            out += self.data
            out += t.put_uint32(self.checksum)
            # v1 padding quirk: scratch header[4:] after the checksum write
            # still holds id(8)+size(4); padding reads from there.
            pad = padding_length(self.size, version)
            scratch = t.put_uint32(self.checksum) + t.put_uint64(self.id) + \
                t.put_uint32(self.size)
            out += scratch[4:4 + pad]
            return bytes(out)
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")

        self.size = self._body_size_v2()
        # One precompiled pack for the fixed header + join instead of
        # eight helper calls and bytearray growth: to_bytes is the
        # hottest function on the volume write path.
        parts = [_HEADER.pack(self.cookie & 0xFFFFFFFF,
                              self.id & 0xFFFFFFFFFFFFFFFF,
                              self.size & 0xFFFFFFFF)]
        if len(self.data) > 0:
            parts.append(t.put_uint32(len(self.data)))
            parts.append(self.data)
            parts.append(bytes((self.flags & 0xFF,)))
            if self.has_name():
                name = self.name[:255]
                parts.append(bytes((len(name),)))
                parts.append(name)
            if self.has_mime():
                parts.append(bytes((len(self.mime) & 0xFF,)))
                parts.append(self.mime)
            if self.has_last_modified_date():
                parts.append(t.put_uint64(self.last_modified)
                             [8 - LAST_MODIFIED_BYTES_LENGTH:])
            if self.has_ttl():
                parts.append(self.ttl.to_bytes())
            if self.has_pairs():
                parts.append(t.put_uint16(len(self.pairs)))
                parts.append(self.pairs)
        pad = padding_length(self.size, version)
        parts.append(t.put_uint32(self.checksum))
        if version == VERSION2:
            # scratch[4:12] = big-endian id; padding reads from there.
            parts.append(t.put_uint64(self.id)[:pad])
        else:
            parts.append(t.put_uint64(self.append_at_ns))
            # scratch[12:16] = big-endian size, then zeros.
            tail = t.put_uint32(self.size) + bytes(8)
            parts.append(tail[:pad])
        return b"".join(parts)

    # -- decode ------------------------------------------------------------

    @classmethod
    def parse_header(cls, b: bytes, off: int = 0) -> "Needle":
        n = cls()
        n.cookie = t.get_uint32(b, off)
        n.id = t.get_uint64(b, off + t.COOKIE_SIZE)
        n.size = t.size_from_bytes(b, off + t.COOKIE_SIZE + t.NEEDLE_ID_SIZE)
        return n

    def _read_body_v2(self, b: bytes) -> None:
        idx, end = 0, len(b)
        if idx < end:
            data_size = t.get_uint32(b, idx)
            idx += 4
            if data_size + idx > end:
                raise ValueError("needle data_size out of range")
            self.data = b[idx:idx + data_size]
            idx += data_size
            self.flags = b[idx]
            idx += 1
        if idx < end and self.has_name():
            name_size = b[idx]
            idx += 1
            self.name = b[idx:idx + name_size]
            idx += name_size
        if idx < end and self.has_mime():
            mime_size = b[idx]
            idx += 1
            self.mime = b[idx:idx + mime_size]
            idx += mime_size
        if idx < end and self.has_last_modified_date():
            self.last_modified = int.from_bytes(
                b[idx:idx + LAST_MODIFIED_BYTES_LENGTH], "big")
            idx += LAST_MODIFIED_BYTES_LENGTH
        if idx < end and self.has_ttl():
            self.ttl = TTL.from_bytes(b[idx:idx + TTL_BYTES_LENGTH])
            idx += TTL_BYTES_LENGTH
        if idx < end and self.has_pairs():
            pairs_size = t.get_uint16(b, idx)
            idx += 2
            self.pairs = b[idx:idx + pairs_size]
            idx += pairs_size

    @classmethod
    def from_bytes(cls, blob: bytes, version: int = CURRENT_VERSION,
                   check_crc: bool = True) -> "Needle":
        """Parse a full record blob (header + body + padding) — ReadBytes."""
        n = cls.parse_header(blob)
        size = n.size
        if version == VERSION1:
            n.data = blob[t.NEEDLE_HEADER_SIZE:t.NEEDLE_HEADER_SIZE + size]
        elif version in (VERSION2, VERSION3):
            n._read_body_v2(blob[t.NEEDLE_HEADER_SIZE:
                                 t.NEEDLE_HEADER_SIZE + size])
        else:
            raise ValueError(f"unsupported needle version {version}")
        if size > 0:
            stored = t.get_uint32(blob, t.NEEDLE_HEADER_SIZE + size)
            if check_crc:
                actual = crc_mod.needle_checksum(n.data)
                if stored != actual:
                    raise ValueError("CRC error! Data On Disk Corrupted")
                n.checksum = actual
            else:
                n.checksum = stored
        if version == VERSION3:
            ts_off = t.NEEDLE_HEADER_SIZE + size + t.NEEDLE_CHECKSUM_SIZE
            n.append_at_ns = t.get_uint64(blob, ts_off)
        return n

    def disk_size(self, version: int = CURRENT_VERSION) -> int:
        return get_actual_size(self.size, version)
