"""`.idx` file walker/writer: 16-byte (key, offset, size) entries.

weed/storage/idx/walk.go.  The same record encodes `.ecx` sorted indexes
(weed/storage/erasure_coding/ec_encoder.go:27-54).
"""

from __future__ import annotations

import io
from typing import Iterator

from . import types as t

ROWS_TO_READ = 1024


def __getattr__(name):
    # ENTRY_SIZE tracks the configured offset flavor (16 bytes for
    # 4-byte offsets, 17 for the 5-byte/8TB flavor) — resolved at
    # access time so set_offset_flavor() takes effect everywhere.
    if name == "ENTRY_SIZE":
        return t.NEEDLE_MAP_ENTRY_SIZE
    raise AttributeError(name)


def iter_index(readable) -> Iterator[t.NeedleMapEntry]:
    """Yield entries from a binary file object or bytes."""
    if isinstance(readable, (bytes, bytearray, memoryview)):
        readable = io.BytesIO(readable)
    entry_size = t.NEEDLE_MAP_ENTRY_SIZE
    while True:
        chunk = readable.read(entry_size * ROWS_TO_READ)
        if not chunk:
            return
        usable = len(chunk) - (len(chunk) % entry_size)
        for off in range(0, usable, entry_size):
            yield t.NeedleMapEntry.from_bytes(chunk, off)
        if usable != len(chunk):
            return  # trailing partial entry: stop like the Go walker


def append_entry(writable, key: int, actual_offset: int, size: int) -> None:
    writable.write(t.NeedleMapEntry(key, actual_offset, size).to_bytes())
