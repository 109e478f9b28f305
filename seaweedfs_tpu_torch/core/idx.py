"""`.idx` file walker/writer: 16-byte (key, offset, size) entries.

weed/storage/idx/walk.go.  The same record encodes `.ecx` sorted indexes
(weed/storage/erasure_coding/ec_encoder.go:27-54).
"""

from __future__ import annotations

import io
from typing import Iterator

from . import types as t

ROWS_TO_READ = 1024
ENTRY_SIZE = t.NEEDLE_MAP_ENTRY_SIZE


def iter_index(readable) -> Iterator[t.NeedleMapEntry]:
    """Yield entries from a binary file object or bytes."""
    if isinstance(readable, (bytes, bytearray, memoryview)):
        readable = io.BytesIO(readable)
    while True:
        chunk = readable.read(ENTRY_SIZE * ROWS_TO_READ)
        if not chunk:
            return
        usable = len(chunk) - (len(chunk) % ENTRY_SIZE)
        for off in range(0, usable, ENTRY_SIZE):
            yield t.NeedleMapEntry.from_bytes(chunk, off)
        if usable != len(chunk):
            return  # trailing partial entry: stop like the Go walker


def append_entry(writable, key: int, actual_offset: int, size: int) -> None:
    writable.write(t.NeedleMapEntry(key, actual_offset, size).to_bytes())
