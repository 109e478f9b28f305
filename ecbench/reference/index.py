"""The sorted needle index `.ecx` from a volume's `.idx`
(WriteSortedFileFromIdx, readNeedleMap): 16-byte big-endian entries
(key u64, offset u32 in 8-byte units, size u32); an entry with offset 0
or the tombstone size deletes its key, a later entry replaces an
earlier one, and the survivors are written in ascending key order."""

from __future__ import annotations

import numpy as np

ENTRY = np.dtype([("key", ">u8"), ("offset", ">u4"), ("size", ">u4")])
TOMBSTONE = 0xFFFFFFFF


def sorted_index(idx: bytes) -> bytes:
    live: dict[int, tuple[int, int]] = {}
    for key, offset, size in np.frombuffer(idx, dtype=ENTRY).tolist():
        if offset != 0 and size != TOMBSTONE:
            live[key] = (offset, size)
        else:
            live.pop(key, None)
    out = np.array([(k, *live[k]) for k in sorted(live)], dtype=ENTRY)
    return out.tobytes()
