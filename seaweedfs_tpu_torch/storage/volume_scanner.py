"""Sequential `.dat` scanner — powers vacuum, `fix` (idx regeneration),
export, and integrity checking (weed/storage/volume_backup.go:247-262
VolumeFileScanner4GenIdx, volume_checking.go)."""

from __future__ import annotations

import os
from typing import Iterator

from ..core import types as t
from ..core.needle import Needle, needle_body_length
from ..core.super_block import SUPER_BLOCK_SIZE, SuperBlock


def scan_volume_file(dat_path: str, check_crc: bool = False,
                     start_offset: int | None = None,
                     ) -> Iterator[tuple[Needle, int, int]]:
    """Yield (needle, offset, total_record_size) for every record in a .dat.

    Tombstone markers (size == 0 records) are yielded too — callers decide.
    Stops cleanly at EOF or a truncated trailing record.
    """
    with open(dat_path, "rb") as f:
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE + 64 * 1024))
        version = sb.version
        offset = start_offset if start_offset is not None else sb.block_size()
        size = os.fstat(f.fileno()).st_size
        while offset + t.NEEDLE_HEADER_SIZE <= size:
            header = os.pread(f.fileno(), t.NEEDLE_HEADER_SIZE, offset)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                return
            n = Needle.parse_header(header)
            if n.size < 0:
                return  # corrupt size: stop like the Go scanner
            body_len = needle_body_length(n.size, version)
            total = t.NEEDLE_HEADER_SIZE + body_len
            if offset + total > size:
                return  # truncated tail
            blob = header + os.pread(f.fileno(), body_len, offset +
                                     t.NEEDLE_HEADER_SIZE)
            needle = Needle.from_bytes(blob, version, check_crc=check_crc)
            yield needle, offset, total
            offset += total


def scan_data_tail(dat_path: str, start_offset: int | None = None,
                   check_crc: bool = False,
                   ) -> tuple[list[tuple[int, int, int]], int]:
    """Tolerant tail scan for crash recovery (storage/scrub.py):
    returns ([(needle_id, offset, size), ...], data_end) for every
    COMPLETE, parseable record from `start_offset` on, stopping — but
    not raising — at the first truncated or malformed record.
    `data_end` is the byte offset just past the last good record: a
    .dat longer than that carries a torn tail to truncate."""
    sb = read_super_block(dat_path)
    start = start_offset if start_offset is not None else sb.block_size()
    entries: list[tuple[int, int, int]] = []
    data_end = start
    gen = scan_volume_file(dat_path, check_crc=check_crc,
                           start_offset=start)
    while True:
        try:
            needle, offset, total = next(gen)
        except StopIteration:
            break
        except (ValueError, OSError):
            break  # malformed record: everything past it is garbage
        entries.append((needle.id, offset, needle.size))
        data_end = offset + total
    return entries, data_end


def read_super_block(dat_path: str) -> SuperBlock:
    with open(dat_path, "rb") as f:
        return SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE + 64 * 1024))


def generate_idx_from_dat(dat_path: str, idx_path: str) -> int:
    """`weed fix`: rebuild the .idx by scanning the .dat. Returns #entries."""
    from ..core import idx as idx_mod
    count = 0
    with open(idx_path, "wb") as out:
        for needle, offset, _total in scan_volume_file(dat_path):
            if needle.size > 0:
                idx_mod.append_entry(out, needle.id, offset, needle.size)
            else:
                idx_mod.append_entry(out, needle.id, 0,
                                     t.TOMBSTONE_FILE_SIZE)
            count += 1
    return count
