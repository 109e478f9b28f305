"""Incremental volume backup / tail.

weed/storage/volume_backup.go — `BinarySearchByAppendAtNs`
(:170) locates the cut offset of the first needle appended after a
timestamp by binary-searching the `.idx` entries (each probe reads that
needle's appendAtNs from the `.dat`), and `IncrementalBackup` (:65)
streams everything after the cut to a following copy.  The volume
server exposes this as the VolumeTail RPCs; `weed backup` consumes it.

The delta wire format is simply the raw `.dat` byte range after the cut
offset: appends are strictly time-ordered in an append-only volume, and
tombstones are needles too, so replaying the range reproduces state.
"""

from __future__ import annotations

import os

from ..core import types as t
from ..core.needle import Needle, needle_body_length
from .volume import Volume, VolumeError
from .volume_scanner import scan_volume_file


def _append_at_ns_at(volume: Volume, offset: int) -> int:
    """appendAtNs of the needle record starting at `offset`."""
    header = volume.pread(t.NEEDLE_HEADER_SIZE, offset)
    n = Needle.parse_header(header)
    body_len = needle_body_length(n.size, volume.version)
    blob = header + volume.pread(body_len,
                                 offset + t.NEEDLE_HEADER_SIZE)
    return Needle.from_bytes(blob, volume.version).append_at_ns


def _record_total(volume: Volume, offset: int) -> int:
    header = volume.pread(t.NEEDLE_HEADER_SIZE, offset)
    n = Needle.parse_header(header)
    return t.NEEDLE_HEADER_SIZE + needle_body_length(n.size,
                                                     volume.version)


def binary_search_by_append_at_ns(volume: Volume,
                                  since_ns: int) -> int:
    """Smallest .dat offset whose record (live OR tombstone) has
    append_at_ns > since_ns (BinarySearchByAppendAtNs); returns the
    volume's end offset when nothing is newer.

    Live-needle offsets (time-ordered in an append-only volume) drive
    the binary search; the gap before the found entry — which holds
    tombstones and overwritten needles invisible to the live map — is
    then walked forward so a delete is never cut out of the delta
    (deleted needles must not resurrect in backups)."""
    entries = volume.nm.ordered_offsets()
    lo, hi = 0, len(entries)
    while lo < hi:
        mid = (lo + hi) // 2
        if _append_at_ns_at(volume, entries[mid]) > since_ns:
            hi = mid
        else:
            lo = mid + 1
    # Scan from the end of the previous live record (or the volume
    # head) across the non-live gap.
    if lo == 0:
        scan_from = volume.super_block.block_size()
    else:
        prev = entries[lo - 1]
        scan_from = prev + _record_total(volume, prev)
    end = volume.dat_size()
    offset = scan_from
    while offset + t.NEEDLE_HEADER_SIZE <= end:
        if _append_at_ns_at(volume, offset) > since_ns:
            return offset
        offset += _record_total(volume, offset)
    return end


def read_incremental(volume: Volume, since_ns: int,
                     max_bytes: int = 64 * 1024 * 1024) -> bytes:
    """Raw .dat bytes for every record appended after since_ns (capped;
    callers loop with the last returned needle's timestamp)."""
    start = binary_search_by_append_at_ns(volume, since_ns)
    end = min(volume.dat_size(), start + max_bytes)
    if start >= end:
        return b""
    # Never split a trailing record: walk records within the window.
    out_end = start
    offset = start
    while offset + t.NEEDLE_HEADER_SIZE <= end:
        header = volume.pread(t.NEEDLE_HEADER_SIZE, offset)
        n = Needle.parse_header(header)
        total = t.NEEDLE_HEADER_SIZE + needle_body_length(
            n.size, volume.version)
        if offset + total > end:
            break
        offset += total
        out_end = offset
    return volume.pread(out_end - start, start)


def last_append_in_blob(delta: bytes, version: int) -> int:
    """Newest appendAtNs inside a delta blob (resume cursor)."""
    last = 0
    offset = 0
    while offset + t.NEEDLE_HEADER_SIZE <= len(delta):
        header = delta[offset:offset + t.NEEDLE_HEADER_SIZE]
        n = Needle.parse_header(header)
        total = t.NEEDLE_HEADER_SIZE + needle_body_length(
            n.size, version)
        if offset + total > len(delta):
            break
        needle = Needle.from_bytes(delta[offset:offset + total],
                                   version)
        last = max(last, needle.append_at_ns)
        offset += total
    return last


def last_append_at_ns(dat_path: str,
                      idx_path: str | None = None) -> int:
    """Newest appendAtNs in a local .dat — the backup's resume point.

    O(1) fast path (SeaweedFS derives the cursor from the idx
    tail): read .idx entries from the end, pread the first live one's
    needle.  A tombstone-only tail or missing .idx falls back to a full
    .dat scan."""
    from ..core import idx as idx_mod
    idx_path = idx_path or dat_path[:-4] + ".idx"
    try:
        from .volume_scanner import read_super_block
        version = read_super_block(dat_path).version
        entry_size = idx_mod.ENTRY_SIZE
        size = os.path.getsize(idx_path)
        with open(idx_path, "rb") as idx, open(dat_path, "rb") as dat:
            pos = size - (size % entry_size)
            # Walk back a bounded number of entries looking for a live
            # one (tombstones carry offset 0, no dat record to probe).
            for _ in range(64):
                pos -= entry_size
                if pos < 0:
                    break
                idx.seek(pos)
                e = t.NeedleMapEntry.from_bytes(idx.read(entry_size), 0)
                if e.offset <= 0 or not t.size_is_valid(e.size):
                    continue
                # Walk from the last live needle to EOF: trailing
                # tombstones are newer, and missing them would make
                # every incremental run re-fetch them.
                dat_size = os.fstat(dat.fileno()).st_size
                last = 0
                offset = e.offset
                while offset + t.NEEDLE_HEADER_SIZE <= dat_size:
                    header = os.pread(dat.fileno(),
                                      t.NEEDLE_HEADER_SIZE, offset)
                    n = Needle.parse_header(header)
                    body_len = needle_body_length(n.size, version)
                    if offset + t.NEEDLE_HEADER_SIZE + body_len > \
                            dat_size:
                        break
                    blob = header + os.pread(
                        dat.fileno(), body_len,
                        offset + t.NEEDLE_HEADER_SIZE)
                    last = max(last, Needle.from_bytes(
                        blob, version).append_at_ns)
                    offset += t.NEEDLE_HEADER_SIZE + body_len
                return last
    except (OSError, ValueError):
        pass
    last = 0
    for needle, _off, _total in scan_volume_file(dat_path):
        if needle.append_at_ns > last:
            last = needle.append_at_ns
    return last


def apply_incremental(dat_path: str, idx_path: str,
                      delta: bytes, version: int) -> int:
    """Append a delta blob to a local backup copy, updating the .idx
    (IncrementalBackup's receiving half).  Returns needles applied."""
    from ..core import idx as idx_mod
    applied = 0
    with open(dat_path, "r+b") as dat, open(idx_path, "ab") as idx:
        dat.seek(0, os.SEEK_END)
        base = dat.tell()
        dat.write(delta)
        dat.flush()
        offset = 0
        while offset + t.NEEDLE_HEADER_SIZE <= len(delta):
            header = delta[offset:offset + t.NEEDLE_HEADER_SIZE]
            n = Needle.parse_header(header)
            total = t.NEEDLE_HEADER_SIZE + needle_body_length(
                n.size, version)
            if offset + total > len(delta):
                raise VolumeError("truncated incremental delta")
            if n.size > 0:
                idx_mod.append_entry(idx, n.id, base + offset, n.size)
            else:  # tombstone
                idx_mod.append_entry(idx, n.id, 0,
                                     t.TOMBSTONE_FILE_SIZE)
            offset += total
            applied += 1
        idx.flush()
    return applied
