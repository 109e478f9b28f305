"""Dirty-page interval buffering for mounted file writes.

Reference: weed/filesys/dirty_page_interval.go — writes land in an
ordered list of non-overlapping intervals; a new write splits/overwrites
whatever it covers (newest wins); contiguous intervals merge so flush
uploads few large chunks instead of many small ones.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class _Interval:
    offset: int
    data: bytearray

    @property
    def end(self) -> int:
        return self.offset + len(self.data)


class ContinuousIntervals:
    """Ordered, non-overlapping, auto-merging write buffer."""

    def __init__(self) -> None:
        self.intervals: list[_Interval] = []

    def total_size(self) -> int:
        return sum(len(iv.data) for iv in self.intervals)

    def add(self, offset: int, data: bytes) -> None:
        if not data:
            return
        new = _Interval(offset, bytearray(data))
        out: list[_Interval] = []
        for iv in self.intervals:
            if iv.end <= new.offset or iv.offset >= new.end:
                out.append(iv)  # disjoint
                continue
            # Keep the non-overlapped head/tail of the older interval.
            if iv.offset < new.offset:
                out.append(_Interval(
                    iv.offset, iv.data[:new.offset - iv.offset]))
            if iv.end > new.end:
                out.append(_Interval(
                    new.end, iv.data[new.end - iv.offset:]))
        out.append(new)
        out.sort(key=lambda iv: iv.offset)
        # Merge adjacency so flush produces few large chunks.
        merged: list[_Interval] = []
        for iv in out:
            if merged and merged[-1].end == iv.offset:
                merged[-1].data.extend(iv.data)
            else:
                merged.append(iv)
        self.intervals = merged

    def read(self, offset: int, size: int) -> list[tuple[int, bytes]]:
        """Buffered byte ranges overlapping [offset, offset+size):
        (absolute offset, bytes) pairs for overlaying onto chunk reads."""
        out = []
        end = offset + size
        for iv in self.intervals:
            lo = max(offset, iv.offset)
            hi = min(end, iv.end)
            if lo < hi:
                out.append((lo, bytes(
                    iv.data[lo - iv.offset:hi - iv.offset])))
        return out

    def pop_all(self) -> list[tuple[int, bytes]]:
        out = [(iv.offset, bytes(iv.data)) for iv in self.intervals]
        self.intervals = []
        return out

    def max_end(self) -> int:
        return self.intervals[-1].end if self.intervals else 0
