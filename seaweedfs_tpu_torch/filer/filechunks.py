"""Chunk algebra: overlapping writes -> non-overlapping visible intervals.

Reference: weed/filer/filechunks.go — `NonOverlappingVisibleIntervals`
(:55-115), `ViewFromVisibleIntervals`, `CompactFileChunks`, `TotalSize`,
`ETag`.  A file is an ordered list of chunks; later-mtime chunks overwrite
older byte ranges.  Reads resolve the chunk list into disjoint visible
intervals, then into per-chunk read views.  Pure functions, heavily
property-tested (the reference's filechunks_test.go model).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .entry import FileChunk


@dataclass
class VisibleInterval:
    """A [start, stop) byte range served by one chunk."""
    start: int
    stop: int
    file_id: str
    mtime: int
    chunk_offset: int  # offset of `start` within the chunk's data

    def size(self) -> int:
        return self.stop - self.start


@dataclass
class ChunkView:
    """One read instruction: bytes [offset_in_chunk, +size) of file_id
    land at logical_offset in the file."""
    file_id: str
    offset_in_chunk: int
    size: int
    logical_offset: int


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def etag(chunks: list[FileChunk]) -> str:
    """ETag of the whole file (filechunks.go ETag): single chunk keeps its
    own; multi-chunk files get the md5-of-etags multipart form."""
    if len(chunks) == 1:
        return chunks[0].etag
    h = hashlib.md5()
    for c in chunks:
        h.update(c.etag.encode())
    return f"{h.hexdigest()}-{len(chunks)}"


def _merge_into_visibles(visibles: list[VisibleInterval],
                         chunk: FileChunk) -> list[VisibleInterval]:
    """Overlay one (newer) chunk onto the visible set
    (MergeIntoVisibles, filechunks.go:187-221)."""
    new = VisibleInterval(chunk.offset, chunk.offset + chunk.size,
                          chunk.file_id, chunk.mtime, 0)
    if not visibles or visibles[-1].stop <= new.start:
        visibles.append(new)  # append fast path (sequential writes)
        return visibles
    out: list[VisibleInterval] = []
    for v in visibles:
        if v.stop <= new.start or new.stop <= v.start:
            out.append(v)  # no overlap: keep whole
            continue
        if v.start < new.start:  # left remnant of the older chunk
            out.append(VisibleInterval(
                v.start, new.start, v.file_id, v.mtime, v.chunk_offset))
        if new.stop < v.stop:  # right remnant
            out.append(VisibleInterval(
                new.stop, v.stop, v.file_id, v.mtime,
                v.chunk_offset + (new.stop - v.start)))
    out.append(new)
    out.sort(key=lambda v: v.start)
    return out


def non_overlapping_visible_intervals(
        chunks: list[FileChunk]) -> list[VisibleInterval]:
    """Resolve a chunk list into disjoint visible intervals; later mtime
    wins (NonOverlappingVisibleIntervals, filechunks.go:223)."""
    visibles: list[VisibleInterval] = []
    for c in sorted(chunks, key=lambda c: (c.mtime, c.file_id)):
        visibles = _merge_into_visibles(visibles, c)
    return visibles


def read_chunk_views(chunks: list[FileChunk], offset: int,
                     size: int) -> list[ChunkView]:
    """Plan the reads for byte range [offset, offset+size)
    (ViewFromChunks / ViewFromVisibleIntervals)."""
    visibles = non_overlapping_visible_intervals(chunks)
    return views_from_visibles(visibles, offset, size)


def views_from_visibles(visibles: list[VisibleInterval], offset: int,
                        size: int) -> list[ChunkView]:
    stop = offset + size
    views = []
    for v in visibles:
        lo = max(v.start, offset)
        hi = min(v.stop, stop)
        if lo >= hi:
            continue
        views.append(ChunkView(
            file_id=v.file_id,
            offset_in_chunk=v.chunk_offset + (lo - v.start),
            size=hi - lo,
            logical_offset=lo))
    return views


def compact_file_chunks(chunks: list[FileChunk]
                        ) -> tuple[list[FileChunk], list[FileChunk]]:
    """Split chunks into (still-visible, fully-overwritten-garbage)
    (CompactFileChunks, filechunks.go:26-42)."""
    visibles = non_overlapping_visible_intervals(chunks)
    used = {v.file_id for v in visibles}
    compacted = [c for c in chunks if c.file_id in used]
    garbage = [c for c in chunks if c.file_id not in used]
    return compacted, garbage


def minus_chunks(a: list[FileChunk], b: list[FileChunk]) -> list[FileChunk]:
    """Chunks in a but not b, by file id (MinusChunks) — the delta an
    entry update must garbage-collect."""
    keep = {c.file_id for c in b}
    return [c for c in a if c.file_id not in keep]
