"""Needle maps: needle id -> (offset, size) with live counters.

SeaweedFS offers several NeedleMapper implementations
(weed/storage/needle_map.go:12-36); this module mirrors that menu with
memory-profiles fitting each volume state:

- `CompactNeedleMap` (default): bounded-memory mapper holding the index
  as sorted numpy column arrays (16 bytes/entry — the same density as
  the `.idx` file itself) with a small dict overflow merged in batches.
  This is the Go `CompactMap`'s sectioned-sorted-arrays design
  (weed/storage/needle_map/compact_map.go:173-218) in its natural numpy
  form: one big sorted section + batch merges, vectorized load.
- `MemoryNeedleMap`: plain dict (O(1) puts, ~10x the RAM); the small-
  volume / test mapper.
- `SortedFileNeedleMap`: O(1)-RAM mapper for read-only volumes that
  binary-searches a sorted index file (`.sdx`) on disk per lookup
  (weed/storage/needle_map_sorted_file.go).
- `MemDb`: sorted map used to build `.ecx` files
  (weed/storage/needle_map/memdb.go).

All mappers write-through appends to the `.idx` journal like
SeaweedFS's baseNeedleMapper.
"""

from __future__ import annotations

import io
import os
import threading
from dataclasses import dataclass, field

import numpy as np

from ..core import idx as idx_mod
from ..core import types as t

# The on-disk .idx record, vectorizable: big-endian u64 key, then the
# offset in /8 units (u32, or u32-low + u1-high for the 5-byte/8TB
# flavor), then i32 size.  Resolved per call so set_offset_flavor()
# takes effect.
_IDX_DTYPE_4 = np.dtype([("key", ">u8"), ("offset", ">u4"),
                         ("size", ">i4")])
_IDX_DTYPE_5 = np.dtype([("key", ">u8"), ("offset", ">u4"),
                         ("off_hi", "u1"), ("size", ">i4")])


def _idx_dtype() -> np.dtype:
    return _IDX_DTYPE_4 if t.OFFSET_SIZE == 4 else _IDX_DTYPE_5


def _units_col(arr: np.ndarray) -> np.ndarray:
    """Offset column in /8 units as uint64, either flavor."""
    units = arr["offset"].astype(np.uint64)
    if "off_hi" in (arr.dtype.names or ()):
        units |= arr["off_hi"].astype(np.uint64) << 32
    return units


def _off_np_dtype():
    """In-memory width for stored offset units: u32 suffices for the
    4-byte flavor; the 8TB flavor needs 40 bits."""
    return np.uint32 if t.OFFSET_SIZE == 4 else np.uint64


def _keep_last_live(arr: np.ndarray) -> np.ndarray:
    """Vectorized .idx replay: the LAST occurrence per key decides its
    fate; returns the live selection ascending by key.  (np.unique
    returns the FIRST index, so scan the reversed key array.)"""
    keys = arr["key"].astype(np.uint64)
    _uniq, idx_rev = np.unique(keys[::-1], return_index=True)
    last = len(keys) - 1 - idx_rev  # ascending-key order
    sel = arr[last]
    live = (_units_col(sel) > 0) & \
           (sel["size"].astype(np.int32) > 0)
    return sel[live]


@dataclass
class MapMetrics:
    file_count: int = 0
    deletion_count: int = 0
    file_byte_count: int = 0
    deletion_byte_count: int = 0
    maximum_file_key: int = 0


def idx_crash_state(idx_path: str
                    ) -> tuple[tuple[int, int] | None, set[int]]:
    """One pass over an .idx for crash recovery (shared by
    verify_idx_against_dat and storage/scrub.recover_volume_files):

    - truncates a partial trailing entry (kill -9 mid-append), or every
      later append would land misaligned and garble the journal;
    - returns ((offset_bytes, size) of the write entry furthest into
      the .dat — the point up to which the index vouches for data —
      or None, and the set of keys whose LAST entry is a tombstone,
      so a tail scan can tell an unjournaled delete marker from one
      the index already knows about).
    """
    if not os.path.exists(idx_path):
        return None, set()
    isize = os.path.getsize(idx_path)
    usable = isize - isize % idx_mod.ENTRY_SIZE
    if usable != isize:
        with open(idx_path, "r+b") as f:
            f.truncate(usable)
    if usable == 0:
        return None, set()
    with open(idx_path, "rb") as f:
        raw = f.read(usable)
    arr = np.frombuffer(raw, dtype=_idx_dtype())
    offs = _units_col(arr) * t.NEEDLE_PADDING_SIZE
    writes = (offs > 0) & (arr["size"].astype(np.int32) > 0)
    furthest = None
    if writes.any():
        i = int(np.argmax(np.where(writes, offs, 0)))
        furthest = (int(offs[i]), int(arr["size"][i]))
    # Keys whose final entry is a delete (keep-LAST semantics).
    keys = arr["key"].astype(np.uint64)
    _uniq, idx_rev = np.unique(keys[::-1], return_index=True)
    last = len(keys) - 1 - idx_rev
    dead_sel = ~writes[last]
    dead = {int(k) for k in keys[last][dead_sel]}
    return furthest, dead


def verify_idx_against_dat(idx_path: str, dat_path: str | None) -> None:
    """Crash-staleness gate run before an .idx is trusted
    (volume_checking.go's CheckVolumeDataIntegrity direction): a
    partial trailing entry is truncated away, and an index whose
    furthest entry points past the .dat's EOF is lying about data that
    no longer exists — regenerate it from the .dat (scanner-based
    `weed fix`) instead of silently trusting it."""
    if not dat_path or not os.path.exists(idx_path) \
            or not os.path.exists(dat_path):
        return
    furthest, _dead = idx_crash_state(idx_path)
    if furthest is None:
        return
    from ..core.needle import get_actual_size
    from .volume_scanner import generate_idx_from_dat, read_super_block
    end = furthest[0] + get_actual_size(
        furthest[1], read_super_block(dat_path).version)
    if end > os.path.getsize(dat_path):
        generate_idx_from_dat(dat_path, idx_path)


class MemoryNeedleMap:
    """NeedleMapper: dict index + write-through append to the .idx file."""

    def __init__(self, idx_file=None):
        self._m: dict[int, tuple[int, int]] = {}
        self.metrics = MapMetrics()
        self._idx_file = idx_file

    @classmethod
    def load(cls, idx_path: str,
             dat_path: str | None = None) -> "MemoryNeedleMap":
        """Rebuild the map from an existing .idx (LoadNewNeedleMap).
        With `dat_path`, the idx tail is first verified against the
        .dat (partial entries truncated, beyond-EOF indexes
        regenerated by the scanner) instead of trusted blindly."""
        verify_idx_against_dat(idx_path, dat_path)
        f = open(idx_path, "a+b")
        f.seek(0)
        nm = cls(idx_file=f)
        for e in idx_mod.iter_index(f):
            nm.metrics.maximum_file_key = max(nm.metrics.maximum_file_key,
                                              e.key)
            if e.offset > 0 and t.size_is_valid(e.size):
                prev = nm._m.get(e.key)
                if prev is not None:
                    nm.metrics.deletion_count += 1
                    nm.metrics.deletion_byte_count += prev[1]
                else:
                    nm.metrics.file_count += 1
                nm.metrics.file_byte_count += e.size
                nm._m[e.key] = (e.offset, e.size)
            else:
                prev = nm._m.pop(e.key, None)
                if prev is not None:
                    nm.metrics.deletion_count += 1
                    nm.metrics.deletion_byte_count += prev[1]
        f.seek(0, os.SEEK_END)
        return nm

    def put(self, key: int, offset: int, size: int) -> None:
        prev = self._m.get(key)
        if prev is not None:
            self.metrics.deletion_count += 1
            self.metrics.deletion_byte_count += prev[1]
        else:
            self.metrics.file_count += 1
        self.metrics.file_byte_count += size
        self.metrics.maximum_file_key = max(self.metrics.maximum_file_key, key)
        self._m[key] = (offset, size)
        if self._idx_file is not None:
            idx_mod.append_entry(self._idx_file, key, offset, size)

    def get(self, key: int) -> tuple[int, int] | None:
        return self._m.get(key)

    def delete(self, key: int) -> int:
        """Returns freed bytes; writes a tombstone idx entry."""
        prev = self._m.pop(key, None)
        if prev is None:
            return 0
        self.metrics.deletion_count += 1
        self.metrics.deletion_byte_count += prev[1]
        if self._idx_file is not None:
            idx_mod.append_entry(self._idx_file, key, 0,
                                 t.TOMBSTONE_FILE_SIZE)
        return prev[1]

    def ordered_offsets(self) -> list[int]:
        """Live-needle .dat offsets in append (= offset) order — the
        probe set for BinarySearchByAppendAtNs (append-only volumes are
        time-ordered by offset)."""
        return sorted(off for off, size in self._m.values()
                      if t.size_is_valid(size))

    def ascending_visit(self, fn) -> None:
        for key in sorted(self._m):
            off, size = self._m[key]
            fn(t.NeedleMapEntry(key, off, size))

    def __len__(self) -> int:
        return len(self._m)

    def __contains__(self, key: int) -> bool:
        return key in self._m

    def content_size(self) -> int:
        return self.metrics.file_byte_count

    def deleted_size(self) -> int:
        return self.metrics.deletion_byte_count

    def flush(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()

    def sync(self) -> None:
        """flush + fsync the .idx journal — the durability half of
        Volume.sync (SeaweedFS's commitNeedleMap path)."""
        if self._idx_file is not None:
            self._idx_file.flush()
            os.fsync(self._idx_file.fileno())

    def close(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()
            self._idx_file.close()
            self._idx_file = None


class CompactNeedleMap:
    """Bounded-memory NeedleMapper (see module docstring).

    Base state: three sorted-by-key numpy arrays holding only LIVE
    entries (raw u32 offsets — 16 bytes/entry total).  Mutations land in
    a dict overflow (tombstones as size=TOMBSTONE) and merge into the
    arrays every OVERFLOW_MERGE updates, so a long-lived writable volume
    stays within the same memory envelope as its .idx file.
    """

    OVERFLOW_MERGE = 16384

    def __init__(self, idx_file=None):
        self._keys = np.empty(0, np.uint64)
        self._offs = np.empty(0, _off_np_dtype())  # /8 units
        self._sizes = np.empty(0, np.int32)
        self._overflow: dict[int, tuple[int, int]] = {}
        self._live = 0
        self.metrics = MapMetrics()
        self._idx_file = idx_file
        # The dict map this replaced was GIL-atomic; sorted-array swaps in
        # _merge() are not.  Vacuum's lock-free get()s and the tail path's
        # ordered_offsets() run concurrently with the write worker, so every
        # public method takes this lock (RLock: put/delete call get).
        self._lock = threading.RLock()

    @classmethod
    def load(cls, idx_path: str,
             dat_path: str | None = None) -> "CompactNeedleMap":
        """Vectorized .idx replay: keep-last per key, drop dead keys.

        Replaces SeaweedFS's per-entry walk (needle_map_memory.go)
        with one numpy pass — the load-time analog of batching onto the
        vector unit.  With `dat_path`, a crash-stale idx (partial tail
        entry, entries past the .dat EOF) is repaired/regenerated
        first — see verify_idx_against_dat."""
        verify_idx_against_dat(idx_path, dat_path)
        f = open(idx_path, "a+b")
        f.seek(0)
        raw = f.read()
        f.seek(0, os.SEEK_END)
        nm = cls(idx_file=f)
        usable = len(raw) - len(raw) % idx_mod.ENTRY_SIZE
        arr = np.frombuffer(raw[:usable], dtype=_idx_dtype())
        if len(arr) == 0:
            return nm
        offs = _units_col(arr)
        sizes = arr["size"].astype(np.int32)
        nm.metrics.maximum_file_key = int(arr["key"].astype(np.uint64).max())
        live_sel = _keep_last_live(arr)
        nm._keys = live_sel["key"].astype(np.uint64)
        nm._offs = _units_col(live_sel).astype(_off_np_dtype())
        nm._sizes = live_sel["size"].astype(np.int32)
        nm._live = len(live_sel)
        writes = (offs > 0) & (sizes > 0)
        write_bytes = int(sizes[writes].sum())
        live_bytes = int(nm._sizes.sum())
        nm.metrics.file_count = nm._live
        nm.metrics.file_byte_count = write_bytes
        nm.metrics.deletion_count = int(writes.sum()) - nm._live
        nm.metrics.deletion_byte_count = write_bytes - live_bytes
        return nm

    # -- lookups -------------------------------------------------------------

    def _base_get(self, key: int) -> tuple[int, int] | None:
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i < len(self._keys) and int(self._keys[i]) == key:
            return (int(self._offs[i]) * t.NEEDLE_PADDING_SIZE,
                    int(self._sizes[i]))
        return None

    def get(self, key: int) -> tuple[int, int] | None:
        with self._lock:
            hit = self._overflow.get(key)
            if hit is not None:
                return None if hit[1] == t.TOMBSTONE_FILE_SIZE else hit
            return self._base_get(key)

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return self._live

    # -- mutations -----------------------------------------------------------

    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            prev = self.get(key)
            if prev is not None:
                self.metrics.deletion_count += 1
                self.metrics.deletion_byte_count += prev[1]
            else:
                self.metrics.file_count += 1
                self._live += 1
            self.metrics.file_byte_count += size
            self.metrics.maximum_file_key = max(
                self.metrics.maximum_file_key, key)
            self._overflow[key] = (offset, size)
            if self._idx_file is not None:
                idx_mod.append_entry(self._idx_file, key, offset, size)
            if len(self._overflow) >= self.OVERFLOW_MERGE:
                self._merge()

    def delete(self, key: int) -> int:
        with self._lock:
            prev = self.get(key)
            if prev is None:
                return 0
            self.metrics.deletion_count += 1
            self.metrics.deletion_byte_count += prev[1]
            self._live -= 1
            self._overflow[key] = (0, t.TOMBSTONE_FILE_SIZE)
            if self._idx_file is not None:
                idx_mod.append_entry(self._idx_file, key, 0,
                                     t.TOMBSTONE_FILE_SIZE)
            if len(self._overflow) >= self.OVERFLOW_MERGE:
                self._merge()
            return prev[1]

    def _merge(self) -> None:
        """Fold the overflow into the sorted base arrays (caller holds
        self._lock)."""
        if not self._overflow:
            return
        items = sorted(self._overflow.items())
        okeys = np.array([k for k, _ in items], np.uint64)
        ooffs = np.array([v[0] // t.NEEDLE_PADDING_SIZE for _, v in items],
                         _off_np_dtype())
        osizes = np.array([v[1] for _, v in items], np.int32)
        keep = ~np.isin(self._keys, okeys, assume_unique=True)
        olive = osizes > 0
        new_keys = np.concatenate([self._keys[keep], okeys[olive]])
        new_offs = np.concatenate([self._offs[keep], ooffs[olive]])
        new_sizes = np.concatenate([self._sizes[keep], osizes[olive]])
        order = np.argsort(new_keys, kind="stable")
        self._keys = new_keys[order]
        self._offs = new_offs[order]
        self._sizes = new_sizes[order]
        self._overflow.clear()

    # -- iteration / stats ---------------------------------------------------

    def ordered_offsets(self):
        """Live-needle .dat offsets in append (= offset) order — the
        probe set for BinarySearchByAppendAtNs."""
        with self._lock:
            self._merge()
            return np.sort(self._offs).astype(np.int64) * \
                t.NEEDLE_PADDING_SIZE

    def ascending_visit(self, fn) -> None:
        with self._lock:
            self._merge()
            keys = self._keys
            offs = self._offs
            sizes = self._sizes
        pad = t.NEEDLE_PADDING_SIZE
        for i in range(len(keys)):
            fn(t.NeedleMapEntry(int(keys[i]), int(offs[i]) * pad,
                                int(sizes[i])))

    def content_size(self) -> int:
        return self.metrics.file_byte_count

    def deleted_size(self) -> int:
        return self.metrics.deletion_byte_count

    def index_memory_bytes(self) -> int:
        """Resident bytes held by the index arrays (diagnostics/tests)."""
        return (self._keys.nbytes + self._offs.nbytes +
                self._sizes.nbytes)

    def flush(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()

    def sync(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()
            os.fsync(self._idx_file.fileno())

    def close(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()
            self._idx_file.close()
            self._idx_file = None


class SortedFileNeedleMap:
    """O(1)-RAM mapper for read-only volumes: every lookup binary-
    searches a by-key-sorted index file (`.sdx`) with preads — nothing
    but metrics lives in memory
    (weed/storage/needle_map_sorted_file.go)."""

    def __init__(self, sdx_path: str):
        self._f = open(sdx_path, "rb")
        self._path = sdx_path
        size = os.fstat(self._f.fileno()).st_size
        self._n = size // idx_mod.ENTRY_SIZE
        self.metrics = MapMetrics()
        self._live = 0
        # One bounded streaming pass for the counters.
        self._f.seek(0)
        while True:
            chunk = self._f.read(idx_mod.ENTRY_SIZE * 65536)
            if not chunk:
                break
            arr = np.frombuffer(
                chunk[:len(chunk) - len(chunk) % idx_mod.ENTRY_SIZE],
                dtype=_idx_dtype())
            sizes = arr["size"].astype(np.int64)
            live = sizes > 0
            self._live += int(live.sum())
            self.metrics.file_byte_count += int(sizes[live].sum())
            if len(arr):
                self.metrics.maximum_file_key = max(
                    self.metrics.maximum_file_key,
                    int(arr["key"].astype(np.uint64).max()))
        self.metrics.file_count = self._live

    @staticmethod
    def generate(idx_path: str, sdx_path: str) -> None:
        """Sort an .idx into the .sdx this map searches
        (WriteSortedFileFromIdx for volumes).

        One numpy pass over the raw records — 16 bytes/entry transient,
        never a Python dict — so generating on a huge volume's idx stays
        within the memory envelope the mapper itself promises."""
        with open(idx_path, "rb") as f:
            raw = f.read()
        usable = len(raw) - len(raw) % idx_mod.ENTRY_SIZE
        arr = np.frombuffer(raw[:usable], dtype=_idx_dtype())
        payload = _keep_last_live(arr).tobytes() if len(arr) else b""
        tmp = sdx_path + ".tmp"
        with open(tmp, "wb") as out:
            out.write(payload)
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, sdx_path)
        # Change-detector sidecar: .idx files are append-only, so the
        # source byte length is an exact staleness signal where mtime
        # granularity is not.
        with open(sdx_path + ".src", "w") as meta:
            meta.write(str(usable))

    @classmethod
    def load(cls, idx_path: str) -> "SortedFileNeedleMap":
        """Open, regenerating the .sdx when missing or stale.  Staleness
        checks the recorded source .idx length (append-only ⇒ exact),
        not mtime, so an append landing within mtime granularity still
        triggers regeneration."""
        sdx = idx_path[:-4] + ".sdx" if idx_path.endswith(".idx") \
            else idx_path + ".sdx"
        stale = not os.path.exists(sdx)
        if not stale and os.path.exists(idx_path):
            try:
                with open(sdx + ".src") as meta:
                    recorded = int(meta.read().strip())
            except (OSError, ValueError):
                recorded = -1
            cur = os.path.getsize(idx_path)
            stale = recorded != cur - cur % idx_mod.ENTRY_SIZE
        if stale:
            cls.generate(idx_path, sdx)
        return cls(sdx)

    def _entry_at(self, i: int) -> t.NeedleMapEntry:
        raw = os.pread(self._f.fileno(), idx_mod.ENTRY_SIZE,
                       i * idx_mod.ENTRY_SIZE)
        return t.NeedleMapEntry.from_bytes(raw)

    def get(self, key: int) -> tuple[int, int] | None:
        lo, hi = 0, self._n - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            e = self._entry_at(mid)
            if e.key == key:
                if e.offset > 0 and t.size_is_valid(e.size):
                    return (e.offset, e.size)
                return None
            if e.key < key:
                lo = mid + 1
            else:
                hi = mid - 1
        return None

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return self._live

    def put(self, key: int, offset: int, size: int) -> None:
        raise RuntimeError("sorted-file needle map is read-only")

    def delete(self, key: int) -> int:
        raise RuntimeError("sorted-file needle map is read-only")

    def ordered_offsets(self):
        offs: list[int] = []
        self.ascending_visit(
            lambda e: offs.append(e.offset)
            if t.size_is_valid(e.size) else None)
        return np.sort(np.array(offs, np.int64))

    def ascending_visit(self, fn) -> None:
        self._f.seek(0)
        for e in idx_mod.iter_index(self._f):
            fn(e)

    def content_size(self) -> int:
        return self.metrics.file_byte_count

    def deleted_size(self) -> int:
        return self.metrics.deletion_byte_count

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        pass  # the .sdx is immutable once generated

    def close(self) -> None:
        self._f.close()


NEEDLE_MAP_KINDS = ("compact", "memory", "sorted_file")


def new_needle_map(kind: str, idx_path: str,
                   dat_path: str | None = None):
    """NeedleMapType selection (needle_map.go:12-36).  `dat_path`
    enables the crash-staleness gate (verify_idx_against_dat)."""
    if kind == "compact":
        return CompactNeedleMap.load(idx_path, dat_path)
    if kind == "memory":
        return MemoryNeedleMap.load(idx_path, dat_path)
    if kind == "sorted_file":
        return SortedFileNeedleMap.load(idx_path)
    raise ValueError(f"unknown needle map kind {kind!r}")


class MemDb:
    """Sorted key -> entry map used for .ecx generation and offline tools."""

    def __init__(self):
        self._m: dict[int, tuple[int, int]] = {}

    def set(self, key: int, offset: int, size: int) -> None:
        self._m[key] = (offset, size)

    def delete(self, key: int) -> None:
        self._m.pop(key, None)

    def get(self, key: int) -> tuple[int, int] | None:
        return self._m.get(key)

    def ascending_visit(self, fn) -> None:
        for key in sorted(self._m):
            off, size = self._m[key]
            fn(t.NeedleMapEntry(key, off, size))

    @classmethod
    def from_idx(cls, readable) -> "MemDb":
        """Load .idx applying deletions (readNeedleMap, ec_encoder.go:289)."""
        db = cls()
        for e in idx_mod.iter_index(readable):
            if e.offset > 0 and e.size != t.TOMBSTONE_FILE_SIZE:
                db.set(e.key, e.offset, e.size)
            else:
                db.delete(e.key)
        return db

    def to_sorted_bytes(self) -> bytes:
        """Serialize ascending — the exact .ecx payload."""
        out = io.BytesIO()
        self.ascending_visit(lambda e: out.write(e.to_bytes()))
        return out.getvalue()
