"""Embedded ordered-KV filer store — the build's leveldb analog.

Reference: weed/filer/leveldb/leveldb_store.go (the default embedded
store) and filer/filerstore.go:20-43 (the contract it plugs into).
Rather than binding an external engine, this is a self-contained
log-structured store:

- every mutation appends a CRC-framed record to a write-ahead log
- the full keyspace lives in memory as a sorted index (filer metadata
  is small relative to blob data; the reference's leveldb block cache
  plays the same role)
- when the log's dead weight exceeds the live set, the store writes a
  sorted snapshot (tmp + fsync + atomic rename) and truncates the log
- on open: load the snapshot, then replay the log, stopping cleanly at
  a torn tail (a crashed writer never corrupts reads)

Key layout mirrors leveldb_store.go genKey(dir, name): entries are
keyed ``E<dir>\\x00<name>`` so one directory's children are a
contiguous ordered range — listing is a range scan, not a tree walk.
The filer KV plane rides the same engine under ``K<key>``.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import zlib

from .entry import Entry
from .filerstore import FilerStore, NotFound, _norm

try:
    from sortedcontainers import SortedDict  # type: ignore[import]
except ImportError:  # pragma: no cover — exercised via _BisectDict tests
    SortedDict = None


class _BisectDict:
    """Minimal SortedDict stand-in (dict + bisect-maintained key list)
    so the store works on installs without sortedcontainers."""

    def __init__(self):
        import bisect
        self._bisect = bisect
        self._keys: list[bytes] = []
        self._m: dict[bytes, bytes] = {}

    def __setitem__(self, k, v):
        if k not in self._m:
            self._bisect.insort(self._keys, k)
        self._m[k] = v

    def __getitem__(self, k):
        return self._m[k]

    def get(self, k, default=None):
        return self._m.get(k, default)

    def __contains__(self, k):
        return k in self._m

    def pop(self, k, *default):
        if k in self._m:
            i = self._bisect.bisect_left(self._keys, k)
            del self._keys[i]
        return self._m.pop(k, *default)

    def items(self):
        return ((k, self._m[k]) for k in self._keys)

    def clear(self):
        self._keys.clear()
        self._m.clear()

    def irange(self, lo, hi, inclusive=(True, False)):
        i = self._bisect.bisect_left(self._keys, lo) if inclusive[0] \
            else self._bisect.bisect_right(self._keys, lo)
        j = self._bisect.bisect_right(self._keys, hi) if inclusive[1] \
            else self._bisect.bisect_left(self._keys, hi)
        return iter(self._keys[i:j])

_PUT, _DEL = 1, 2
_HDR = struct.Struct("<II")  # crc32(payload), len(payload)


class OrderedKv:
    """The storage engine: durable ordered byte-string -> bytes map."""

    def __init__(self, directory: str,
                 compact_min_bytes: int = 1 << 20):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.snap_path = os.path.join(directory, "kv.snap")
        self.wal_path = os.path.join(directory, "kv.wal")
        self.compact_min_bytes = compact_min_bytes
        self._m = SortedDict() if SortedDict is not None else _BisectDict()
        self._lock = threading.RLock()
        self._live_bytes = 0
        self._load()
        self._wal = open(self.wal_path, "ab")

    # -- engine API ----------------------------------------------------------

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._append(_PUT, key, value)
            old = self._m.get(key)
            if old is not None:
                self._live_bytes -= len(key) + len(old)
            self._m[key] = value
            self._live_bytes += len(key) + len(value)
            self._maybe_compact()

    def delete(self, key: bytes) -> None:
        with self._lock:
            if key not in self._m:
                return
            self._append(_DEL, key, b"")
            self._live_bytes -= len(key) + len(self._m.pop(key))
            self._maybe_compact()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._m.get(key)

    def scan(self, start: bytes, end: bytes,
             limit: int = -1) -> list[tuple[bytes, bytes]]:
        """Ordered [start, end) range."""
        with self._lock:
            out = []
            for k in self._m.irange(start, end, inclusive=(True, False)):
                out.append((k, self._m[k]))
                if 0 <= limit <= len(out):
                    break
            return out

    def delete_range(self, start: bytes, end: bytes) -> int:
        with self._lock:
            doomed = list(self._m.irange(start, end,
                                         inclusive=(True, False)))
            for k in doomed:
                self._append(_DEL, k, b"")
                self._live_bytes -= len(k) + len(self._m.pop(k))
            self._maybe_compact()
            return len(doomed)

    def close(self) -> None:
        with self._lock:
            if not self._wal.closed:
                self._wal.flush()
                os.fsync(self._wal.fileno())
                self._wal.close()

    # -- log + snapshot machinery -------------------------------------------

    @staticmethod
    def _frame(op: int, key: bytes, value: bytes) -> bytes:
        payload = bytes([op]) + struct.pack("<H", len(key)) + key + value
        return _HDR.pack(zlib.crc32(payload), len(payload)) + payload

    def _append(self, op: int, key: bytes, value: bytes) -> None:
        self._wal.write(self._frame(op, key, value))
        self._wal.flush()

    def _replay_file(self, path: str) -> int:
        """Apply every intact record; returns the offset of the first
        torn/corrupt record (= file size when clean)."""
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return 0
        with f:
            good = 0
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                crc, n = _HDR.unpack(hdr)
                payload = f.read(n)
                if len(payload) < n or zlib.crc32(payload) != crc:
                    break
                op = payload[0]
                klen = struct.unpack("<H", payload[1:3])[0]
                key = payload[3:3 + klen]
                value = payload[3 + klen:]
                if op == _PUT:
                    self._m[key] = value
                elif op == _DEL:
                    self._m.pop(key, None)
                good = f.tell()
            return good

    def _load(self) -> None:
        self._m.clear()
        self._replay_file(self.snap_path)
        good = self._replay_file(self.wal_path)
        if os.path.exists(self.wal_path) and \
                good < os.path.getsize(self.wal_path):
            # Torn tail from a crashed writer: drop it so the next
            # append doesn't interleave with garbage.
            with open(self.wal_path, "r+b") as f:
                f.truncate(good)
        self._live_bytes = sum(len(k) + len(v)
                               for k, v in self._m.items())

    def _maybe_compact(self) -> None:
        wal_bytes = self._wal.tell()
        if wal_bytes < self.compact_min_bytes or \
                wal_bytes < 2 * max(self._live_bytes, 1):
            return
        self.compact()

    def compact(self) -> None:
        """Snapshot the live set (tmp + fsync + rename) and reset the
        log — the vacuum of this store."""
        with self._lock:
            tmp = self.snap_path + ".tmp"
            with open(tmp, "wb") as f:
                for k, v in self._m.items():
                    f.write(self._frame(_PUT, k, v))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            self._wal.close()
            self._wal = open(self.wal_path, "wb")  # truncate
            self._wal.flush()


class OrderedKvStore(FilerStore):
    """FilerStore over OrderedKv (leveldb_store.go shape)."""

    name = "ordered_kv"

    _E, _K = b"E", b"K"
    _SEP = b"\x00"

    def __init__(self, directory: str, **kw):
        self.kv = OrderedKv(directory, **kw)

    # entry key: E<dir>\x00<name>  (genKey)
    @classmethod
    def _key(cls, path: str) -> bytes:
        path = _norm(path)
        if path == "/":
            d, name = "", "/"
        else:
            d, name = path.rsplit("/", 1)
            d = d or "/"
        return cls._E + d.encode() + cls._SEP + name.encode()

    def insert_entry(self, entry: Entry) -> None:
        doc = json.dumps(entry.to_dict()).encode()
        self.kv.put(self._key(entry.path), doc)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        blob = self.kv.get(self._key(path))
        if blob is None:
            raise NotFound(path)
        return Entry.from_dict(json.loads(blob))

    def delete_entry(self, path: str) -> None:
        self.kv.delete(self._key(path))

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        if path == "/":
            # Every entry key except the root row itself.
            self.kv.delete_range(self._E, self._E + b"\xff")
            return
        base = path.encode()
        # Children of `path` sort at E<path>\x00…, grandchildren under
        # E<path>/…; '\x00' < '/' < '0' makes [E<path>\x00, E<path>0)
        # exactly the subtree and nothing else (e.g. /ab is outside
        # /a's range).
        self.kv.delete_range(self._E + base + self._SEP,
                             self._E + base + b"0")

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        d = _norm(dir_path).encode()
        prefix = self._E + d + self._SEP
        start = prefix + start_file_name.encode()
        if start_file_name and not include_start:
            start += b"\x00"  # skip exactly the start name
        # End bound: the separator is \x00, so bumping it to \x01 ends
        # the range after every possible child name.
        rows = self.kv.scan(start, self._E + d + b"\x01", limit)
        return [Entry.from_dict(json.loads(v)) for _k, v in rows]

    def kv_put(self, key: str, value: bytes) -> None:
        self.kv.put(self._K + key.encode(), bytes(value))

    def kv_get(self, key: str) -> bytes | None:
        return self.kv.get(self._K + key.encode())

    def kv_delete(self, key: str) -> None:
        self.kv.delete(self._K + key.encode())

    def close(self) -> None:
        self.kv.close()


class ShardedKvStore(FilerStore):
    """N OrderedKv stores sharded by parent-directory hash — the
    reference's leveldb2 backend (weed/filer/leveldb2/leveldb2_store.go:
    md5(dir) picks one of 8 dbs).  A directory's direct children always
    colocate, so finds and listings touch exactly one shard while write
    load and compaction spread across all of them.  Subtree deletes fan
    the range delete to every shard: descendants live wherever their own
    parent hashed."""

    name = "sharded_kv"
    SHARDS = 8

    def __init__(self, directory: str, shards: int = SHARDS, **kw):
        os.makedirs(directory, exist_ok=True)
        self.shards = [OrderedKvStore(os.path.join(directory, f"{i:02d}"),
                                      **kw)
                       for i in range(shards)]

    def _shard_for_dir(self, d: str) -> OrderedKvStore:
        h = hashlib.md5(d.encode()).digest()
        return self.shards[h[0] % len(self.shards)]

    def _shard(self, path: str) -> OrderedKvStore:
        path = _norm(path)
        d = "/" if path == "/" else (path.rsplit("/", 1)[0] or "/")
        return self._shard_for_dir(d)

    def insert_entry(self, entry: Entry) -> None:
        self._shard(entry.path).insert_entry(entry)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        return self._shard(path).find_entry(path)

    def delete_entry(self, path: str) -> None:
        self._shard(path).delete_entry(path)

    def delete_folder_children(self, path: str) -> None:
        for s in self.shards:
            s.delete_folder_children(path)

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        return self._shard_for_dir(_norm(dir_path)) \
            .list_directory_entries(dir_path, start_file_name,
                                    include_start, limit)

    def kv_put(self, key: str, value: bytes) -> None:
        self._kv_shard(key).kv_put(key, value)

    def kv_get(self, key: str) -> bytes | None:
        return self._kv_shard(key).kv_get(key)

    def kv_delete(self, key: str) -> None:
        self._kv_shard(key).kv_delete(key)

    def _kv_shard(self, key: str) -> OrderedKvStore:
        h = hashlib.md5(key.encode()).digest()
        return self.shards[h[0] % len(self.shards)]

    def close(self) -> None:
        for s in self.shards:
            s.close()
