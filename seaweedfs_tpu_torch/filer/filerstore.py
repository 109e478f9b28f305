"""FilerStore: pluggable metadata backends.

Reference: weed/filer/filerstore.go:20-43 (the interface) and the 11
backends under weed/filer/{leveldb,redis,mysql,...}.  This build ships
the full breadth — embedded:

- MemoryStore    — sorted dict (the reference's memdb, test store)
- SqliteStore    — stdlib sqlite3, the batteries-included durable
                   default (the reference defaults to leveldb)
- OrderedKvStore — embedded ordered-KV with WAL/snapshots (leveldb
                   analog), plus its 8-way ShardedKvStore (leveldb2)

and networked, each speaking its real wire protocol with no SDK:

- RedisStore     — RESP2 (redis_store.py)
- AbstractSqlStore — the shared-SQL layer with verbatim
                   mysql/postgres dialect texts (abstract_sql.py)
- EtcdStore      — etcd v3 KV gRPC (etcd_store.py)
- ElasticStore   — Elasticsearch REST (elastic_store.py)
- MongoStore     — OP_MSG + BSON (mongo_store.py)
- CassandraStore — CQL binary protocol v4 (cassandra_store.py)

All implement the same five-method contract + KV and pass the same
conformance suite (tests/test_filer.py's `store` fixture runs every
backend; the networked ones against in-process mini wire servers).
"""

from __future__ import annotations

import bisect
import json
import sqlite3
import threading
from typing import Iterable

from .entry import Entry


class FilerStoreError(Exception):
    pass


class NotFound(FilerStoreError):
    pass


class FilerStore:
    """The store contract (filerstore.go FilerStore interface)."""

    name = "abstract"

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, path: str) -> Entry:
        raise NotImplementedError

    def delete_entry(self, path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, path: str) -> None:
        raise NotImplementedError

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        raise NotImplementedError

    # KV (filer.proto KvGet/KvPut — sync checkpoints, hardlink blobs)
    def kv_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def kv_delete(self, key: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _norm(path: str) -> str:
    if not path.startswith("/"):
        raise FilerStoreError(f"path must be absolute: {path!r}")
    while "//" in path:
        path = path.replace("//", "/")
    return path.rstrip("/") or "/"


def _dir_key(dir_path: str) -> str:
    """Key prefix under which a directory's children sort."""
    return dir_path if dir_path.endswith("/") else dir_path + "/"


def split_dir_name(path: str) -> tuple[str, str]:
    """Normalize and split into (directory, name) — FullPath.DirAndName.
    Root splits to ("/", "") — shared by every (directory, name)-keyed
    networked store so the scheme can't drift between backends."""
    path = _norm(path)
    if path == "/":
        return "/", ""
    d, name = path.rsplit("/", 1)
    return d or "/", name


class MemoryStore(FilerStore):
    """Sorted-key in-memory store (reference: filer/needle-free memdb)."""

    name = "memory"

    def __init__(self) -> None:
        self._keys: list[str] = []
        self._m: dict[str, Entry] = {}
        self._kv: dict[str, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        path = _norm(entry.path)
        with self._lock:
            if path not in self._m:
                bisect.insort(self._keys, path)
            self._m[path] = entry.clone()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        path = _norm(path)
        with self._lock:
            e = self._m.get(path)
            if e is None:
                raise NotFound(path)
            return e.clone()

    def delete_entry(self, path: str) -> None:
        path = _norm(path)
        with self._lock:
            if path in self._m:
                del self._m[path]
                i = bisect.bisect_left(self._keys, path)
                del self._keys[i]

    def delete_folder_children(self, path: str) -> None:
        prefix = _dir_key(_norm(path))
        # Range end: bump the final char ('/' -> '0') so EVERY key with
        # this prefix — including astral-plane names above U+FFFF — is
        # inside [prefix, end).
        end = prefix[:-1] + chr(ord(prefix[-1]) + 1)
        with self._lock:
            lo = bisect.bisect_left(self._keys, prefix)
            hi = bisect.bisect_left(self._keys, end)
            for k in self._keys[lo:hi]:
                del self._m[k]
            del self._keys[lo:hi]

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        prefix = _dir_key(_norm(dir_path))
        with self._lock:
            if start_file_name:
                key = prefix + start_file_name
                lo = bisect.bisect_left(self._keys, key)
                if (not include_start and lo < len(self._keys)
                        and self._keys[lo] == key):
                    lo += 1
            else:
                lo = bisect.bisect_left(self._keys, prefix)
            out = []
            for k in self._keys[lo:]:
                if not k.startswith(prefix):
                    break
                if "/" in k[len(prefix):]:
                    continue  # grandchildren don't list here
                out.append(self._m[k].clone())
                if len(out) >= limit:
                    break
            return out

    def kv_put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._kv[key] = bytes(value)

    def kv_get(self, key: str) -> bytes | None:
        with self._lock:
            return self._kv.get(key)

    def kv_delete(self, key: str) -> None:
        with self._lock:
            self._kv.pop(key, None)


class SqliteStore(FilerStore):
    """sqlite3-backed store — the abstract_sql analog
    (filer/abstract_sql/abstract_sql_store.go: dirhash+name keyed table;
    here (dir, name) with a covering index, same listing semantics)."""

    name = "sqlite"

    def __init__(self, path: str = ":memory:") -> None:
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS filemeta ("
                " dir TEXT NOT NULL, name TEXT NOT NULL,"
                " meta TEXT NOT NULL, PRIMARY KEY (dir, name))")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS filer_kv ("
                " k TEXT PRIMARY KEY, v BLOB NOT NULL)")
            self._db.commit()

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        path = _norm(path)
        if path == "/":
            return "", "/"
        d, name = path.rsplit("/", 1)
        return d or "/", name

    def insert_entry(self, entry: Entry) -> None:
        d, name = self._split(entry.path)
        meta = json.dumps(entry.to_dict())
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO filemeta (dir, name, meta) "
                "VALUES (?, ?, ?)", (d, name, meta))
            self._db.commit()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        d, name = self._split(path)
        with self._lock:
            row = self._db.execute(
                "SELECT meta FROM filemeta WHERE dir=? AND name=?",
                (d, name)).fetchone()
        if row is None:
            raise NotFound(path)
        return Entry.from_dict(json.loads(row[0]))

    def delete_entry(self, path: str) -> None:
        d, name = self._split(path)
        with self._lock:
            self._db.execute(
                "DELETE FROM filemeta WHERE dir=? AND name=?", (d, name))
            self._db.commit()

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        # Escape LIKE metacharacters: '_'/'%' are legal in file names and
        # unescaped would match siblings (e.g. /a_b matching /axb).
        pat = (_dir_key(path).replace("\\", "\\\\")
               .replace("%", "\\%").replace("_", "\\_")) + "%"
        with self._lock:
            self._db.execute(
                "DELETE FROM filemeta WHERE dir=? OR dir LIKE ? "
                "ESCAPE '\\'", (path, pat))
            self._db.commit()

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        d = _norm(dir_path)
        op = ">=" if include_start else ">"
        with self._lock:
            rows = self._db.execute(
                f"SELECT meta FROM filemeta WHERE dir=? AND name {op} ? "
                "ORDER BY name LIMIT ?",
                (d, start_file_name, limit)).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def kv_put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO filer_kv (k, v) VALUES (?, ?)",
                (key, sqlite3.Binary(bytes(value))))
            self._db.commit()

    def kv_get(self, key: str) -> bytes | None:
        with self._lock:
            row = self._db.execute(
                "SELECT v FROM filer_kv WHERE k=?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def kv_delete(self, key: str) -> None:
        with self._lock:
            self._db.execute("DELETE FROM filer_kv WHERE k=?", (key,))
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()


def store_for_path(path: str | None) -> FilerStore:
    """Store factory, mirroring the reference's filer.toml-driven choice
    (weed/filer/filer_on_disk.go + command/scaffold.go's filer section):
    an `enabled = true` section in filer.toml wins; without one, a
    directory-shaped path gets the embedded ordered-KV store (the
    reference's leveldb default) and a file path gets sqlite.  None is
    the in-memory test store."""
    if path is None:
        return MemoryStore()
    from ..utils.config import load_configuration
    cfg = load_configuration("filer")
    if cfg.get_bool("memory.enabled"):
        return MemoryStore()
    if cfg.get_bool("ordered_kv.enabled"):
        from .ordered_kv import OrderedKvStore
        return OrderedKvStore(cfg.get_string("ordered_kv.dir") or path)
    if cfg.get_bool("sharded_kv.enabled"):
        # The leveldb2 analog: 8-way dir-hash sharding for spread
        # compaction/write load on big namespaces.
        from .ordered_kv import ShardedKvStore
        return ShardedKvStore(cfg.get_string("sharded_kv.dir") or path)
    if cfg.get_bool("sqlite.enabled"):
        return SqliteStore(cfg.get_string("sqlite.file") or path)
    if cfg.get_bool("redis.enabled"):
        # filer.toml [redis] — scaffold.go's redis section shape.
        from .redis_store import RedisStore
        return RedisStore(
            host=cfg.get_string("redis.address",
                                "localhost:6379").split(":")[0],
            port=int((cfg.get_string("redis.address", "localhost:6379")
                      .split(":") + ["6379"])[1]),
            password=cfg.get_string("redis.password"),
            database=int(cfg.get_string("redis.database", "0") or 0))
    if cfg.get_bool("mongodb.enabled"):
        from .mongo_store import MongoStore
        uri = cfg.get_string("mongodb.uri", "mongodb://localhost:27017")
        hostport = uri.split("://")[-1].split("/")[0]
        host, _, port = hostport.rpartition(":")
        return MongoStore(host or hostport,
                          int(port) if port.isdigit() else 27017,
                          database=cfg.get_string("mongodb.database",
                                                  "seaweedfs"))
    if cfg.get_bool("cassandra.enabled"):
        from .cassandra_store import CassandraStore
        hosts = cfg.get_string("cassandra.hosts", "localhost").split(",")
        host, _, port = hosts[0].rpartition(":")
        return CassandraStore(
            host or hosts[0],
            int(port) if port.isdigit() else 9042,
            keyspace=cfg.get_string("cassandra.keyspace", "seaweedfs"))
    if cfg.get_bool("etcd.enabled"):
        from .etcd_store import EtcdStore
        return EtcdStore(cfg.get_string("etcd.servers",
                                        "localhost:2379").split(",")[0])
    if cfg.get_bool("elastic7.enabled"):
        from .elastic_store import ElasticStore
        servers = cfg.get_string("elastic7.servers",
                                 "http://localhost:9200")
        return ElasticStore(
            servers.split(",")[0],
            username=cfg.get_string("elastic7.username"),
            password=cfg.get_string("elastic7.password"))
    for section, dialect_name in (("mysql", "mysql"),
                                  ("postgres", "postgres")):
        if cfg.get_bool(f"{section}.enabled"):
            # No mysql/postgres DBAPI driver ships in this image: the
            # dialect's exact SQL runs on a local sqlite engine (the
            # abstract_sql layer is the compatibility surface; point a
            # real driver at AbstractSqlStore to reach a server).
            from .abstract_sql import (MysqlDialect, PostgresDialect,
                                       sqlite_validating_store)
            dialect = MysqlDialect() if dialect_name == "mysql" \
                else PostgresDialect()
            return sqlite_validating_store(
                dialect, cfg.get_string(f"{section}.file") or path)
    import os
    if os.path.isfile(path):
        # An existing regular file is a sqlite store from a previous
        # run, whatever its extension — never shadow it.
        return SqliteStore(path)
    if os.path.isdir(path) or not os.path.splitext(path)[1]:
        from .ordered_kv import OrderedKvStore
        return OrderedKvStore(path)
    return SqliteStore(path)


def iterate_tree(store: FilerStore, root: str,
                 batch: int = 1024) -> Iterable[Entry]:
    """Depth-first walk of a subtree (util for fs.du/meta.save/sync)."""
    try:
        root_entry = store.find_entry(root)
    except NotFound:
        return
    yield root_entry
    if not root_entry.is_directory:
        return
    stack = [root]
    while stack:
        d = stack.pop()
        start, include = "", True
        while True:
            entries = store.list_directory_entries(d, start, include, batch)
            if not entries:
                break
            for e in entries:
                yield e
                if e.is_directory:
                    stack.append(e.path)
            start, include = entries[-1].name, False
