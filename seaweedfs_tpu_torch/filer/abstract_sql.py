"""Shared-SQL FilerStore: the reference's abstract_sql layer with
mysql/postgres dialects, validated on sqlite.

Reference: weed/filer/abstract_sql/abstract_sql_store.go:17 (seven SQL
texts injected by each dialect), mysql/mysql_store.go:45-51,
postgres/postgres_store.go:44-50, and util.HashStringToLong
(weed/util/bytes.go:73 — md5 first 8 bytes as a signed big-endian
int64) for the `dirhash` key column.  KV rides the same filemeta table
through genDirAndName (abstract_sql_store_kv.go).

No mysql/postgres driver ships in this image, so the dialects'
EXACT SQL strings are executed against sqlite: sqlite accepts the
mysql texts verbatim ('?' placeholders) and the postgres texts after a
mechanical `$N` → `?N` placeholder rewrite (sqlite numbered
parameters) — the statement text itself is what's being validated.  A
real deployment passes any DBAPI connection factory (pymysql /
psycopg2) with the matching dialect.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading

from .entry import Entry
from .filerstore import FilerStore, NotFound, _norm, split_dir_name


def hash_string_to_long(s: str) -> int:
    """util.HashStringToLong: md5's first 8 bytes as signed int64."""
    b = hashlib.md5(s.encode()).digest()
    v = int.from_bytes(b[:8], "big")
    return v - (1 << 64) if v >= (1 << 63) else v


class Dialect:
    """The seven SQL texts a concrete store injects
    (abstract_sql_store.go:17-23), plus DDL for test bring-up."""

    name = "abstract"
    create_table = ""
    create_table_kv = ""  # unused: kv rides filemeta, like the ref
    insert = ""
    update = ""
    find = ""
    delete = ""
    delete_folder_children = ""
    list_exclusive = ""
    list_inclusive = ""

    def placeholders(self, sql: str) -> str:
        """Rewrite for the validating engine (sqlite) — identity for
        '?' dialects."""
        return sql


class MysqlDialect(Dialect):
    """mysql_store.go:45-51 — verbatim."""

    name = "mysql"
    create_table = (
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dirhash BIGINT, name VARCHAR(1000), directory TEXT,"
        " meta LONGBLOB, PRIMARY KEY (dirhash, name))")
    insert = ("INSERT INTO filemeta (dirhash,name,directory,meta) "
              "VALUES(?,?,?,?)")
    update = ("UPDATE filemeta SET meta=? "
              "WHERE dirhash=? AND name=? AND directory=?")
    find = ("SELECT meta FROM filemeta "
            "WHERE dirhash=? AND name=? AND directory=?")
    delete = ("DELETE FROM filemeta "
              "WHERE dirhash=? AND name=? AND directory=?")
    delete_folder_children = ("DELETE FROM filemeta "
                              "WHERE dirhash=? AND directory=?")
    list_exclusive = (
        "SELECT NAME, meta FROM filemeta "
        "WHERE dirhash=? AND name>? AND directory=? AND name like ? "
        "ORDER BY NAME ASC LIMIT ?")
    list_inclusive = (
        "SELECT NAME, meta FROM filemeta "
        "WHERE dirhash=? AND name>=? AND directory=? AND name like ? "
        "ORDER BY NAME ASC LIMIT ?")


class PostgresDialect(Dialect):
    """postgres_store.go:44-50 — verbatim; `$N` placeholders are
    rewritten to sqlite's numbered `?N` form when validating."""

    name = "postgres"
    create_table = (
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dirhash BIGINT, name VARCHAR(65535), directory VARCHAR(65535),"
        " meta bytea, PRIMARY KEY (dirhash, name))")
    insert = ("INSERT INTO filemeta (dirhash,name,directory,meta) "
              "VALUES($1,$2,$3,$4)")
    update = ("UPDATE filemeta SET meta=$1 "
              "WHERE dirhash=$2 AND name=$3 AND directory=$4")
    find = ("SELECT meta FROM filemeta "
            "WHERE dirhash=$1 AND name=$2 AND directory=$3")
    delete = ("DELETE FROM filemeta "
              "WHERE dirhash=$1 AND name=$2 AND directory=$3")
    delete_folder_children = ("DELETE FROM filemeta "
                              "WHERE dirhash=$1 AND directory=$2")
    list_exclusive = (
        "SELECT NAME, meta FROM filemeta "
        "WHERE dirhash=$1 AND name>$2 AND directory=$3 AND name like $4 "
        "ORDER BY NAME ASC LIMIT $5")
    list_inclusive = (
        "SELECT NAME, meta FROM filemeta "
        "WHERE dirhash=$1 AND name>=$2 AND directory=$3 AND name like $4 "
        "ORDER BY NAME ASC LIMIT $5")

    _DOLLAR = re.compile(r"\$(\d+)")

    def placeholders(self, sql: str) -> str:
        return self._DOLLAR.sub(r"?\1", sql)


class AbstractSqlStore(FilerStore):
    """FilerStore over any DBAPI connection + Dialect pair.

    Row shape is the reference's: (dirhash BIGINT, name, directory,
    meta).  insert falls back to update on duplicate-key, exactly like
    InsertEntry/KvPut (abstract_sql_store.go / _kv.go)."""

    def __init__(self, conn, dialect: Dialect):
        self.conn = conn
        self.dialect = dialect
        self.name = f"abstract_sql/{dialect.name}"
        self._lock = threading.RLock()
        with self._lock:
            self._exec_raw(dialect.create_table)
            self.conn.commit()

    # -- plumbing ------------------------------------------------------------

    def _exec_raw(self, sql: str, args: tuple = ()):
        return self.conn.execute(self.dialect.placeholders(sql), args)

    def _exec(self, sql: str, args: tuple = ()):
        with self._lock:
            cur = self._exec_raw(sql, args)
            self.conn.commit()
            return cur

    def _query(self, sql: str, args: tuple = ()):
        with self._lock:
            return self._exec_raw(sql, args).fetchall()

    # -- entries -------------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_dir_name(entry.path)
        meta = json.dumps(entry.to_dict()).encode()
        self._upsert(d, name, meta)

    def _upsert(self, d: str, name: str, meta: bytes) -> None:
        h = hash_string_to_long(d)
        with self._lock:
            try:
                self._exec_raw(self.dialect.insert, (h, name, d, meta))
            except Exception as e:  # noqa: BLE001 — duplicate-key
                if "unique" not in str(e).lower() \
                        and "duplicate" not in str(e).lower():
                    self.conn.rollback()
                    raise
                # Real PostgreSQL aborts the whole transaction on the
                # failed INSERT; the UPDATE must run in a fresh one
                # (sqlite tolerates the rollback as a no-op).
                self.conn.rollback()
                self._exec_raw(self.dialect.update, (meta, h, name, d))
            self.conn.commit()

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry:
        d, name = split_dir_name(path)
        rows = self._query(self.dialect.find,
                           (hash_string_to_long(d), name, d))
        if not rows:
            raise NotFound(path)
        return Entry.from_dict(json.loads(bytes(rows[0][0])))

    def delete_entry(self, path: str) -> None:
        d, name = split_dir_name(path)
        self._exec(self.dialect.delete,
                   (hash_string_to_long(d), name, d))

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        # The reference deletes one directory level per call and the
        # filer recurses; here subdirectory levels are walked from the
        # listing so a single call clears the whole subtree, matching
        # the other stores' conformance behavior.
        while True:
            entries = self.list_directory_entries(path, "", True, 1024)
            if not entries:
                break
            for e in entries:
                if e.is_directory:
                    self.delete_folder_children(e.path)
                self.delete_entry(e.path)
        self._exec(self.dialect.delete_folder_children,
                   (hash_string_to_long(path), path))

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        d = _norm(dir_path)
        sql = self.dialect.list_inclusive if include_start \
            else self.dialect.list_exclusive
        rows = self._query(
            sql, (hash_string_to_long(d), start_file_name, d, "%",
                  limit))
        return [Entry.from_dict(json.loads(bytes(meta)))
                for _name, meta in rows]

    # -- kv (rides filemeta via genDirAndName, abstract_sql_store_kv.go) ----

    @staticmethod
    def _kv_dir_name(key: str) -> tuple[str, str]:
        return "/etc/kv", key

    def kv_put(self, key: str, value: bytes) -> None:
        d, name = self._kv_dir_name(key)
        self._upsert(d, name, bytes(value))

    def kv_get(self, key: str) -> bytes | None:
        d, name = self._kv_dir_name(key)
        rows = self._query(self.dialect.find,
                           (hash_string_to_long(d), name, d))
        return bytes(rows[0][0]) if rows else None

    def kv_delete(self, key: str) -> None:
        d, name = self._kv_dir_name(key)
        self._exec(self.dialect.delete,
                   (hash_string_to_long(d), name, d))

    def close(self) -> None:
        with self._lock:
            self.conn.close()


def sqlite_validating_store(dialect: Dialect,
                            path: str = ":memory:") -> AbstractSqlStore:
    """The dialect's exact SQL running on sqlite — CI-grade validation
    of the mysql/postgres statement texts without a DB server."""
    import sqlite3
    conn = sqlite3.connect(path, check_same_thread=False)
    return AbstractSqlStore(conn, dialect)
