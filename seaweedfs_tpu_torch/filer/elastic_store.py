"""Elasticsearch-backed FilerStore over the plain REST API — no SDK.

Reference: weed/filer/elastic/v7/elastic_store.go — one index per
top-level path component (`.seaweedfs_<root>`), doc id = md5(fullpath),
docs shaped {ParentId: md5(dir), Entry: {...}}, KV in the
`.seaweedfs_kv_entries` index, listing = term search on ParentId.
This build drives the same REST endpoints with the pooled HTTP client
(PUT/GET/DELETE /{index}/_doc/{id}, POST /{index}/_search,
GET /_cat/indices?format=json) — the olivere/elastic client is
Go-ecosystem glue, not part of the wire surface.

Two contract-driven deviations from the reference, noted for the
record: listings sort on the entry NAME (search sort on the Name
keyword + search_after) instead of the md5 _id, so pagination follows
the FilerStore contract's lexicographic order; and delete_entry on a
top-level directory deletes only that doc (the reference drops the
whole index, which would take the children with it — subtree removal
belongs to delete_folder_children)."""

from __future__ import annotations

import hashlib
import json

from ..cluster import rpc
from .entry import Entry
from .filerstore import FilerStore, FilerStoreError, NotFound, _norm

INDEX_PREFIX = ".seaweedfs_"
INDEX_KV = ".seaweedfs_kv_entries"


def _md5(s: str) -> str:
    return hashlib.md5(s.encode()).hexdigest()


def _index_of(path: str) -> str:
    """Index name for a path: its top-level component (elastic_store.go
    getIndex)."""
    parts = _norm(path).split("/")
    root = parts[1] if len(parts) > 1 else ""
    return INDEX_PREFIX + (root or "_root")


class ElasticStore(FilerStore):
    """filer.toml `[elastic7]` store (elastic_store.go:46)."""

    name = "elastic7"

    def __init__(self, base_url: str = "http://localhost:9200",
                 username: str = "", password: str = "",
                 max_page_size: int = 10000):
        self.base = base_url.rstrip("/")
        self.max_page_size = max_page_size
        self._headers = {}
        if username and password:
            import base64
            token = base64.b64encode(
                f"{username}:{password}".encode()).decode()
            self._headers["Authorization"] = f"Basic {token}"

    def _call(self, method: str, path: str, payload=None):
        body = json.dumps(payload).encode() if payload is not None \
            else None
        headers = dict(self._headers)
        if body is not None:
            headers["Content-Type"] = "application/json"
        return rpc.call(f"{self.base}{path}", method, body,
                        headers=headers or None)

    # -- entries -------------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        path = _norm(entry.path)
        d = path.rsplit("/", 1)[0] or "/"
        doc = {"ParentId": _md5(d), "Name": entry.name,
               "Entry": entry.to_dict()}
        # refresh=true: the filer's contract is read-after-write
        # listing; without it real ES search lags writes by the ~1s
        # refresh interval.
        self._call("PUT",
                   f"/{_index_of(path)}/_doc/{_md5(path)}?refresh=true",
                   doc)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        path = _norm(path)
        try:
            out = self._call(
                "GET", f"/{_index_of(path)}/_doc/{_md5(path)}")
        except rpc.RpcError as e:
            if e.status == 404:
                raise NotFound(path) from None
            raise
        if not isinstance(out, dict) or not out.get("found"):
            raise NotFound(path)
        return Entry.from_dict(out["_source"]["Entry"])

    def delete_entry(self, path: str) -> None:
        path = _norm(path)
        try:
            self._call(
                "DELETE",
                f"/{_index_of(path)}/_doc/{_md5(path)}?refresh=true")
        except rpc.RpcError as e:
            if e.status != 404:
                raise

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        while True:
            entries = self.list_directory_entries(path, "", True, 1024)
            if not entries:
                return
            for e in entries:
                if e.is_directory:
                    self.delete_folder_children(e.path)
                self.delete_entry(e.path)

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               include_start: bool,
                               limit: int) -> list[Entry]:
        d = _norm(dir_path)
        # Sort/range on Name.keyword: ES7 dynamic mapping types Name
        # as analyzed text (unsortable, tokenized) with an automatic
        # .keyword subfield — raw "Name" would 400 on sort and break
        # lexicographic pagination.
        body = {
            "size": min(limit, self.max_page_size),
            "query": {"term": {"ParentId": _md5(d)}},
            "sort": [{"Name.keyword": "asc"}],
        }
        if start_file_name:
            # search_after-style cursor expressed as a range filter so
            # inclusive/exclusive both map cleanly.
            op = "gte" if include_start else "gt"
            body["query"] = {"bool": {
                "must": [{"term": {"ParentId": _md5(d)}}],
                "filter": [{"range": {
                    "Name.keyword": {op: start_file_name}}}],
            }}
        # Children of "/" span one index per top-level name (the
        # reference walks _cat/indices); a wildcard multi-index search
        # covers them in one call.  Deeper directories share their
        # top-level component's index.
        target = f"{INDEX_PREFIX}*" if d == "/" else _index_of(d)
        try:
            out = self._call("POST", f"/{target}/_search", body)
        except rpc.RpcError as e:
            if e.status == 404:
                return []  # index not created yet: empty directory
            raise
        hits = (out.get("hits") or {}).get("hits") or []
        return [Entry.from_dict(h["_source"]["Entry"])
                for h in hits[:limit]]

    # -- kv ------------------------------------------------------------------

    def kv_put(self, key: str, value: bytes) -> None:
        import base64
        self._call("PUT", f"/{INDEX_KV}/_doc/{_md5(key)}",
                   {"Value": base64.b64encode(bytes(value)).decode()})

    def kv_get(self, key: str) -> bytes | None:
        import base64
        try:
            out = self._call("GET", f"/{INDEX_KV}/_doc/{_md5(key)}")
        except rpc.RpcError as e:
            if e.status == 404:
                return None
            raise
        if not isinstance(out, dict) or not out.get("found"):
            return None
        return base64.b64decode(out["_source"]["Value"])

    def kv_delete(self, key: str) -> None:
        try:
            self._call("DELETE", f"/{INDEX_KV}/_doc/{_md5(key)}")
        except rpc.RpcError as e:
            if e.status != 404:
                raise
