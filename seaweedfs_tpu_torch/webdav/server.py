"""WebDAV gateway over the filer (reference: weed/server/webdav_server.go,
which adapts golang.org/x/net/webdav onto a filer-client FileSystem).

Implements the WebDAV class-2 verb set most clients (davfs2, macOS
Finder, Windows explorer, cadaver) exercise:

  OPTIONS            capability advertisement (DAV: 1,2)
  PROPFIND           207 multistatus listings, Depth 0/1
  GET/HEAD/PUT       file IO (streamed through the filer)
  DELETE             file or recursive collection delete
  MKCOL              mkdir
  MOVE/COPY          rename via the filer's atomic rename / byte copy
  LOCK/UNLOCK        in-memory advisory locks (x/net/webdav's memLS)
  PROPPATCH          accepted and echoed (properties are not persisted;
                     the reference's webdav FS ignores them too)
"""

from __future__ import annotations

import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from ..cluster import rpc
from ..filer.client import FilerProxy

DAV_NS = "DAV:"


def _dav(tag: str) -> str:
    return f"{{{DAV_NS}}}{tag}"


def _http_date(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))


class WebDavServer:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 0, root: str = "/",
                 metrics_port: int | None = None,
                 ssl_context=None):
        self.filer = FilerProxy(filer_url)
        self.root = "/" + root.strip("/") if root.strip("/") else ""
        self.server = rpc.JsonHttpServer(host, port, pass_headers=True,
                                         ssl_context=ssl_context)
        for method in ("OPTIONS", "PROPFIND", "PROPPATCH", "GET", "HEAD",
                       "PUT", "POST", "DELETE", "MKCOL", "MOVE", "COPY",
                       "LOCK", "UNLOCK"):
            self.server.prefix_route(method, "/", self._route)
        # token -> path of advisory locks (memLS equivalent)
        self._locks: dict[str, tuple[str, float]] = {}  # token -> (path, expiry)
        self._locks_mu = threading.Lock()
        # WebDAV paths own the URL namespace; /metrics rides its own
        # port like the other gateways.
        self.metrics_registry = self.server.enable_metrics(
            "webdav", serve_route=False)
        self.metrics_server = None
        if metrics_port is not None:
            self.metrics_server = rpc.JsonHttpServer(host, metrics_port)
            self.metrics_server.serve_metrics_route(
                self.metrics_registry)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        if self.metrics_server is not None:
            self.metrics_server.start()

    def stop(self) -> None:
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self.server.stop()

    def url(self) -> str:
        return self.server.url()

    # -- routing -------------------------------------------------------------

    def _fpath(self, path: str) -> str:
        p = urllib.parse.unquote(path).rstrip("/")
        return (self.root + p) or "/"

    def _route(self, path: str, query: dict, body: bytes):
        method = query.get("_method", "GET")
        headers = query.get("_headers", {})
        fpath = self._fpath(path)
        try:
            if method == "OPTIONS":
                return (200, b"", {"DAV": "1,2", "MS-Author-Via": "DAV",
                                   "Allow": "OPTIONS, PROPFIND, PROPPATCH,"
                                   " GET, HEAD, PUT, DELETE, MKCOL, MOVE,"
                                   " COPY, LOCK, UNLOCK"})
            if method == "PROPFIND":
                return self._propfind(fpath, path, headers)
            if method == "PROPPATCH":
                return self._proppatch(fpath, path)
            if method in ("GET", "HEAD"):
                return self._get(fpath, headers, head=(method == "HEAD"))
            if method == "PUT":
                return self._put(fpath, headers, body)
            if method == "DELETE":
                return self._delete(fpath)
            if method == "MKCOL":
                return self._mkcol(fpath, body)
            if method in ("MOVE", "COPY"):
                return self._move_copy(fpath, headers,
                                       copy=(method == "COPY"))
            if method == "LOCK":
                return self._lock(fpath)
            if method == "UNLOCK":
                return self._unlock(fpath, headers)
            return (405, b"method not allowed")
        except rpc.RpcError as e:
            return (e.status if e.status >= 400 else 502,
                    e.message.encode())

    # -- PROPFIND ------------------------------------------------------------

    def _prop_response(self, multistatus, href: str, meta: dict) -> None:
        resp = ET.SubElement(multistatus, _dav("response"))
        ET.SubElement(resp, _dav("href")).text = urllib.parse.quote(href)
        propstat = ET.SubElement(resp, _dav("propstat"))
        prop = ET.SubElement(propstat, _dav("prop"))
        is_dir = bool(meta.get("is_directory"))
        name = href.rstrip("/").rsplit("/", 1)[-1] or "/"
        ET.SubElement(prop, _dav("displayname")).text = name
        rt = ET.SubElement(prop, _dav("resourcetype"))
        attrs = meta.get("attributes", {})
        mtime = attrs.get("mtime", meta.get("mtime", 0))
        if is_dir:
            ET.SubElement(rt, _dav("collection"))
        else:
            size = meta.get("size",
                            sum(c.get("size", 0)
                                for c in meta.get("chunks", [])))
            ET.SubElement(prop, _dav("getcontentlength")).text = str(size)
            ET.SubElement(prop, _dav("getcontenttype")).text = \
                attrs.get("mime", "application/octet-stream")
        ET.SubElement(prop, _dav("getlastmodified")).text = \
            _http_date(mtime)
        ET.SubElement(prop, _dav("supportedlock"))
        ET.SubElement(propstat, _dav("status")).text = "HTTP/1.1 200 OK"

    def _propfind(self, fpath: str, href: str, headers: dict):
        depth = headers.get("depth", "1")
        meta = self.filer.meta(fpath) if fpath != "/" else \
            {"is_directory": True}
        if meta is None:
            return (404, b"not found")
        ET.register_namespace("D", DAV_NS)
        ms = ET.Element(_dav("multistatus"))
        href_base = href if href.endswith("/") or \
            not meta.get("is_directory") else href + "/"
        self._prop_response(ms, href_base, meta)
        if depth != "0" and meta.get("is_directory"):
            for e in self.filer.list_all(fpath):
                child_href = href_base.rstrip("/") + "/" + e["name"]
                if e.get("is_directory"):
                    child_href += "/"
                self._prop_response(ms, child_href, e)
        body = b'<?xml version="1.0" encoding="utf-8"?>' + \
            ET.tostring(ms)
        return (207, body, {"Content-Type": 'application/xml; '
                                            'charset="utf-8"'})

    def _proppatch(self, fpath: str, href: str):
        if self.filer.meta(fpath) is None:
            return (404, b"not found")
        ET.register_namespace("D", DAV_NS)
        ms = ET.Element(_dav("multistatus"))
        resp = ET.SubElement(ms, _dav("response"))
        ET.SubElement(resp, _dav("href")).text = urllib.parse.quote(href)
        ps = ET.SubElement(resp, _dav("propstat"))
        ET.SubElement(ps, _dav("prop"))
        ET.SubElement(ps, _dav("status")).text = "HTTP/1.1 200 OK"
        return (207, b'<?xml version="1.0" encoding="utf-8"?>' +
                ET.tostring(ms),
                {"Content-Type": 'application/xml; charset="utf-8"'})

    # -- file IO -------------------------------------------------------------

    def _get(self, fpath: str, headers: dict, head: bool):
        meta = self.filer.meta(fpath)
        if meta is None:
            return (404, b"not found")
        if meta.get("is_directory"):
            return (405, b"is a collection")
        attrs = meta.get("attributes", {})
        base = {"Content-Type": attrs.get("mime",
                                          "application/octet-stream"),
                "Last-Modified": _http_date(attrs.get("mtime", 0)),
                "Accept-Ranges": "bytes"}
        if head:
            size = sum(c.get("size", 0) for c in meta.get("chunks", []))
            base["Content-Length"] = str(size)
            return (200, b"", base)
        rng = headers.get("range", "")
        # Stream the open filer response through (no buffering).
        resp = self.filer.get(fpath, rng)
        base["Content-Length"] = resp.headers.get("Content-Length", "0")
        if resp.status == 206:
            base["Content-Range"] = resp.headers.get("Content-Range", "")
            return (206, resp, base)
        return (200, resp, base)

    def _put(self, fpath: str, headers: dict, body: bytes):
        existed = self.filer.meta(fpath) is not None
        self.filer.put(fpath, body,
                       headers.get("content-type",
                                   "application/octet-stream"))
        return (204 if existed else 201, b"")

    def _delete(self, fpath: str):
        if not self.filer.delete(fpath, recursive=True):
            return (404, b"not found")
        return (204, b"")

    def _mkcol(self, fpath: str, body: bytes):
        if body:
            return (415, b"MKCOL with body is unsupported")
        if self.filer.meta(fpath) is not None:
            return (405, b"already exists")
        parent = fpath.rsplit("/", 1)[0] or "/"
        if parent != "/" and self.filer.meta(parent) is None:
            return (409, b"parent collection missing")
        self.filer.mkdir(fpath)
        return (201, b"")

    def _move_copy(self, fpath: str, headers: dict, copy: bool):
        dest_url = headers.get("destination", "")
        if not dest_url:
            return (400, b"Destination header required")
        dest_path = urllib.parse.unquote(
            urllib.parse.urlparse(dest_url).path).rstrip("/")
        dest = (self.root + dest_path) or "/"
        overwrite = headers.get("overwrite", "T").upper() != "F"
        meta = self.filer.meta(fpath)
        if meta is None:
            return (404, b"source not found")
        existed = self.filer.meta(dest) is not None
        if existed and not overwrite:
            return (412, b"destination exists")
        if copy:
            if meta.get("is_directory"):
                return (501, b"COPY of collections is unsupported")
            with self.filer.get(fpath) as resp:
                data = resp.read()
            ctype = meta.get("attributes", {}).get(
                "mime", "application/octet-stream")
            self.filer.put(dest, data, ctype)
        else:
            if existed:
                self.filer.delete(dest, recursive=True)
            self.filer.rename(fpath, dest)
        return (204 if existed else 201, b"")

    # -- locks (advisory, in-memory like x/net/webdav memLS) -----------------

    LOCK_TIMEOUT = 3600.0

    def _purge_expired_locks(self) -> None:
        # Callers hold self._locks_mu.  Enforces the Second-3600 timeout
        # we advertise — abandoned tokens (crashed clients) must not
        # accumulate forever.
        now = time.time()
        for tok in [t for t, (_p, exp) in self._locks.items()
                    if exp < now]:
            del self._locks[tok]

    def _lock(self, fpath: str):
        token = f"opaquelocktoken:{uuid.uuid4()}"
        with self._locks_mu:
            self._purge_expired_locks()
            self._locks[token] = (fpath, time.time() + self.LOCK_TIMEOUT)
        ET.register_namespace("D", DAV_NS)
        root = ET.Element(_dav("prop"))
        ld = ET.SubElement(root, _dav("lockdiscovery"))
        al = ET.SubElement(ld, _dav("activelock"))
        lt = ET.SubElement(al, _dav("locktoken"))
        ET.SubElement(lt, _dav("href")).text = token
        ET.SubElement(al, _dav("timeout")).text = "Second-3600"
        body = b'<?xml version="1.0" encoding="utf-8"?>' + \
            ET.tostring(root)
        return (200, body, {"Content-Type": 'application/xml; '
                                            'charset="utf-8"',
                            "Lock-Token": f"<{token}>"})

    def _unlock(self, fpath: str, headers: dict):
        token = headers.get("lock-token", "").strip("<>")
        with self._locks_mu:
            self._locks.pop(token, None)
        return (204, b"")
