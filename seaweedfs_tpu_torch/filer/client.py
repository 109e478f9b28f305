"""Filer HTTP client used by the gateways (S3, WebDAV, mount).

The reference gateways talk to the filer over gRPC
(weed/s3api/s3api_handlers.go WithFilerClient, weed/server/webdav_server.go);
here the filer's HTTP surface is the single wire, so one thin proxy serves
every gateway.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from ..cluster import resilience, rpc
from ..trace import current_traceparent


def _traced(req: urllib.request.Request) -> urllib.request.Request:
    """Propagate the active trace AND tenancy context on the
    urllib-based calls (the rpc-pooled calls inject both in
    rpc._request)."""
    tp = current_traceparent()
    if tp:
        req.add_header("traceparent", tp)
    from ..tenancy import context as _tenant_ctx
    tenant = _tenant_ctx.current_tenant()
    if tenant:
        req.add_header("X-Weed-Tenant", tenant)
    client = _tenant_ctx.current_client()
    if client:
        req.add_header("X-Weed-Client", client)
    return req


class FilerProxy:
    """Thin client of the filer HTTP surface.

    The urllib-based calls (get / put / kv_get — the ones that bypass
    the pooled rpc layer for streaming or raw-bytes reasons) ride the
    same resilience machinery as cluster/rpc.py: a RetryPolicy with
    jittered backoff, and the per-host circuit breaker so a dead filer
    fails fast instead of eating a full timeout per gateway request."""

    # Reads retry freely; non-idempotent uploads only retry failures
    # classified as safe (connect-class, 429 shed) by the policy.
    _RETRY = resilience.RetryPolicy(max_attempts=3, base_delay=0.05,
                                    per_attempt_timeout=60.0)

    def __init__(self, filer_url: str):
        self.url = filer_url.rstrip("/")
        self._hostport = self.url.split("://")[-1]

    def _urlopen(self, make_req, timeout: float, idempotent: bool):
        """urlopen under the retry policy + breaker.  `make_req` builds
        a FRESH Request per attempt (a consumed body can't be resent —
        callers with reader bodies pass idempotent=False)."""
        breaker = resilience.breaker_for(self._hostport)

        def attempt(_n: int, t: float):
            if not breaker.allow():
                raise resilience.BreakerOpen(
                    f"breaker open for {self._hostport}")
            try:
                resp = urllib.request.urlopen(make_req(),
                                              timeout=min(timeout, t))
            except urllib.error.HTTPError:
                breaker.record_success()  # a live server answered
                raise
            except OSError:
                breaker.record_failure()
                raise
            breaker.record_success()
            return resp

        return self._RETRY.run(attempt, idempotent=idempotent)

    def _q(self, path: str) -> str:
        return self.url + urllib.parse.quote(path)

    def get(self, path: str, range_header: str = ""):
        def make_req():
            req = _traced(urllib.request.Request(self._q(path)))
            if range_header:
                req.add_header("Range", range_header)
            return req
        return self._urlopen(make_req, 60, idempotent=True)

    def meta(self, path: str) -> dict | None:
        try:
            out = rpc.call(self._q(path) + "?metadata=true")
            assert isinstance(out, dict)
            return out
        except rpc.RpcError as e:
            if e.status == 404:
                return None
            raise  # a filer 5xx is not "no such key"

    def put(self, path: str, body, content_type: str = "",
            length: int | None = None) -> dict:
        """Upload body (bytes or a file-like reader).  A reader streams:
        with a known length it goes out as-is under Content-Length,
        otherwise chunked transfer-encoding — either way the filer
        consumes it incrementally (its upload route is stream_body)."""
        def make_req():
            req = _traced(urllib.request.Request(
                self._q(path), data=body, method="POST"))
            if content_type:
                req.add_header("Content-Type", content_type)
            if hasattr(body, "read"):
                if length is not None:
                    req.add_header("Content-Length", str(length))
                else:
                    req.add_header("Transfer-Encoding", "chunked")
            return req
        # A reader body is consumed by the first attempt — never
        # replayable; a bytes body is, but the write itself may have
        # been processed, so only connect-class failures retry.
        with self._urlopen(make_req, 600, idempotent=False) as resp:
            return json.load(resp)

    def create_entry(self, path: str, entry: dict) -> dict:
        out = rpc.call(self._q(path) + "?entry=true", "POST",
                       json.dumps(entry).encode())
        assert isinstance(out, dict)
        return out

    def mkdir(self, path: str) -> None:
        rpc.call(self._q(path) + "?mkdir=true", "POST", b"")

    def hardlink(self, src: str, dst: str) -> dict:
        """`ln src dst` (filerstore_hardlink.go plane)."""
        out = rpc.call(self._q(dst) + "?hardlink.from=" +
                       urllib.parse.quote(src, safe=""), "POST", b"")
        assert isinstance(out, dict)
        return out

    def rename(self, path: str, new_path: str) -> None:
        rpc.call(self._q(path) + "?mv.to=" +
                 urllib.parse.quote(new_path, safe=""), "POST", b"")

    def delete(self, path: str, recursive: bool = False,
               keep_chunks: bool = False) -> bool:
        q = []
        if recursive:
            q.append("recursive=true")
        if keep_chunks:
            q.append("skipChunkDeletion=true")
        try:
            rpc.call(self._q(path) + ("?" + "&".join(q) if q else ""),
                     "DELETE")
            return True
        except rpc.RpcError as e:
            if e.status == 404:
                return False
            raise

    def list(self, path: str, last: str = "", limit: int = 1024) -> list:
        q = f"?limit={limit}"
        if last:
            q += f"&lastFileName={urllib.parse.quote(last)}"
        try:
            out = rpc.call(self._q(path.rstrip('/') + '/') + q)
        except rpc.RpcError as e:
            if e.status == 404:
                return []
            raise  # a filer 5xx is not "empty directory"
        assert isinstance(out, dict)
        return out.get("entries", [])

    # -- meta subscription + KV (SubscribeMetadata / KvGet / KvPut) ---------

    def meta_info(self) -> dict:
        out = rpc.call(self.url + "/.meta/info")
        assert isinstance(out, dict)
        return out

    def meta_events(self, since_ns: int = 0, exclude_signature: int = 0,
                    prefix: str = "", limit: int = 10000) -> dict:
        q = f"?since_ns={since_ns}&limit={limit}"
        if exclude_signature:
            q += f"&exclude_signature={exclude_signature}"
        if prefix:
            q += f"&prefix={urllib.parse.quote(prefix, safe='')}"
        out = rpc.call(self.url + "/.meta/subscribe" + q)
        assert isinstance(out, dict)
        return out

    def meta_stream(self, since_ns: int = 0, exclude_signature: int = 0,
                    prefix: str = "", stop_event=None):
        """Long-lived push tail (?tail=true NDJSON stream): yields event
        dicts the moment they commit on the filer — the
        SubscribeMetadata gRPC stream analog; no polling.  Returns
        (handle, generator): handle.close() stops tailing immediately
        from any thread, and a stop_event ends the generator on its
        next heartbeat wakeup."""
        q = f"?tail=true&since_ns={since_ns}"
        if exclude_signature:
            q += f"&exclude_signature={exclude_signature}"
        if prefix:
            q += f"&prefix={urllib.parse.quote(prefix, safe='')}"
        handle = rpc.call_stream(self.url + "/.meta/subscribe" + q,
                                 stop_event=stop_event)
        return handle, handle.events()

    def kv_get(self, key: str) -> bytes | None:
        def make_req():
            return _traced(urllib.request.Request(
                self.url + "/.kv/" + urllib.parse.quote(key, safe="")))
        try:
            with self._urlopen(make_req, 30, idempotent=True) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def kv_put(self, key: str, value: bytes) -> None:
        rpc.call(self.url + "/.kv/" +
                 urllib.parse.quote(key, safe=""), "PUT", value)

    def list_all(self, path: str) -> list:
        """Paginate until exhausted (for unbounded listings like
        multipart-part enumeration)."""
        out: list = []
        last = ""
        while True:
            page = self.list(path, last, 1024)
            if not page:
                return out
            out.extend(page)
            last = page[-1]["name"]
            if len(page) < 1024:
                return out


class ShardedFilerClient:
    """Shard-map-aware metadata client for the HA filer fleet — the
    vid-map analog for metadata: the master's shard map is cached with
    a short TTL and every operation routes straight to the path's
    shard primary.

    Staleness heals itself: a 409 wrong-shard answer (the filer's
    refusal carries the current primary as a hint) triggers one map
    re-fetch + retry, and a contested shard (503 — mid-move, or a
    failover in flight) is retried with backoff under
    `contested_deadline` so callers ride through a promotion instead
    of surfacing it."""

    def __init__(self, master_url: str | list[str],
                 map_ttl: float = 5.0,
                 contested_deadline: float = 10.0):
        urls = master_url if isinstance(master_url, list) \
            else [master_url]
        self.masters = [u.rstrip("/") for u in urls]
        self._midx = 0
        self.map_ttl = map_ttl
        self.contested_deadline = contested_deadline
        self._map: dict[int, dict] = {}
        self.num_shards = 0
        self._fetched_at = 0.0
        self._lock = threading.Lock()
        self._proxies: dict[str, FilerProxy] = {}

    # -- the map -------------------------------------------------------------

    def refresh_map(self, force: bool = False) -> None:
        with self._lock:
            fresh = self._map and \
                time.monotonic() - self._fetched_at < self.map_ttl
        if fresh and not force:
            return
        doc = None
        for _ in range(len(self.masters)):
            try:
                doc = rpc.call(self.masters[self._midx] +
                               "/cluster/filer/shards", timeout=5.0)
                break
            except Exception:  # noqa: BLE001 — next seed
                self._midx = (self._midx + 1) % len(self.masters)
        if not isinstance(doc, dict):
            return  # keep serving the stale map: better than nothing
        with self._lock:
            self._map = {int(k): v for k, v in
                         (doc.get("shards") or {}).items()}
            self.num_shards = int(doc.get("num_shards", 0))
            self._fetched_at = time.monotonic()

    def shard_for(self, path: str) -> int:
        from .metaha import shard_of
        self.refresh_map()
        if self.num_shards <= 0:
            return 0
        return shard_of(path, self.num_shards)

    def primary_for(self, path: str) -> str | None:
        self.refresh_map()
        if self.num_shards <= 0:
            return None
        from .metaha import shard_of
        row = self._map.get(shard_of(path, self.num_shards)) or {}
        return row.get("primary")

    def proxy_for(self, path: str) -> FilerProxy:
        url = self.primary_for(path)
        if url is None:
            raise rpc.RpcError(
                503, f"no shard primary for {path} "
                     "(map empty or plane disarmed)")
        proxy = self._proxies.get(url)
        if proxy is None:
            proxy = self._proxies.setdefault(url, FilerProxy(url))
        return proxy

    def run(self, path: str, fn):
        """fn(FilerProxy) routed to the path's shard primary.  One
        wrong-shard (409) retry after a forced map re-fetch; contested
        (503) — and a dead/unreachable primary (connect-class failure
        or an open breaker: the map is stale, a failover is in
        flight) — retried with backoff until contested_deadline."""
        deadline = time.monotonic() + self.contested_deadline
        retried_409 = False
        delay = 0.05
        while True:
            try:
                return fn(self.proxy_for(path))
            except (rpc.RpcError, urllib.error.HTTPError) as e:
                status = getattr(e, "status", None) or \
                    getattr(e, "code", None)
                if status == 409 and not retried_409 and \
                        "shard" in str(e):
                    retried_409 = True
                    self.refresh_map(force=True)
                    continue
                if status == 503 and time.monotonic() < deadline:
                    time.sleep(delay)
                    delay = min(delay * 2, 1.0)
                    self.refresh_map(force=True)
                    continue
                raise
            except (OSError, resilience.BreakerOpen):
                # The mapped primary is gone (kill -9, partition):
                # keep re-fetching the map until the master promotes
                # a follower — the op then lands there.
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
                self.refresh_map(force=True)

    # -- convenience mutations (the common gateway verbs) --------------------

    def put(self, path: str, body, content_type: str = "") -> dict:
        return self.run(path, lambda p: p.put(path, body, content_type))

    def meta(self, path: str) -> dict | None:
        return self.run(path, lambda p: p.meta(path))

    def mkdir(self, path: str) -> None:
        return self.run(path, lambda p: p.mkdir(path))

    def rename(self, path: str, new_path: str) -> None:
        return self.run(path, lambda p: p.rename(path, new_path))

    def delete(self, path: str, recursive: bool = False) -> bool:
        return self.run(path, lambda p: p.delete(path, recursive))

    def list(self, path: str, last: str = "",
             limit: int = 1024) -> list:
        return self.run(path, lambda p: p.list(path, last, limit))

    # -- cluster-wide (shard, seq) subscription ------------------------------

    def poll_events(self, cursors: dict | None = None,
                    limit: int = 1000) -> tuple[list, dict]:
        """One cluster-wide metadata poll: every shard's journal from
        its cursor.  Returns (records, cursors) where cursors maps
        shard -> last seen seq — exact resume positions that survive a
        failover, because seq numbers ARE the replicated history (a
        new primary serves the same numbering the old one acked)."""
        self.refresh_map()
        cursors = {int(k): int(v) for k, v in (cursors or {}).items()}
        out: list = []
        for k in sorted(self._map):
            primary = (self._map[k] or {}).get("primary")
            if not primary:
                continue
            since = cursors.get(k, 0)
            try:
                doc = rpc.call(
                    f"{primary}/.meta/subscribe?shard={k}"
                    f"&since_seq={since}&limit={limit}", timeout=10.0)
            except Exception:  # noqa: BLE001 — primary mid-failover:
                self.refresh_map(force=True)  # next poll hits the
                continue                      # promoted one
            if not isinstance(doc, dict):
                continue
            for r in doc.get("records", []):
                out.append({"shard": k, **r})
            cursors[k] = max(since, int(doc.get("last_seq", since)))
        return out, cursors
