"""Filer HTTP server: path-addressed file API over the blob store.

Reference: weed/server/filer_server.go + filer_server_handlers_*.go:

  GET    /path/to/file          content (Range supported)
  GET    /path/to/dir/          JSON listing (?limit=&lastFileName=)
  GET    /path?metadata=true    entry metadata JSON
  POST   /path/to/file          upload (auto-chunked, _write_autochunk.go)
  PUT    /path/to/file          same
  POST   /path?mv.to=/new/path  rename (AtomicRenameEntry)
  DELETE /path[?recursive=true] delete entry / subtree
  GET    /.meta/subscribe?since_ns=  meta events since a timestamp
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse

from ..cluster import rpc
from ..cluster.client import WeedClient
from ..trace import span as trace_span
from .entry import Attributes, Entry
from .filechunks import etag as chunks_etag, read_chunk_views, total_size
from .filer import Filer, FilerError
from .filerstore import NotFound, store_for_path
from .packing import SmallFilePacker
from .stream import ChunkedWriter, ChunkStreamer


class _MetaTail:
    """Streaming response body for ?tail=true: PAGED journal replay
    (bounded memory, no log lock held while paging), then a gap-free
    switch to live push under the log lock, then the live queue.

    The poll endpoint this supersedes was bounded at 10k events per
    request; this keeps the same bound per read() while serving the
    whole history + live tail on one connection
    (filer_grpc_server_sub_meta.go: replay from disk, then tail the
    in-memory log buffer)."""

    _PAGE = 1000

    def __init__(self, filer, since_ns: int, excl: int, prefix: str):
        self._filer = filer
        self._cursor = since_ns
        self._excl = excl
        self._prefix = prefix
        self._live = rpc.EventStream()
        self._attached = False
        self._unsubscribe = None

    def _serialize(self, ev) -> bytes:
        if (self._excl and self._excl in ev.signatures) or \
                (self._prefix and not (ev.directory + "/").startswith(
                    self._prefix.rstrip("/") + "/")):
            # Filtered out — still advance the client's resume cursor,
            # or a tail full of excluded events would pin it forever.
            return json.dumps({"ts_ns": ev.ts_ns,
                               "_cursor_only": True}).encode() + b"\n"
        d = ev.to_dict()
        d["_signature"] = self._filer.signature
        return json.dumps(d).encode() + b"\n"

    def read(self, n: int = -1) -> bytes:
        if not self._attached:
            page = self._filer.read_meta_events(self._cursor, self._PAGE)
            if len(page) >= self._PAGE:
                self._cursor = page[-1].ts_ns
                return b"".join(self._serialize(ev) for ev in page)
            # Nearly caught up: replay the small remainder and attach
            # the live subscriber atomically under the log lock so no
            # event falls between replay and tail.
            with self._filer._log_lock:
                gap = self._filer.read_meta_events(self._cursor,
                                                   10 ** 9)
                self._filer._subscribers.append(self._live_cb)
            self._attached = True
            self._unsubscribe = lambda: self._detach()
            if gap:
                self._cursor = gap[-1].ts_ns
                return b"".join(self._serialize(ev) for ev in gap)
        return self._live.read()

    def _live_cb(self, ev) -> None:
        self._live.push_raw(self._serialize(ev))

    def _detach(self) -> None:
        with self._filer._log_lock:
            if self._live_cb in self._filer._subscribers:
                self._filer._subscribers.remove(self._live_cb)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._unsubscribe is not None:
            self._unsubscribe()
        return False


class _ShardTail:
    """Streaming body for /.meta/subscribe?shard=K&tail=true: NDJSON
    journal records from since_seq+1 onward, pushed as the primary
    commits them.  Resuming by (shard, seq) is exact — no timestamp
    heuristics — so a shard-aware aggregator survives a failover by
    reconnecting to the new primary at its applied seq."""

    _PAGE = 500

    def __init__(self, plane, shard: int, since_seq: int):
        self._plane = plane
        self._shard = shard
        self._cursor = since_seq

    def read(self, n: int = -1) -> bytes:
        while True:
            recs = self._plane.log_for(self._shard).read_from(
                self._cursor + 1, self._PAGE)
            if recs:
                self._cursor = recs[-1][0]
                return b"".join(
                    json.dumps({"shard": self._shard, "seq": s,
                                "epoch": e,
                                "record": r}).encode() + b"\n"
                    for s, e, r in recs)
            if self._plane._stop.is_set():
                return b""  # plane shutting down: end the stream
            self._plane.wait_for_seq(self._shard, self._cursor + 1,
                                     25.0)


class FilerServer:
    # Smallest single-chunk GET window served by the direct
    # volume→client relay instead of the buffered chunk path
    # (-filer.proxy.min; 0 disables).  Below this, the read-through
    # chunk cache wins (reuse across requests); above it, a one-shot
    # big read would only evict hot small chunks.
    PROXY_MIN = 256 * 1024

    def __init__(self, master_url: str | list[str],
                 host: str = "127.0.0.1",
                 port: int = 0, store_path: str | None = None,
                 chunk_size: int = 4 * 1024 * 1024,
                 collection: str = "", replication: str | None = None,
                 metrics_port: int | None = None,
                 ssl_context=None, cipher: bool = False,
                 slo_read_p99: float | None = None,
                 slo_availability: float | None = None,
                 transport: str | None = None,
                 cache_mb: int | None = None,
                 pack_threshold: int = 0,
                 pack_max_bytes: int = 1 << 20,
                 pack_linger: float = 0.008,
                 proxy_min: int | None = None,
                 tenant_rules: str = "",
                 cache_tenant_mb: int | None = None,
                 pulse_seconds: float = 5.0,
                 ha_dir: str | None = None):
        # Accepts an HA seed list; all master traffic (including the
        # /dir/* proxies mounts rely on) fails over via WeedClient.
        self.client = WeedClient(master_url)
        self.master_url = self.client.master_url
        self.chunk_size = chunk_size
        self.collection = collection
        self.replication = replication
        # filer.toml `cipher`: every data chunk this filer uploads is
        # sealed with a per-chunk AES-256-GCM key kept in the entry
        # metadata (filer_server_handlers_write.go cipher option).
        self.cipher = cipher
        self.proxy_min = self.PROXY_MIN if proxy_min is None \
            else int(proxy_min)
        if cache_mb is not None:
            # -filer.cache.mb resizes the process-global read-through
            # chunk cache (storage/chunk_cache.py).
            from ..storage.chunk_cache import CACHE
            CACHE.configure(int(cache_mb) << 20)
        if cache_tenant_mb is not None:
            # -filer.cache.tenant.mb caps any one tenant's share of the
            # chunk cache (tenant-first eviction; 0 = off).
            from ..storage.chunk_cache import CACHE
            CACHE.configure_tenant_cap(int(cache_tenant_mb) << 20)
        # Tenancy plane: local rules drive the front-door QoS gate
        # (per-tenant DRR fairness + token buckets in the rpc server);
        # HARD byte/object quotas are enforced against the MASTER's
        # cluster-wide rollup, polled with a short TTL (fail-open — a
        # quota check must never take writes down with the master).
        from ..tenancy import TenantUsage, load_rules
        self.tenant_policy = load_rules(tenant_rules) \
            if tenant_rules else None
        self.usage = TenantUsage()
        self._quota_cache: dict = {}     # tenant -> master row
        self._quota_cache_at = 0.0
        self._quota_cache_ttl = 2.0
        self._quota_lock = threading.Lock()
        # -filer.pack.threshold: group-commit sub-threshold uploads
        # into shared needles (filer/packing.py; 0 = off).
        self.packer = SmallFilePacker(self.client, pack_threshold,
                                      pack_max_bytes, pack_linger)
        meta_log_dir = store_path + ".metalog" if store_path else None
        self.streamer = ChunkStreamer(self.client)
        self.filer = Filer(store=store_for_path(store_path),
                           delete_file_id_fn=self._delete_file_ids,
                           meta_log_dir=meta_log_dir,
                           fetch_chunk_fn=self.streamer._fetch)
        # notification.toml: publish every meta event to the configured
        # queue (filer_notify.go + notification/configuration.go).
        try:
            from ..replication.notification import queue_from_config
            from ..utils.config import load_configuration
            self.filer.notification_queue = queue_from_config(
                load_configuration("notification"))
        except Exception as e:  # noqa: BLE001 — a broken notification
            from ..utils import glog  # config must not kill the filer
            glog.warningf("notification queue disabled: %s", e)
        self.server = rpc.JsonHttpServer(
            host, port, ssl_context=ssl_context, transport=transport,
            admission=rpc.AdmissionControl(
                0, tenant_policy=self.tenant_policy))
        s = self.server
        # Metadata-HA shard plane (filer/metaha.py): per-shard durable
        # journals + replication + the epoch fence.  Disarmed until the
        # master's heartbeat response carries a shard map
        # (-filer.shards=N on the master); a standalone filer never
        # pays for it.
        from .metaha import ShardPlane, ShardWriteError
        self._shard_err = ShardWriteError
        self._ha_tmp = None
        if ha_dir is None:
            if store_path:
                ha_dir = store_path + ".shards"
            else:
                import tempfile
                self._ha_tmp = tempfile.TemporaryDirectory(
                    prefix="filer-shards-")
                ha_dir = self._ha_tmp.name
        self.pulse_seconds = pulse_seconds
        self.shards = ShardPlane(self.filer, ha_dir,
                                 self_url="",  # set in start()
                                 pulse_seconds=pulse_seconds)
        self.filer.shard_sink = self.shards.on_op
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._hb_master = None  # leader hint; falls back to seeds
        s.route("GET", "/.meta/subscribe", self._meta_subscribe)
        s.route("GET", "/.meta/info", self._meta_info)
        s.route("POST", "/.meta/shard/apply", self._shard_apply)
        s.route("POST", "/.meta/shard/demote", self._shard_demote)
        s.route("POST", "/.meta/shard/acquire", self._shard_acquire)
        s.route("POST", "/.meta/shard/insync", self._shard_insync)
        s.route("GET", "/.meta/shard/status", self._shard_status)
        s.route("GET", "/.meta/shard/tail", self._shard_tail)
        s.route("GET", "/debug/shards", self._debug_shards)
        s.route("GET", "/debug/cache", self._debug_cache)
        s.route("GET", "/debug/tenants", self._debug_tenants)
        s.route("GET", "/.ui", self._ui)
        from ..utils.pprof import enable_pprof_routes
        enable_pprof_routes(s)
        from ..trace import setup_server_tracing
        setup_server_tracing(s, "filer")
        from ..fault.routes import setup_fault_routes
        setup_fault_routes(s)
        from ..events import setup_event_routes
        setup_event_routes(s)
        # Master proxies: mounts and other filer-only clients assign
        # file ids and resolve volumes through the filer (the filer
        # gRPC AssignVolume/LookupVolume surface, filer.proto:30-33).
        s.route("GET", "/dir/assign", self._proxy_assign)
        s.route("POST", "/dir/assign", self._proxy_assign)
        s.route("GET", "/dir/lookup", self._proxy_lookup)
        s.prefix_route("GET", "/.kv/", self._kv_get)
        s.prefix_route("PUT", "/.kv/", self._kv_put)
        # The filer's / namespace is user paths; /metrics rides its own
        # port like the other gateways (the reference's -metricsPort).
        self.metrics_registry = s.enable_metrics(
            "filer", serve_route=False)
        # Shard-plane instruments (process-global singletons,
        # stats/metrics.py): journal appends, replicated applies,
        # epoch-fence refusals.
        from ..stats.metrics import (filer_shard_apply_total,
                                     filer_shard_fences_total,
                                     filer_shard_journal_records_total)
        for m in (filer_shard_journal_records_total,
                  filer_shard_apply_total, filer_shard_fences_total):
            self.metrics_registry.register_once(m)
        # SLO plane: exemplars + live quantiles on /debug/slow and
        # /debug/slo (literal routes win over the user-path prefix
        # routes, same as the other /debug surfaces above); declared
        # objectives drive the filer's own burn engine.
        from ..stats.slo import setup_slo_routes
        setup_slo_routes(s)
        s.slo.set_objectives(slo_read_p99, slo_availability)
        # Lock-contention surface, same literal-route-wins stance as
        # the /debug surfaces above.
        from ..stats.contention import setup_contention_routes
        setup_contention_routes(s)
        self.metrics_server = None
        if metrics_port is not None:
            self.metrics_server = rpc.JsonHttpServer(host, metrics_port)
            self.metrics_server.serve_metrics_route(
                self.metrics_registry)
        s.prefix_route("GET", "/", self._get)
        s.prefix_route("HEAD", "/", self._head)
        # Uploads consume the body incrementally: each chunk_size piece
        # goes to a volume server as it arrives, so RSS stays O(chunk)
        # however large the PUT (autochunk streaming,
        # filer_server_handlers_write_autochunk.go:188).
        s.prefix_route("POST", "/", self._shard_gated(self._post),
                       stream_body=True)
        s.prefix_route("PUT", "/", self._shard_gated(self._post),
                       stream_body=True)
        s.prefix_route("DELETE", "/",
                       self._shard_gated(self._delete))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        if self.metrics_server is not None:
            self.metrics_server.start()
        # Live volume-location push from the master (KeepConnected):
        # stale vid-map entries drop as heartbeats land.
        try:
            self._loc_watch_stop = self.client.start_location_watch()
        except Exception:  # noqa: BLE001 — degrade to TTL cache
            self._loc_watch_stop = None
        # Fleet membership: the shard plane needs the bound port as its
        # identity before the first pulse (port=0 resolves at bind).
        self.shards.self_url = self.url()
        try:
            self.heartbeat_once()  # register before serving writes
        except Exception:  # noqa: BLE001 — master down: loop retries
            pass
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="filer-heartbeat")
        self._hb_thread.start()

    def stop(self) -> None:
        # Release any upload threads parked on an open pack before the
        # server stops accepting their responses.
        self.packer.flush_all()
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        if getattr(self, "_loc_watch_stop", None):
            self._loc_watch_stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self.server.stop()
        self.filer.shard_sink = None
        self.shards.stop()
        self.filer.close()
        if self._ha_tmp is not None:
            self._ha_tmp.cleanup()

    def url(self) -> str:
        return self.server.url()

    def _delete_file_ids(self, fids: list[str]) -> None:
        for fid in fids:
            try:
                self.client.delete(fid)
            except Exception:  # noqa: BLE001 — volume may be down/EC'd;
                pass           # orphan blobs are vacuum's problem

    def _manifestize(self, chunks, collection: str = "", ttl: str = "",
                     created=None):
        """Collapse huge chunk lists before they hit the metadata store
        (filer_server_handlers_write_autochunk.go saveMetaData ->
        MaybeManifestize).  Manifest blobs are stored as single chunks
        with the same collection/TTL as the data they index."""
        from .filechunk_manifest import maybe_manifestize
        from .stream import upload_blob
        return maybe_manifestize(
            lambda data: upload_blob(self.client, data,
                                     collection or self.collection,
                                     self.replication, ttl,
                                     cipher=self.cipher), chunks,
            created=created)

    # -- read ----------------------------------------------------------------

    def _get(self, path: str, query: dict, body: bytes,
             head: bool = False):
        path = urllib.parse.unquote(path)
        is_dir_request = path.endswith("/") and path != "/"
        lookup = path.rstrip("/") or "/"
        try:
            e = self.filer.find_entry(lookup)
        except NotFound:
            raise rpc.RpcError(404, f"{lookup} not found") from None
        if query.get("metadata") == "true":
            return e.to_dict()
        if e.is_directory:
            return self._list_dir(lookup, query)
        if is_dir_request:
            raise rpc.RpcError(404, f"{lookup} is a file")
        return self._serve_file(e, query, head=head)

    def _head(self, path: str, query: dict, body: bytes):
        return self._get(path, query, body, head=True)

    def _list_dir(self, path: str, query: dict) -> dict:
        limit = int(query.get("limit", 1024))
        last = query.get("lastFileName", "")
        entries = self.filer.list_entries(path, last, False, limit)
        return {
            "path": path,
            "entries": [self._entry_summary(e) for e in entries],
            "lastFileName": entries[-1].name if entries else "",
            "shouldDisplayLoadMore": len(entries) >= limit,
        }

    @staticmethod
    def _entry_summary(e: Entry) -> dict:
        return {"FullPath": e.path, "name": e.name,
                "is_directory": e.is_directory, "size": e.size(),
                "mtime": e.attributes.mtime, "mode": e.attributes.mode,
                "mime": e.attributes.mime}

    def _serve_file(self, e: Entry, query: dict, head: bool = False):
        size = total_size(e.chunks)
        mime = e.attributes.mime or "application/octet-stream"
        headers = {"Content-Type": mime, "Accept-Ranges": "bytes",
                   "ETag": f'"{chunks_etag(e.chunks)}"' if e.chunks
                   else '""'}
        if head:  # never materialize chunks just to discard the body
            headers["Content-Length"] = str(size)
            return (200, b"", headers)
        # Stream: the handler hands a file-like range reader to the rpc
        # writer, so a multi-GB GET is O(MB) filer RSS — symmetric with
        # the streaming upload path (the reference's StreamContent).
        rng = self._parse_range(query.get("_range_header", ""), size)
        if rng is not None:
            # parse_byte_range guarantees lo <= hi (reversed ranges
            # come back None -> whole body) and raises 416 itself for
            # past-the-end starts.
            lo, hi = rng
            status, n = 206, hi - lo + 1
            headers["Content-Range"] = f"bytes {lo}-{hi}/{size}"
        else:
            status, lo, n = 200, 0, size
        headers["Content-Length"] = str(n)
        self.usage.note_request(query.get("_tenant", ""), read_bytes=n)
        if self.proxy_min > 0 and n >= self.proxy_min:
            # Large single-chunk window: relay the volume's bytes
            # straight through (zero-copy when the platform splices)
            # instead of buffering them — and keep them OUT of the
            # chunk cache, where a one-shot big read would evict hot
            # small chunks.
            body = self._open_direct(e.chunks, lo, n)
            if body is not None:
                return (status, body, headers)
        return (status,
                self.streamer.range_reader(e.chunks, lo, n).prime(),
                headers)

    def _open_direct(self, chunks, lo: int, n: int):
        """ProxiedBody for [lo, lo+n) when exactly one plaintext,
        unpacked chunk covers the whole window — else None (the
        buffered chunk path handles everything)."""
        try:
            chunks = self.streamer.resolve(chunks)
        except Exception:  # noqa: BLE001 — manifest fetch failed: let
            return None    # the buffered path surface the error
        views = read_chunk_views(chunks, lo, n)
        if len(views) != 1:
            return None
        v = views[0]
        if v.size != n or v.logical_offset != lo:
            return None  # hole-padded or short window
        c = next((c for c in chunks if c.file_id == v.file_id), None)
        if c is None or c.cipher_key or getattr(c, "packed", False):
            return None
        return self.client.open_stream(v.file_id, v.offset_in_chunk, n)

    # Range parsing is the shared strict parser (rpc.parse_byte_range)
    # — the reference's filer and volume reads go through the same
    # processRangeRequest (filer_server_handlers_read.go:130).
    _parse_range = staticmethod(rpc.parse_byte_range)

    # -- tenancy -------------------------------------------------------------

    def _tenant_rows(self) -> dict:
        """Master /cluster/tenants rows, cached ~2s.  Fail-open: a
        master outage must degrade quota enforcement, not uploads —
        the master re-checks at assign time anyway (the backstop)."""
        now = time.monotonic()
        with self._quota_lock:
            if now - self._quota_cache_at < self._quota_cache_ttl:
                return self._quota_cache
        try:
            doc = self.client._master_call("/cluster/tenants")
            rows = doc.get("tenants", {}) if isinstance(doc, dict) \
                else {}
        except Exception:  # noqa: BLE001 — fail open
            rows = self._quota_cache
        with self._quota_lock:
            self._quota_cache = rows
            self._quota_cache_at = now
        return rows

    def _check_quota(self, tenant: str) -> None:
        """Reject an upload up front when the master's rollup says the
        tenant is over a HARD quota — same 403 shape as the master's
        assign gate, but caught before any chunk bytes move."""
        if not tenant:
            return
        row = self._tenant_rows().get(tenant)
        if not row:
            return
        over = row.get("over_quota") or []
        if over and row.get("enforcement") == "hard":
            raise rpc.RpcError(
                403, f"QuotaExceeded: tenant {tenant!r} over quota "
                f"({','.join(over)}); delete data (and let vacuum "
                "reclaim) to resume writes")

    def _debug_tenants(self, query: dict, body: bytes) -> dict:
        """GET /debug/tenants — same shape as the volume server's:
        stored/rates at top level, plus the filer-only surfaces (the
        master-rollup quota cache and per-tenant chunk-cache bytes)."""
        from ..storage.chunk_cache import CACHE
        out = self.usage.snapshot()
        out["node"] = self.url()
        out["admission"] = self.server.admission.snapshot()
        out["quota_cache"] = self._quota_cache
        out["cache_tenants"] = CACHE.stats().get("tenants", {})
        out["rules"] = self.tenant_policy.to_dict() \
            if self.tenant_policy else []
        return out

    # -- write ---------------------------------------------------------------

    @staticmethod
    def _signatures(query: dict) -> list[int]:
        """?signatures=1,2,3 — origin chain a sync client replays so the
        resulting events keep their loop-breaker signatures."""
        raw = query.get("signatures", "")
        return [int(s) for s in raw.split(",") if s.strip()]

    def _post(self, path: str, query: dict, body):
        """body is a rpc.BodyReader (stream_body route): the metadata
        branches read it fully (small JSON), the upload branch streams
        it to volume servers chunk by chunk."""
        path = urllib.parse.unquote(path).rstrip("/") or "/"
        if query.get("entry") == "true":
            body = body.read()
            # Raw entry create with an explicit chunk list — the filer
            # gRPC CreateEntry surface (used by S3 multipart completion
            # and filer.sync, which move chunks without re-uploading).
            d = json.loads(body)
            d["path"] = path
            entry = Entry.from_dict(d)
            ttl_sec = entry.attributes.ttl_sec
            manifests: list = []
            try:
                entry.chunks = self._manifestize(
                    entry.chunks, entry.attributes.collection,
                    f"{ttl_sec}s" if ttl_sec else "", created=manifests)
                with self.filer.with_signatures(self._signatures(query)):
                    e = self.filer.create_entry(entry)
            except Exception as err:
                # The caller owns its chunks, but any manifest blobs we
                # uploaded (even partially, mid-manifestize) belong to
                # nobody now — free them.
                self._delete_file_ids([c.file_id for c in manifests])
                if isinstance(err, FilerError):
                    raise rpc.RpcError(409, str(err)) from None
                raise
            return e.to_dict()
        if "hardlink.from" in query:
            # `ln` through the HTTP surface: POST /new/name?hardlink.from=
            # /existing/file (the filer gRPC CreateEntry-with-HardLinkId
            # path the FUSE mount uses in the reference).
            src = query["hardlink.from"]
            try:
                e = self.filer.create_hardlink(src, path)
            except NotFound:
                raise rpc.RpcError(404, f"{src} not found") from None
            except FilerError as err:
                raise rpc.RpcError(400, str(err)) from None
            return e.to_dict()
        if "mv.to" in query:
            dst = query["mv.to"]
            try:
                self.filer.rename(path, dst)
            except NotFound:
                raise rpc.RpcError(404, f"{path} not found") from None
            except FilerError as e:
                raise rpc.RpcError(400, str(e)) from None
            return {"from": path, "to": dst}
        if query.get("mkdir") == "true":
            try:
                with self.filer.with_signatures(self._signatures(query)):
                    self.filer.create_entry(Entry(
                        path=path, is_directory=True,
                        attributes=Attributes(mtime=time.time(),
                                              crtime=time.time(),
                                              mode=0o775)))
            except FilerError as e:
                raise rpc.RpcError(409, str(e)) from None
            return {"path": path, "is_directory": True}
        if path == "/":
            raise rpc.RpcError(400, "cannot upload to the root directory")
        tenant = query.get("_tenant", "")
        self._check_quota(tenant)
        collection = query.get("collection", self.collection)
        ttl = query.get("ttl", "")
        head = b""
        if self.packer.enabled and not self.cipher:
            # Small-file fast path: peek one byte past the packing
            # threshold.  A body that fits whole joins the open pack
            # (one shared needle per linger window instead of one
            # assign+POST per file); anything larger — or a failed
            # pack — continues on the normal chunked path with the
            # consumed head stitched back in front.
            want = self.packer.threshold + 1
            while len(head) < want:
                piece = body.read(want - len(head))
                if not piece:
                    break
                head += piece
            if len(head) <= self.packer.threshold:
                pc = self.packer.add(head, collection,
                                     self.replication, ttl)
                if pc is not None:
                    attr = Attributes(
                        mtime=time.time(), crtime=time.time(),
                        mime=query.get("_content_type",
                                       "application/octet-stream"),
                        ttl_sec=_ttl_seconds(ttl),
                        collection=collection,
                        replication=self.replication or "")
                    try:
                        with trace_span("filer.create_entry",
                                        path=path, packed=True), \
                                self.filer.with_signatures(
                                    self._signatures(query)):
                            entry = self.filer.create_entry(Entry(
                                path=path, chunks=[pc],
                                attributes=attr))
                    except FilerError as err:
                        # Metadata-only rollback: the pack needle is
                        # shared with sibling files — never delete it.
                        raise rpc.RpcError(409, str(err)) from None
                    self.usage.note_request(tenant,
                                            written_bytes=pc.size)
                    return {"name": entry.name, "size": pc.size,
                            "eTag": chunks_etag([pc])}
        writer = ChunkedWriter(
            self.client, chunk_size=self.chunk_size,
            collection=collection, replication=self.replication, ttl=ttl,
            cipher=self.cipher)
        raw_chunks: list = []
        manifests: list = []
        try:
            # The chunk-upload fan-out is where a slow filer write
            # hides: each chunk is an assign (master hop) + POST
            # (volume hop, which itself fans out to replicas) — all
            # child spans of this one on a trace.
            with trace_span("filer.write.chunks", path=path) as csp:
                writer.write(_PrefixedBody(head, body) if head
                             else body, into=raw_chunks)
                chunks = self._manifestize(raw_chunks, collection, ttl,
                                           created=manifests)
                csp.set(chunks=len(raw_chunks))
        except Exception:
            # Client died (or a volume write failed) mid-stream: the
            # entry never existed, so free everything that landed —
            # data chunks AND any manifest blobs already uploaded.
            self._delete_file_ids([c.file_id for c in raw_chunks] +
                                  [c.file_id for c in manifests])
            raise
        attr = Attributes(
            mtime=time.time(), crtime=time.time(),
            mime=query.get("_content_type",
                           "application/octet-stream"),
            ttl_sec=_ttl_seconds(ttl), collection=collection,
            replication=self.replication or "")
        try:
            with trace_span("filer.create_entry", path=path), \
                    self.filer.with_signatures(self._signatures(query)):
                entry = self.filer.create_entry(
                    Entry(path=path, chunks=chunks, attributes=attr))
        except FilerError as e:
            # Roll back EVERYTHING uploaded: the raw data chunks (the
            # manifest blobs only reference them — deleting the
            # manifest first would orphan them) plus the manifest
            # blobs themselves.
            self._delete_file_ids(
                [c.file_id for c in raw_chunks] +
                [c.file_id for c in chunks if c.is_chunk_manifest])
            raise rpc.RpcError(409, str(e)) from None
        self.usage.note_request(tenant,
                                written_bytes=total_size(chunks))
        return {"name": entry.name, "size": total_size(chunks),
                "eTag": chunks_etag(chunks)}

    # -- delete --------------------------------------------------------------

    def _delete(self, path: str, query: dict, body: bytes):
        path = urllib.parse.unquote(path).rstrip("/") or "/"
        recursive = query.get("recursive") == "true"
        keep_chunks = query.get("skipChunkDeletion") == "true"
        try:
            with self.filer.with_signatures(self._signatures(query)):
                self.filer.delete_entry(path, recursive=recursive,
                                        delete_chunks=not keep_chunks)
        except NotFound:
            raise rpc.RpcError(404, f"{path} not found") from None
        except FilerError as e:
            raise rpc.RpcError(400, str(e)) from None
        return {"deleted": path}

    # -- meta subscription ---------------------------------------------------

    def _meta_subscribe(self, query: dict, body: bytes):
        """Metadata tail (SubscribeMetadata): events newer than
        since_ns, replayed from the persistent journal.
        ?exclude_signature=N drops events already carrying that
        signature — the filer.sync loop-breaker; ?prefix=/p filters by
        directory prefix (SubscribeMetadata PathPrefix).

        Default is one poll page; ?tail=true upgrades to a LONG-LIVED
        PUSH STREAM (NDJSON over chunked transfer-encoding): replay,
        then every new mutation is pushed the moment it commits — the
        reference's replay-then-tail gRPC stream
        (filer_grpc_server_sub_meta.go), no polling."""
        if "shard" in query:
            # Shard-journal mode: exact (shard, seq) resume — the
            # cursor survives a failover because seq numbers are the
            # replicated history, not this node's clock.
            return self._shard_subscribe(query)
        if query.get("tail") == "true":
            return self._meta_subscribe_stream(query)
        since = int(query.get("since_ns", 0))
        limit = int(query.get("limit", 10000))
        excl = int(query.get("exclude_signature", 0))
        prefix = query.get("prefix", "")
        # Snapshot the journal head BEFORE scanning: an event appended
        # mid-scan must not advance the cursor past itself unseen (it
        # will be redelivered next poll — duplicates over loss).
        head = self.filer.meta_log.last_ts_ns()
        raw = self.filer.read_meta_events(since, limit)
        events = []
        for ev in raw:
            if excl and excl in ev.signatures:
                continue
            if prefix and not (ev.directory + "/").startswith(
                    prefix.rstrip("/") + "/"):
                continue
            events.append(ev.to_dict())
        # The resume cursor must not jump past unscanned events either:
        # it stops at the last *scanned* event (even if filters dropped
        # it), or at the pre-scan head when the scan saw nothing.
        last = raw[-1].ts_ns if raw else max(since, head)
        return {"events": events, "last_ns": last,
                "signature": self.filer.signature}

    def _meta_subscribe_stream(self, query: dict):
        since = int(query.get("since_ns", 0))
        excl = int(query.get("exclude_signature", 0))
        prefix = query.get("prefix", "")
        return (200, _MetaTail(self.filer, since, excl, prefix),
                {"Content-Type": "application/x-ndjson"})

    # -- metadata-HA shard plane (filer/metaha.py) ---------------------------

    def _shard_gated(self, fn):
        """Write-gate for the user-namespace mutation routes: when the
        shard plane is armed, refuse up front (before any body bytes or
        chunk uploads move) unless this filer is the live primary for
        the path's shard — and convert a mid-commit ShardWriteError
        (fence/no-insync discovered at journal time) into the same
        JSON verdict.  409 carries the primary hint for shard-map-aware
        clients; 503 means contested, retry after the map settles."""
        def handler(path: str, query: dict, body):
            if self.shards.armed:
                p = urllib.parse.unquote(path).rstrip("/") or "/"
                if "mv.to" in query:
                    verdict = self.shards.gate_rename(p, query["mv.to"])
                else:
                    verdict = self.shards.gate(p)
                if verdict is not None:
                    return self._shard_verdict(*verdict)
            try:
                return fn(path, query, body)
            except self._shard_err as e:
                return self._shard_verdict(e.status, e.doc)
        return handler

    @staticmethod
    def _shard_verdict(status: int, doc: dict):
        if status == 200:
            return doc
        return (status, json.dumps(doc).encode(),
                {"Content-Type": "application/json"})

    def _shard_apply(self, query: dict, body: bytes):
        d = json.loads(body)
        return self._shard_verdict(*self.shards.apply_record(
            int(d["shard"]), int(d["epoch"]), int(d["seq"]),
            d["record"]))

    def _shard_demote(self, query: dict, body: bytes):
        d = json.loads(body)
        return self._shard_verdict(*self.shards.demote(
            int(d["shard"]), int(d.get("epoch", 0))))

    def _shard_acquire(self, query: dict, body: bytes):
        d = json.loads(body)
        return self._shard_verdict(*self.shards.acquire(
            int(d["shard"]), int(d["epoch"]),
            list(d.get("followers", [])), int(d.get("version", 0))))

    def _shard_insync(self, query: dict, body: bytes):
        d = json.loads(body)
        return self._shard_verdict(*self.shards.reinsync(
            int(d["shard"]), d["follower"], int(d.get("seq", 0))))

    def _shard_status(self, query: dict, body: bytes) -> dict:
        if "shard" in query:
            k = int(query["shard"])
            log = self.shards.log_for(k)
            return {"shard": k, "role": self.shards.role(k),
                    "epoch": self.shards._epochs.get(k, 0),
                    "last_seq": log.last_seq,
                    "applied_seq": log.watermark.value}
        return self.shards.status()

    def _shard_tail(self, query: dict, body: bytes) -> dict:
        k = int(query["shard"])
        since = int(query.get("since_seq", 0))
        limit = min(int(query.get("limit", 500)), 2000)
        log = self.shards.log_for(k)
        recs = log.read_from(since + 1, limit)
        return {"shard": k, "last_seq": log.last_seq,
                "records": [[s, e, r] for s, e, r in recs]}

    def _shard_subscribe(self, query: dict):
        k = int(query["shard"])
        since = int(query.get("since_seq", 0))
        if query.get("tail") == "true":
            return (200, _ShardTail(self.shards, k, since),
                    {"Content-Type": "application/x-ndjson"})
        limit = min(int(query.get("limit", 1000)), 10000)
        recs = self.shards.log_for(k).read_from(since + 1, limit)
        return {"shard": k,
                "records": [{"seq": s, "epoch": e, "record": r}
                            for s, e, r in recs],
                "last_seq": recs[-1][0] if recs else since,
                "signature": self.filer.signature}

    def _debug_shards(self, query: dict, body: bytes) -> dict:
        """GET /debug/shards — the plane's own view: per-shard role,
        epoch, journal head, applied watermark, in-sync set."""
        return self.shards.status()

    def heartbeat_once(self) -> bool:
        """Register + pulse with the master (filers are fleet members
        like volume servers): ships per-shard journal positions so
        failover promotes the most-caught-up follower, and adopts the
        shard map the leader's response carries.  A successful pulse
        renews the primary lease TTL (metaha.note_master_contact) —
        no master contact, no acks."""
        from ..fault import registry as _fault
        payload = {"url": self.url(),
                   "signature": self.filer.signature,
                   "shards": self.shards.heartbeat_rows()}
        master = self._hb_master or self.client.master_url
        try:
            if _fault.ARMED:
                _fault.hit("wan.partition", master=master,
                           server=self.url())
            doc = rpc.call_json(master + "/filer/heartbeat",
                                payload=payload, timeout=5.0)
        except Exception:  # noqa: BLE001 — master down: rotate seeds
            seeds = self.client.masters
            if len(seeds) > 1:
                i = (seeds.index(master) + 1) % len(seeds) \
                    if master in seeds else 0
                self._hb_master = seeds[i]
            return False
        if doc.get("is_leader") is False:
            hint = doc.get("leader")
            if hint and hint != master:
                self._hb_master = hint  # redial the leader next tick
            return False
        self._hb_master = master
        self.shards.note_master_contact()
        if doc.get("num_shards"):
            self.shards.arm(doc)
        return True

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.pulse_seconds):
            try:
                self.heartbeat_once()
            except Exception:  # noqa: BLE001 — never kill the pulse
                pass

    def _ui(self, query: dict, body: bytes):
        """Status page (the reference's filer UI).  Lives at /.ui since
        / is the user namespace."""
        from html import escape as esc
        html = (
            "<!doctype html><title>seaweedfs-tpu filer</title>"
            "<style>body{font-family:sans-serif;margin:2em}</style>"
            f"<h1>Filer {self.url()}</h1>"
            f"<p>master: {esc(self.master_url)}"
            " &middot; "
            f"store: {type(self.filer.store).__name__} &middot; "
            f"signature: {self.filer.signature} &middot; "
            f"meta log head: {self.filer.meta_log.last_ts_ns()}</p>"
            "<p><a href='/?limit=100'>browse /</a> &middot; "
            "<a href='/.meta/info'>meta info</a></p>")
        return (200, html.encode(),
                {"Content-Type": "text/html; charset=utf-8"})

    def _debug_cache(self, query: dict, body: bytes) -> dict:
        """Front-door read-path surface: chunk-cache hit economics and
        the packing configuration, one curl away (README debug table).
        `?fids=1` adds the port's `resident` list: [file id, bytes] of
        every cached chunk, least recently used first, so a caller can
        tell which of its reads the cache will serve."""
        from ..storage.chunk_cache import CACHE
        out = {"chunk_cache": CACHE.stats(),
               "packing": {"enabled": self.packer.enabled,
                           "threshold": self.packer.threshold,
                           "max_bytes": self.packer.max_bytes,
                           "linger_s": self.packer.linger},
               "proxy_min": self.proxy_min}
        if query.get("fids") == "1":
            out["resident"] = CACHE.resident()
        return out

    def _meta_info(self, query: dict, body: bytes) -> dict:
        # `cipher` is the GetFilerConfiguration bit mounts honor
        # (filer_grpc_server.go GetFilerConfiguration → wfs.go): clients
        # writing through this filer must seal chunks the same way.
        return {"signature": self.filer.signature,
                "last_ns": self.filer.meta_log.last_ts_ns(),
                "cipher": self.cipher}

    def _proxy_assign(self, query: dict, body: bytes):
        import urllib.parse
        qs = urllib.parse.urlencode(
            {k: v for k, v in query.items() if not k.startswith("_")})
        return self.client._master_call(
            "/dir/assign" + (f"?{qs}" if qs else ""))

    def _proxy_lookup(self, query: dict, body: bytes):
        import urllib.parse
        qs = urllib.parse.urlencode(
            {k: v for k, v in query.items() if not k.startswith("_")})
        return self.client._master_call(
            "/dir/lookup" + (f"?{qs}" if qs else ""))

    # -- KV (filer.proto KvGet/KvPut — sync offset checkpoints) -------------

    def _kv_get(self, path: str, query: dict, body: bytes):
        key = path[len("/.kv/"):]
        v = self.filer.store.kv_get(key)
        if v is None:
            raise rpc.RpcError(404, f"kv key {key} not found")
        return (200, v, {"Content-Type": "application/octet-stream"})

    def _kv_put(self, path: str, query: dict, body: bytes):
        key = path[len("/.kv/"):]
        self.filer.store.kv_put(key, body)
        return {"stored": key}


class _PrefixedBody:
    """Stitches the packing fast path's peeked head back in front of
    the unread remainder, filling each read to the requested size so
    ChunkedWriter still cuts full chunk_size chunks."""

    def __init__(self, head: bytes, rest):
        self._head = head
        self._rest = rest

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            out, self._head = self._head, b""
            return out + self._rest.read()
        out = bytearray(self._head[:n])
        self._head = self._head[n:]
        while len(out) < n:
            piece = self._rest.read(n - len(out))
            if not piece:
                break
            out += piece
        return bytes(out)


def _ttl_seconds(ttl: str) -> int:
    if not ttl:
        return 0
    from ..core.ttl import TTL
    return TTL.parse(ttl).minutes() * 60
