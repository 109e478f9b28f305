"""Client operations: assign / upload / download / delete, with a
volume-location cache — the wdclient + operation packages of the reference
(weed/wdclient/masterclient.go vidMap, weed/operation/).

`use_grpc=True` (or WEED_INTERNAL_GRPC=1) sends assign and lookup over
the master's wire-compatible gRPC plane (pb/master_grpc.py), which needs
grpcio and protobuf.  Unlike the reference, a master that is not the
leader answers an assign there with the status UNAVAILABLE, not an
in-message error, so the client rotates to the next seed as the JSON
plane does on a 503.
"""

from __future__ import annotations

import threading
import time
import urllib.parse

from ..core import types as t
from ..netcore import splice as splice_mod
from ..stats import flows as _flows
from ..trace import current_traceparent
from . import resilience, rpc


def _grpc_trace_metadata():
    """traceparent as gRPC metadata — the gRPC analog of the header the
    HTTP plane injects in rpc._request (the server facade forwards it
    to the JSON handlers)."""
    tp = current_traceparent()
    return (("traceparent", tp),) if tp else None


class VidCache:
    """vid -> locations with TTL + round-robin reads (wdclient/vid_map.go)."""

    def __init__(self, ttl_seconds: float = 60.0):
        self.ttl = ttl_seconds
        self._m: dict[int, tuple[float, list[dict]]] = {}
        self._rr: dict[int, int] = {}
        self._lock = threading.Lock()

    def get(self, vid: int) -> list[dict] | None:
        with self._lock:
            hit = self._m.get(vid)
            if hit is None or time.time() - hit[0] > self.ttl:
                return None
            return hit[1]

    def put(self, vid: int, locations: list[dict]) -> None:
        with self._lock:
            self._m[vid] = (time.time(), locations)

    def forget(self, vid: int) -> None:
        with self._lock:
            self._m.pop(vid, None)

    def pick(self, vid: int) -> dict | None:
        locs = self.get(vid)
        if not locs:
            return None
        with self._lock:
            i = self._rr.get(vid, 0)
            self._rr[vid] = i + 1
        return locs[i % len(locs)]


class ProxiedBody:
    """Streaming volume→client relay for the filer's large-read proxy
    leg: wraps an open upstream GET whose body has NOT been read, and
    hands it to rpc._respond as a file-like payload.  On a plaintext
    downstream, _respond calls sendfile_to and the bytes move
    volume-socket → filer → client-socket kernel-side (netcore/splice);
    TLS or spliceless platforms take the buffered read() loop instead.
    Either way the filer never holds more than one window in memory."""

    def __init__(self, resp, conn, size: int):
        self._resp = resp
        self._conn = conn
        self.size = size
        # Instance attribute, not a method: rpc._respond probes with
        # getattr, and a TLS *upstream* (https volume leg) has no raw
        # fd to splice from — the attribute is simply absent then.
        if splice_mod.HAVE_SPLICE and conn.key[0] == "http":
            self.sendfile_to = self._splice_to

    def read(self, n: int = -1) -> bytes:
        return self._resp.read(n)

    def _splice_to(self, dst, note=None) -> None:
        resp, conn = self._resp, self._conn
        # Wire-flow attribution: spliced bytes bypass resp.read(), so
        # the client leg's "in" note (set by rpc._request) is fed here
        # with the same syscall totals the downstream "out" note gets.
        fin = resp.flow_note

        def _both(n: int) -> None:
            if note is not None:
                note(n)
            if fin is not None:
                fin(n)

        left = resp._remaining
        # The buffered reader that parsed the response head almost
        # always pulled the first body bytes along with it; one read1
        # empties that buffer (<= its 64KB size) without a raw recv,
        # then the rest moves straight off the socket fd.
        head = conn.rf.read1(min(left, 1 << 16)) if left > 0 else b""
        if head:
            splice_mod._write_all(dst.fileno(), head)
            left -= len(head)
            _both(len(head))
        if left:
            splice_mod.copy_fd(conn.sock.fileno(), dst.fileno(), left,
                               note=_both)
        resp._remaining = 0
        resp._done = True

    def close(self) -> None:
        # Fully-relayed bodies return the upstream conn to the pool;
        # an aborted transfer leaves unread bytes, so the conn dies.
        if self._resp._done:
            rpc._finish(self._conn, self._resp)
        else:
            self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _GrpcMasterTransport:
    """Master Assign/Lookup over the wire-compatible master_pb.Seaweed
    gRPC plane (http port + 10000) — the transport a ported Go client
    uses (wdclient dials gRPC, pb/grpc_client_server.go).  Selected by
    WeedClient(use_grpc=True) or WEED_INTERNAL_GRPC=1, so the capstone
    stack can run its internal master traffic through the gRPC facade
    instead of the JSON plane (facade-drift canary).  One instance per
    master seed; WeedClient rotates across them on failure
    (tryAllMasters, like the JSON path)."""

    def __init__(self, master_url: str):
        import grpc

        from ..pb import master_pb2
        from ..pb.master_grpc import GRPC_PORT_DELTA
        self.pb = master_pb2
        hostport = master_url.split("://")[-1].rstrip("/")
        host, _, port = hostport.rpartition(":")
        if not host or not port.isdigit():
            host, port = hostport, "80"  # port-less URL: http default
        self.addr = f"{host}:{int(port) + GRPC_PORT_DELTA}"
        self._chan = grpc.insecure_channel(self.addr)
        svc = "/master_pb.Seaweed/"
        self._assign = self._chan.unary_unary(
            svc + "Assign",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=master_pb2.AssignResponse.FromString)
        self._lookup = self._chan.unary_unary(
            svc + "LookupVolume",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=(
                master_pb2.LookupVolumeResponse.FromString))

    def assign(self, count, collection, replication, ttl,
               data_center) -> dict:
        out = self._assign(self.pb.AssignRequest(
            count=count, collection=collection,
            replication=replication or "", ttl=ttl,
            data_center=data_center), timeout=10,
            wait_for_ready=True, metadata=_grpc_trace_metadata())
        if out.error:
            raise rpc.RpcError(500, out.error)
        resp = {"fid": out.fid, "url": out.url,
                "publicUrl": out.public_url, "count": out.count}
        if out.auth:
            resp["auth"] = out.auth
        return resp

    def lookup(self, vid: int) -> list[dict]:
        out = self._lookup(self.pb.LookupVolumeRequest(
            volume_ids=[str(vid)]), timeout=10, wait_for_ready=True,
            metadata=_grpc_trace_metadata())
        for entry in out.volume_id_locations:
            if entry.error:
                return []
            return [{"url": loc.url, "publicUrl": loc.public_url}
                    for loc in entry.locations]
        return []

    def close(self) -> None:
        self._chan.close()


class WeedClient:
    """Accepts one master URL or an HA seed list; master calls fail
    over across seeds like the reference's MasterClient
    (wdclient/masterclient.go tryAllMasters)."""

    def __init__(self, master_url: str | list[str],
                 use_grpc: bool | None = None,
                 retry_policy: "resilience.RetryPolicy | None" = None):
        import os
        urls = master_url if isinstance(master_url, list) \
            else [master_url]
        self.masters = [u.rstrip("/") for u in urls]
        self._master_idx = 0
        # Write-path policy: upload re-assigns to a fresh volume on
        # failure, paced by this policy's backoff.
        self.retry_policy = retry_policy or resilience.RetryPolicy()
        self._secured: bool | None = None  # learned from responses
        self.cache = VidCache()
        self._watch_stop: threading.Event | None = None
        if use_grpc is None:
            use_grpc = os.environ.get("WEED_INTERNAL_GRPC") == "1"
        self._use_grpc = use_grpc
        # Lazily dialed, one per master seed (HA failover rotates).
        self._grpc_transports: dict[str, _GrpcMasterTransport] = {}

    @property
    def _grpc(self) -> "_GrpcMasterTransport | None":
        """Transport for the CURRENT master seed (None when the JSON
        plane is selected)."""
        if not self._use_grpc:
            return None
        url = self.master_url
        t = self._grpc_transports.get(url)
        if t is None:
            t = self._grpc_transports[url] = _GrpcMasterTransport(url)
        return t

    def _grpc_master_call(self, method: str, *args):
        """Try each master seed once over gRPC, rotating past dead
        ones — the gRPC analog of _master_call/tryAllMasters."""
        last_err: Exception | None = None
        for _ in range(len(self.masters)):
            try:
                return getattr(self._grpc, method)(*args)
            except rpc.RpcError:
                raise  # a real server-side answer
            except Exception as e:  # noqa: BLE001 — dead/unreachable
                last_err = e
            self._master_idx = (self._master_idx + 1) % \
                len(self.masters)
        raise last_err or rpc.RpcError(503, "no master reachable")

    def close(self) -> None:
        """Release transport resources (gRPC channels)."""
        if self._watch_stop is not None:
            self._watch_stop.set()
        for t in self._grpc_transports.values():
            t.close()
        self._grpc_transports.clear()

    def start_location_watch(self):
        """Subscribe to the master's /cluster/watch push stream (the
        KeepConnected analog): volume-location changes invalidate the
        vid cache the moment heartbeats land, instead of waiting out
        the TTL.  Returns a stop() function; reconnects with backoff
        while running."""
        stop = threading.Event()
        self._watch_stop = stop
        holder: dict = {}

        def loop():
            while not stop.is_set():
                try:
                    handle = rpc.call_stream(
                        f"{self.master_url}/cluster/watch",
                        stop_event=stop)
                    holder["handle"] = handle
                    for doc in handle.events():
                        if stop.is_set():
                            return
                        for vid in doc.get("new_vids", []) + \
                                doc.get("deleted_vids", []):
                            self.cache.forget(int(vid))
                except rpc.RpcError as e:
                    # A follower refuses watch streams (503): rotate to
                    # the next seed until the leader answers.
                    if e.status == 503 and len(self.masters) > 1:
                        self._master_idx = (self._master_idx + 1) \
                            % len(self.masters)
                except Exception:  # noqa: BLE001 — master down; redial
                    pass
                finally:
                    holder.pop("handle", None)
                stop.wait(1.0)

        threading.Thread(target=loop, daemon=True,
                         name="vid-watch").start()

        def stopper():
            stop.set()
            handle = holder.get("handle")
            if handle is not None:
                handle.close()
        return stopper

    @property
    def master_url(self) -> str:
        return self.masters[self._master_idx]

    def _master_call(self, path_qs: str):
        """Try each master seed once; rotate past dead/leaderless ones
        so the winner stays current for subsequent calls."""
        last_err: Exception | None = None
        for _ in range(len(self.masters)):
            try:
                return rpc.call(self.master_url + path_qs)
            except rpc.RpcError as e:
                if e.status != 503:  # a real answer, not "no leader"
                    raise
                last_err = e
            except OSError as e:
                last_err = e
            self._master_idx = (self._master_idx + 1) % \
                len(self.masters)
        raise last_err or rpc.RpcError(503, "no master reachable")

    # -- master ops ----------------------------------------------------------

    def assign(self, count: int = 1, collection: str = "",
               replication: str | None = None, ttl: str = "",
               data_center: str = "") -> dict:
        q = [f"count={count}"]
        if collection:
            q.append(f"collection={collection}")
        if replication is not None:
            q.append(f"replication={replication}")
        if ttl:
            q.append(f"ttl={ttl}")
        if data_center:
            q.append(f"dataCenter={data_center}")
        if self._use_grpc:
            return self._grpc_master_call(
                "assign", count, collection, replication, ttl,
                data_center)
        return self._master_call("/dir/assign?" + "&".join(q))

    def lookup(self, vid: int, include_ec: bool = False) -> list[dict]:
        """Volume locations.  include_ec adds EC shard holders — READ
        targets only (any holder reconstructs across the cluster); they
        are never cached and never offered to write/delete paths, which
        must keep failing fast on EC'd volumes."""
        cached = self.cache.get(vid)
        if cached is not None:
            return cached
        if self._use_grpc:
            locs = self._grpc_master_call("lookup", vid)
            if locs:
                self.cache.put(vid, locs)
                return locs
            # EC-only / unknown volumes need the richer JSON answer
            # (ecShards); fall through to the HTTP lookup.
        resp = self._master_call(f"/dir/lookup?volumeId={vid}")
        locs = resp.get("locations", [])
        if locs:
            self.cache.put(vid, locs)
            return locs
        if include_ec:
            urls = {d["url"] for dns in resp.get("ecShards", {}).values()
                    for d in dns}
            return [{"url": u} for u in sorted(urls)]
        return []

    # -- object ops ----------------------------------------------------------

    def upload_data(self, data: bytes, collection: str = "",
                    replication: str | None = None, ttl: str = "",
                    name: str = "") -> str:
        """Assign + PUT. Returns the fid."""
        return self.upload(data, collection=collection,
                           replication=replication, ttl=ttl,
                           name=name)["fid"]

    def upload(self, data: bytes, collection: str = "",
               replication: str | None = None, ttl: str = "",
               name: str = "", mime: str = "",
               compress: bool = True, cipher: bool = False) -> dict:
        """Assign + PUT with the full upload pipeline of the
        reference's operation.UploadData (operation/upload_content.go):
        compressible content is gzipped when that shrinks it (sent with
        Content-Encoding so the needle records the flag), and cipher=True
        seals the bytes with a fresh AES-256-GCM key the caller keeps —
        the volume server stores opaque data with no name/mime.

        Returns {fid, url, size, etag, is_compressed, cipher_key}.
        `size` is the logical (plaintext) size; cipher_key is b"" unless
        cipher was requested.

        Write-path resilience: a failed PUT (dead/sick volume server)
        does not surface the first dead server — the client re-assigns,
        which hands it a FRESH volume/fid, and retries there after a
        jittered backoff (retry_policy).  Re-sending to a new fid is
        always safe: the non-idempotent body never replays against the
        same needle, which is the transport's own no-resend rule lifted
        to the application layer.
        """
        size = len(data)
        gzipped = False
        key = b""
        if cipher:
            # Sealed uploads never double as gzip uploads: ciphertext
            # doesn't compress, and the chunk metadata (not the needle)
            # carries everything a reader needs.
            from ..utils.cipher import encrypt
            data, key = encrypt(data)
        elif compress:
            from ..utils.compression import maybe_gzip
            data, gzipped = maybe_gzip(data, name, mime)
        policy = self.retry_policy
        deadline = (time.monotonic() + policy.total_deadline
                    if policy.total_deadline else None)
        last_err: Exception | None = None
        for attempt in range(policy.max_attempts):
            if attempt:
                resilience.rpc_retries_total.inc(reason="reassign")
                delay = policy.backoff(attempt - 1)
                if deadline is not None:
                    delay = min(delay,
                                max(0.0, deadline - time.monotonic()))
                time.sleep(delay)
            # Per-attempt timeout clipped to what remains of the total
            # deadline budget: a sick server costs one bounded attempt,
            # and the whole upload never overstays its budget.
            timeout = policy.per_attempt_timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                timeout = min(timeout, remaining)
            try:
                a = self.assign(collection=collection,
                                replication=replication, ttl=ttl)
            except (rpc.RpcError, OSError) as e:
                last_err = e
                continue
            fid = a["fid"]
            url = f"http://{a['url']}/{fid}"
            q = []
            if name and not cipher:
                q.append("name=" + urllib.parse.quote(name))
            if mime and not cipher:
                q.append("mime=" + urllib.parse.quote(mime))
            if a.get("auth"):  # master-minted write JWT (secured)
                q.append(f"jwt={a['auth']}")
            if q:
                url += "?" + "&".join(q)
            try:
                resp = rpc.call(url, "POST", data, timeout=timeout,
                                headers={"Content-Encoding": "gzip"}
                                if gzipped else None)
            except rpc.RpcError as e:
                if e.status < 500 and e.status != 429:
                    raise  # a definitive answer (auth, bad request)
                # 5xx (failed replication fan-out, sick store,
                # draining replica) or a 429 shed: the volume is
                # suspect — forget it and re-assign; the master's
                # steering hands the retry a volume off the draining/
                # overloaded node.  A shed/drain answer was refused
                # before execution, so re-sending is always safe.
                last_err = e
                self.cache.forget(t.parse_file_id(fid)[0])
                continue
            except OSError as e:  # dead server: re-assign elsewhere
                last_err = e
                self.cache.forget(t.parse_file_id(fid)[0])
                continue
            etag = resp.get("eTag", "") if isinstance(resp, dict) \
                else ""
            return {"fid": fid, "url": a["url"], "size": size,
                    "etag": etag, "is_compressed": gzipped,
                    "cipher_key": key}
        raise last_err or rpc.RpcError(503, "upload: no attempt ran")

    def download(self, fid: str, cipher_key: bytes = b"") -> bytes:
        """Fetch a needle; opens sealed blobs when the caller holds the
        chunk's cipher key (gzip is undone server-side — plain `call`
        never advertises Accept-Encoding)."""
        data = self._download_raw(fid)
        if cipher_key:
            from ..utils.cipher import decrypt
            data = decrypt(data, cipher_key)
        return data

    def _download_raw(self, fid: str) -> bytes:
        vid, _key, _cookie = t.parse_file_id(fid)
        locs = self.lookup(vid, include_ec=True)
        if not locs:
            raise rpc.RpcError(404, f"volume {vid} has no locations")
        last_err: Exception | None = None
        # Round-robin across replicas (vid_map.go's read balancing).
        with self.cache._lock:
            start = self.cache._rr.get(vid, 0)
            self.cache._rr[vid] = start + 1
        relooked = False
        i = 0
        while i < len(locs):
            loc = locs[(start + i) % len(locs)]
            i += 1
            try:
                out = rpc.call(f"http://{loc['url']}/{fid}")
                assert isinstance(out, (bytes, bytearray))
                return bytes(out)
            except rpc.RpcError as e:
                last_err = e
                if e.status == 404 and "volume" in e.message:
                    self.cache.forget(vid)
                elif e.status in (429, 503) and not relooked:
                    # Draining/shedding replica: re-run the master
                    # lookup once instead of burning the rest of a
                    # stale list against a node that is leaving.
                    relooked = True
                    self.cache.forget(vid)
                    fresh = self._relookup(vid, include_ec=True)
                    if fresh:
                        locs, i, start = fresh, 0, 0
            except OSError as e:  # dead server: fail over to next replica
                last_err = e
                self.cache.forget(vid)
                if i >= len(locs) and not relooked:
                    # Every cached location failed at the connection
                    # level: during a rolling restart the cached list
                    # can be stale in BOTH directions (a drained node
                    # still listed, a restarted one missing).  One
                    # fresh master lookup before giving up.
                    relooked = True
                    fresh = self._relookup(vid, include_ec=True)
                    if fresh:
                        locs, i, start = fresh, 0, 0
        raise last_err or rpc.RpcError(404, "not found")

    def _relookup(self, vid: int, include_ec: bool = False) -> list:
        """Best-effort mid-failover lookup refresh: a master outage
        (leaderless window, exactly when a failover is likely running)
        must not abort a replica walk that can still succeed against
        the remaining cached locations."""
        try:
            return self.lookup(vid, include_ec=include_ec)
        except Exception:  # noqa: BLE001 — keep walking the old list
            return []

    def open_stream(self, fid: str, offset: int, size: int,
                    timeout: float = 30.0) -> ProxiedBody | None:
        """Open a ranged GET for `size` bytes of a needle WITHOUT
        reading the body: the filer's direct proxy leg relays (splices,
        when the platform allows) the stream straight to its own
        client.  Returns None when no replica can serve the exact range
        — the caller falls back to the buffered chunk path, so this is
        strictly an optimization, never a correctness dependency."""
        if size <= 0:
            return None
        vid, _key, _cookie = t.parse_file_id(fid)
        try:
            locs = self.lookup(vid, include_ec=True)
        except Exception:  # noqa: BLE001 — fall back to buffered path
            return None
        if not locs:
            return None
        with self.cache._lock:
            start = self.cache._rr.get(vid, 0)
            self.cache._rr[vid] = start + 1
        # The volume leg of a filer proxy read is `proxy` traffic, not
        # a user read — the user-facing read is the filer's own
        # response (stats/flows.py).
        rng = {"Range": f"bytes={offset}-{offset + size - 1}",
               **_flows.tag("proxy")}
        for i in range(len(locs)):
            loc = locs[(start + i) % len(locs)]
            try:
                resp, conn = rpc._request(
                    f"http://{loc['url']}/{fid}", "GET", None, timeout,
                    req_headers=rng)
            except Exception:  # noqa: BLE001 — replica down: try next
                continue
            if resp.status in (200, 206) and not resp._chunks and \
                    resp.getheader("content-length") == str(size):
                return ProxiedBody(resp, conn, size)
            # Error status, chunked framing, or a whole-needle 200 when
            # we asked for a subrange: this replica can't feed the
            # relay.  Closing (not draining) keeps the failure O(1).
            conn.close()
        return None

    def delete(self, fid: str) -> None:
        """Delete a needle, failing over across replicas exactly like
        `_download_raw` does — any live replica (or EC shard holder)
        fans the delete out to its siblings, so the first dead server
        must not fail the op."""
        vid, _key, _cookie = t.parse_file_id(fid)
        # An erasure-coded volume's shard holders take the delete too
        # (the port's; the reference finds no locations for it, so a
        # filer's chunk delete never lands on an EC volume).
        locs = self.lookup(vid, include_ec=True)
        if not locs:
            raise rpc.RpcError(404, f"volume {vid} has no locations")
        # Secured cluster: fetch a delete token via lookup?fileId=
        # (operation/delete_content.go).  Once the master answers
        # without auth the cluster is known-unsecured and the extra
        # lookup is skipped.
        jwt = ""
        if self._secured is not False:
            resp = self._master_call(
                f"/dir/lookup?volumeId={vid}&fileId={fid}")
            auth = resp.get("auth", "")
            self._secured = bool(auth)
            if auth:
                jwt = f"?jwt={auth}"
        last_err: Exception | None = None
        relooked = False
        i = 0
        while i < len(locs):
            url = f"http://{locs[i]['url']}/{fid}{jwt}"
            i += 1
            try:
                rpc.call(url, "DELETE")
                return
            except rpc.RpcError as e:
                last_err = e
                if e.status == 404 and "volume" in e.message:
                    self.cache.forget(vid)
                elif e.status in (429, 503) and not relooked:
                    # Draining (or shedding) replica: the cached
                    # location list is going stale — re-run the master
                    # lookup ONCE and walk the fresh replicas instead
                    # of burning the rest of the list against a node
                    # that is leaving.
                    relooked = True
                    self.cache.forget(vid)
                    fresh = self._relookup(vid)
                    if fresh:
                        locs, i = fresh, 0
            except OSError as e:  # dead server: next replica
                last_err = e
                self.cache.forget(vid)
        raise last_err or rpc.RpcError(404, "not found")

    def submit(self, data: bytes, **kw) -> dict:
        """upload + return its result dict (operation/submit.go):
        {fid, size, url} plus etag/is_compressed/cipher_key.  Reuses
        the url the upload already resolved — a transient lookup
        failure must not fail a write that succeeded — and passes the
        full dict through so a cipher=True submit never silently drops
        the one copy of its cipher_key."""
        return self.upload(data, **kw)
