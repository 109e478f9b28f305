"""S3 gateway server: path-style S3 REST protocol over the filer.

Reference: weed/s3api/s3api_server.go:38-131 (route table) and the
handlers in s3api_object_handlers.go, s3api_bucket_handlers.go,
filer_multipart.go, s3api_object_tagging_handlers.go.

Objects live under /buckets/<bucket>/<key> in the filer namespace, like
the reference's filerBucketsPath.  Multipart parts are uploaded as
ordinary filer files and the completed object is assembled by merging the
parts' chunk lists with adjusted offsets — no data copy (the reference
does exactly this with gRPC CreateEntry; here it is the filer's
?entry=true raw-create endpoint).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
import xml.etree.ElementTree as ET

from ..cluster import rpc
from ..filer.client import FilerProxy
from .auth import (ACTION_ADMIN, ACTION_LIST, ACTION_READ, ACTION_TAGGING,
                   ACTION_WRITE, AuthError, Identity,
                   IdentityAccessManagement)

BUCKETS_PATH = "/buckets"
UPLOADS_DIR = ".uploads"
XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _xml(root: ET.Element) -> bytes:
    return (b'<?xml version="1.0" encoding="UTF-8"?>'
            + ET.tostring(root))


def _el(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


def _error_xml(code: str, message: str) -> bytes:
    root = ET.Element("Error")
    _el(root, "Code", code)
    _el(root, "Message", message)
    return _xml(root)


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


def _as_bytes(body) -> bytes:
    """Materialize a (possibly streaming) request body."""
    return body.read() if hasattr(body, "read") else body


class _AwsChunkedReader:
    """Incrementally strips aws-chunked framing from a streaming body
    — the streaming analog of _decode_aws_chunked, so a multi-GB SDK
    upload never materializes (the reference wraps the request body in
    a chunkedReader the same way).  The port reads the inner body in
    blocks through a buffer: the JAX package reads each header line a
    byte at a time, and every read of a server's request body is a
    wire-flow ledger note, so an 8 MiB upload cost it ~11 000 notes."""

    _BLOCK = 64 * 1024

    def __init__(self, inner, decoded_length: int | None):
        self._inner = inner
        self.length = decoded_length
        self._in_chunk = 0
        self._done = False
        self._decoded = 0
        self._buf = bytearray()

    def _take(self, n: int) -> bytes:
        """Up to n bytes: the buffer's first, else one read of the
        inner body (b"" at its end)."""
        if not self._buf:
            return self._inner.read(n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def _read_line(self) -> bytes:
        while True:
            end = self._buf.find(b"\r\n", 0, 8192)
            if end >= 0:
                line = bytes(self._buf[:end + 2])
                del self._buf[:end + 2]
                return line
            if len(self._buf) >= 8192:
                raise ConnectionError(
                    "aws-chunked header line exceeds 8KB")
            more = self._inner.read(self._BLOCK)
            if not more:
                line = bytes(self._buf)
                self._buf.clear()
                return line
            self._buf += more

    def _read_crlf(self) -> None:
        """The chunk data's trailing CRLF (2 bytes, as the JAX package
        reads them)."""
        got = self._take(2)
        if len(got) == 1:
            self._take(1)

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while not self._done and (n < 0 or len(out) < n):
            if self._in_chunk == 0:
                header = self._read_line().strip()
                if not header:
                    # EOF where a chunk header belongs before the
                    # 0-size terminator: the framing is truncated.  A
                    # malformed stream must ERROR, never 200 as a
                    # silently-truncated object.
                    raise ConnectionError(
                        "aws-chunked framing truncated")
                size_hex = header.split(b";", 1)[0].strip()
                try:
                    size = int(size_hex, 16)
                except ValueError:
                    raise ConnectionError(
                        f"malformed aws-chunked size line "
                        f"{header[:32]!r}") from None
                if size == 0:
                    self._read_line()  # trailing CRLF / trailers
                    self._done = True
                    if self.length is not None and \
                            self._decoded != self.length:
                        raise ConnectionError(
                            f"aws-chunked decoded {self._decoded} bytes "
                            f"!= declared x-amz-decoded-content-length "
                            f"{self.length}")
                    break
                self._in_chunk = size
            want = self._in_chunk if n < 0 \
                else min(n - len(out), self._in_chunk)
            piece = self._take(want)
            if not piece:
                raise ConnectionError(
                    "aws-chunked data truncated mid-chunk")
            out += piece
            self._decoded += len(piece)
            if self.length is not None and self._decoded > self.length:
                # More payload than declared: storing it would truncate
                # at the forwarded Content-Length — fail loudly instead.
                raise ConnectionError(
                    f"aws-chunked payload exceeds declared "
                    f"x-amz-decoded-content-length {self.length}")
            self._in_chunk -= len(piece)
            if self._in_chunk == 0:
                self._read_crlf()
        return bytes(out)


class _HashingReader:
    """Tee reader computing md5 as bytes flow through (streamed PUT
    ETags without buffering)."""

    def __init__(self, inner):
        self._inner = inner
        self.length = getattr(inner, "length", None)
        self._md5 = hashlib.md5()
        self.bytes_read = 0

    def read(self, n: int = -1) -> bytes:
        data = self._inner.read(n)
        self._md5.update(data)
        self.bytes_read += len(data)
        return data

    @property
    def md5_hex(self) -> str:
        return self._md5.hexdigest()


def _valid_bucket_name(name: str) -> bool:
    """AWS bucket naming rules (the subset the reference enforces):
    3-63 chars of [a-z0-9.-], starting/ending alphanumeric — which also
    keeps reserved names like '.uploads' out of the bucket namespace."""
    import re
    return bool(re.fullmatch(r"[a-z0-9][a-z0-9.-]{1,61}[a-z0-9]", name))


class S3Error(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = status
        self.code = code
        self.message = message


# Filer path holding the live S3 identities config (the reference's
# filer-backed IAM: auth_credentials.go loads the same JSON shape from
# the filer's /etc tree and reloads on change).
IAM_CONFIG_PATH = "/etc/iam/identity.json"


class S3ApiServer:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 0,
                 identities: list[Identity] | None = None,
                 metrics_port: int | None = None,
                 ssl_context=None,
                 iam_refresh_seconds: float = 5.0):
        self.filer = FilerProxy(filer_url)
        self.iam = IdentityAccessManagement(identities)
        # Filer-backed IAM: with no explicit identities, the config
        # lives IN the cluster at /etc/iam/identity.json and hot-
        # reloads — update the file through any filer and every S3
        # gateway picks it up.
        self._iam_from_filer = identities is None
        self._iam_raw: bytes | None = None
        self._iam_refresh = iam_refresh_seconds
        self._iam_stop = threading.Event()
        self._iam_thread = None
        if self._iam_from_filer:
            self._reload_iam()
        self.server = rpc.JsonHttpServer(host, port, pass_headers=True,
                                         ssl_context=ssl_context)
        for method in ("GET", "HEAD", "PUT", "POST", "DELETE"):
            self.server.prefix_route(method, "/", self._route,
                                     stream_body=True)
        # Bucket names own the URL namespace, so /metrics lives on its
        # own port (the reference's -metricsPort behaves the same).
        self.metrics_registry = self.server.enable_metrics(
            "s3", serve_route=False)
        self.metrics_server = None
        if metrics_port is not None:
            self.metrics_server = rpc.JsonHttpServer(host, metrics_port)
            self.metrics_server.serve_metrics_route(
                self.metrics_registry)
        try:
            self.filer.mkdir(BUCKETS_PATH)
        except Exception:  # noqa: BLE001 — filer may not be up yet
            pass

    def start(self) -> None:
        self.server.start()
        if self.metrics_server is not None:
            self.metrics_server.start()
        if self._iam_from_filer:
            self._iam_thread = threading.Thread(
                target=self._iam_reload_loop, daemon=True,
                name="s3-iam-reload")
            self._iam_thread.start()

    def stop(self) -> None:
        self._iam_stop.set()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self.server.stop()

    def _reload_iam(self) -> bool:
        """Pull /etc/iam/identity.json from the filer; swap the
        identity set when it changed.  A definitive 404 means IAM is
        intentionally unconfigured (anonymous mode); any OTHER failure
        before the first successful read fails CLOSED — a filer outage
        at startup must not open the gateway to the world."""
        import urllib.error
        try:
            with self.filer.get(IAM_CONFIG_PATH) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                # Definitive: the config does not exist.  If identities
                # were previously loaded from the filer, the file's
                # deletion revokes them (back to anonymous — the
                # pre-config state).  _iam_raw keeps a sentinel so a
                # LATER transient error doesn't flip to fail-closed.
                if self._iam_raw not in (None, b""):
                    self.iam.replace([])
                self._iam_raw = b""
                self.iam.fail_closed = False
                return False
            self._iam_fetch_failed()
            return False
        except Exception:  # noqa: BLE001 — filer down / timeout
            self._iam_fetch_failed()
            return False
        if raw == self._iam_raw:
            self.iam.fail_closed = False
            return False
        try:
            from .auth import identities_from_dict
            idents = identities_from_dict(json.loads(raw))
        except Exception as e:  # noqa: BLE001 — keep serving with the
            from ..utils import glog  # last-good identities
            glog.warningf("s3 iam: unparseable %s: %s",
                          IAM_CONFIG_PATH, e)
            return False
        self._iam_raw = raw
        self.iam.replace(idents)
        self.iam.fail_closed = False
        return True

    def _iam_fetch_failed(self) -> None:
        if self._iam_raw is None:
            # Never successfully read the config: we cannot tell
            # "anonymous intended" from "filer unreachable" — deny
            # until a poll succeeds.
            self.iam.fail_closed = True

    def _iam_reload_loop(self) -> None:
        while not self._iam_stop.wait(self._iam_refresh):
            try:
                self._reload_iam()
            except Exception:  # noqa: BLE001
                pass

    def url(self) -> str:
        return self.server.url()

    # -- routing -------------------------------------------------------------

    # Bodies at or below this size are buffered so the payload-hash
    # cross-check still runs; larger signed PUTs stream and the
    # signature covers the declared hash (reference behavior).
    _VERIFY_BUFFER_MAX = 8 * 1024 * 1024
    # Browser-form POST uploads are parsed in memory; cap the body.
    _POST_FORM_MAX = 256 * 1024 * 1024

    def _route(self, path: str, query: dict, body):
        method = query.get("_method", "GET")
        headers = query.get("_headers", {})
        raw_query = query.get("_raw_query", "")
        try:
            if method == "POST" and headers.get(
                    "content-type", "").startswith("multipart/form-data"):
                # Browser-form upload: authentication is the signed
                # POST policy inside the form, not a header
                # (s3api/policy/post-policy.go).  The multipart body is
                # buffered for parsing (the reference's
                # ParseMultipartForm buffers/spills too) — capped so a
                # giant form can't balloon RSS; large objects belong on
                # the streaming PUT path.
                length = getattr(body, "length", None)
                if length is not None and length > self._POST_FORM_MAX:
                    raise S3Error(413, "EntityTooLarge",
                                  "POST form uploads are capped at "
                                  f"{self._POST_FORM_MAX >> 20}MB; use "
                                  "a signed PUT for larger objects")
                data = body.read(self._POST_FORM_MAX + 1) \
                    if hasattr(body, "read") else body
                if len(data) > self._POST_FORM_MAX:
                    raise S3Error(413, "EntityTooLarge",
                                  "POST form uploads are capped at "
                                  f"{self._POST_FORM_MAX >> 20}MB; use "
                                  "a signed PUT for larger objects")
                return self._post_object(path, headers, data)
            sha_hdr = headers.get("x-amz-content-sha256", "")
            length = getattr(body, "length", None)
            if self.iam.enabled and not sha_hdr:
                # No declared hash: the signature needs the payload.
                body = _as_bytes(body)
            elif sha_hdr and sha_hdr != "UNSIGNED-PAYLOAD" \
                    and not sha_hdr.startswith("STREAMING-") \
                    and length is not None \
                    and length <= self._VERIFY_BUFFER_MAX:
                # Small declared-hash body: buffer so the recompute
                # cross-check still runs.  Large or unknown-length
                # (chunked TE) bodies stream — auth signs the declared
                # hash, and RSS stays O(chunk).
                body = _as_bytes(body)
            identity = self.iam.authenticate(
                method, path, raw_query, headers,
                body if isinstance(body, (bytes, bytearray)) else None)
            if identity is not None and identity.name:
                # Tenancy principal = the authenticated S3 identity.
                # set_principal makes every downstream filer/volume hop
                # carry X-Weed-Tenant (rpc._request injects it), so
                # quotas, fair admission, usage ledgers and /debug/hot
                # all attribute to the S3 user, not the gateway.
                from ..tenancy import context as _tenant_ctx
                _tenant_ctx.set_principal(identity.name,
                                          _tenant_ctx.current_client())
            if sha_hdr.startswith("STREAMING-"):
                # aws-chunked framing: strip the chunk headers and
                # signatures or the framed wire bytes would be stored
                # as content.  (STREAMING- payloads are never buffered
                # by the branches above, so body is always a reader.)
                decoded = headers.get("x-amz-decoded-content-length")
                body = _AwsChunkedReader(
                    body, int(decoded) if decoded else None)
            return self._dispatch(method, path, query, headers, body,
                                  identity)
        except AuthError as e:
            return (e.status, _error_xml(e.code, str(e)),
                    {"Content-Type": "application/xml"})
        except S3Error as e:
            return (e.status, _error_xml(e.code, e.message),
                    {"Content-Type": "application/xml"})
        except rpc.RpcError as e:
            # Tenancy verdicts from the filer/master surface in S3
            # shape: hard quota -> 403 QuotaExceeded, throttle -> the
            # AWS SlowDown error (503) with Retry-After preserved.
            ans = self._tenancy_error(e.status, e.message,
                                      e.retry_after)
            if ans is None:
                raise
            return ans
        except urllib.error.HTTPError as e:
            # FilerProxy's streaming calls ride urllib, not the rpc
            # pool — same tenancy mapping for their error shape.
            msg = e.read().decode("utf-8", "replace")
            ra = e.headers.get("Retry-After") if e.headers else None
            ans = self._tenancy_error(
                e.code, msg, float(ra) if ra else None)
            if ans is None:
                raise
            return ans

    @staticmethod
    def _tenancy_error(status: int, message: str,
                       retry_after: float | None):
        if status == 403 and "QuotaExceeded" in message:
            return (403, _error_xml("QuotaExceeded", message),
                    {"Content-Type": "application/xml"})
        if status == 429:
            hdrs = {"Content-Type": "application/xml"}
            if retry_after is not None:
                hdrs["Retry-After"] = f"{retry_after:g}"
            return (503, _error_xml(
                "SlowDown", "Reduce your request rate."), hdrs)
        return None

    def _dispatch(self, method: str, path: str, query: dict,
                  headers: dict, body,
                  identity: Identity | None):
        path = urllib.parse.unquote(path)
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        # Only object/part PUTs stream; every other operation's body is
        # small control XML/JSON.
        if not (method == "PUT" and key and "tagging" not in query
                and not headers.get("x-amz-copy-source", "")):
            body = _as_bytes(body)
        auth = lambda action: self.iam.authorize(identity, action, bucket)  # noqa: E731

        if not bucket:  # service level
            auth(ACTION_LIST)
            return self._list_buckets(identity)
        if not key:  # bucket level
            if method == "PUT":
                auth(ACTION_ADMIN)
                return self._create_bucket(bucket)
            if method == "DELETE":
                auth(ACTION_ADMIN)
                return self._delete_bucket(bucket)
            if method == "HEAD":
                auth(ACTION_READ)
                return self._head_bucket(bucket)
            if method == "POST" and "delete" in query:
                auth(ACTION_WRITE)
                return self._delete_multiple(bucket, body)
            if method == "GET":
                if "uploads" in query:
                    auth(ACTION_LIST)
                    return self._list_multipart_uploads(bucket)
                auth(ACTION_LIST)
                return self._list_objects(bucket, query)
            raise S3Error(405, "MethodNotAllowed", method)

        # object level
        if method == "POST" and "select" in query:
            auth(ACTION_READ)
            return self._select_object_content(bucket, key, body)
        if method == "POST" and "uploads" in query:
            auth(ACTION_WRITE)
            return self._initiate_multipart(bucket, key, headers)
        if method == "PUT" and "partNumber" in query:
            auth(ACTION_WRITE)
            return self._upload_part(bucket, key, query, body)
        if method == "POST" and "uploadId" in query:
            auth(ACTION_WRITE)
            return self._complete_multipart(bucket, key, query, body)
        if method == "DELETE" and "uploadId" in query:
            auth(ACTION_WRITE)
            return self._abort_multipart(bucket, key, query)
        if "tagging" in query:
            if method == "PUT":
                auth(ACTION_TAGGING)
                return self._put_tagging(bucket, key, body)
            if method == "GET":
                auth(ACTION_READ)
                return self._get_tagging(bucket, key)
            if method == "DELETE":
                auth(ACTION_TAGGING)
                return self._delete_tagging(bucket, key)
        if method == "PUT":
            auth(ACTION_WRITE)
            src = headers.get("x-amz-copy-source", "")
            if src:
                # The caller must also be allowed to READ the source
                # bucket (s3api_object_copy_handlers.go checks both).
                sbucket = urllib.parse.unquote(src).lstrip("/") \
                    .partition("/")[0]
                self.iam.authorize(identity, ACTION_READ, sbucket)
                return self._copy_object(bucket, key, src)
            return self._put_object(bucket, key, headers, body)
        if method in ("GET", "HEAD"):
            auth(ACTION_READ)
            return self._get_object(bucket, key, headers,
                                    head=(method == "HEAD"))
        if method == "DELETE":
            auth(ACTION_WRITE)
            return self._delete_object(bucket, key)
        raise S3Error(405, "MethodNotAllowed", method)

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _bucket_path(bucket: str) -> str:
        return f"{BUCKETS_PATH}/{bucket}"

    def _obj_path(self, bucket: str, key: str) -> str:
        return f"{BUCKETS_PATH}/{bucket}/{key}"

    def _require_bucket(self, bucket: str) -> dict:
        meta = self.filer.meta(self._bucket_path(bucket))
        if meta is None or not meta.get("is_directory"):
            raise S3Error(404, "NoSuchBucket",
                          f"bucket {bucket} does not exist")
        return meta

    # -- service / bucket ----------------------------------------------------

    def _list_buckets(self, identity: Identity | None = None):
        root = ET.Element("ListAllMyBucketsResult",
                          {"xmlns": XMLNS})
        owner = _el(root, "Owner")
        _el(owner, "ID", "seaweedfs")
        buckets = _el(root, "Buckets")
        for e in self.filer.list_all(BUCKETS_PATH):
            if not e.get("is_directory") or e["name"] == UPLOADS_DIR:
                continue
            # Only buckets the caller may actually touch
            # (s3api_bucket_handlers.go filters by identity.canDo).
            if identity is not None and not (
                    identity.allows(ACTION_LIST, e["name"])
                    or identity.allows(ACTION_READ, e["name"])):
                continue
            b = _el(buckets, "Bucket")
            _el(b, "Name", e["name"])
            _el(b, "CreationDate", _iso(e.get("mtime", 0)))
        return (200, _xml(root), {"Content-Type": "application/xml"})

    def _create_bucket(self, bucket: str):
        if not _valid_bucket_name(bucket):
            raise S3Error(400, "InvalidBucketName",
                          f"{bucket!r} is not a valid bucket name")
        self.filer.mkdir(self._bucket_path(bucket))
        return (200, b"", {"Location": f"/{bucket}"})

    def _delete_bucket(self, bucket: str):
        self._require_bucket(bucket)
        if self.filer.list(self._bucket_path(bucket), limit=1):
            raise S3Error(409, "BucketNotEmpty",
                          f"bucket {bucket} is not empty")
        self.filer.delete(self._bucket_path(bucket), recursive=True)
        # Abort any in-progress multipart uploads with the bucket, or
        # their part chunks leak and resurface on bucket re-create.
        self.filer.delete(f"{BUCKETS_PATH}/{UPLOADS_DIR}/{bucket}",
                          recursive=True)
        return (204, b"")

    def _head_bucket(self, bucket: str):
        self._require_bucket(bucket)
        return (200, b"")

    # -- objects -------------------------------------------------------------

    def _put_object(self, bucket: str, key: str, headers: dict,
                    body):
        self._require_bucket(bucket)
        if key.endswith("/"):  # directory marker
            _as_bytes(body)
            self.filer.mkdir(self._obj_path(bucket, key.rstrip("/")))
            return (200, b"", {"ETag": '"d41d8cd98f00b204e9800998ecf8427e"'})
        ctype = headers.get("content-type",
                            "application/octet-stream")
        path = self._obj_path(bucket, key)
        fallback_etag = self._put_body(path, body, ctype)
        # Return the same ETag GET/HEAD will serve (computed from the
        # stored chunk list) so sync clients' change detection is stable.
        meta = self.filer.meta(path)
        etag = self._entry_etag(meta) if meta else fallback_etag
        return (200, b"", {"ETag": f'"{etag}"'})

    def _post_object(self, path: str, headers: dict, body: bytes):
        """POST-policy upload: multipart form to the bucket URL with a
        signed policy; the file lands at the form's `key`
        (s3api_object_handlers PostPolicyBucketHandler analog)."""
        from .policy import PostPolicy, parse_multipart_form
        bucket = urllib.parse.unquote(path).lstrip("/").split("/", 1)[0]
        if not bucket:
            raise S3Error(405, "MethodNotAllowed",
                          "POST uploads go to a bucket URL")
        fields, file_name, file_bytes, file_ctype = parse_multipart_form(
            body, headers.get("content-type", ""))
        key = fields.get("key", "")
        if not key:
            raise S3Error(400, "InvalidArgument",
                          "POST form needs a key field")
        # Substitute ${filename} BEFORE the policy runs: conditions
        # must constrain the FINAL key, or an attacker-chosen filename
        # escapes the signed prefix (post-policy.go substitutes first).
        key = key.replace("${filename}", file_name)
        # Authenticate before touching the bucket — a 404-vs-403 split
        # for anonymous callers would be a bucket-existence oracle.
        identity = self.iam.authenticate_policy(fields)
        if self.iam.enabled:
            self.iam.authorize(identity, ACTION_WRITE, bucket)
            lower = {k.lower(): v for k, v in fields.items()}
            PostPolicy.parse(lower["policy"]).check(
                dict(fields, key=key), len(file_bytes))
        self._require_bucket(bucket)
        obj_path = self._obj_path(bucket, key)
        etag = self._put_body(
            obj_path, file_bytes,
            fields.get("Content-Type") or file_ctype
            or "application/octet-stream")
        status = fields.get("success_action_status", "204")
        loc = f"/{bucket}/{urllib.parse.quote(key)}"
        if status == "201":
            root = ET.Element("PostResponse")
            _el(root, "Location", loc)
            _el(root, "Bucket", bucket)
            _el(root, "Key", key)
            _el(root, "ETag", f'"{etag}"')
            return (201, _xml(root),
                    {"Content-Type": "application/xml"})
        return (200 if status == "200" else 204, b"",
                {"ETag": f'"{etag}"', "Location": loc})

    def _put_body(self, path: str, body, ctype: str = "") -> str:
        """Store a request body (bytes or streaming reader) at a filer
        path; returns its md5 hex.  Readers stream straight through —
        RSS stays O(chunk) for however large the PUT."""
        if hasattr(body, "read"):
            tee = _HashingReader(body)
            self.filer.put(path, tee, ctype, length=tee.length)
            return tee.md5_hex
        self.filer.put(path, body, ctype)
        return hashlib.md5(body).hexdigest()

    def _copy_object(self, bucket: str, key: str, src: str):
        self._require_bucket(bucket)
        src = urllib.parse.unquote(src).lstrip("/")
        sbucket, _, skey = src.partition("/")
        spath = self._obj_path(sbucket, skey)
        smeta = self.filer.meta(spath)
        if smeta is None or smeta.get("is_directory"):
            raise S3Error(404, "NoSuchKey", f"source {src} not found")
        # Re-upload the bytes: sharing chunk ids between two entries would
        # double-free when either copy is later deleted (the filer GC has
        # no refcounting; the reference copies data too).
        with self.filer.get(spath) as resp:
            data = resp.read()
        ctype = smeta.get("attributes", {}).get(
            "mime", "application/octet-stream")
        dpath = self._obj_path(bucket, key)
        self.filer.put(dpath, data, ctype)
        dmeta = self.filer.meta(dpath)
        etag = self._entry_etag(dmeta) if dmeta else \
            hashlib.md5(data).hexdigest()
        root = ET.Element("CopyObjectResult", {"xmlns": XMLNS})
        _el(root, "LastModified", _iso(time.time()))
        _el(root, "ETag", f'"{etag}"')
        return (200, _xml(root), {"Content-Type": "application/xml"})

    def _select_object_content(self, bucket: str, key: str,
                               body: bytes):
        """SelectObjectContent: run a SELECT over one object and stream
        the result as AWS event-stream frames (volume Query RPC
        analog at the S3 surface)."""
        from ..query import run_query
        from ..query.sql import SqlError
        from .select import event_stream, parse_select_request
        try:
            req = parse_select_request(body)
        except Exception as e:  # noqa: BLE001 — malformed XML
            raise S3Error(400, "MalformedXML", str(e)) from None
        path = self._obj_path(bucket, key)
        meta = self.filer.meta(path)
        if meta is None or meta.get("is_directory"):
            raise S3Error(404, "NoSuchKey", f"{key} not found")
        with self.filer.get(path) as resp:
            data = resp.read()
        try:
            records = run_query(
                data, req["expression"],
                input_format=req["input_format"],
                csv_header=req["csv_header"],
                csv_delimiter=req["csv_delimiter"],
                output_format=req["output_format"])
        except (SqlError, ValueError) as e:
            raise S3Error(400, "InvalidTextEncoding"
                          if "format" in str(e) else
                          "InvalidExpression", str(e)) from None
        payload = event_stream(records, len(data), len(records))
        return (200, payload,
                {"Content-Type": "application/octet-stream"})

    def _get_object(self, bucket: str, key: str, headers: dict,
                    head: bool = False):
        path = self._obj_path(bucket, key)
        meta = self.filer.meta(path)
        if meta is None or meta.get("is_directory"):
            raise S3Error(404, "NoSuchKey", f"{key} not found")
        attrs = meta.get("attributes", {})
        size = sum(c["size"] for c in self._visible_sizes(meta))
        base_headers = {
            "Content-Type": attrs.get("mime",
                                      "application/octet-stream"),
            "Last-Modified": time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT",
                time.gmtime(attrs.get("mtime", 0))),
            "Accept-Ranges": "bytes",
            "ETag": f'"{self._entry_etag(meta)}"',
        }
        if head:
            base_headers["Content-Length"] = str(size)
            return (200, b"", base_headers)
        rng = headers.get("range", "")
        # Hand the open filer response to the rpc layer, which streams
        # it to the client — a 10GB GET stays O(1MB) in gateway memory.
        resp = self.filer.get(path, rng)
        base_headers["Content-Length"] = \
            resp.headers.get("Content-Length", str(size))
        if resp.status == 206:
            base_headers["Content-Range"] = \
                resp.headers.get("Content-Range", "")
            return (206, resp, base_headers)
        return (200, resp, base_headers)

    @staticmethod
    def _entry_etag(meta: dict) -> str:
        from ..filer.entry import FileChunk
        from ..filer.filechunks import etag as chunks_etag
        chunks = [FileChunk.from_dict(c) for c in meta.get("chunks", [])]
        return chunks_etag(chunks)

    @staticmethod
    def _visible_sizes(meta: dict) -> list[dict]:
        from ..filer.entry import FileChunk
        from ..filer.filechunks import non_overlapping_visible_intervals
        chunks = [FileChunk.from_dict(c) for c in meta.get("chunks", [])]
        return [{"size": v.stop - v.start}
                for v in non_overlapping_visible_intervals(chunks)]

    def _delete_object(self, bucket: str, key: str):
        self.filer.delete(self._obj_path(bucket, key), recursive=True)
        return (204, b"")

    def _delete_multiple(self, bucket: str, body: bytes):
        root = ET.fromstring(body)
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag[:root.tag.index("}") + 1]
        deleted, errors = [], []
        for obj in root.iter(f"{ns}Object"):
            key_el = obj.find(f"{ns}Key")
            if key_el is None or not key_el.text:
                continue
            key = key_el.text
            try:
                self.filer.delete(self._obj_path(bucket, key),
                                  recursive=True)
                deleted.append(key)
            except Exception as e:  # noqa: BLE001
                errors.append((key, str(e)))
        out = ET.Element("DeleteResult", {"xmlns": XMLNS})
        for key in deleted:
            d = _el(out, "Deleted")
            _el(d, "Key", key)
        for key, msg in errors:
            er = _el(out, "Error")
            _el(er, "Key", key)
            _el(er, "Message", msg)
        return (200, _xml(out), {"Content-Type": "application/xml"})

    # -- listing -------------------------------------------------------------

    def _walk_keys(self, bucket: str, prefix: str, after: str = ""):
        """Yield (key, entry) in S3 key order (lexicographic over full
        key names), depth-first under prefix, skipping keys <= after.

        Within one directory the filer lists by entry name, but S3 order
        compares full keys — a subtree under dir `a` sorts as `a/`, which
        is AFTER file `a.txt` ('.' < '/').  So each directory's entries
        are re-sorted by their effective key (name + '/' for dirs) before
        descending.  Subtrees that cannot intersect [prefix, after..) are
        pruned, so prefix listings don't walk the whole bucket.
        """
        base = self._bucket_path(bucket)

        def rec(dir_rel: str):
            dir_abs = base + ("/" + dir_rel if dir_rel else "")
            entries = self.filer.list_all(dir_abs)
            entries.sort(key=lambda e: e["name"] +
                         ("/" if e.get("is_directory") else ""))
            for e in entries:
                rel = (dir_rel + "/" if dir_rel else "") + e["name"]
                if e.get("is_directory"):
                    if e["name"] == UPLOADS_DIR and not dir_rel:
                        continue
                    sub = rel + "/"
                    # prune: subtree keys all start with `sub`
                    if prefix and not (sub.startswith(prefix)
                                       or prefix.startswith(sub)):
                        continue
                    if after and after > sub and \
                            not after.startswith(sub):
                        continue  # whole subtree sorts <= after
                    yield from rec(rel)
                else:
                    if rel.startswith(prefix) and \
                            not (after and rel <= after):
                        yield rel, e

        # Start from the deepest directory fully inside the prefix.
        start = prefix.rsplit("/", 1)[0] if "/" in prefix else ""
        if start.split("/", 1)[0] == UPLOADS_DIR:
            # Starting inside the multipart staging subtree would bypass
            # rec()'s root-level skip and leak in-progress upload parts.
            return
        if start and self.filer.meta(base + "/" + start) is None:
            return
        yield from rec(start)

    def _list_objects(self, bucket: str, query: dict):
        self._require_bucket(bucket)
        prefix = query.get("prefix", "")
        delimiter = query.get("delimiter", "")
        max_keys = int(query.get("max-keys", 1000))
        v2 = query.get("list-type") == "2"
        after = query.get("continuation-token",
                          query.get("start-after", "")) if v2 else \
            query.get("marker", "")
        contents, common = [], []
        truncated = False
        seen_prefixes = set()
        last_item = ""  # last key or common prefix actually included
        for key, e in self._walk_keys(bucket, prefix, after):
            cp = None
            if delimiter:
                rest = key[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp in seen_prefixes:
                        continue
                    if after and cp <= after:
                        continue  # prefix already reported on a prior page
            # CommonPrefixes count toward MaxKeys like Contents do; only
            # report IsTruncated when a further item actually exists.
            if len(contents) + len(common) >= max_keys:
                truncated = True
                break
            if cp is not None:
                seen_prefixes.add(cp)
                common.append(cp)
                last_item = cp
            else:
                contents.append((key, e))
                last_item = key
        root = ET.Element("ListBucketResult", {"xmlns": XMLNS})
        _el(root, "Name", bucket)
        _el(root, "Prefix", prefix)
        _el(root, "MaxKeys", max_keys)
        _el(root, "IsTruncated", "true" if truncated else "false")
        if v2:
            _el(root, "KeyCount", len(contents) + len(common))
            if truncated and last_item:
                _el(root, "NextContinuationToken", last_item)
        elif truncated and last_item:
            _el(root, "NextMarker", last_item)
        for key, e in contents:
            c = _el(root, "Contents")
            _el(c, "Key", key)
            _el(c, "LastModified", _iso(e.get("mtime", 0)))
            _el(c, "Size", e.get("size", 0))
            _el(c, "StorageClass", "STANDARD")
        for cp in common:
            p = _el(root, "CommonPrefixes")
            _el(p, "Prefix", cp)
        return (200, _xml(root), {"Content-Type": "application/xml"})

    # -- multipart -----------------------------------------------------------

    def _uploads_path(self, bucket: str, upload_id: str) -> str:
        return f"{BUCKETS_PATH}/{UPLOADS_DIR}/{bucket}/{upload_id}"

    def _initiate_multipart(self, bucket: str, key: str, headers: dict):
        self._require_bucket(bucket)
        upload_id = uuid.uuid4().hex
        self.filer.mkdir(self._uploads_path(bucket, upload_id))
        # Remember the target key + content type on the upload dir.
        self.filer.create_entry(
            self._uploads_path(bucket, upload_id) + "/.manifest",
            {"attributes": {"mime": "application/json"},
             "extended": {"key": key,
                          "content_type": headers.get(
                              "content-type",
                              "application/octet-stream")}})
        root = ET.Element("InitiateMultipartUploadResult",
                          {"xmlns": XMLNS})
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "UploadId", upload_id)
        return (200, _xml(root), {"Content-Type": "application/xml"})

    def _upload_part(self, bucket: str, key: str, query: dict,
                     body: bytes):
        part = int(query["partNumber"])
        if not 1 <= part <= 10000:
            raise S3Error(400, "InvalidArgument",
                          "partNumber must be between 1 and 10000")
        upload_id = query["uploadId"]
        updir = self._uploads_path(bucket, upload_id)
        if self.filer.meta(updir + "/.manifest") is None:
            raise S3Error(404, "NoSuchUpload", upload_id)
        path = f"{updir}/{part:05d}.part"
        md5 = self._put_body(path, body)
        return (200, b"", {"ETag": f'"{md5}"'})

    def _complete_multipart(self, bucket: str, key: str, query: dict,
                            body: bytes):
        upload_id = query["uploadId"]
        updir = self._uploads_path(bucket, upload_id)
        manifest = self.filer.meta(updir + "/.manifest")
        if manifest is None:
            raise S3Error(404, "NoSuchUpload", upload_id)
        uploaded = sorted(
            (e["name"] for e in self.filer.list_all(updir)
             if e["name"].endswith(".part")))
        # S3 semantics: only the parts listed in the request body are
        # assembled; unlisted uploaded parts are excluded.
        wanted = self._requested_part_numbers(body)
        if wanted is not None:
            by_number = {int(n.split(".")[0]): n for n in uploaded}
            missing = [p for p in wanted if p not in by_number]
            if missing:
                raise S3Error(400, "InvalidPart",
                              f"parts {missing} were not uploaded")
            parts = [by_number[p] for p in sorted(wanted)]
        else:
            parts = uploaded
        if not parts:
            raise S3Error(400, "MalformedXML",
                          "completion requires at least one part")
        chunks: list[dict] = []
        offset = 0
        for name in parts:
            meta = self.filer.meta(f"{updir}/{name}")
            if meta is None:
                continue
            for c in sorted(meta.get("chunks", []),
                            key=lambda c: c["offset"]):
                chunks.append({**c, "offset": offset + c["offset"]})
            offset += sum(c["size"] for c in meta.get("chunks", []))
        ctype = manifest.get("extended", {}).get(
            "content_type", "application/octet-stream")
        self.filer.create_entry(
            self._obj_path(bucket, key),
            {"attributes": {"mime": ctype}, "chunks": chunks})
        # Excluded parts' chunks are NOT in the final object: free them.
        for name in uploaded:
            if name not in parts:
                self.filer.delete(f"{updir}/{name}")
        # Metadata-only delete of the used parts: their chunks now belong
        # to the completed object (filer_multipart.go does the same merge).
        self.filer.delete(updir, recursive=True, keep_chunks=True)
        root = ET.Element("CompleteMultipartUploadResult",
                          {"xmlns": XMLNS})
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "ETag", f'"{upload_id}-{len(parts)}"')
        return (200, _xml(root), {"Content-Type": "application/xml"})

    @staticmethod
    def _requested_part_numbers(body: bytes) -> list[int] | None:
        """PartNumbers from a CompleteMultipartUpload body; None when the
        body lists none (legacy/minimal clients: use all parts)."""
        if not body.strip():
            return None
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error(400, "MalformedXML",
                          "cannot parse completion body") from None
        ns = root.tag[:root.tag.index("}") + 1] if \
            root.tag.startswith("{") else ""
        nums = [int(el.text) for el in root.iter(f"{ns}PartNumber")
                if el.text and el.text.strip().isdigit()]
        return nums or None

    def _abort_multipart(self, bucket: str, key: str, query: dict):
        self.filer.delete(
            self._uploads_path(bucket, query["uploadId"]),
            recursive=True)
        return (204, b"")

    def _list_multipart_uploads(self, bucket: str):
        root = ET.Element("ListMultipartUploadsResult", {"xmlns": XMLNS})
        _el(root, "Bucket", bucket)
        base = f"{BUCKETS_PATH}/{UPLOADS_DIR}/{bucket}"
        for e in self.filer.list(base):
            if not e.get("is_directory"):
                continue
            manifest = self.filer.meta(f"{base}/{e['name']}/.manifest")
            u = _el(root, "Upload")
            _el(u, "UploadId", e["name"])
            if manifest:
                _el(u, "Key",
                    manifest.get("extended", {}).get("key", ""))
        return (200, _xml(root), {"Content-Type": "application/xml"})

    # -- tagging -------------------------------------------------------------

    def _put_tagging(self, bucket: str, key: str, body: bytes):
        meta = self.filer.meta(self._obj_path(bucket, key))
        if meta is None:
            raise S3Error(404, "NoSuchKey", key)
        root = ET.fromstring(body)
        ns = root.tag[:root.tag.index("}") + 1] if \
            root.tag.startswith("{") else ""
        tags = {}
        for t in root.iter(f"{ns}Tag"):
            k = t.find(f"{ns}Key")
            v = t.find(f"{ns}Value")
            if k is not None and k.text:
                tags[k.text] = v.text or "" if v is not None else ""
        extended = meta.get("extended", {})
        extended = {k: v for k, v in extended.items()
                    if not k.startswith("x-amz-tag-")}
        for k, v in tags.items():
            extended[f"x-amz-tag-{k}"] = v
        meta["extended"] = extended
        self.filer.create_entry(self._obj_path(bucket, key), meta)
        return (200, b"")

    def _get_tagging(self, bucket: str, key: str):
        meta = self.filer.meta(self._obj_path(bucket, key))
        if meta is None:
            raise S3Error(404, "NoSuchKey", key)
        root = ET.Element("Tagging", {"xmlns": XMLNS})
        ts = _el(root, "TagSet")
        for k, v in meta.get("extended", {}).items():
            if k.startswith("x-amz-tag-"):
                t = _el(ts, "Tag")
                _el(t, "Key", k[len("x-amz-tag-"):])
                _el(t, "Value", v)
        return (200, _xml(root), {"Content-Type": "application/xml"})

    def _delete_tagging(self, bucket: str, key: str):
        meta = self.filer.meta(self._obj_path(bucket, key))
        if meta is None:
            raise S3Error(404, "NoSuchKey", key)
        meta["extended"] = {k: v for k, v in
                            meta.get("extended", {}).items()
                            if not k.startswith("x-amz-tag-")}
        self.filer.create_entry(self._obj_path(bucket, key), meta)
        return (204, b"")
