"""Replication sinks: where replicated entries land.

Reference: weed/replication/sink/ — `ReplicationSink` interface
(replicator consumes CreateEntry/UpdateEntry/DeleteEntry, sink.go), with
filer (filersink/filer_sink.go), local-FS, S3 (s3sink/s3_sink.go),
GCS, B2 and Azure targets.  No cloud SDKs here: GCS and B2 ride their
S3-compatible endpoints through the in-repo sig v4 signer, and Azure
speaks its Blob REST API with stdlib SharedKey signing.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable

from ..filer.client import FilerProxy


class ReplicationSink:
    """One replication target (sink.go ReplicationSink)."""

    def create_entry(self, key: str, entry: dict,
                     data: bytes | None) -> None:
        """key is the sink-relative path; entry the source entry dict;
        data the file content (None for directories)."""
        raise NotImplementedError

    def update_entry(self, key: str, entry: dict,
                     data: bytes | None) -> None:
        self.delete_entry(key, is_directory=False)
        self.create_entry(key, entry, data)

    def delete_entry(self, key: str, is_directory: bool) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FilerSink(ReplicationSink):
    """Replicate into another filer cluster (filersink/filer_sink.go).

    Content is re-uploaded through the target filer so chunks get fresh
    file ids in the target cluster's blob space; `signatures` carries the
    origin chain so a sync loop in the other direction skips these."""

    def __init__(self, filer_url: str, directory: str = "/",
                 signatures: list[int] | None = None):
        self.proxy = FilerProxy(filer_url)
        self.dir = "/" + directory.strip("/")
        self.signatures = signatures or []

    def _path(self, key: str) -> str:
        return (self.dir.rstrip("/") + "/" + key.lstrip("/")) \
            .replace("//", "/")

    def _sig_q(self) -> str:
        if not self.signatures:
            return ""
        return "?signatures=" + ",".join(str(s) for s in self.signatures)

    def create_entry(self, key: str, entry: dict,
                     data: bytes | None) -> None:
        path = self._path(key)
        if entry.get("is_directory"):
            url = self.proxy.url + urllib.parse.quote(path) + \
                "?mkdir=true"
            if self.signatures:
                url += "&signatures=" + \
                    ",".join(str(s) for s in self.signatures)
            urllib.request.urlopen(urllib.request.Request(
                url, data=b"", method="POST"), timeout=60).read()
            return
        mime = entry.get("attributes", {}).get("mime", "")
        url = self.proxy.url + urllib.parse.quote(path) + self._sig_q()
        req = urllib.request.Request(url, data=data or b"",
                                     method="POST")
        if mime:
            req.add_header("Content-Type", mime)
        urllib.request.urlopen(req, timeout=600).read()

    def delete_entry(self, key: str, is_directory: bool) -> None:
        path = self._path(key)
        url = self.proxy.url + urllib.parse.quote(path) + \
            ("?recursive=true" if is_directory else "")
        if self.signatures:
            sep = "&" if "?" in url else "?"
            url += sep + "signatures=" + \
                ",".join(str(s) for s in self.signatures)
        req = urllib.request.Request(url, method="DELETE")
        try:
            urllib.request.urlopen(req, timeout=60).read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


class LocalSink(ReplicationSink):
    """Replicate to a local directory tree (localsink/local_sink.go)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.join(self.dir, key.lstrip("/"))
        # A replicated key must stay inside the sink root.
        root = os.path.realpath(self.dir)
        real = os.path.realpath(p)
        if not (real + os.sep).startswith(root + os.sep) and real != root:
            raise ValueError(f"replication key escapes sink root: {key}")
        return p

    def create_entry(self, key: str, entry: dict,
                     data: bytes | None) -> None:
        p = self._path(key)
        if entry.get("is_directory"):
            os.makedirs(p, exist_ok=True)
            return
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data or b"")

    def delete_entry(self, key: str, is_directory: bool) -> None:
        p = self._path(key)
        try:
            if is_directory:
                import shutil
                shutil.rmtree(p)
            else:
                os.remove(p)
        except FileNotFoundError:
            pass


def _join_key(directory: str, key: str) -> str:
    """dir + key -> bucket/container-relative blob name (shared by
    every object-store sink so the layouts can't drift apart)."""
    return (directory + "/" + key.lstrip("/")).lstrip("/")


def _http(url: str, method: str, data: bytes,
          headers: dict[str, str]) -> None:
    """One blob-store request.  DELETE-404 is success (the entry is
    already gone — replays and races are normal in replication)."""
    req = urllib.request.Request(
        url, data=data if method != "DELETE" else None,
        method=method, headers=headers)
    try:
        urllib.request.urlopen(req, timeout=600).read()
    except urllib.error.HTTPError as e:
        if not (method == "DELETE" and e.code == 404):
            raise


class S3Sink(ReplicationSink):
    """Replicate into an S3-compatible endpoint (s3sink/s3_sink.go) —
    works against our own S3 gateway (seaweedfs_tpu_torch/s3api)."""

    def __init__(self, endpoint: str, bucket: str, directory: str = "/",
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1"):
        from ..s3api.sigv4 import sign_request
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.dir = directory.strip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        # Signed into the credential scope — region-validating
        # endpoints (B2, real AWS) reject a mismatch.
        self.region = region
        self._sign: Callable = sign_request

    def _url(self, key: str) -> str:
        return f"{self.endpoint}/{self.bucket}/" + \
            urllib.parse.quote(_join_key(self.dir, key))

    def _request(self, url: str, method: str, data: bytes = b"",
                 content_type: str = "") -> None:
        headers = {}
        if content_type:
            headers["Content-Type"] = content_type
        if self.access_key:
            headers = self._sign(method, url, headers, data,
                                 self.access_key, self.secret_key,
                                 region=self.region)
        _http(url, method, data, headers)

    def create_entry(self, key: str, entry: dict,
                     data: bytes | None) -> None:
        if entry.get("is_directory"):
            return  # S3 has no directories
        mime = entry.get("attributes", {}).get(
            "mime", "application/octet-stream")
        self._request(self._url(key), "PUT", data or b"", mime)

    def delete_entry(self, key: str, is_directory: bool) -> None:
        if is_directory:
            return
        self._request(self._url(key), "DELETE")


class GcsSink(S3Sink):
    """Google Cloud Storage through its S3-interoperable XML API
    (HMAC keys) — no SDK needed (weed/replication/sink/gcssink).
    Default endpoint is GCS's interop host; override for tests."""

    def __init__(self, bucket: str, directory: str = "/",
                 access_key: str = "", secret_key: str = "",
                 endpoint: str = "https://storage.googleapis.com",
                 region: str = "auto"):
        # GCS's interop endpoint accepts any scope region; "auto" is
        # the documented default for sig v4 against storage.googleapis.
        super().__init__(endpoint, bucket, directory,
                         access_key, secret_key, region=region)


class B2Sink(S3Sink):
    """Backblaze B2 through its S3-compatible endpoint
    (weed/replication/sink/b2sink).  `region` forms the default
    endpoint host; override `endpoint` for tests."""

    def __init__(self, bucket: str, directory: str = "/",
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-west-004", endpoint: str = ""):
        super().__init__(
            endpoint or f"https://s3.{region}.backblazeb2.com",
            bucket, directory, access_key, secret_key,
            region=region)


class AzureSink(ReplicationSink):
    """Azure Blob Storage over its REST API with SharedKey auth —
    stdlib hmac/base64, no SDK (weed/replication/sink/azuresink).
    The account key is the base64 string from the portal."""

    API_VERSION = "2019-12-12"

    def __init__(self, account: str, container: str,
                 directory: str = "/", account_key: str = "",
                 endpoint: str = ""):
        self.account = account
        self.container = container
        self.dir = directory.strip("/")
        self.key = base64.b64decode(account_key) if account_key else b""
        self.endpoint = (endpoint or
                         f"https://{account}.blob.core.windows.net"
                         ).rstrip("/")

    def _auth(self, method: str, encoded_blob: str,
              headers: dict[str, str]) -> str:
        """SharedKey canonical string (Azure docs: 'Authorize with
        Shared Key', 2015-02-21+ rules: empty Content-Length for 0).
        The canonicalized resource uses the ENCODED URI path — the
        service signs what it receives on the wire, so signing the raw
        blob name breaks on any key needing percent-encoding."""
        ms = sorted((k.lower(), v) for k, v in headers.items()
                    if k.lower().startswith("x-ms-"))
        canon_headers = "".join(f"{k}:{v}\n" for k, v in ms)
        length = headers.get("Content-Length", "")
        if length == "0":
            length = ""
        canon = "\n".join([
            method,
            "",                                  # Content-Encoding
            "",                                  # Content-Language
            length,                              # Content-Length
            "",                                  # Content-MD5
            headers.get("Content-Type", ""),     # Content-Type
            "",                                  # Date (x-ms-date used)
            "", "", "", "",                      # If-*
            "",                                  # Range
        ]) + "\n" + canon_headers + \
            f"/{self.account}/{self.container}/{encoded_blob}"
        sig = base64.b64encode(
            hmac.new(self.key, canon.encode(),
                     hashlib.sha256).digest()).decode()
        return f"SharedKey {self.account}:{sig}"

    def _request(self, method: str, blob: str, data: bytes = b"",
                 content_type: str = "") -> None:
        headers = {
            "x-ms-date": time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                                       time.gmtime()),
            "x-ms-version": self.API_VERSION,
            "Content-Length": str(len(data)),
        }
        if method == "PUT":
            headers["x-ms-blob-type"] = "BlockBlob"
        if content_type:
            headers["Content-Type"] = content_type
        encoded = urllib.parse.quote(blob)
        if self.key:
            headers["Authorization"] = self._auth(method, encoded,
                                                  headers)
        _http(f"{self.endpoint}/{self.container}/{encoded}",
              method, data, headers)

    def create_entry(self, key: str, entry: dict,
                     data: bytes | None) -> None:
        if entry.get("is_directory"):
            return  # blob stores have no directories
        mime = entry.get("attributes", {}).get(
            "mime", "application/octet-stream")
        self._request("PUT", _join_key(self.dir, key), data or b"",
                      mime)

    def delete_entry(self, key: str, is_directory: bool) -> None:
        if is_directory:
            return
        self._request("DELETE", _join_key(self.dir, key))


def sink_for_spec(spec: str, **kw) -> ReplicationSink:
    """'filer://host:port/dir', 'local:///path', 's3://endpoint/bucket',
    'gcs://bucket/dir', 'b2://bucket/dir',
    'azure://account/container/dir' (credentials via keyword args)."""
    scheme, _, rest = spec.partition("://")
    if scheme == "filer":
        host, _, d = rest.partition("/")
        return FilerSink("http://" + host, "/" + d, **kw)
    if scheme == "local":
        return LocalSink("/" + rest.lstrip("/"))
    if scheme == "s3":
        host, _, rest2 = rest.partition("/")
        bucket, _, d = rest2.partition("/")
        return S3Sink("http://" + host, bucket, "/" + d, **kw)
    if scheme == "gcs":
        bucket, _, d = rest.partition("/")
        return GcsSink(bucket, "/" + d, **kw)
    if scheme == "b2":
        bucket, _, d = rest.partition("/")
        return B2Sink(bucket, "/" + d, **kw)
    if scheme == "azure":
        account, _, rest2 = rest.partition("/")
        container, _, d = rest2.partition("/")
        return AzureSink(account, container, "/" + d, **kw)
    raise ValueError(f"unknown sink spec: {spec}")
