"""Storage backends: where a volume's `.dat` bytes physically live.

weed/storage/backend/backend.go:15-47 — `BackendStorageFile`
(ReadAt/WriteAt/Truncate/Sync/GetStat) + `BackendStorage` (NewStorageFile,
CopyFile up, DownloadFile back, DeleteFile) with a factory registry;
disk_file.go is the default, s3_backend/ the remote tier.

Here: DiskFile (local), S3Backend (any S3-compatible endpoint — including
this framework's own gateway — via the shared sig v4 signer), and
LocalDirBackend (a directory posing as remote: tests + second-mount
tiers).  Remote reads go through RemoteFile with an LRU block cache so
needle preads against a tiered volume stay cheap.
"""

from __future__ import annotations

import os
import shutil
import urllib.parse
import urllib.request

REMOTE_BLOCK = 1 << 20  # ranged-GET granularity for remote preads

# Needle-read ranged GETs must be bounded: a WAN-partitioned backend
# has to surface as a fast, retryable error (the volume server maps it
# to 503), never a 60s-per-block hang that wedges every reader queued
# behind the singleflight.
REMOTE_READ_TIMEOUT = 20.0


class BackendStorageFile:
    """Random-access file surface (backend.go BackendStorageFile)."""

    def pread(self, size: int, offset: int) -> bytes:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class DiskFile(BackendStorageFile):
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")

    def pread(self, size: int, offset: int) -> bytes:
        return os.pread(self._f.fileno(), size, offset)

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def close(self) -> None:
        self._f.close()


class RemoteFile(BackendStorageFile):
    """Read-only view of a remote object: block-aligned range reads
    through the process-global read-through cache (storage/remote_cache
    — bounded bytes, singleflight per block), plus the per-read
    accounting the promotion policy consumes."""

    def __init__(self, backend: "BackendStorage", key: str,
                 file_size: int, cache_blocks: int = 32):
        # cache_blocks is accepted for signature compatibility; the
        # budget is the process-wide byte bound now.
        self.backend = backend
        self.key = key
        self._size = file_size

    def _block(self, idx: int) -> tuple[bytes, bool]:
        from .remote_cache import CACHE
        lo = idx * REMOTE_BLOCK
        n = min(REMOTE_BLOCK, self._size - lo)
        return CACHE.get_block(self.backend, self.key, idx, lo, n)

    def pread(self, size: int, offset: int) -> bytes:
        from .remote_cache import CACHE
        if offset >= self._size:
            return b""
        size = min(size, self._size - offset)
        out = bytearray()
        pos = offset
        hit_b = miss_b = 0
        while pos < offset + size:
            idx = pos // REMOTE_BLOCK
            blk, hit = self._block(idx)
            lo = pos - idx * REMOTE_BLOCK
            take = min(len(blk) - lo, offset + size - pos)
            out += blk[lo:lo + take]
            pos += take
            if hit:
                hit_b += take
            else:
                miss_b += take
        if hit_b:
            CACHE.record_served(hit_b, hit=True)
        if miss_b:
            CACHE.record_served(miss_b, hit=False)
        CACHE.record_read(self.backend.spec, self.key)
        return bytes(out)

    def size(self) -> int:
        return self._size


class BackendStorage:
    """One remote tier destination (backend.go BackendStorage)."""

    spec: str = ""

    def upload_file(self, key: str, path: str) -> int:
        """Copy a local file up; returns byte size."""
        raise NotImplementedError

    def download_file(self, key: str, path: str) -> int:
        raise NotImplementedError

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def open_file(self, key: str, file_size: int) -> RemoteFile:
        return RemoteFile(self, key, file_size)


class LocalDirBackend(BackendStorage):
    """'local://<dir>': a directory posing as a remote tier."""

    def __init__(self, directory: str):
        self.dir = directory
        self.spec = f"local://{directory}"
        os.makedirs(directory, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.dir, key.replace("/", "_"))

    def upload_file(self, key: str, path: str) -> int:
        shutil.copyfile(path, self._p(key))
        return os.path.getsize(self._p(key))

    def download_file(self, key: str, path: str) -> int:
        shutil.copyfile(self._p(key), path)
        return os.path.getsize(path)

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with open(self._p(key), "rb") as f:
            return os.pread(f.fileno(), size, offset)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._p(key))
        except FileNotFoundError:
            pass


class S3Backend(BackendStorage):
    """'s3://host:port/bucket[/prefix]': S3-compatible remote tier
    (backend/s3_backend/s3_backend.go) signed with the shared sig v4
    client."""

    def __init__(self, endpoint: str, bucket: str, prefix: str = "",
                 access_key: str = "", secret_key: str = ""):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        scheme = "s3+https" if self.endpoint.startswith("https") \
            else "s3"
        host = self.endpoint.split("://", 1)[-1]
        self.spec = f"{scheme}://{host}/{bucket}" + \
            (f"/{self.prefix}" if self.prefix else "")

    def _url(self, key: str) -> str:
        k = f"{self.prefix}/{key}" if self.prefix else key
        return f"{self.endpoint}/{self.bucket}/" + \
            urllib.parse.quote(k)

    def _request(self, key: str, method: str, data: bytes = b"",
                 headers: dict | None = None) -> bytes:
        headers = dict(headers or {})
        if self.access_key:
            from ..s3api.sigv4 import sign_request
            headers = sign_request(method, self._url(key), headers,
                                   data, self.access_key,
                                   self.secret_key)
        req = urllib.request.Request(
            self._url(key), data=data if method in ("PUT", "POST")
            else None, method=method, headers=headers)
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.read()

    def upload_file(self, key: str, path: str) -> int:
        """Streaming PUT: hash pass then a file-object body, so a 30GB
        .dat never materializes in memory."""
        import hashlib
        size = os.path.getsize(path)
        sha = hashlib.sha256()
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                sha.update(chunk)
        headers = {"Content-Length": str(size),
                   "x-amz-content-sha256": sha.hexdigest()}
        if self.access_key:
            from ..s3api.sigv4 import sign_request
            headers = sign_request(
                "PUT", self._url(key), {"Content-Length": str(size)},
                b"", self.access_key, self.secret_key,
                payload_hash=sha.hexdigest())
        with open(path, "rb") as f:
            req = urllib.request.Request(self._url(key), data=f,
                                         method="PUT", headers=headers)
            with urllib.request.urlopen(req, timeout=3600) as resp:
                resp.read()
        return size

    def download_file(self, key: str, path: str) -> int:
        headers = {}
        if self.access_key:
            from ..s3api.sigv4 import sign_request
            headers = sign_request("GET", self._url(key), {}, b"",
                                   self.access_key, self.secret_key)
        req = urllib.request.Request(self._url(key), headers=headers)
        total = 0
        with urllib.request.urlopen(req, timeout=3600) as resp, \
                open(path, "wb") as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
                total += len(chunk)
        return total

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        hdrs = {"Range": f"bytes={offset}-{offset + size - 1}"}
        if self.access_key:
            from ..s3api.sigv4 import sign_request
            hdrs = sign_request("GET", self._url(key), hdrs, b"",
                                self.access_key, self.secret_key)
        req = urllib.request.Request(self._url(key), headers=hdrs)
        with urllib.request.urlopen(
                req, timeout=REMOTE_READ_TIMEOUT) as resp:
            return resp.read()

    def delete(self, key: str) -> None:
        try:
            self._request(key, "DELETE")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


def backend_for_spec(spec: str, access_key: str = "",
                     secret_key: str = "") -> BackendStorage:
    """'local:///dir' or 's3://host:port/bucket[/prefix]' -> backend
    (the factory registry, backend.go:48-93)."""
    scheme, _, rest = spec.partition("://")
    if scheme == "local":
        return LocalDirBackend("/" + rest.lstrip("/"))
    if scheme in ("s3", "s3+https"):
        host, _, rest2 = rest.partition("/")
        bucket, _, prefix = rest2.partition("/")
        if not bucket:
            raise ValueError(f"s3 spec needs a bucket: {spec}")
        proto = "https" if scheme == "s3+https" else "http"
        return S3Backend(f"{proto}://{host}", bucket, prefix,
                         access_key, secret_key)
    raise ValueError(f"unknown backend spec: {spec}")
