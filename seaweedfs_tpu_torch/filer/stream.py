"""Streaming chunked file content to/from the blob store.

Reference: weed/filer/stream.go (StreamContent), reader_at.go
(ChunkReadAt with chunk cache), operation/upload_content.go.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Iterator

from ..cluster.client import WeedClient
from ..trace import span as trace_span
from .entry import FileChunk
from .filechunks import read_chunk_views, total_size


class ChunkCache:
    """Tiny LRU of chunk bytes (reference: util/chunk_cache tiered cache)."""

    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024):
        self.capacity = capacity_bytes
        self._m: OrderedDict[str, bytes] = OrderedDict()
        self._size = 0
        self._lock = threading.Lock()

    def get(self, file_id: str) -> bytes | None:
        with self._lock:
            data = self._m.get(file_id)
            if data is not None:
                self._m.move_to_end(file_id)
            return data

    def put(self, file_id: str, data: bytes) -> None:
        if len(data) > self.capacity:
            return
        with self._lock:
            if file_id in self._m:
                return
            self._m[file_id] = data
            self._size += len(data)
            while self._size > self.capacity:
                _k, v = self._m.popitem(last=False)
                self._size -= len(v)


class ChunkStreamer:
    """Resolves chunk views and fetches the bytes (StreamContent).

    Manifest chunks are expanded lazily at read time — the entry's
    metadata stays small while the full chunk list lives in the blob
    store (filechunk_manifest.go ResolveChunkManifest)."""

    def __init__(self, client: WeedClient,
                 cache=None):
        self.client = client
        # Default: the process-global singleflight cache
        # (storage/chunk_cache.py, bounded by -filer.cache.mb).  A
        # local ChunkCache may still be injected for isolation.
        if cache is None:
            from ..storage.chunk_cache import CACHE as cache
        self.cache = cache

    def _fetch(self, file_id: str, cipher_key_hex: str = "") -> bytes:
        """Chunk bytes, opened: sealed chunks are decrypted before they
        enter the cache, so cache hits never re-pay the AES pass and
        the key check happens exactly once per fetch."""
        def pull() -> bytes:
            # Flow attribution: a chunk pulled to serve a filer read
            # is `proxy` traffic on the volume leg, whichever thread
            # (handler or singleflight leader) executes the fetch.
            from ..stats import flows as _flows
            with _flows.purpose("proxy"):
                return self.client.download(
                    file_id,
                    cipher_key=bytes.fromhex(cipher_key_hex)
                    if cipher_key_hex else b"")

        gof = getattr(self.cache, "get_or_fetch", None)
        if gof is not None:  # singleflight path
            from ..tenancy import context as _tenant_ctx
            return gof(file_id, pull,
                       tenant=_tenant_ctx.current_tenant())
        data = self.cache.get(file_id)
        if data is None:
            data = pull()
            self.cache.put(file_id, data)
        return data

    def resolve(self, chunks: list[FileChunk]) -> list[FileChunk]:
        """Expand any manifest chunks into their data chunks (the
        manifest blobs ride the same chunk cache as file data)."""
        from .filechunk_manifest import (has_chunk_manifest,
                                         resolve_chunk_manifest)
        if not has_chunk_manifest(chunks):
            return chunks
        data, _manifests = resolve_chunk_manifest(self._fetch, chunks)
        return data

    def read(self, chunks: list[FileChunk], offset: int = 0,
             size: int = -1) -> bytes:
        """Materialize byte range [offset, offset+size) (gaps are zeros,
        like a sparse file)."""
        chunks = self.resolve(chunks)
        file_size = total_size(chunks)
        if size < 0:
            size = max(file_size - offset, 0)
        size = min(size, max(file_size - offset, 0))
        if size <= 0:
            return b""
        out = bytearray(size)
        keys = {c.file_id: c.cipher_key for c in chunks if c.cipher_key}
        # Packed small files (filer/packing.py) share a needle: their
        # chunk carries sub_offset, the file's start inside the pack.
        subs = {c.file_id: c.sub_offset for c in chunks
                if getattr(c, "sub_offset", 0)}
        for view in read_chunk_views(chunks, offset, size):
            data = self._fetch(view.file_id, keys.get(view.file_id, ""))
            base = subs.get(view.file_id, 0) + view.offset_in_chunk
            piece = data[base:base + view.size]
            lo = view.logical_offset - offset
            out[lo:lo + len(piece)] = piece
        return bytes(out)

    def iter_content(self, chunks: list[FileChunk], offset: int = 0,
                     size: int = -1,
                     chunk_bytes: int = 1024 * 1024
                     ) -> Iterator[bytes]:
        """Yield the range in bounded pieces (HTTP streaming).

        Resolution and the visible-interval merge run ONCE for the
        whole range — a per-piece read() would re-sort the chunk list
        every piece, turning a many-chunk GET quadratic.  Gaps between
        views yield zeros (sparse-file semantics, same as read())."""
        chunks = self.resolve(chunks)
        file_size = total_size(chunks)
        if size < 0:
            size = max(file_size - offset, 0)
        size = min(size, max(file_size - offset, 0))
        if size <= 0:
            return
        end = offset + size
        keys = {c.file_id: c.cipher_key for c in chunks if c.cipher_key}
        subs = {c.file_id: c.sub_offset for c in chunks
                if getattr(c, "sub_offset", 0)}
        pos = offset
        for view in read_chunk_views(chunks, offset, size):
            while view.logical_offset > pos:  # gap -> zeros
                n = min(chunk_bytes, view.logical_offset - pos)
                yield bytes(n)
                pos += n
            data = self._fetch(view.file_id,
                               keys.get(view.file_id, ""))
            lo = subs.get(view.file_id, 0) + view.offset_in_chunk
            for i in range(0, view.size, chunk_bytes):
                piece = data[lo + i:lo + min(i + chunk_bytes,
                                             view.size)]
                yield piece
                pos += len(piece)
        while pos < end:  # trailing hole
            n = min(chunk_bytes, end - pos)
            yield bytes(n)
            pos += n

    def range_reader(self, chunks: list[FileChunk], offset: int = 0,
                     size: int = -1) -> "ChunkRangeReader":
        return ChunkRangeReader(self, chunks, offset, size)


class ChunkRangeReader:
    """File-like view over a chunk range — what a server handler
    returns so the rpc response writer streams a multi-GB body in 1MB
    pieces instead of materializing it (StreamContent's shape: the
    reference never buffers a whole file either, filer/stream.go)."""

    def __init__(self, streamer: ChunkStreamer,
                 chunks: list[FileChunk], offset: int, size: int):
        self._it = streamer.iter_content(chunks, offset, size)
        self._buf = bytearray()
        self._done = False

    def prime(self) -> "ChunkRangeReader":
        """Pull the first piece NOW, inside the request handler: chunk
        resolution / first-fetch failures then surface as a clean 500
        instead of a truncated 200 after headers went out."""
        self._fill(1)
        return self

    def _fill(self, n: int) -> None:
        while not self._done and (n < 0 or len(self._buf) < n):
            try:
                self._buf += next(self._it)
            except StopIteration:
                self._done = True

    def read(self, n: int = -1) -> bytes:
        self._fill(n)
        if n < 0:
            out = bytes(self._buf)
            self._buf.clear()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._it.close()
        return False


def upload_blob(client: WeedClient, data: bytes, collection: str = "",
                replication: str | None = None, ttl: str = "",
                offset: int = 0, cipher: bool = False) -> FileChunk:
    """Upload one blob as a single chunk via the client's upload
    pipeline (upload_content.go) and wrap the result as a FileChunk.
    With cipher=True the blob is sealed with a fresh AES-256-GCM key
    that lives only in the returned chunk's metadata (the filer cipher
    model, upload_content.go:150-170): volume servers hold ciphertext.
    Chunks are never needle-gzipped: ranged reads slice chunks at
    arbitrary offsets, which a compressed needle cannot serve."""
    r = client.upload(data, collection=collection,
                      replication=replication, ttl=ttl,
                      compress=False, cipher=cipher)
    return FileChunk(file_id=r["fid"], offset=offset, size=r["size"],
                     mtime=time.time_ns(), etag=r["etag"],
                     cipher_key=r["cipher_key"].hex()
                     if r["cipher_key"] else "")


class ChunkedWriter:
    """Upload a byte stream as fixed-size chunks (the filer's auto-chunk
    upload, filer_server_handlers_write_autochunk.go:188)."""

    def __init__(self, client: WeedClient, chunk_size: int = 4 * 1024 * 1024,
                 collection: str = "", replication: str | None = None,
                 ttl: str = "", cipher: bool = False):
        self.client = client
        self.chunk_size = chunk_size
        self.collection = collection
        self.replication = replication
        self.ttl = ttl
        self.cipher = cipher

    def write(self, reader, offset: int = 0,
              into: list[FileChunk] | None = None) -> list[FileChunk]:
        """Consume reader (bytes or file-like), upload chunk_size pieces,
        return the FileChunk list starting at logical `offset`.  Pass
        `into` to observe chunks as they land — on a mid-stream failure
        (client died, volume error) the caller can roll back exactly
        what was uploaded."""
        if isinstance(reader, (bytes, bytearray)):
            data = bytes(reader)
            import io
            reader = io.BytesIO(data)
        chunks = into if into is not None else []
        pos = offset
        while True:
            piece = reader.read(self.chunk_size)
            if not piece:
                break
            # One span per chunk: assign + volume POST, each a child
            # server span on the trace — a no-op outside a request.
            with trace_span("filer.chunk", offset=pos,
                            bytes=len(piece)):
                chunks.append(upload_blob(
                    self.client, piece, self.collection,
                    self.replication, self.ttl, pos,
                    cipher=self.cipher))
            pos += len(piece)
        return chunks
