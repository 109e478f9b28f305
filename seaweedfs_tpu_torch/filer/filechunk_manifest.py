"""Chunk manifests: metadata indirection for huge files.

Reference: weed/filer/filechunk_manifest.go.  A file with thousands of
chunks would balloon every metadata read/write, so full batches of
MANIFEST_BATCH data chunks are serialized into a blob stored in the
volume store like any chunk, and the entry keeps ONE FileChunk with
is_chunk_manifest=True covering the batch's byte range
(mergeIntoManifest: offset = min offset, size = span).  Readers resolve
manifests lazily — and recursively, so manifests of manifests work —
before computing visible intervals (ResolveChunkManifest).

The manifest body here is JSON ``{"chunks": [...FileChunk dicts...]}``,
matching this build's wire/store format (the reference uses its
FileChunkManifest protobuf; same shape, different codec).
"""

from __future__ import annotations

import json
from typing import Callable

from .entry import FileChunk

# Full batches of this many data chunks collapse into one manifest
# chunk (filechunk_manifest.go:18 ManifestBatch).
MANIFEST_BATCH = 1000

# fetch(file_id, cipher_key_hex) -> opened bytes of the stored blob
# (manifest blobs written by a cipher-enabled filer are sealed like any
# other chunk — they hold every data chunk's key, so leaving them
# plaintext would defeat encryption at rest)
FetchFn = Callable[[str, str], bytes]
# save(data) -> FileChunk for the uploaded blob (offset/size overwritten)
SaveFn = Callable[[bytes], FileChunk]


def has_chunk_manifest(chunks: list[FileChunk]) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def resolve_chunk_manifest(
        fetch_fn: FetchFn, chunks: list[FileChunk]
) -> tuple[list[FileChunk], list[FileChunk]]:
    """Expand every manifest chunk (recursively) into its data chunks.
    Returns (data_chunks, manifest_chunks) — the manifest chunks
    themselves are returned separately so deletion can free both levels
    (ResolveChunkManifest)."""
    data: list[FileChunk] = []
    manifests: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            data.append(c)
            continue
        inner = resolve_one_chunk_manifest(fetch_fn, c)
        manifests.append(c)
        d2, m2 = resolve_chunk_manifest(fetch_fn, inner)
        data.extend(d2)
        manifests.extend(m2)
    return data, manifests


def resolve_one_chunk_manifest(fetch_fn: FetchFn,
                               chunk: FileChunk) -> list[FileChunk]:
    if not chunk.is_chunk_manifest:
        return []
    blob = fetch_fn(chunk.file_id, chunk.cipher_key)
    try:
        doc = json.loads(bytes(blob))
    except Exception as e:  # noqa: BLE001
        raise ValueError(
            f"unreadable chunk manifest {chunk.file_id}: {e}") from None
    return [FileChunk.from_dict(d) for d in doc.get("chunks", [])]


def maybe_manifestize(save_fn: SaveFn, chunks: list[FileChunk],
                      merge_factor: int = MANIFEST_BATCH,
                      created: list[FileChunk] | None = None
                      ) -> list[FileChunk]:
    """Collapse full merge_factor-sized batches of data chunks into
    manifest chunks; the remainder (and pre-existing manifest chunks)
    pass through untouched (MaybeManifestize/doMaybeManifestize).
    Pass `created` to observe manifest blobs as they are uploaded — on
    a mid-run failure the caller can roll back exactly what landed."""
    data = [c for c in chunks if not c.is_chunk_manifest]
    out = [c for c in chunks if c.is_chunk_manifest]
    i = 0
    while i + merge_factor <= len(data):
        m = _merge_into_manifest(save_fn, data[i:i + merge_factor])
        if created is not None:
            created.append(m)
        out.append(m)
        i += merge_factor
    out.extend(data[i:])
    return out


def _merge_into_manifest(save_fn: SaveFn,
                         data_chunks: list[FileChunk]) -> FileChunk:
    blob = json.dumps(
        {"chunks": [c.to_dict() for c in data_chunks]}).encode()
    lo = min(c.offset for c in data_chunks)
    hi = max(c.offset + c.size for c in data_chunks)
    manifest = save_fn(blob)
    manifest.is_chunk_manifest = True
    manifest.offset = lo
    manifest.size = hi - lo
    return manifest
