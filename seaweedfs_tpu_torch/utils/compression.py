"""Upload-side gzip: compress what shrinks, skip what won't.

Reference: weed/util/compression.go (GzipData/UnGzipData) and the
IsGzippableFileType heuristic in weed/operation/upload_content.go:
compressible mime families / extensions are gzipped on the client, sent
with `Content-Encoding: gzip`, stored with the needle's compressed flag,
and transparently decompressed for readers that don't accept gzip.
"""

from __future__ import annotations

import gzip
import io
import zlib

# Extension / mime families that reliably shrink.  Media containers
# (jpeg/png/zip/mp4/...) are already entropy-coded and excluded.
_EXTS = {
    ".txt", ".log", ".md", ".csv", ".tsv", ".json", ".js", ".css",
    ".html", ".htm", ".xml", ".svg", ".yaml", ".yml", ".toml", ".ini",
    ".conf", ".py", ".go", ".c", ".h", ".cpp", ".cc", ".java", ".rs",
    ".sh", ".sql", ".proto", ".ps", ".pdf",
}
_MIME_PREFIXES = ("text/",)
_MIME_EXACT = {
    "application/json", "application/javascript", "application/xml",
    "application/xhtml+xml", "application/x-javascript",
    "image/svg+xml", "application/x-ndjson",
}


def is_compressable(name: str = "", mime: str = "") -> bool:
    mime = (mime or "").split(";")[0].strip().lower()
    if mime:
        if any(mime.startswith(p) for p in _MIME_PREFIXES):
            return True
        if mime in _MIME_EXACT:
            return True
    name = (name or "").lower()
    dot = name.rfind(".")
    return dot >= 0 and name[dot:] in _EXTS


def gzip_data(data: bytes, level: int = 3) -> bytes:
    """Deterministic gzip (no mtime in the header) so replicas built
    from the same bytes stay byte-identical."""
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb",
                       compresslevel=level, mtime=0) as f:
        f.write(data)
    return buf.getvalue()


def ungzip_data(data: bytes) -> bytes:
    # 32+15: accept both gzip and raw-zlib wrapped payloads.
    try:
        return gzip.decompress(data)
    except (OSError, EOFError):
        return zlib.decompress(data, 32 + 15)


def maybe_gzip(data: bytes, name: str = "", mime: str = "",
               force: bool = False) -> tuple[bytes, bool]:
    """Gzip when the content type suggests it AND it actually shrinks
    (upload_content.go keeps the original if compression loses)."""
    if len(data) < 128:
        return data, False
    if not force and not is_compressable(name, mime):
        return data, False
    z = gzip_data(data)
    if len(z) >= len(data):
        return data, False
    return z, True
