"""Entry: one file or directory in the filer namespace.

Reference: weed/filer/entry.go:10-70 (Attr + Entry with chunks) and
weed/pb/filer.proto's FileChunk message.  A file's content is an ordered
list of chunks, each a needle in the blob store; directories have no
chunks.  Entries serialise to plain dicts (JSON) — the wire format of our
filer server and the on-store value format.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace


@dataclass
class FileChunk:
    """One piece of file content stored as a needle (filer.proto FileChunk).

    offset    — logical position of this chunk within the file
    file_id   — "vid,keyhex+cookiehex" needle reference
    mtime     — nanosecond timestamp deciding overwrite order
    """
    file_id: str
    offset: int
    size: int
    mtime: int
    etag: str = ""
    is_chunk_manifest: bool = False
    # Hex AES-256-GCM key for chunks sealed by a cipher-enabled filer
    # (filer.proto FileChunk.cipher_key); empty = plaintext needle.
    cipher_key: str = ""
    # Small-file packing (filer/packing.py): the needle holds SEVERAL
    # files' payloads back to back; this file's bytes are
    # [sub_offset, sub_offset+size) within the needle.  packed=True
    # marks the needle as shared — per-file deletes must not free it
    # (TTL/vacuum reclaim the pack as a whole).  Both fields serialize
    # sparsely, so pre-packing entries round-trip unchanged.
    sub_offset: int = 0
    packed: bool = False

    def to_dict(self) -> dict:
        d = {"file_id": self.file_id, "offset": self.offset,
             "size": self.size, "mtime": self.mtime}
        if self.etag:
            d["etag"] = self.etag
        if self.is_chunk_manifest:
            d["is_chunk_manifest"] = True
        if self.cipher_key:
            d["cipher_key"] = self.cipher_key
        if self.sub_offset:
            d["sub_offset"] = self.sub_offset
        if self.packed:
            d["packed"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(file_id=d["file_id"], offset=d["offset"],
                   size=d["size"], mtime=d["mtime"],
                   etag=d.get("etag", ""),
                   is_chunk_manifest=d.get("is_chunk_manifest", False),
                   cipher_key=d.get("cipher_key", ""),
                   sub_offset=d.get("sub_offset", 0),
                   packed=d.get("packed", False))


@dataclass
class Attributes:
    """File attributes (entry.go Attr)."""
    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    group_names: list[str] = field(default_factory=list)
    symlink_target: str = ""
    md5: str = ""
    replication: str = ""
    collection: str = ""

    def to_dict(self) -> dict:
        d: dict = {"mtime": self.mtime, "crtime": self.crtime,
                   "mode": self.mode}
        for k in ("uid", "gid", "ttl_sec"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        for k in ("mime", "user_name", "symlink_target", "md5",
                  "replication", "collection"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        if self.group_names:
            d["group_names"] = self.group_names
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Attributes":
        return cls(mtime=d.get("mtime", 0.0), crtime=d.get("crtime", 0.0),
                   mode=d.get("mode", 0o660), uid=d.get("uid", 0),
                   gid=d.get("gid", 0), mime=d.get("mime", ""),
                   ttl_sec=d.get("ttl_sec", 0),
                   user_name=d.get("user_name", ""),
                   group_names=d.get("group_names", []),
                   symlink_target=d.get("symlink_target", ""),
                   md5=d.get("md5", ""),
                   replication=d.get("replication", ""),
                   collection=d.get("collection", ""))


@dataclass
class Entry:
    """One namespace entry: full path + attributes + content chunks."""
    path: str  # absolute, '/'-separated, no trailing slash (except root)
    is_directory: bool = False
    attributes: Attributes = field(default_factory=Attributes)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)  # xattrs
    hard_link_id: str = ""
    hard_link_counter: int = 0

    @property
    def name(self) -> str:
        return self.path.rsplit("/", 1)[-1]

    @property
    def dir(self) -> str:
        d = self.path.rsplit("/", 1)[0]
        return d or "/"

    def size(self) -> int:
        from .filechunks import total_size
        return total_size(self.chunks)

    def is_expired(self, now: float | None = None) -> bool:
        if self.attributes.ttl_sec <= 0:
            return False
        now = time.time() if now is None else now
        return self.attributes.crtime + self.attributes.ttl_sec < now

    def clone(self) -> "Entry":
        return Entry(path=self.path, is_directory=self.is_directory,
                     attributes=replace(self.attributes,
                                        group_names=list(
                                            self.attributes.group_names)),
                     chunks=[replace(c) for c in self.chunks],
                     extended=dict(self.extended),
                     hard_link_id=self.hard_link_id,
                     hard_link_counter=self.hard_link_counter)

    def to_dict(self) -> dict:
        d: dict = {"path": self.path}
        if self.is_directory:
            d["is_directory"] = True
        d["attributes"] = self.attributes.to_dict()
        if self.chunks:
            d["chunks"] = [c.to_dict() for c in self.chunks]
        if self.extended:
            d["extended"] = self.extended
        if self.hard_link_id:
            d["hard_link_id"] = self.hard_link_id
            d["hard_link_counter"] = self.hard_link_counter
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        return cls(
            path=d["path"], is_directory=d.get("is_directory", False),
            attributes=Attributes.from_dict(d.get("attributes", {})),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=d.get("extended", {}),
            hard_link_id=d.get("hard_link_id", ""),
            hard_link_counter=d.get("hard_link_counter", 0))
