"""WFS: the kernel-independent mounted-filesystem core.

Reference: weed/filesys/wfs.go:54-113 (WFS), file.go / dir.go (node
ops), dirty_page.go (upload-on-flush), filehandle.go (read overlay).

Every operation takes an absolute path below the mounted filer
directory.  The FUSE shim (fuse_ll.py) is a thin translation layer, so
all semantics live here and are testable without /dev/fuse.
"""

from __future__ import annotations

import errno
import os
import stat as stat_m
import threading
import time

from ..cluster.client import WeedClient
from ..filer.client import FilerProxy
from ..filer.entry import FileChunk
from ..filer.filechunks import total_size
from ..filer.stream import ChunkedWriter, ChunkStreamer
from .dirty_pages import ContinuousIntervals
from .meta_cache import MetaCache


class FuseError(OSError):
    def __init__(self, err: int, msg: str = ""):
        super().__init__(err, msg or os.strerror(err))
        self.errno = err


class FileHandle:
    """One open file: entry snapshot + dirty write buffer.

    Reads overlay the dirty intervals on top of chunk content
    (filehandle.go Read); flush uploads the intervals as fresh chunks
    and persists the new chunk list (dirty_page.go saveToStorage)."""

    def __init__(self, wfs: "WFS", path: str, entry: dict):
        import copy
        self.wfs = wfs
        self.path = path
        # Deep copy: the cache hands out its stored dict by reference;
        # mutating it in place would leak unflushed truncates/chunk
        # edits into other handles and getattr before persistence.
        self.entry = copy.deepcopy(entry)
        self.dirty = ContinuousIntervals()
        self.lock = threading.RLock()
        self._truncated_to: int | None = None
        self.ref = 1

    # -- size ---------------------------------------------------------------

    def size(self) -> int:
        with self.lock:
            base = total_size(self._chunks())
            if self._truncated_to is not None:
                base = self._truncated_to
            return max(base, self.dirty.max_end())

    def _chunks(self) -> list[FileChunk]:
        return [FileChunk.from_dict(c)
                for c in self.entry.get("chunks", [])]

    # -- IO -----------------------------------------------------------------

    def read(self, size: int, offset: int) -> bytes:
        with self.lock:
            file_size = self.size()
            if offset >= file_size:
                return b""
            size = min(size, file_size - offset)
            base = self.wfs.streamer.read(self._chunks(), offset, size)
            buf = bytearray(base.ljust(size, b"\0"))
            for abs_off, piece in self.dirty.read(offset, size):
                lo = abs_off - offset
                buf[lo:lo + len(piece)] = piece
            return bytes(buf)

    def write(self, data: bytes, offset: int) -> int:
        with self.lock:
            self.dirty.add(offset, data)
            if self.dirty.total_size() > self.wfs.flush_threshold:
                self._flush_locked()
            return len(data)

    def truncate(self, length: int) -> None:
        with self.lock:
            cur = self.size()
            if length < cur:
                # Shrink: materialize the surviving prefix as dirty data
                # and drop the chunk list — flush rewrites the file
                # (small-file mount semantics; reference punts the same
                # way for non-append truncates).
                keep = self.read(length, 0) if length else b""
                self.entry["chunks"] = []
                self.dirty = ContinuousIntervals()
                if keep:
                    self.dirty.add(0, keep)
                self._truncated_to = length
            elif length > cur:
                self.dirty.add(length - 1, b"\0")

    def flush(self) -> None:
        with self.lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        pieces = self.dirty.pop_all()
        if not pieces and self._truncated_to is None:
            return
        chunks = self._chunks()
        writer = self.wfs.writer
        for off, data in pieces:
            import io
            chunks.extend(writer.write(io.BytesIO(data), offset=off))
        self.entry["chunks"] = [c.to_dict() for c in chunks]
        self.entry.setdefault("attributes", {})["mtime"] = time.time()
        self._truncated_to = None
        import copy
        self.wfs.proxy.create_entry(self.path, self.entry)
        self.wfs.meta_cache.upsert(self.path, copy.deepcopy(self.entry))


class WFS:
    """The mounted filesystem (wfs.go WFS)."""

    def __init__(self, filer_url: str, filer_dir: str = "/",
                 collection: str = "", replication: str = "",
                 chunk_size: int = 4 * 1024 * 1024,
                 flush_threshold: int = 32 * 1024 * 1024):
        self.proxy = FilerProxy(filer_url)
        self.root = "/" + filer_dir.strip("/")
        self.collection = collection
        self.chunk_size = chunk_size
        self.flush_threshold = flush_threshold
        # The filer proxies /dir/assign and /dir/lookup, so the blob
        # client speaks to the filer only (like the reference mount).
        self.client = WeedClient(filer_url)
        self.streamer = ChunkStreamer(self.client)
        # Honor the filer's cipher configuration (wfs.go reads it from
        # GetFilerConfiguration): a mount of a cipher-enabled filer must
        # seal its chunks too, or writes through FUSE silently bypass
        # encryption at rest.
        # Strict: a mount cannot run without its filer anyway, and
        # silently falling back to plaintext on a transient error would
        # re-open the bypass.
        self.cipher = cipher = bool(
            self.proxy.meta_info().get("cipher", False))
        self.writer = ChunkedWriter(self.client, chunk_size=chunk_size,
                                    collection=collection,
                                    replication=replication or None,
                                    cipher=cipher)
        self.meta_cache = MetaCache(filer_url)
        self.handles: dict[int, FileHandle] = {}
        self._next_fh = 1
        self._lock = threading.RLock()

    def start(self) -> None:
        self.meta_cache.start()

    def stop(self) -> None:
        with self._lock:
            for fh in list(self.handles.values()):
                try:
                    fh.flush()
                except Exception:  # noqa: BLE001 — unmount must finish
                    pass
            self.handles.clear()
        self.meta_cache.stop()

    # -- path helpers --------------------------------------------------------

    def _full(self, path: str) -> str:
        p = (self.root.rstrip("/") + "/" + path.lstrip("/"))
        return p.rstrip("/") or "/"

    def _entry(self, path: str) -> dict:
        e = self.meta_cache.lookup(self._full(path))
        if e is None:
            raise FuseError(errno.ENOENT, path)
        return e

    # -- attrs ---------------------------------------------------------------

    def getattr(self, path: str, fh: int | None = None) -> dict:
        if fh is not None:
            h = self._handle(fh)
            e = h.entry
            size = h.size()
        else:
            if path in ("/", ""):
                return {"st_mode": stat_m.S_IFDIR | 0o755, "st_nlink": 2,
                        "st_size": 0, "st_mtime": time.time(),
                        "st_uid": os.getuid(), "st_gid": os.getgid()}
            e = self._entry(path)
            size = total_size([FileChunk.from_dict(c)
                               for c in e.get("chunks", [])])
        attr = e.get("attributes", {})
        if e.get("is_directory"):
            mode = stat_m.S_IFDIR | attr.get("mode", 0o755)
        elif attr.get("symlink_target"):
            mode = stat_m.S_IFLNK | 0o777
        else:
            mode = stat_m.S_IFREG | attr.get("mode", 0o644)
        return {"st_mode": mode,
                "st_nlink": max(1, e.get("hard_link_counter", 0)),
                "st_size": size,
                "st_mtime": attr.get("mtime", 0.0) or 0.0,
                "st_ctime": attr.get("crtime", 0.0) or 0.0,
                "st_uid": attr.get("uid", os.getuid()),
                "st_gid": attr.get("gid", os.getgid())}

    def readdir(self, path: str) -> list[str]:
        full = self._full(path)
        if full in ("/", self.root):
            # The mount root always lists (it may not exist in the filer
            # yet when -filer.path points at a fresh directory).
            return [d["name"] for d in self.meta_cache.list_dir(full)]
        e = self.meta_cache.lookup(full)
        if e is None or not e.get("is_directory"):
            raise FuseError(errno.ENOTDIR if e else errno.ENOENT, path)
        return [d["name"] for d in self.meta_cache.list_dir(full)]

    # -- namespace ops -------------------------------------------------------

    def mkdir(self, path: str, mode: int = 0o755) -> None:
        self.proxy.mkdir(self._full(path))
        self.meta_cache.invalidate(self._full(path))

    def rmdir(self, path: str) -> None:
        e = self._entry(path)
        if not e.get("is_directory"):
            raise FuseError(errno.ENOTDIR, path)
        if self.proxy.list(self._full(path), limit=1):
            raise FuseError(errno.ENOTEMPTY, path)
        self.proxy.delete(self._full(path))
        self.meta_cache.upsert(self._full(path), None)

    def unlink(self, path: str) -> None:
        e = self._entry(path)
        if e.get("is_directory"):
            raise FuseError(errno.EISDIR, path)
        self.proxy.delete(self._full(path))
        self.meta_cache.upsert(self._full(path), None)

    def rename(self, old: str, new: str) -> None:
        src = self._entry(old)
        dst = self.meta_cache.lookup(self._full(new))
        if dst is not None:
            # POSIX rename-over-existing rules — never silently destroy
            # a directory tree.
            if dst.get("is_directory"):
                if not src.get("is_directory"):
                    raise FuseError(errno.EISDIR, new)
                if self.proxy.list(self._full(new), limit=1):
                    raise FuseError(errno.ENOTEMPTY, new)
                self.proxy.delete(self._full(new))
            elif src.get("is_directory"):
                raise FuseError(errno.ENOTDIR, new)
            else:
                self.proxy.delete(self._full(new))
        self.proxy.rename(self._full(old), self._full(new))
        self.meta_cache.invalidate(self._full(old))
        self.meta_cache.invalidate(self._full(new))

    def link(self, src: str, dst: str) -> None:
        """Hardlink: dst becomes another name for src's content, backed
        by the filer's hard_link_id indirection
        (filerstore_hardlink.go; filesys/dir_link.go Link)."""
        self.proxy.hardlink(self._full(src), self._full(dst))
        self.meta_cache.invalidate(self._full(src))
        self.meta_cache.invalidate(self._full(dst))

    def symlink(self, target: str, path: str) -> None:
        entry = {"attributes": {"symlink_target": target,
                                "mode": 0o777,
                                "mtime": time.time(),
                                "crtime": time.time()}}
        self.proxy.create_entry(self._full(path), entry)
        self.meta_cache.invalidate(self._full(path))

    def readlink(self, path: str) -> str:
        e = self._entry(path)
        target = e.get("attributes", {}).get("symlink_target", "")
        if not target:
            raise FuseError(errno.EINVAL, path)
        return target

    def chmod(self, path: str, mode: int) -> None:
        self._update_attr(path, mode=mode & 0o7777)

    def chown(self, path: str, uid: int, gid: int) -> None:
        kw = {}
        if uid != -1:
            kw["uid"] = uid
        if gid != -1:
            kw["gid"] = gid
        if kw:
            self._update_attr(path, **kw)

    def utimens(self, path: str, atime: float, mtime: float) -> None:
        self._update_attr(path, mtime=mtime)

    def _update_attr(self, path: str, **kw) -> None:
        e = self._entry(path)
        e.setdefault("attributes", {}).update(kw)
        self.proxy.create_entry(self._full(path), e)
        self.meta_cache.upsert(self._full(path), e)

    # -- xattrs (entry.extended, filesys/xattr.go) ---------------------------

    def setxattr(self, path: str, name: str, value: bytes) -> None:
        e = self._entry(path)
        e.setdefault("extended", {})[name] = value.decode(
            "utf-8", "surrogateescape")
        self.proxy.create_entry(self._full(path), e)
        self.meta_cache.upsert(self._full(path), e)

    def getxattr(self, path: str, name: str) -> bytes:
        e = self._entry(path)
        v = e.get("extended", {}).get(name)
        if v is None:
            raise FuseError(errno.ENODATA, name)
        return v.encode("utf-8", "surrogateescape")

    def listxattr(self, path: str) -> list[str]:
        return list(self._entry(path).get("extended", {}))

    def removexattr(self, path: str, name: str) -> None:
        e = self._entry(path)
        if name not in e.get("extended", {}):
            raise FuseError(errno.ENODATA, name)
        del e["extended"][name]
        self.proxy.create_entry(self._full(path), e)
        self.meta_cache.upsert(self._full(path), e)

    # -- file handles --------------------------------------------------------

    def _handle(self, fh: int) -> FileHandle:
        with self._lock:
            h = self.handles.get(fh)
        if h is None:
            raise FuseError(errno.EBADF, str(fh))
        return h

    def _register(self, h: FileHandle) -> int:
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self.handles[fh] = h
            return fh

    def create(self, path: str, mode: int = 0o644) -> int:
        now = time.time()
        entry = {"path": self._full(path),
                 "attributes": {"mode": mode & 0o7777, "mtime": now,
                                "crtime": now,
                                "collection": self.collection},
                 "chunks": []}
        self.proxy.create_entry(self._full(path), entry)
        self.meta_cache.upsert(self._full(path), entry)
        return self._register(FileHandle(self, self._full(path), entry))

    def open(self, path: str, flags: int = os.O_RDONLY) -> int:
        e = self._entry(path)
        if e.get("is_directory"):
            raise FuseError(errno.EISDIR, path)
        h = FileHandle(self, self._full(path), e)
        if flags & os.O_TRUNC:
            h.truncate(0)
        return self._register(h)

    def read(self, fh: int, size: int, offset: int) -> bytes:
        return self._handle(fh).read(size, offset)

    def write(self, fh: int, data: bytes, offset: int) -> int:
        return self._handle(fh).write(data, offset)

    def truncate(self, path: str, length: int,
                 fh: int | None = None) -> None:
        if fh is not None:
            self._handle(fh).truncate(length)
            return
        h = FileHandle(self, self._full(path), self._entry(path))
        h.truncate(length)
        h.flush()

    def flush(self, fh: int) -> None:
        self._handle(fh).flush()

    def release(self, fh: int) -> None:
        with self._lock:
            h = self.handles.pop(fh, None)
        if h is not None:
            h.flush()
