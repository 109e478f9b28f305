"""Files kept in this process's memory (memfd_create), each reached
through a symlink at its path, so every open, stat and read of the path
by the program sees it.  A volume of the benchmark lives here, not on
the disk and not on the card: a run may write a few GiB to disk, and one
pass over a full volume writes tens.  (A copy of chip_smoke.py's
RamFiles, with fresh files swapped in behind a path.)"""

from __future__ import annotations

import os


class RamFiles:
    def __init__(self):
        self.fds: dict[str, int] = {}

    def make(self, path: str) -> int:
        """A new empty file at `path` (which must not exist)."""
        fd = os.memfd_create(os.path.basename(path))
        os.symlink(f"/proc/self/fd/{fd}", path)
        self.fds[path] = fd
        return fd

    def renew(self, path: str) -> int:
        """Put a new empty file behind `path` (the symlink stays; its
        descriptor number now holds the new file); returns a descriptor
        of the old file, which the caller owns and closes."""
        fd = self.fds[path]
        old = os.dup(fd)
        new = os.memfd_create(os.path.basename(path))
        os.dup2(new, fd)
        os.close(new)
        return old

    def size(self, path: str) -> int:
        return os.fstat(self.fds[path]).st_size

    def close(self) -> None:
        for path, fd in self.fds.items():
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            os.close(fd)
        self.fds.clear()


def write_all(fd: int, buf, offset: int) -> None:
    """pwrite every byte of `buf` at `offset`."""
    view = memoryview(buf).cast("B")
    while len(view):
        n = os.pwrite(fd, view, offset)
        view = view[n:]
        offset += n


def read_at(fd: int, size: int, offset: int) -> bytes:
    """Up to `size` bytes at `offset` (fewer at the end of the file)."""
    parts = []
    while size > 0:
        b = os.pread(fd, size, offset)
        if not b:
            break
        parts.append(b)
        size -= len(b)
        offset += len(b)
    return b"".join(parts)


def read_all(fd: int) -> bytes:
    return read_at(fd, os.fstat(fd).st_size, 0)


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")
