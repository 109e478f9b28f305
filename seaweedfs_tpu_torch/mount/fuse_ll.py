"""ctypes binding of libfuse 2.9 driving a WFS instance.

Reference: the reference mounts via bazil.org/fuse (weed/filesys/); this
build binds the system libfuse.so.2 high-level API directly — no
third-party FUSE package.  Struct layouts are the x86-64 glibc/libfuse
2.9 ABI.  All filesystem semantics live in vfs.WFS; this file only
translates the C callback surface.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import subprocess
import threading

from .vfs import WFS, FuseError

c_stat_time = ctypes.c_long * 2  # struct timespec


class c_stat(ctypes.Structure):
    _fields_ = [
        ("st_dev", ctypes.c_ulong),
        ("st_ino", ctypes.c_ulong),
        ("st_nlink", ctypes.c_ulong),
        ("st_mode", ctypes.c_uint),
        ("st_uid", ctypes.c_uint),
        ("st_gid", ctypes.c_uint),
        ("__pad0", ctypes.c_int),
        ("st_rdev", ctypes.c_ulong),
        ("st_size", ctypes.c_long),
        ("st_blksize", ctypes.c_long),
        ("st_blocks", ctypes.c_long),
        ("st_atim", c_stat_time),
        ("st_mtim", c_stat_time),
        ("st_ctim", c_stat_time),
        ("__reserved", ctypes.c_long * 3),
    ]


class c_fuse_file_info(ctypes.Structure):
    _fields_ = [
        ("flags", ctypes.c_int),
        ("fh_old", ctypes.c_ulong),
        ("writepage", ctypes.c_int),
        ("bits", ctypes.c_uint),
        ("fh", ctypes.c_uint64),
        ("lock_owner", ctypes.c_uint64),
    ]


class c_timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


fill_dir_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
    ctypes.POINTER(c_stat), ctypes.c_long)

_P = ctypes.POINTER
_CB = ctypes.CFUNCTYPE


def _op(restype, *argtypes):
    return _CB(restype, *argtypes)


class c_fuse_operations(ctypes.Structure):
    """libfuse 2.9 fuse_operations — field ORDER is ABI."""
    _fields_ = [
        ("getattr", _op(ctypes.c_int, ctypes.c_char_p, _P(c_stat))),
        ("readlink", _op(ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_void_p, ctypes.c_size_t)),
        ("getdir", ctypes.c_void_p),
        ("mknod", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint,
                      ctypes.c_ulong)),
        ("mkdir", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint)),
        ("unlink", _op(ctypes.c_int, ctypes.c_char_p)),
        ("rmdir", _op(ctypes.c_int, ctypes.c_char_p)),
        ("symlink", _op(ctypes.c_int, ctypes.c_char_p,
                        ctypes.c_char_p)),
        ("rename", _op(ctypes.c_int, ctypes.c_char_p,
                       ctypes.c_char_p)),
        ("link", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)),
        ("chmod", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint)),
        ("chown", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint,
                      ctypes.c_uint)),
        ("truncate", _op(ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_long)),
        ("utime", ctypes.c_void_p),
        ("open", _op(ctypes.c_int, ctypes.c_char_p,
                     _P(c_fuse_file_info))),
        ("read", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                     ctypes.c_size_t, ctypes.c_long,
                     _P(c_fuse_file_info))),
        ("write", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                      ctypes.c_size_t, ctypes.c_long,
                      _P(c_fuse_file_info))),
        ("statfs", ctypes.c_void_p),
        ("flush", _op(ctypes.c_int, ctypes.c_char_p,
                      _P(c_fuse_file_info))),
        ("release", _op(ctypes.c_int, ctypes.c_char_p,
                        _P(c_fuse_file_info))),
        ("fsync", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                      _P(c_fuse_file_info))),
        ("setxattr", _op(ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_char_p, ctypes.c_void_p,
                         ctypes.c_size_t, ctypes.c_int)),
        ("getxattr", _op(ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_char_p, ctypes.c_void_p,
                         ctypes.c_size_t)),
        ("listxattr", _op(ctypes.c_int, ctypes.c_char_p,
                          ctypes.c_void_p, ctypes.c_size_t)),
        ("removexattr", _op(ctypes.c_int, ctypes.c_char_p,
                            ctypes.c_char_p)),
        ("opendir", ctypes.c_void_p),
        ("readdir", _op(ctypes.c_int, ctypes.c_char_p,
                        ctypes.c_void_p, fill_dir_t, ctypes.c_long,
                        _P(c_fuse_file_info))),
        ("releasedir", ctypes.c_void_p),
        ("fsyncdir", ctypes.c_void_p),
        ("init", ctypes.c_void_p),
        ("destroy", ctypes.c_void_p),
        ("access", ctypes.c_void_p),
        ("create", _op(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint,
                       _P(c_fuse_file_info))),
        ("ftruncate", _op(ctypes.c_int, ctypes.c_char_p,
                          ctypes.c_long, _P(c_fuse_file_info))),
        ("fgetattr", _op(ctypes.c_int, ctypes.c_char_p, _P(c_stat),
                         _P(c_fuse_file_info))),
        ("lock", ctypes.c_void_p),
        ("utimens", _op(ctypes.c_int, ctypes.c_char_p,
                        _P(c_timespec))),
        ("bmap", ctypes.c_void_p),
        ("flags", ctypes.c_uint),
        ("ioctl", ctypes.c_void_p),
        ("poll", ctypes.c_void_p),
        ("write_buf", ctypes.c_void_p),
        ("read_buf", ctypes.c_void_p),
        ("flock", ctypes.c_void_p),
        ("fallocate", ctypes.c_void_p),
    ]


def _restore_sigpipe_ignore() -> None:
    """libfuse's signal teardown (fuse_remove_signal_handlers) restores
    SIG_DFL for SIGPIPE at the C level while Python's bookkeeping still
    says "ignored" — any later write to a closed socket ANYWHERE in the
    process would then be a silent SIGKILL-style death instead of
    BrokenPipeError.  Re-assert SIG_IGN via the C library (the Python
    signal module only works from the main thread; fuse_main usually
    runs on a mount thread)."""
    try:
        libc = ctypes.CDLL(None)
        libc.signal(13, ctypes.c_void_p(1))  # signal(SIGPIPE, SIG_IGN)
    except Exception:  # noqa: BLE001 — best effort
        pass


def _errno_of(e: Exception) -> int:
    if isinstance(e, FuseError):
        return -e.errno
    if isinstance(e, OSError) and e.errno:
        return -e.errno
    return -errno.EIO


def _fill_stat(st: "_P(c_stat)", attrs: dict) -> None:
    ctypes.memset(ctypes.byref(st.contents), 0,
                  ctypes.sizeof(c_stat))
    s = st.contents
    s.st_mode = attrs["st_mode"]
    s.st_nlink = attrs.get("st_nlink", 1)
    s.st_size = attrs.get("st_size", 0)
    s.st_uid = attrs.get("st_uid", 0)
    s.st_gid = attrs.get("st_gid", 0)
    mt = attrs.get("st_mtime", 0.0)
    ct = attrs.get("st_ctime", 0.0) or mt
    s.st_mtim[0] = int(mt)
    s.st_mtim[1] = int((mt % 1) * 1e9)
    s.st_ctim[0] = int(ct)
    s.st_ctim[1] = int((ct % 1) * 1e9)
    s.st_atim[0] = int(mt)
    s.st_blocks = (attrs.get("st_size", 0) + 511) // 512


class FuseMount:
    """Mount a WFS at a local path via libfuse (foreground thread)."""

    def __init__(self, wfs: WFS, mountpoint: str,
                 allow_other: bool = False):
        self.wfs = wfs
        self.mountpoint = os.path.abspath(mountpoint)
        self.allow_other = allow_other
        self._lib = ctypes.CDLL("libfuse.so.2", use_errno=True)
        self._ops = self._build_ops()
        self._thread: threading.Thread | None = None

    # -- callbacks -----------------------------------------------------------

    def _build_ops(self) -> c_fuse_operations:
        w = self.wfs
        ops = c_fuse_operations()

        debug = bool(os.environ.get("WEED_FUSE_DEBUG"))

        def wrap(fn):
            def inner(*args):
                try:
                    return fn(*args) or 0
                except Exception as e:  # noqa: BLE001 — every error
                    if debug:            # becomes an errno for the
                        import traceback  # kernel, never a crash
                        traceback.print_exc()
                    return _errno_of(e)
            return inner

        def _p(raw: bytes) -> str:
            return raw.decode("utf-8", "surrogateescape")

        @wrap
        def op_getattr(path, st):
            _fill_stat(st, w.getattr(_p(path)))
        ops.getattr = type(ops.getattr)(op_getattr)

        @wrap
        def op_fgetattr(path, st, fi):
            fh = fi.contents.fh if fi else None
            _fill_stat(st, w.getattr(_p(path), fh=fh or None))
        ops.fgetattr = type(ops.fgetattr)(op_fgetattr)

        @wrap
        def op_readdir(path, buf, filler, off, fi):
            filler(buf, b".", None, 0)
            filler(buf, b"..", None, 0)
            for name in w.readdir(_p(path)):
                filler(buf, name.encode("utf-8", "surrogateescape"),
                       None, 0)
        ops.readdir = type(ops.readdir)(op_readdir)

        @wrap
        def op_mkdir(path, mode):
            w.mkdir(_p(path), mode)
        ops.mkdir = type(ops.mkdir)(op_mkdir)

        @wrap
        def op_rmdir(path):
            w.rmdir(_p(path))
        ops.rmdir = type(ops.rmdir)(op_rmdir)

        @wrap
        def op_unlink(path):
            w.unlink(_p(path))
        ops.unlink = type(ops.unlink)(op_unlink)

        @wrap
        def op_rename(old, new):
            w.rename(_p(old), _p(new))
        ops.rename = type(ops.rename)(op_rename)

        @wrap
        def op_symlink(target, path):
            w.symlink(_p(target), _p(path))
        ops.symlink = type(ops.symlink)(op_symlink)

        @wrap
        def op_link(src, dst):
            w.link(_p(src), _p(dst))
        ops.link = type(ops.link)(op_link)

        @wrap
        def op_readlink(path, buf, size):
            data = w.readlink(_p(path)).encode() + b"\0"
            ctypes.memmove(buf, data, min(len(data), size))
        ops.readlink = type(ops.readlink)(op_readlink)

        @wrap
        def op_chmod(path, mode):
            w.chmod(_p(path), mode)
        ops.chmod = type(ops.chmod)(op_chmod)

        @wrap
        def op_chown(path, uid, gid):
            w.chown(_p(path), ctypes.c_int(uid).value,
                    ctypes.c_int(gid).value)
        ops.chown = type(ops.chown)(op_chown)

        @wrap
        def op_utimens(path, times):
            if times:
                at = times[0].tv_sec + times[0].tv_nsec / 1e9
                mt = times[1].tv_sec + times[1].tv_nsec / 1e9
            else:
                import time as _t
                at = mt = _t.time()
            w.utimens(_p(path), at, mt)
        ops.utimens = type(ops.utimens)(op_utimens)

        @wrap
        def op_create(path, mode, fi):
            fi.contents.fh = w.create(_p(path), mode)
        ops.create = type(ops.create)(op_create)

        @wrap
        def op_mknod(path, mode, dev):
            # The kernel never sends release for mknod; close the
            # handle create() registered or it leaks per file.
            w.release(w.create(_p(path), mode))
        ops.mknod = type(ops.mknod)(op_mknod)

        @wrap
        def op_open(path, fi):
            fi.contents.fh = w.open(_p(path), fi.contents.flags)
        ops.open = type(ops.open)(op_open)

        @wrap
        def op_read(path, buf, size, off, fi):
            data = w.read(fi.contents.fh, size, off)
            ctypes.memmove(buf, data, len(data))
            return len(data)
        ops.read = type(ops.read)(op_read)

        @wrap
        def op_write(path, buf, size, off, fi):
            data = ctypes.string_at(buf, size)
            return w.write(fi.contents.fh, data, off)
        ops.write = type(ops.write)(op_write)

        @wrap
        def op_truncate(path, length):
            w.truncate(_p(path), length)
        ops.truncate = type(ops.truncate)(op_truncate)

        @wrap
        def op_ftruncate(path, length, fi):
            w.truncate(_p(path), length, fh=fi.contents.fh)
        ops.ftruncate = type(ops.ftruncate)(op_ftruncate)

        @wrap
        def op_flush(path, fi):
            w.flush(fi.contents.fh)
        ops.flush = type(ops.flush)(op_flush)

        @wrap
        def op_release(path, fi):
            w.release(fi.contents.fh)
        ops.release = type(ops.release)(op_release)

        @wrap
        def op_fsync(path, datasync, fi):
            w.flush(fi.contents.fh)
        ops.fsync = type(ops.fsync)(op_fsync)

        @wrap
        def op_setxattr(path, name, value, size, flags):
            w.setxattr(_p(path), _p(name),
                       ctypes.string_at(value, size))
        ops.setxattr = type(ops.setxattr)(op_setxattr)

        @wrap
        def op_getxattr(path, name, buf, size):
            data = w.getxattr(_p(path), _p(name))
            if size == 0:
                return len(data)
            if size < len(data):
                return -errno.ERANGE
            ctypes.memmove(buf, data, len(data))
            return len(data)
        ops.getxattr = type(ops.getxattr)(op_getxattr)

        @wrap
        def op_listxattr(path, buf, size):
            names = b"".join(n.encode() + b"\0"
                             for n in w.listxattr(_p(path)))
            if size == 0:
                return len(names)
            if size < len(names):
                return -errno.ERANGE
            ctypes.memmove(buf, names, len(names))
            return len(names)
        ops.listxattr = type(ops.listxattr)(op_listxattr)

        @wrap
        def op_removexattr(path, name):
            w.removexattr(_p(path), _p(name))
        ops.removexattr = type(ops.removexattr)(op_removexattr)

        return ops

    # -- mount lifecycle -----------------------------------------------------

    def mount(self, foreground: bool = True) -> None:
        """Run fuse_main (blocks until unmounted)."""
        args = [b"weed-mount", self.mountpoint.encode(), b"-f",
                b"-o", b"big_writes,default_permissions"]
        if self.allow_other:
            args += [b"-o", b"allow_other"]
        argv = (ctypes.c_char_p * len(args))(*args)
        self.wfs.start()
        try:
            err = self._lib.fuse_main_real(
                len(args), argv, ctypes.byref(self._ops),
                ctypes.sizeof(self._ops), None)
            if err:
                raise RuntimeError(f"fuse_main failed: {err}")
        finally:
            self.wfs.stop()
            _restore_sigpipe_ignore()

    def mount_background(self, ready_timeout: float = 10.0) -> None:
        """Mount on a daemon thread; returns once the kernel mount is
        visible (for tests and the CLI's non-blocking path)."""
        import time
        self._thread = threading.Thread(target=self.mount, daemon=True,
                                        name="fuse-main")
        self._thread.start()
        deadline = time.monotonic() + ready_timeout
        while time.monotonic() < deadline:
            if os.path.ismount(self.mountpoint):
                return
            if not self._thread.is_alive():
                raise RuntimeError("fuse_main exited during mount")
            time.sleep(0.05)
        raise TimeoutError("mount did not appear")

    def unmount(self) -> None:
        subprocess.run(["fusermount", "-u", self.mountpoint],
                       check=False, capture_output=True)
        if self._thread:
            self._thread.join(timeout=5)
