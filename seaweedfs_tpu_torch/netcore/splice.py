"""Kernel-side fd-to-fd byte relay: the socket→socket analogue of the
volume server's os.sendfile needle path.

A filer proxying a large GET used to pull every byte into Python (recv
→ bytes object → sendall) twice over.  os.splice moves pages
volume-socket → pipe → client-socket entirely inside the kernel; the
filer's CPU cost per proxied byte drops to the two splice syscalls per
1MB window.  Platforms without os.splice (or fds it rejects) degrade
to a plain read/write loop mid-stream with no bytes lost — the pipe is
always fully drained before more is pulled from the source.

Source fds are often NON-BLOCKING: a pooled client socket under
settimeout() runs its fd in non-blocking mode (CPython implements the
timeout with poll).  Every kernel call here therefore treats EAGAIN as
"select and retry", bounded by `timeout` per wait.
"""

from __future__ import annotations

import os
import select as _select

HAVE_SPLICE = hasattr(os, "splice")

_WINDOW = 1 << 20


def _wait(fd: int, write: bool, timeout: float) -> None:
    r, w, _x = _select.select([] if write else [fd],
                              [fd] if write else [], [], timeout)
    if not (r or w):
        raise TimeoutError(
            f"relay stalled {timeout:.0f}s waiting to "
            f"{'write' if write else 'read'}")


def _write_all(fd: int, buf: bytes, timeout: float = 30.0) -> None:
    view = memoryview(buf)
    while view:
        try:
            view = view[os.write(fd, view):]
        except BlockingIOError:
            _wait(fd, True, timeout)


def _drain_pipe(r: int, dst: int, n: int, timeout: float) -> None:
    """Move exactly n bytes pipe→dst; falls back to read/write if the
    destination rejects splice, so no byte is ever stranded in the
    pipe."""
    left = n
    while left:
        try:
            left -= os.splice(r, dst, left)
        except BlockingIOError:
            _wait(dst, True, timeout)
        except OSError:
            buf = os.read(r, min(left, 1 << 16))
            _write_all(dst, buf, timeout)
            left -= len(buf)


def copy_fd(src: int, dst: int, count: int,
            timeout: float = 30.0, note=None) -> None:
    """Relay exactly `count` bytes src→dst.  Raises ConnectionError on
    source EOF before count (a truncated upstream body must surface as
    a failed transfer, mirroring _Resp.read's incomplete-read rule).

    `note(n)` is invoked with each syscall-returned byte total — the
    wire-flow ledger's only window into bytes that never transit
    userspace (stats/flows.py)."""
    left = count
    if HAVE_SPLICE and left:
        pr, pw = os.pipe()
        try:
            while left:
                try:
                    n = os.splice(src, pw, min(left, _WINDOW))
                except BlockingIOError:
                    _wait(src, False, timeout)
                    continue
                except OSError:
                    break  # unsupported fd pair: finish copying below
                if n == 0:
                    raise ConnectionError(
                        f"splice: EOF with {left} of {count} bytes unread")
                _drain_pipe(pr, dst, n, timeout)
                left -= n
                if note is not None:
                    note(n)
        finally:
            os.close(pr)
            os.close(pw)
    while left:
        try:
            buf = os.read(src, min(left, 1 << 16))
        except BlockingIOError:
            _wait(src, False, timeout)
            continue
        if not buf:
            raise ConnectionError(
                f"copy: EOF with {left} of {count} bytes unread")
        _write_all(dst, buf, timeout)
        left -= len(buf)
        if note is not None:
            note(len(buf))
