"""Leveled glog-style logging (reference: weed/glog/, a vendored glog fork).

The reference logs with `glog.V(n).Infof(...)` verbosity gates plus
Info/Warning/Error/Fatal severities, `-v` controlling the verbosity
threshold.  This is the same surface on Python's stdlib logging:

    from seaweedfs_tpu_torch.utils import glog
    glog.setup(verbosity=2)
    glog.v(1).infof("volume %d loaded", vid)
    glog.infof("serving on %s", addr)
    glog.errorf("read %s: %s", fid, err)

Format mirrors glog's header: `I0729 14:03:02.123456 file.py:87] msg`.
"""

from __future__ import annotations

import io
import logging
import os
import sys
import threading
import time
import traceback

_LEVEL_CHARS = {logging.DEBUG: "D", logging.INFO: "I",
                logging.WARNING: "W", logging.ERROR: "E",
                logging.CRITICAL: "F"}

_logger = logging.getLogger("seaweedfs_tpu_torch")
_verbosity = 0
_setup_done = False
_lock = threading.Lock()


class _GlogFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        c = _LEVEL_CHARS.get(record.levelno, "I")
        t = time.localtime(record.created)
        us = int((record.created % 1) * 1e6)
        head = (f"{c}{t.tm_mon:02d}{t.tm_mday:02d} "
                f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}.{us:06d} "
                f"{os.path.basename(record.pathname)}:{record.lineno}]")
        msg = record.getMessage()
        if record.exc_info:
            buf = io.StringIO()
            traceback.print_exception(*record.exc_info, file=buf)
            msg += "\n" + buf.getvalue().rstrip()
        return f"{head} {msg}"


class _StderrHandler(logging.StreamHandler):
    """Resolves sys.stderr at emit time (it is swapped under pytest
    capture and by daemonizers)."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


def setup(verbosity: int | None = None, log_file: str | None = None) -> None:
    """Install handlers. Idempotent; env WEED_V overrides verbosity."""
    global _verbosity, _setup_done
    with _lock:
        if verbosity is None:
            verbosity = int(os.environ.get("WEED_V", "0"))
        _verbosity = verbosity
        if _setup_done:
            return
        _setup_done = True
        handler = _StderrHandler()
        handler.setFormatter(_GlogFormatter())
        _logger.addHandler(handler)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(_GlogFormatter())
            _logger.addHandler(fh)
        _logger.setLevel(logging.DEBUG)
        _logger.propagate = False


def _emit(level: int, fmt: str, *args) -> None:
    if not _setup_done:
        setup()
    # stacklevel=3: caller -> infof/_emit -> here
    _logger.log(level, fmt, *args, stacklevel=3)


def infof(fmt: str, *args) -> None:
    _emit(logging.INFO, fmt, *args)


def warningf(fmt: str, *args) -> None:
    _emit(logging.WARNING, fmt, *args)


def errorf(fmt: str, *args) -> None:
    _emit(logging.ERROR, fmt, *args)


def fatalf(fmt: str, *args) -> None:
    _emit(logging.CRITICAL, fmt, *args)
    raise SystemExit(1)


class _V:
    """glog.V(n) gate: logs only when n <= the configured verbosity."""

    __slots__ = ("on",)

    def __init__(self, on: bool):
        self.on = on

    def infof(self, fmt: str, *args) -> None:
        if self.on:
            _emit(logging.DEBUG, fmt, *args)


def v(level: int) -> _V:
    return _V(level <= _verbosity)
