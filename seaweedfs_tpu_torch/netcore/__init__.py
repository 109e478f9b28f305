"""netcore — the event-loop network core behind `-transport=aio`.

A selectors-based readiness loop owns every accepted socket while it
is idle or mid-header (netpoll in the Go reference; one goroutine per
conn there, one *registered fd* per conn here).  Complete requests are
handed to a small bounded worker pool where the existing synchronous
`JsonHttpServer._serve_one` runs unchanged — admission lanes, tracing,
phase ledgers, SLO observation and response framing are byte-identical
across transports because both transports execute the same code on a
socket + buffered reader.

Pieces:

- `registry`  — per-connection state shared by BOTH transports
  (`/debug/conns`, the `SeaweedFS_open_connections` gauge).
- `bufio`     — `SockReader`, a buffered reader over (prefix bytes +
  blocking socket) with `makefile("rb")`-compatible semantics.
- `loop`      — `EventLoopTransport`, the accept/read/dispatch loop.
- `splice`    — zero-copy fd→fd byte movement (os.splice with a
  read/sendall fallback) for the filer→volume proxy leg.
"""

from .registry import ConnInfo, ConnRegistry, CountedConn  # noqa: F401
from .bufio import SockReader  # noqa: F401

__all__ = ["ConnInfo", "ConnRegistry", "CountedConn", "SockReader"]
