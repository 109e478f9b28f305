"""Distributed tracing subsystem (see tracer.py for the design).

Public surface:

- `span(name, **attrs)`: context-managed child span of the active one.
- `current_traceparent()`: header value outbound clients inject.
- `setup_server_tracing(server, service)`: middleware + /debug/traces.
- `BUFFER`: the process-global bounded trace ring.
"""

from .tracer import (BUFFER, NOOP, Span, TraceBuffer,  # noqa: F401
                     begin_server_span, current_span,
                     current_traceparent, enabled, end_server_span,
                     parse_traceparent, recording_on, root_span,
                     sample_rate, slow_threshold_seconds, span)
from .routes import (setup_server_tracing,  # noqa: F401
                     traces_route_enabled)
