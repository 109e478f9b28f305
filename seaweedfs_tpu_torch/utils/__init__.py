"""Shared utilities: native-library loading, logging, profiling, locks."""

import os as _os


def env_float(name: str, default: float) -> float:
    """Float env-var knob with a safe fallback — the one parser behind
    the trace, resilience, and EC-rebuild tunables (an unset or
    malformed value must never crash a server at import).  Lives here,
    dependency-free: utils.config needs tomllib (3.11+), and knob
    readers must import on 3.10."""
    try:
        return float(_os.environ.get(name, "") or default)
    except ValueError:
        return default
