"""TTL expiry decisions, with an injectable clock.

Every "is this expired?" question in the system routes through here so
they all agree: the needle read path (404 with an expiry reason),
vacuum's live filter (expired == dead, reclaim the bytes), the volume
server's sweeper (a fully-expired TTL volume is deleted whole, like
weed/topology's volume-ttl vacuum), and the master's layout steering
(stop assigning writes to a near-expiry volume so it can drain and
die).

The TTL wire codec's minimum unit is one minute (core/ttl.py), so
tests can't wait out a real expiry; `set_clock` lets them advance time
instead.  Production never calls it.
"""

from __future__ import annotations

import time

from ..core.ttl import TTL

_clock = time.time


def now() -> float:
    return _clock()


def set_clock(fn) -> None:
    """Test hook: replace the expiry wall clock (pass `time.time` or
    call `reset_clock` to restore)."""
    global _clock
    _clock = fn


def reset_clock() -> None:
    global _clock
    _clock = time.time


def needle_ttl_sec(needle, volume_ttl: TTL | None) -> int:
    """Effective TTL for one needle in seconds (0 = never expires).
    A per-needle TTL wins; otherwise the volume superblock's applies —
    SeaweedFS stamps the assign-time ?ttl on both."""
    if needle.has_ttl() and needle.ttl.minutes() > 0:
        return needle.ttl.minutes() * 60
    if volume_ttl is not None and volume_ttl.minutes() > 0:
        return volume_ttl.minutes() * 60
    return 0


def needle_expired(needle, volume_ttl: TTL | None = None,
                   at: float | None = None) -> bool:
    ttl_sec = needle_ttl_sec(needle, volume_ttl)
    if ttl_sec <= 0 or not needle.has_last_modified_date():
        return False
    if at is None:
        at = now()
    return at > needle.last_modified + ttl_sec


def volume_expired(ttl: TTL | None, modified_at: float,
                   grace: float = 0.0, at: float | None = None) -> bool:
    """A TTL volume whose NEWEST write is past expiry (plus grace) holds
    only dead needles and can be retired whole."""
    if ttl is None or ttl.minutes() <= 0 or modified_at <= 0:
        return False
    if at is None:
        at = now()
    return at > modified_at + ttl.minutes() * 60 + grace


def volume_near_expiry(ttl: TTL | None, modified_at: float,
                       fraction: float = 0.5,
                       at: float | None = None) -> bool:
    """Past `fraction` of the TTL since the newest write: the master
    stops steering new writes here so the volume drains toward whole-
    volume retirement instead of being kept alive forever."""
    if ttl is None or ttl.minutes() <= 0 or modified_at <= 0:
        return False
    if at is None:
        at = now()
    return at > modified_at + ttl.minutes() * 60 * fraction
