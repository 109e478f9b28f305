"""Consistent-hash ring for topic-partition -> broker placement.

Reference: weed/messaging/broker/consistent_distribution.go (buraksezer/
consistent with xxhash there; a from-scratch virtual-node ring here).
Adding/removing a broker moves only ~1/n of the partitions.
"""

from __future__ import annotations

import bisect
import hashlib

VNODES = 64


def _hash(key: str) -> int:
    return int.from_bytes(
        hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, members: list[str] | None = None):
        self._ring: list[tuple[int, str]] = []
        self._keys: list[int] = []
        for m in members or []:
            self.add(m)

    def add(self, member: str) -> None:
        for i in range(VNODES):
            h = _hash(f"{member}#{i}")
            idx = bisect.bisect(self._keys, h)
            self._keys.insert(idx, h)
            self._ring.insert(idx, (h, member))

    def remove(self, member: str) -> None:
        keep = [(h, m) for h, m in self._ring if m != member]
        self._ring = keep
        self._keys = [h for h, _ in keep]

    def members(self) -> list[str]:
        return sorted({m for _, m in self._ring})

    def locate(self, key: str) -> str | None:
        if not self._ring:
            return None
        h = _hash(key)
        idx = bisect.bisect(self._keys, h) % len(self._ring)
        return self._ring[idx][1]
