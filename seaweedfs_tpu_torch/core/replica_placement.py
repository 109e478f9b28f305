"""Replica placement: 'XYZ' digit string / single byte —
weed/storage/super_block/replica_placement.go."""

from __future__ import annotations

from dataclasses import dataclass

_PARSE_CACHE: dict = {}


@dataclass(frozen=True)
class ReplicaPlacement:
    diff_data_center_count: int = 0
    diff_rack_count: int = 0
    same_rack_count: int = 0

    @classmethod
    def parse(cls, t: str) -> "ReplicaPlacement":
        # Memoized: parse runs twice per /dir/assign on the master hot
        # path and the distinct placement strings are few ("000",
        # "001", ...).  The instance is frozen, so sharing is safe.
        hit = _PARSE_CACHE.get(t)
        if hit is not None:
            return hit
        vals = [0, 0, 0]
        for i, c in enumerate(t):
            count = ord(c) - ord("0")
            if not 0 <= count <= 2:
                raise ValueError(f"unknown replication type {t!r}")
            if i < 3:
                vals[i] = count
        rp = cls(diff_data_center_count=vals[0], diff_rack_count=vals[1],
                 same_rack_count=vals[2])
        if len(_PARSE_CACHE) < 1024:  # bounded (strings are attacker-
            _PARSE_CACHE[t] = rp      # influenced via the query param)
        return rp

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return (self.diff_data_center_count * 100 +
                self.diff_rack_count * 10 + self.same_rack_count)

    def copy_count(self) -> int:
        return (self.diff_data_center_count + self.diff_rack_count +
                self.same_rack_count + 1)

    def __str__(self) -> str:
        return (f"{self.diff_data_center_count}"
                f"{self.diff_rack_count}{self.same_rack_count}")
