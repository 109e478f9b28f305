"""Replica placement: 'XYZ' digit string / single byte —
weed/storage/super_block/replica_placement.go."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ReplicaPlacement:
    diff_data_center_count: int = 0
    diff_rack_count: int = 0
    same_rack_count: int = 0

    @classmethod
    def parse(cls, t: str) -> "ReplicaPlacement":
        vals = [0, 0, 0]
        for i, c in enumerate(t):
            count = ord(c) - ord("0")
            if not 0 <= count <= 2:
                raise ValueError(f"unknown replication type {t!r}")
            if i < 3:
                vals[i] = count
        return cls(diff_data_center_count=vals[0], diff_rack_count=vals[1],
                   same_rack_count=vals[2])

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
