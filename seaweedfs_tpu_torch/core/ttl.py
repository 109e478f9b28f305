"""2-byte TTL encoding (count, unit) — weed/storage/needle/volume_ttl.go."""

from __future__ import annotations

from dataclasses import dataclass

EMPTY = 0
MINUTE = 1
HOUR = 2
DAY = 3
WEEK = 4
MONTH = 5
YEAR = 6

_UNIT_FROM_CHAR = {"m": MINUTE, "h": HOUR, "d": DAY, "w": WEEK,
                   "M": MONTH, "y": YEAR}
_CHAR_FROM_UNIT = {v: k for k, v in _UNIT_FROM_CHAR.items()}

_UNIT_MINUTES = {EMPTY: 0, MINUTE: 1, HOUR: 60, DAY: 24 * 60,
                 WEEK: 7 * 24 * 60, MONTH: 31 * 24 * 60,
                 YEAR: 365 * 24 * 60}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = EMPTY

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """'3m', '4h', '5d', '6w', '7M', '8y'; bare digits mean minutes."""
        if not s:
            return EMPTY_TTL
        unit_ch = s[-1]
        if unit_ch.isdigit():
            count, unit = int(s), MINUTE
        else:
            if unit_ch not in _UNIT_FROM_CHAR:
                raise ValueError(f"unknown TTL unit {unit_ch!r}")
            count, unit = int(s[:-1]), _UNIT_FROM_CHAR[unit_ch]
        return cls(count=count, unit=unit)

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return EMPTY_TTL
        return cls(count=b[0], unit=b[1])

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def minutes(self) -> int:
        return self.count * _UNIT_MINUTES.get(self.unit, 0)

    def __str__(self) -> str:
        if self.count == 0 or self.unit == EMPTY:
            return ""
        return f"{self.count}{_CHAR_FROM_UNIT[self.unit]}"


EMPTY_TTL = TTL()
