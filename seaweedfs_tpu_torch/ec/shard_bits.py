"""ShardBits: bitmask of shard ids held per (server, volume).

Port of weed/storage/erasure_coding/ec_volume_info.go:61-113.
"""

from __future__ import annotations

from . import DATA_SHARDS, TOTAL_SHARDS


class ShardBits(int):
    def add_shard_id(self, sid: int) -> "ShardBits":
        return ShardBits(self | (1 << sid))

    def remove_shard_id(self, sid: int) -> "ShardBits":
        return ShardBits(self & ~(1 << sid))

    def has_shard_id(self, sid: int) -> bool:
        return bool(self & (1 << sid))

    def shard_ids(self, total_shards: int = TOTAL_SHARDS) -> list[int]:
        """Held shard ids; `total_shards` bounds the scan for codecs
        whose shard count differs from RS(10,4)'s 14."""
        return [sid for sid in range(max(total_shards, self.bit_length()))
                if self.has_shard_id(sid)]

    def shard_id_count(self) -> int:
        return bin(self).count("1")

    def plus(self, other: "ShardBits | int") -> "ShardBits":
        return ShardBits(self | other)

    def minus(self, other: "ShardBits | int") -> "ShardBits":
        return ShardBits(self & ~other)

    def minus_parity_shards(self) -> "ShardBits":
        out = self
        for sid in range(DATA_SHARDS, TOTAL_SHARDS):
            out = out.remove_shard_id(sid)
        return out
