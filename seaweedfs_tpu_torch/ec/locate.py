"""Map volume byte ranges to shard-file intervals.

Port of weed/storage/erasure_coding/ec_locate.go (semantics preserved
exactly, including the rows-count derivation that lets a shard file size
stand in for the dat size).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import DATA_SHARDS


@dataclass(frozen=True)
class Interval:
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int

    def to_shard_id_and_offset(self, large_block_size: int,
                               small_block_size: int) -> tuple[int, int]:
        offset = self.inner_block_offset
        row_index = self.block_index // DATA_SHARDS
        if self.is_large_block:
            offset += row_index * large_block_size
        else:
            offset += (self.large_block_rows_count * large_block_size +
                       row_index * small_block_size)
        return self.block_index % DATA_SHARDS, offset


def _locate_within_blocks(block_length: int, offset: int) -> tuple[int, int]:
    return offset // block_length, offset % block_length


def _locate_offset(large: int, small: int, dat_size: int,
                   offset: int) -> tuple[int, bool, int]:
    large_row_size = large * DATA_SHARDS
    n_large_rows = dat_size // large_row_size
    if offset < n_large_rows * large_row_size:
        idx, inner = _locate_within_blocks(large, offset)
        return idx, True, inner
    offset -= n_large_rows * large_row_size
    idx, inner = _locate_within_blocks(small, offset)
    return idx, False, inner


def locate_data(large: int, small: int, dat_size: int, offset: int,
                size: int) -> list[Interval]:
    """All shard intervals covering [offset, offset+size) of the volume."""
    block_index, is_large, inner = _locate_offset(large, small, dat_size,
                                                  offset)
    # Rows-count derivation per the reference: padding by a full small row
    # makes the count recoverable from a rounded-up dat size.
    n_large_rows = (dat_size + DATA_SHARDS * small) // (large * DATA_SHARDS)

    intervals: list[Interval] = []
    while size > 0:
        block_remaining = (large if is_large else small) - inner
        take = min(size, block_remaining)
        intervals.append(Interval(
            block_index=block_index, inner_block_offset=inner, size=take,
            is_large_block=is_large, large_block_rows_count=n_large_rows))
        size -= take
        if size <= 0:
            break
        block_index += 1
        if is_large and block_index == n_large_rows * DATA_SHARDS:
            is_large = False
            block_index = 0
        inner = 0
    return intervals
