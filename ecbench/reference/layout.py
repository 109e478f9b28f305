"""The Go encoder's layout of a volume into shards
(weed/storage/erasure_coding/ec_encoder.go, encodeDatFile): the `.dat`
is cut into rows of k blocks, large rows (k x large bytes) while MORE
than one full large row remains, then small rows (k x small) to its end,
the last one zero-padded.  Shard i holds block i of every row, in row
order, so its size is large_rows x large + small_rows x small."""

from __future__ import annotations

import numpy as np


def rows(dat_size: int, k: int, large: int, small: int) -> tuple[int, int]:
    large_rows, rest = 0, dat_size
    while rest > k * large:
        large_rows += 1
        rest -= k * large
    return large_rows, -(-rest // (k * small))


def shard_size(dat_size: int, k: int, large: int, small: int) -> int:
    large_rows, small_rows = rows(dat_size, k, large, small)
    return large_rows * large + small_rows * small


def dat_offset(shard: int, offset: int, dat_size: int, k: int, large: int,
               small: int) -> int:
    """Where byte `offset` of data shard `shard` lies in the `.dat`."""
    large_rows, _ = rows(dat_size, k, large, small)
    if offset < large_rows * large:
        row, within = divmod(offset, large)
        return row * k * large + shard * large + within
    row, within = divmod(offset - large_rows * large, small)
    return large_rows * k * large + row * k * small + shard * small + within


def data_rows(read_at, dat_size: int, k: int, large: int, small: int,
              lo: int, hi: int) -> np.ndarray:
    """Bytes [lo, hi) of the k data shards, `lo` and `hi` multiples of
    `small`; read_at(offset, size) reads the `.dat`."""
    out = np.zeros((k, hi - lo), dtype=np.uint8)
    for shard in range(k):
        for at in range(lo, hi, small):
            src = dat_offset(shard, at, dat_size, k, large, small)
            take = max(0, min(small, dat_size - src))
            if take:
                out[shard, at - lo:at - lo + take] = np.frombuffer(
                    read_at(src, take), dtype=np.uint8)
    return out
