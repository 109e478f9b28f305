"""EC decode: shard files -> `.dat` (the ec.decode reverse path).

Port of weed/storage/erasure_coding/ec_decoder.go: the volume version,
the `.dat` size from the `.ecx`, and the interleaved copy back.
"""

from __future__ import annotations

from . import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext
from ..core import idx as idx_mod
from ..core import types as t
from ..core.needle import get_actual_size
from ..core.super_block import SuperBlock


def read_ec_volume_version(base_file_name: str) -> int:
    """Volume version from the superblock at the head of .ec00."""
    with open(base_file_name + to_ext(0), "rb") as f:
        return SuperBlock.from_bytes(f.read(64 * 1024)).version


def find_dat_file_size(base_file_name: str) -> int:
    """Max (offset + record size) over live .ecx entries (FindDatFileSize)."""
    version = read_ec_volume_version(base_file_name)
    dat_size = 0
    with open(base_file_name + ".ecx", "rb") as f:
        for e in idx_mod.iter_index(f):
            if t.size_is_deleted(e.size):
                continue
            stop = e.offset + get_actual_size(e.size, version)
            dat_size = max(dat_size, stop)
    return dat_size


def write_dat_file(base_file_name: str, dat_file_size: int,
                   large_block_size: int = LARGE_BLOCK_SIZE,
                   small_block_size: int = SMALL_BLOCK_SIZE) -> None:
    """Interleave-copy .ec00-.ec09 back into a .dat of the given size."""
    ins = [open(base_file_name + to_ext(i), "rb")
           for i in range(DATA_SHARDS)]
    try:
        with open(base_file_name + ".dat", "wb") as out:
            remaining = dat_file_size
            while remaining >= DATA_SHARDS * large_block_size:
                for f in ins:
                    buf = f.read(large_block_size)
                    if len(buf) != large_block_size:
                        raise ValueError("short large-block read")
                    out.write(buf)
                    remaining -= large_block_size
            while remaining > 0:
                for f in ins:
                    to_read = min(remaining, small_block_size)
                    if to_read <= 0:
                        break
                    buf = f.read(to_read)
                    if len(buf) != to_read:
                        raise ValueError("short small-block read")
                    out.write(buf)
                    remaining -= to_read
    finally:
        for f in ins:
            f.close()
