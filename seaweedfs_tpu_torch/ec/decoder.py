"""EC decode: shard files -> `.dat` + `.idx` (the ec.decode reverse path).

Port of weed/storage/erasure_coding/ec_decoder.go: the volume version,
the `.dat` size from the `.ecx`, the interleaved copy back, and the
`.idx` from the `.ecx` plus the `.ecj` deletion journal.
"""

from __future__ import annotations

import os
import shutil
import time

from . import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext
from ..core import idx as idx_mod
from ..core import types as t
from ..core.needle import get_actual_size
from ..core.super_block import SuperBlock
from ..stats.metrics import observe_ec_stage
from ..trace import span as trace_span


def read_ec_volume_version(base_file_name: str) -> int:
    """Volume version from the superblock at the head of .ec00."""
    with open(base_file_name + to_ext(0), "rb") as f:
        return SuperBlock.from_bytes(f.read(64 * 1024)).version


def iterate_ecj_file(base_file_name: str):
    """Yield deleted needle ids from the `.ecj` journal."""
    path = base_file_name + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            buf = f.read(t.NEEDLE_ID_SIZE)
            if len(buf) != t.NEEDLE_ID_SIZE:
                return
            yield t.get_uint64(buf)


def write_idx_file_from_ec_index(base_file_name: str) -> None:
    """.ecx + .ecj -> .idx (WriteIdxFileFromEcIndex): copy then tombstones."""
    shutil.copyfile(base_file_name + ".ecx", base_file_name + ".idx")
    with open(base_file_name + ".idx", "ab") as out:
        for key in iterate_ecj_file(base_file_name):
            idx_mod.append_entry(out, key, 0, t.TOMBSTONE_FILE_SIZE)


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
    """Interleave-copy .ec00-.ec09 back into a .dat of the given size,
    timed into the EC stage histogram as `dat_rebuild` and spanned on a
    trace as `ec.dat_rebuild`."""
    t0 = time.perf_counter()
    with trace_span("ec.dat_rebuild", bytes=dat_file_size):
        _write_dat_file(base_file_name, dat_file_size,
                        large_block_size, small_block_size)
    observe_ec_stage("dat_rebuild", time.perf_counter() - t0,
                     dat_file_size)


def _write_dat_file(base_file_name: str, dat_file_size: int,
                    large_block_size: int,
                    small_block_size: int) -> None:
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
