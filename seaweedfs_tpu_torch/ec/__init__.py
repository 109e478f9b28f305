"""Erasure-coding pipeline: volume files <-> RS(10,4) shard files.

Layout compatible with the reference (weed/storage/erasure_coding):
`.ec00`-`.ec13` shard files (row-striped: 10x1GB large blocks then 10x1MB
small blocks), `.ecx` sorted needle index, `.ecj` deletion journal.
A key property the GPU path exploits: byte column p across the 14 shard
files is one RS codeword, so encode/rebuild are pure column-parallel GF
bit-matrix products regardless of the block layout — the layout only
matters for mapping needle offsets to shard positions (locate.py).
"""

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS
LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB
SMALL_BLOCK_SIZE = 1024 * 1024         # 1MB


def to_ext(shard_id: int) -> str:
    return f".ec{shard_id:02d}"
