"""LRC(10,2,2): locally repairable code with 5-read single-shard repair.

Port of seaweedfs_tpu/codecs/lrc.py.  Layout (14 shards, the same
shard-file count and extensions as RS(10,4)):

    shards 0-4   data, local group A
    shards 5-9   data, local group B
    shard  10    local parity of group A  (XOR of shards 0-4)
    shard  11    local parity of group B  (XOR of shards 5-9)
    shards 12-13 global parities          (Cauchy rows over all data)

A lost shard inside a group is the XOR of the 5 other group members: 5
reads instead of RS's 10.  A lost global parity re-encodes from the 10
data shards.  Any 3 simultaneous losses decode (same-group losses fall
back to the global parities, whose 2x10 Cauchy rows have every minor
nonsingular), and so does one loss per local group plus both globals;
patterns the code cannot express raise from the generic solver in
base.py.
"""

from __future__ import annotations

import numpy as np

from ..ops import gf256
from .base import Codec, LocalGroup, register_codec

GROUP_A = LocalGroup(data=(0, 1, 2, 3, 4), parity=10)
GROUP_B = LocalGroup(data=(5, 6, 7, 8, 9), parity=11)
GLOBALS = (12, 13)


def lrc_matrix(data_shards: int = 10,
               groups: tuple[LocalGroup, ...] = (GROUP_A, GROUP_B),
               global_rows: tuple[int, ...] = GLOBALS) -> np.ndarray:
    """Systematic LRC generator: identity, XOR local-parity rows, then
    Cauchy global rows m[r, c] = 1/(r ^ c) — r >= total-2 > c keeps
    r ^ c nonzero, and Cauchy minors are all nonsingular, which is what
    makes two same-group losses globally decodable."""
    total = data_shards + len(groups) + len(global_rows)
    m = np.zeros((total, data_shards), dtype=np.uint8)
    m[:data_shards] = gf256.mat_identity(data_shards)
    for g in groups:
        m[g.parity, list(g.data)] = 1
    for r in global_rows:
        for c in range(data_shards):
            m[r, c] = gf256.gf_inv(r ^ c)
    return m


LRC_10_2_2 = register_codec(Codec(
    "lrc", lrc_matrix(), data_shards=10,
    locality=(GROUP_A, GROUP_B), tolerance=3))
