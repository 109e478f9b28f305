"""Pluggable erasure codecs (see base.py for the design).

    from seaweedfs_tpu_torch import codecs
    codec = codecs.get_codec("lrc")
    codec.repair_plan(present=set(range(14)) - {3}, missing=[3])
    # -> [RepairRead(sid=3, reads=(0, 1, 2, 4, 10), local=True)]
"""

from .base import (DEFAULT_CODEC, Codec, LocalGroup, RepairRead,
                   codec_from_reference, codec_names, get_codec,
                   register_codec, rs_codec, solve_decode)
from .lrc import LRC_10_2_2  # noqa: F401 — import registers "lrc"

__all__ = [
    "DEFAULT_CODEC", "Codec", "LocalGroup", "RepairRead",
    "codec_from_reference", "codec_names", "get_codec", "register_codec",
    "rs_codec", "solve_decode", "LRC_10_2_2",
]
