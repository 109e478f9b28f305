"""Pluggable erasure codecs (see base.py for the design).

    from seaweedfs_tpu_torch import codecs
    codec = codecs.get_codec("rs")
    codec.repair_plan(present=set(range(14)) - {3}, missing=[3])
"""

from .base import (DEFAULT_CODEC, Codec, LocalGroup, RepairRead,
                   codec_from_reference, codec_names, get_codec,
                   register_codec, rs_codec, solve_decode)

__all__ = [
    "DEFAULT_CODEC", "Codec", "LocalGroup", "RepairRead",
    "codec_from_reference", "codec_names", "get_codec", "register_codec",
    "rs_codec", "solve_decode",
]
