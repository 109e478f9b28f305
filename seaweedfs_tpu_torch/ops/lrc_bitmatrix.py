"""Bit-sliced GF(2) lowering of the LRC(10,2,2) matrices.

Port of seaweedfs_tpu/ops/lrc_bitmatrix.py.  Sibling of
`rs_bitmatrix.py` for the `lrc` codec: the same LSB-first 8x expansion
applied to the LRC generator, so the local-parity XOR rows, the Cauchy
global rows and every decode matrix go through the same bit-matrix
kernels (`ops/coder_cuda.py`) — only the matrix argument changes.  The
generic construction lives on `codecs.Codec`; this module keeps the
per-scheme entry points.
"""

from __future__ import annotations

import numpy as np


def _codec():
    from ..codecs import get_codec
    return get_codec("lrc")


def parity_bitmatrix() -> np.ndarray:
    """(8*4, 8*10) GF(2) parity matrix of LRC(10,2,2): two XOR
    local-parity row blocks (identity 8x8 blocks) and two Cauchy global
    row blocks."""
    return _codec().parity_bitmatrix()


def decode_bitmatrix(present: tuple[int, ...], wanted: tuple[int, ...],
                     prefer: tuple[int, ...] = ()
                     ) -> tuple[np.ndarray, tuple[int, ...]]:
    """(8*len(wanted), 8*len(used)) reconstruction matrix and the minimal
    `used` read set (5 survivors for an in-group loss, not 10)."""
    return _codec().decode_bitmatrix(tuple(present), tuple(wanted),
                                     tuple(prefer))
