"""Bit-sliced GF(2^8) -> GF(2) lowering of Reed-Solomon matrices.

GF(2^8) multiplication by a *constant* is linear over GF(2): for a fixed
coefficient c there is an 8x8 bit matrix M_c with bits(c*x) = M_c @
bits(x) (mod 2).  A whole RS code matrix C (r x k over GF(2^8)) therefore
lowers to a single (8r x 8k) 0/1 matrix B, and shard encoding becomes

    parity_bits = (B @ data_bits) mod 2

which the CUDA kernels of `coder_cuda.py` evaluate with AND and parity
on packed bytes.  This replaces klauspost/reedsolomon's AVX2 PSHUFB
galois kernels (used at `weed/storage/erasure_coding/ec_encoder.go`).

Bit conventions: bit j of a byte is (byte >> j) & 1 (LSB-first).  Row/col
index 8*s + j refers to bit j of shard s.
"""

from __future__ import annotations

import functools

import numpy as np

from . import gf256


def mul_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix of 'multiply by constant c' acting on LSB-first bits.

    Column j is bits(c * 2^j):  out_bit[i] = XOR_j in_bit[j] * M[i, j].
    """
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = gf256.gf_mul(c, 1 << j)
        for i in range(8):
            m[i, j] = (prod >> i) & 1
    return m


def expand_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """Lower an (r x k) GF(2^8) matrix to the (8r x 8k) GF(2) block matrix."""
    r, k = mat.shape
    out = np.zeros((8 * r, 8 * k), dtype=np.uint8)
    for i in range(r):
        for j in range(k):
            c = int(mat[i, j])
            if c:
                out[8 * i:8 * i + 8, 8 * j:8 * j + 8] = mul_bitmatrix(c)
    return out


@functools.lru_cache(maxsize=None)
def parity_bitmatrix(data_shards: int, total_shards: int,
                     kind: str = "vandermonde") -> np.ndarray:
    """Bit-lowered parity matrix: (8*parity, 8*data) uint8 0/1."""
    pm = gf256.parity_matrix(data_shards, total_shards, kind)
    b = expand_bitmatrix(pm)
    b.setflags(write=False)
    return b


@functools.lru_cache(maxsize=256)
def decode_bitmatrix(data_shards: int, total_shards: int,
                     present: tuple[int, ...], wanted: tuple[int, ...] | None = None,
                     kind: str = "vandermonde") -> tuple[np.ndarray, tuple[int, ...]]:
    """Bit-lowered reconstruction matrix for a given survivor set.

    Returns (B, used): B is (8*len(wanted), 8*data_shards) and maps the bits
    of the `used` survivor shards (first data_shards of `present`, stacked in
    order) to the bits of the `wanted` shards.
    """
    mat, used = gf256.decode_matrix(
        data_shards, total_shards, list(present),
        wanted=list(wanted) if wanted is not None else None, kind=kind)
    b = expand_bitmatrix(mat)
    b.setflags(write=False)  # cached: must not be mutated by callers
    return b, tuple(used)
