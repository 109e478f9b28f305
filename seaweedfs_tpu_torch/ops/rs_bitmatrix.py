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


# ---------------------------------------------------------------------------
# Host-side bit (un)packing helpers — numpy oracle for the bit-matrix form
# ---------------------------------------------------------------------------


def unpack_bits(shards: np.ndarray) -> np.ndarray:
    """(k, n) uint8 bytes -> (8k, n) uint8 bits, LSB-first per shard row."""
    k, n = shards.shape
    shifts = np.arange(8, dtype=np.uint8)
    bits = (shards[:, None, :] >> shifts[None, :, None]) & 1  # (k, 8, n)
    return bits.reshape(8 * k, n)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(8r, n) uint8 bits -> (r, n) uint8 bytes, LSB-first."""
    r8, n = bits.shape
    r = r8 // 8
    weights = (1 << np.arange(8, dtype=np.uint16))
    grouped = bits.reshape(r, 8, n).astype(np.uint16)
    return (grouped * weights[None, :, None]).sum(axis=1).astype(np.uint8)


def encode_bits_numpy(data: np.ndarray, data_shards: int, total_shards: int,
                      kind: str = "vandermonde") -> np.ndarray:
    """Bit-sliced encode in numpy (oracle for the bit-matrix formulation)."""
    b = parity_bitmatrix(data_shards, total_shards, kind)
    bits = unpack_bits(np.asarray(data, np.uint8))
    parity_bits = (b.astype(np.int32) @ bits.astype(np.int32)) & 1
    return pack_bits(parity_bits.astype(np.uint8))
