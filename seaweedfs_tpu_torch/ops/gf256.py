"""GF(2^8) arithmetic and matrix algebra for Reed-Solomon erasure coding.

This is the mathematical core of the erasure-coding pipeline.  The
reference (SeaweedFS) delegates this to github.com/klauspost/reedsolomon,
whose field is GF(2^8) with the reducing polynomial x^8+x^4+x^3+x^2+1
(0x11D) and whose systematic code matrix is built from an extended
Vandermonde matrix made systematic by right-multiplying with the inverse of
its top square (the Backblaze JavaReedSolomon construction).  We reproduce
that construction exactly so that shard bytes are bit-identical with the
reference's `.ec00`-`.ec13` outputs (reference call sites:
`weed/storage/erasure_coding/ec_encoder.go:198` `reedsolomon.New(10,4)`).

Everything here is tiny, setup-time work done in numpy on the host; the hot
path (the actual byte crunching) lives in `rs_bitmatrix.py` /
`coder_cuda.py`, which consume the matrices produced here.
"""

from __future__ import annotations

import functools

import numpy as np

# The reducing polynomial used by klauspost/reedsolomon (and Backblaze's
# JavaReedSolomon, and Intel ISA-L's default): x^8 + x^4 + x^3 + x^2 + 1.
GENERATING_POLYNOMIAL = 0x11D

FIELD_SIZE = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """Build exp/log tables for GF(2^8) with generator 2.

    exp table is doubled (510 entries) so mul can skip the mod-255.
    """
    exp = np.zeros(510, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GENERATING_POLYNOMIAL
    exp[255:510] = exp[0:255]
    log[0] = -1  # log(0) undefined; sentinel
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Multiply two field elements."""
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] - GF_LOG[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(GF_EXP[(255 - GF_LOG[a]) % 255])


def gf_exp(a: int, n: int) -> int:
    """a raised to the n'th power (klauspost `galExp` semantics: 0^0 == 1)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def _build_mul_table() -> np.ndarray:
    """Full 256x256 multiplication table (used by the numpy reference coder)."""
    t = np.zeros((256, 256), dtype=np.uint8)
    la = GF_LOG[1:256]
    idx = la[:, None] + la[None, :]
    t[1:, 1:] = GF_EXP[idx]
    t.setflags(write=False)
    return t


MUL_TABLE = _build_mul_table()


def mul_table() -> np.ndarray:
    return MUL_TABLE


# ---------------------------------------------------------------------------
# Matrix algebra over GF(2^8)
# ---------------------------------------------------------------------------


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8). a: (m,k) uint8, b: (k,n) uint8."""
    t = mul_table()
    # products[i,j,l] = a[i,l] * b[l,j] in GF; XOR-reduce over l.
    prods = t[a[:, None, :], b.T[None, :, :]]  # (m, n, k)
    return np.bitwise_xor.reduce(prods, axis=2).astype(np.uint8)


def mat_identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8). Raises ValueError if singular."""
    n = m.shape[0]
    if m.shape[0] != m.shape[1]:
        raise ValueError("matrix must be square")
    t = mul_table()
    work = np.concatenate([m.astype(np.uint8), mat_identity(n)], axis=1)
    for col in range(n):
        # Find pivot.
        pivot = -1
        for r in range(col, n):
            if work[r, col] != 0:
                pivot = r
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF(2^8)")
        if pivot != col:
            work[[col, pivot]] = work[[pivot, col]]
        # Scale pivot row to 1.
        inv = gf_inv(int(work[col, col]))
        work[col] = t[inv, work[col]]
        # Eliminate all other rows.
        for r in range(n):
            if r != col and work[r, col] != 0:
                factor = int(work[r, col])
                work[r] ^= t[factor, work[col]]
    return work[:, n:].copy()


# ---------------------------------------------------------------------------
# Code-matrix constructions
# ---------------------------------------------------------------------------


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """Extended Vandermonde matrix: vm[r, c] = r ** c in GF(2^8).

    This is the exact construction used by klauspost/reedsolomon
    (`vandermonde(totalShards, dataShards)`), which seaweedfs uses through
    `reedsolomon.New(10, 4)` (reference: ec_encoder.go:198).
    """
    vm = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            vm[r, c] = gf_exp(r, c)
    return vm


@functools.lru_cache(maxsize=None)
def build_systematic_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """klauspost `buildMatrix`: systematic (total x data) encode matrix.

    Top `data_shards` rows are the identity; the remaining rows generate the
    parity shards.  Byte-compatible with the reference's shard files.
    """
    if not (0 < data_shards < total_shards <= FIELD_SIZE):
        raise ValueError("invalid shard counts")
    vm = vandermonde(total_shards, data_shards)
    top_inv = mat_inv(vm[:data_shards])
    m = mat_mul(vm, top_inv)
    assert np.array_equal(m[:data_shards], mat_identity(data_shards))
    m.setflags(write=False)
    return m


@functools.lru_cache(maxsize=None)
def build_cauchy_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """klauspost `buildMatrixCauchy` (WithCauchyMatrix option).

    Identity on top; parity row r, col c = 1 / (r ^ c) where r ranges over
    [data_shards, total_shards).  Already systematic by construction.
    Provided for the parameterized RS(16,4)/RS(8,3) alt schemes in
    BASELINE.json; the default stays Vandermonde for reference parity.
    """
    if not (0 < data_shards < total_shards <= FIELD_SIZE):
        raise ValueError("invalid shard counts")
    m = np.zeros((total_shards, data_shards), dtype=np.uint8)
    m[:data_shards] = mat_identity(data_shards)
    for r in range(data_shards, total_shards):
        for c in range(data_shards):
            m[r, c] = gf_inv(r ^ c)
    m.setflags(write=False)
    return m


def parity_matrix(data_shards: int, total_shards: int,
                  kind: str = "vandermonde") -> np.ndarray:
    """The (parity x data) sub-matrix that maps data shards to parity shards."""
    if kind == "vandermonde":
        return build_systematic_matrix(data_shards, total_shards)[data_shards:]
    if kind == "cauchy":
        return build_cauchy_matrix(data_shards, total_shards)[data_shards:]
    raise ValueError(f"unknown matrix kind {kind!r}")


def decode_matrix(data_shards: int, total_shards: int,
                  present: list[int], wanted: list[int] | None = None,
                  kind: str = "vandermonde") -> tuple[np.ndarray, list[int]]:
    """Build the matrix that reconstructs shards from surviving shards.

    `present` is the sorted list of available shard ids (>= data_shards of
    them).  Returns (matrix, used) where `used` is the subset of `present`
    (exactly `data_shards` ids — the first data_shards available, matching
    klauspost's subshard selection in `Reconstruct`) and `matrix` maps the
    stacked `used` shards to the `wanted` shard contents (default: all
    missing shards).
    """
    if kind == "vandermonde":
        full = build_systematic_matrix(data_shards, total_shards)
    elif kind == "cauchy":
        full = build_cauchy_matrix(data_shards, total_shards)
    else:
        raise ValueError(f"unknown matrix kind {kind!r}")

    present = sorted(present)
    bad = [s for s in present if not 0 <= s < total_shards]
    if bad:
        raise ValueError(
            f"survivor shard ids {bad} out of range [0, {total_shards})")
    if len(set(present)) != len(present):
        raise ValueError(f"duplicate survivor shard ids in {present}")
    if len(present) < data_shards:
        raise ValueError(
            f"too few shards: have {len(present)}, need {data_shards}")
    used = present[:data_shards]
    sub = full[used]  # (data, data)
    sub_inv = mat_inv(sub)  # maps used-shard bytes -> original data bytes

    if wanted is None:
        wanted = [s for s in range(total_shards) if s not in set(present)]
    # shard w = full[w] @ data = full[w] @ sub_inv @ used_shards
    mat = mat_mul(full[list(wanted)], sub_inv)
    return mat, used
