"""GF(2^8) and the RS(k, m) generator matrix.

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) (0x11D) with
generator 2, the field of klauspost/reedsolomon.  Its systematic
matrix: the (k + m) x k Vandermonde matrix V[r][c] = r^c (0^0 = 1)
times the inverse of its top k x k square, so the top k rows are the
identity and the bottom m rows make the parity.  `cauchy_parity` is
ISA-L's gf_gen_cauchy1_matrix, another valid code: the benchmark's
control uses it as the guarantee it breaks."""

from __future__ import annotations

import numpy as np

POLY = 0x11D


def _tables() -> tuple[list[int], list[int]]:
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return EXP[LOG[a] + LOG[b]]


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return EXP[255 - LOG[a]]


def power(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return EXP[(LOG[a] * n) % 255]


def matmul(a: list[list[int]], b: list[list[int]]) -> list[list[int]]:
    out = []
    for row in a:
        acc = [0] * len(b[0])
        for x, brow in zip(row, b):
            if x:
                for j, y in enumerate(brow):
                    acc[j] ^= mul(x, y)
        out.append(acc)
    return out


def invert(m: list[list[int]]) -> list[list[int]]:
    """Gauss-Jordan inverse of a square matrix over GF(2^8)."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r][col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        a[col], a[piv] = a[piv], a[col]
        scale = inv(a[col][col])
        a[col] = [mul(scale, x) for x in a[col]]
        for r in range(n):
            f = a[r][col]
            if r != col and f:
                a[r] = [x ^ mul(f, y) for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def vandermonde_parity(k: int, m: int) -> np.ndarray:
    """The m x k parity rows of klauspost/reedsolomon's RS(k, m)."""
    vm = [[power(r, c) for c in range(k)] for r in range(k + m)]
    full = matmul(vm, invert(vm[:k]))
    return np.array(full[k:], dtype=np.uint8)


def cauchy_parity(k: int, m: int) -> np.ndarray:
    """ISA-L's Cauchy parity rows: 1 / (i ^ j) for i in k..k+m-1."""
    return np.array([[inv(i ^ j) for j in range(k)]
                     for i in range(k, k + m)], dtype=np.uint8)


def decode_rows(parity: np.ndarray, present: list[int],
                wanted: list[int]) -> tuple[np.ndarray, list[int]]:
    """The rows that rebuild `wanted` from the first k shards of
    `present`: (len(wanted) x k matrix, the k shard ids it reads)."""
    m, k = parity.shape
    gen = [[int(i == j) for j in range(k)] for i in range(k)] + \
        [list(map(int, row)) for row in parity]
    used = sorted(present)[:k]
    data_from_used = invert([gen[s] for s in used])
    rows = matmul([gen[w] for w in wanted], data_from_used)
    return np.array(rows, dtype=np.uint8), used
