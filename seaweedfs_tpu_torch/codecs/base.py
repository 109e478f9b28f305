"""Codec-as-data: an erasure codec is a generator matrix, not code.

Every codec is a *value* — a name, shard counts, locality groups, and a
systematic (total x data) generator matrix over GF(2^8) — and every
byte-crunching backend (the numpy oracle, the CUDA kernels of
`ops/coder_cuda.py`) consumes that value through the same GF(2)
bit-matmul primitive, which takes the matrix as an argument.  Adding a
codec therefore never touches a kernel.

Two codecs are registered:

- `rs`  — RS(10,4), whose matrices come from the klauspost Vandermonde
  construction (`ops/gf256.py`), so shard bytes stay bit-identical with
  SeaweedFS's `.ec00`-`.ec13`;
- `lrc` — LRC(10,2,2) (codecs/lrc.py): two local groups of 5 data
  shards with one XOR local parity each, and two global Cauchy
  parities; a single-shard repair reads 5 shards instead of 10.

Decoding is a generic GF(2^8) solve: express each wanted shard's
generator row as a combination of survivor rows (Gaussian elimination
with a caller-supplied read-preference order), so the SAME solver
serves RS's any-k-of-n decode, LRC's 5-read local repair and LRC's
global fallback — the read set falls out of the algebra.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np

from ..ops import gf256

DEFAULT_CODEC = "rs"

# Per-codec decode/bit-matrix cache bound (mirrors the coder-level
# lru_cache(maxsize=256)): keys are (present, wanted, prefer) tuples,
# and on a long-degraded cluster the partial-survivor key space would
# otherwise grow without limit on these process-global singletons.
# Matrices are cheap to re-derive, so overflow just clears.
_CACHE_CAP = 1024


@dataclass(frozen=True)
class LocalGroup:
    """One locality group: the data shards it spans plus its dedicated
    local parity shard (the XOR of the members)."""

    data: tuple[int, ...]
    parity: int

    @property
    def members(self) -> tuple[int, ...]:
        return self.data + (self.parity,)


@dataclass(frozen=True)
class RepairRead:
    """The planned read set for rebuilding one missing shard."""

    sid: int
    reads: tuple[int, ...]
    local: bool  # True when the reads stay inside one locality group


class Codec:
    """An erasure codec as data.

    matrix: (total x data) systematic generator over GF(2^8) — top
    `data_shards` rows are the identity.  `locality` lists the local
    groups (empty for plain MDS codes like RS).  `tolerance` is the
    number of simultaneous shard losses the codec ALWAYS survives
    (some patterns beyond it may still decode — e.g. LRC(10,2,2)
    survives one loss per local group plus both globals = 4).
    """

    def __init__(self, name: str, matrix: np.ndarray, data_shards: int,
                 locality: tuple[LocalGroup, ...] = (),
                 tolerance: int | None = None,
                 matrix_kind: str = "vandermonde"):
        total = matrix.shape[0]
        if matrix.shape[1] != data_shards or total <= data_shards:
            raise ValueError(
                f"codec {name!r}: generator must be (total x {data_shards}) "
                f"with total > data, got {matrix.shape}")
        if not np.array_equal(matrix[:data_shards],
                              gf256.mat_identity(data_shards)):
            raise ValueError(f"codec {name!r}: generator not systematic")
        self.name = name
        self.data_shards = data_shards
        self.total_shards = total
        self.parity_shards = total - data_shards
        self.locality = locality
        self.matrix_kind = matrix_kind
        self.tolerance = (total - data_shards if tolerance is None
                          else tolerance)
        m = np.ascontiguousarray(matrix, dtype=np.uint8)
        m.setflags(write=False)
        self.matrix = m
        self._group_of: dict[int, LocalGroup] = {}
        for g in locality:
            for sid in g.members:
                self._group_of[sid] = g
        self._decode_cache: dict[tuple, tuple] = {}
        self._bit_cache: dict[tuple, tuple] = {}
        self._cache_lock = threading.Lock()

    # RS codecs keep the exact klauspost decode path (identical `used`
    # selection, identical error strings) — the generic solver is for
    # codecs whose minimal read set is NOT "any data_shards survivors".
    @property
    def is_rs(self) -> bool:
        return not self.locality

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"Codec({self.name!r}, k={self.data_shards}, "
                f"m={self.parity_shards}, groups={len(self.locality)})")

    # -- structure ----------------------------------------------------------

    def local_group(self, sid: int) -> LocalGroup | None:
        return self._group_of.get(sid)

    def shard_ids(self) -> list[int]:
        return list(range(self.total_shards))

    def min_repair_reads(self, sid: int) -> int:
        """Shards a single-shard repair reads when everything else
        survives — the headline repair-bandwidth number."""
        g = self._group_of.get(sid)
        if g is not None:
            return len(g.members) - 1
        return self.data_shards

    # -- matrices -----------------------------------------------------------

    def parity_matrix(self) -> np.ndarray:
        """(parity x data) rows that map data shards to parity shards."""
        return self.matrix[self.data_shards:]

    def parity_bitmatrix(self) -> np.ndarray:
        """GF(2)-lowered (8*parity x 8*data) parity matrix."""
        from ..ops import rs_bitmatrix
        if self.is_rs:
            return rs_bitmatrix.parity_bitmatrix(
                self.data_shards, self.total_shards, self.matrix_kind)
        key = ("parity",)
        with self._cache_lock:
            hit = self._bit_cache.get(key)
        if hit is None:
            b = rs_bitmatrix.expand_bitmatrix(self.parity_matrix())
            b.setflags(write=False)
            with self._cache_lock:
                hit = self._bit_cache.setdefault(key, b)
        return hit  # the parity key is a singleton; no bound needed

    def decode_matrix(self, present: tuple[int, ...],
                      wanted: tuple[int, ...],
                      prefer: tuple[int, ...] = ()
                      ) -> tuple[np.ndarray, tuple[int, ...]]:
        """GF(2^8) matrix rebuilding `wanted` shards from survivors.

        Returns (mat, used): `used` is the minimal read set the solve
        settled on (survivors in `prefer`-first order are tried as
        pivots first), mat is (len(wanted) x len(used)) with
        wanted_shards = mat @ stacked(used shards).  Raises ValueError
        when the erasure pattern is undecodable.
        """
        present = tuple(sorted(set(present)))
        wanted = tuple(wanted)
        prefer = tuple(prefer)
        if self.is_rs:
            mat, used = gf256.decode_matrix(
                self.data_shards, self.total_shards, list(present),
                wanted=list(wanted), kind=self.matrix_kind)
            return mat, tuple(used)
        key = (present, wanted, prefer)
        with self._cache_lock:
            hit = self._decode_cache.get(key)
        if hit is None:
            bad = [s for s in present + wanted
                   if not 0 <= s < self.total_shards]
            if bad:
                raise ValueError(
                    f"shard ids {bad} out of range [0, {self.total_shards})")
            mat, used = solve_decode(self.matrix, present, wanted, prefer)
            mat.setflags(write=False)
            with self._cache_lock:
                if len(self._decode_cache) >= _CACHE_CAP:
                    self._decode_cache.clear()
                hit = self._decode_cache.setdefault(key, (mat, used))
        return hit

    def decode_bitmatrix(self, present: tuple[int, ...],
                         wanted: tuple[int, ...],
                         prefer: tuple[int, ...] = ()
                         ) -> tuple[np.ndarray, tuple[int, ...]]:
        """GF(2)-lowered decode matrix: (8*wanted x 8*used), used."""
        from ..ops import rs_bitmatrix
        if self.is_rs:
            return rs_bitmatrix.decode_bitmatrix(
                self.data_shards, self.total_shards, tuple(present),
                tuple(wanted), self.matrix_kind)
        key = (tuple(sorted(set(present))), tuple(wanted), tuple(prefer))
        with self._cache_lock:
            hit = self._bit_cache.get(key)
        if hit is None:
            mat, used = self.decode_matrix(*key)
            b = rs_bitmatrix.expand_bitmatrix(mat)
            b.setflags(write=False)
            with self._cache_lock:
                if len(self._bit_cache) >= _CACHE_CAP:
                    self._bit_cache.clear()
                hit = self._bit_cache.setdefault(key, (b, used))
        return hit

    # -- repair planning ----------------------------------------------------

    def repair_plan(self, present, missing) -> list[RepairRead]:
        """Per-missing-shard minimal read sets: local group first,
        global fallback — the repair-bandwidth-optimal plan the
        cluster rebuild and the degraded-read ladder both follow.
        Raises ValueError when any missing shard is undecodable."""
        present = tuple(sorted(set(present)))
        plans = []
        for sid in missing:
            g = self._group_of.get(sid)
            prefer = tuple(m for m in g.members if m != sid) if g else ()
            _mat, used = self.decode_matrix(present, (sid,), prefer)
            local = g is not None and set(used) <= set(g.members)
            plans.append(RepairRead(sid, used, local))
        return plans


def solve_decode(gen: np.ndarray, present: tuple[int, ...],
                 wanted: tuple[int, ...], prefer: tuple[int, ...] = ()
                 ) -> tuple[np.ndarray, tuple[int, ...]]:
    """Express each `wanted` generator row as a GF(2^8) combination of
    `present` rows (Gauss-Jordan on gen[present].T with survivor
    columns tried in prefer-first order).  The unique solution over
    the pivot columns IS the minimal-read decode: survivors the
    algebra doesn't need get zero coefficients and are dropped.
    """
    order = [s for s in prefer if s in present] + \
            [s for s in sorted(present) if s not in prefer]
    k = gen.shape[1]
    t = gf256.mul_table()
    a = gen[order].T.astype(np.uint8).copy()          # (k, survivors)
    b = gen[list(wanted)].T.astype(np.uint8).copy()   # (k, wanted)
    ncols = a.shape[1]
    pivots: list[int] = []
    row = 0
    for c in range(ncols):
        if row >= k:
            break
        pivot = -1
        for r in range(row, k):
            if a[r, c]:
                pivot = r
                break
        if pivot < 0:
            continue
        if pivot != row:
            a[[row, pivot]] = a[[pivot, row]]
            b[[row, pivot]] = b[[pivot, row]]
        inv = gf256.gf_inv(int(a[row, c]))
        a[row] = t[inv, a[row]]
        b[row] = t[inv, b[row]]
        for r in range(k):
            if r != row and a[r, c]:
                f = int(a[r, c])
                a[r] ^= t[f, a[row]]
                b[r] ^= t[f, b[row]]
        pivots.append(c)
        row += 1
    # Non-pivot rows are all-zero in `a`; a nonzero target there means
    # the wanted shard is outside the survivors' span: undecodable.
    for r in range(row, k):
        if b[r].any():
            unsolved = [w for i, w in enumerate(wanted) if b[r, i]]
            raise ValueError(
                f"shards {unsolved} unrecoverable from survivors "
                f"{sorted(present)}: erasure pattern exceeds the code")
    x = np.zeros((ncols, len(wanted)), dtype=np.uint8)
    for i, c in enumerate(pivots):
        x[c] = b[i]
    used_cols = [c for c in pivots if x[c].any()]
    used = tuple(order[c] for c in used_cols)
    mat = np.ascontiguousarray(x[used_cols].T)
    return mat, used


# -- registry ---------------------------------------------------------------

_REGISTRY: dict[str, Codec] = {}
_REGISTRY_LOCK = threading.Lock()


def register_codec(codec: Codec) -> Codec:
    with _REGISTRY_LOCK:
        _REGISTRY[codec.name] = codec
    return codec


def codec_names() -> list[str]:
    with _REGISTRY_LOCK:
        return sorted(_REGISTRY)


def get_codec(name: str | Codec | None) -> Codec:
    """Resolve a codec by name (None -> the default `rs`)."""
    if isinstance(name, Codec):
        return name
    if not name:
        name = DEFAULT_CODEC
    with _REGISTRY_LOCK:
        codec = _REGISTRY.get(name)
    if codec is None:
        raise ValueError(
            f"unknown erasure codec {name!r}; registered: {codec_names()}")
    return codec


@functools.lru_cache(maxsize=None)
def rs_codec(data_shards: int = 10, parity_shards: int = 4,
             matrix_kind: str = "vandermonde") -> Codec:
    """Ad-hoc RS codec for parameterized schemes (RS(16,4), RS(8,3));
    the registered `rs` is exactly rs_codec(10, 4, "vandermonde")."""
    total = data_shards + parity_shards
    if matrix_kind == "vandermonde":
        matrix = gf256.build_systematic_matrix(data_shards, total)
    elif matrix_kind == "cauchy":
        matrix = gf256.build_cauchy_matrix(data_shards, total)
    else:
        raise ValueError(f"unknown matrix kind {matrix_kind!r}")
    name = "rs" if (data_shards, parity_shards,
                    matrix_kind) == (10, 4, "vandermonde") \
        else f"rs{data_shards}_{parity_shards}_{matrix_kind}"
    return Codec(name, np.asarray(matrix), data_shards,
                 tolerance=parity_shards, matrix_kind=matrix_kind)


def codec_from_reference(name: str, matrix: np.ndarray, data_shards: int,
                         locality: tuple[LocalGroup, ...] = (),
                         tolerance: int | None = None,
                         matrix_kind: str = "vandermonde") -> Codec:
    """Build this package's Codec from a generator matrix handed over
    as numpy (e.g. `seaweedfs_tpu.codecs.get_codec(name).matrix`).

    For an RS codec (no locality) the parity bit-matrix is derived from
    this package's own `matrix_kind` construction, so the call checks
    that it equals the GF(2) lowering of the given matrix: a codec whose
    matrix this package would not rebuild identically is refused.
    """
    from ..ops import rs_bitmatrix
    codec = Codec(name, np.asarray(matrix, dtype=np.uint8), data_shards,
                  locality=locality, tolerance=tolerance,
                  matrix_kind=matrix_kind)
    want = rs_bitmatrix.expand_bitmatrix(codec.parity_matrix())
    if not np.array_equal(codec.parity_bitmatrix(), want):
        raise ValueError(
            f"codec {name!r}: the {matrix_kind} construction for "
            f"({data_shards}, {codec.total_shards}) does not reproduce "
            "the given generator matrix")
    return codec


register_codec(rs_codec())
