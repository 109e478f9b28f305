"""CRC32-C as GF(2) linear algebra — the math behind the fused-CRC kernel.

The `.ecc` sidecar (ec/integrity.py) wants one CRC32-C per 1MB block of
every shard file.  Computed on the CPU that is a second pass over bytes
the encode kernel already holds on the card.  This module turns the CRC
into the same kind of GF(2) product the RS parity already is, so the
encode kernel (`coder_cuda.apply_bitmatrix_crc`) emits block checksums
as a tiny second output per 4096-byte tile.

The algebra.  Write the table-driven register evolution of crc32c as
``step(x, m)`` (register x advanced over message m, WITHOUT the pre/post
inversions: ``step(x, m) = ~crc32c(m, ~x)``).  ``step`` is GF(2)-linear
in (x, m) jointly — CRC is polynomial remainder — so for a tile of T
bytes:

    step(0, tile) = sum_{c,s} bit_{s}(tile[c]) * S^(T-1-c)(E(2^s))

where S = advance-one-zero-byte (a 32x32 bit matrix) and E(v) =
step(0, [v]).  Three structural facts make this one contraction plus
O(32^2) fixups:

1. E(2^(s+1)) = Sh(E(2^s)) for the fixed invertible map Sh =
   multiply-by-x^-1 mod P (verified at table-build time), so ONE weight
   table W0 (contribution of bit 0 per column) serves all 8 bit planes:
   the plane-s partial is folded through Sh^s afterwards.
2. Sh commutes with S (both are multiplications in GF(2)[x]/P), so the
   plane fold can run AFTER the column contraction.
3. Tiles chain linearly: the register after a full `.ecc` block of
   `tpb` tiles is sum_j P^(tpb-1-j)(q_j) with P = S^T, so a per-tile
   position matrix (selected by tile index mod tpb) turns per-tile
   partials into XOR-able per-block contributions.

The actual crc32c of a block is then CONST(block) ^ packed_bits, where
CONST(block) = crc32c of `block` zero bytes (the affine part the
inversions introduce).

Everything here is probed numerically from ``core.crc.crc32c``, so the
tables are correct by construction against that implementation.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ..core.crc import CASTAGNOLI_POLY, crc32c
from ..ec import SMALL_BLOCK_SIZE

_MASK = 0xFFFFFFFF


def fused_crc_enabled(device=None) -> bool:
    """Whether `write_ec_files` takes the fused-CRC path.

    `SEAWEEDFS_TPU_EC_FUSED_CRC` overrides in either direction (`0` /
    `false` reverts to the CPU byte accumulators, anything else forces
    fused) — the same variable and semantics as seaweedfs_tpu, so one
    setting drives both packages.  Unset, fused CRC is on when the
    coder's `device` (a torch.device; None for a host-only coder) is a
    CUDA device, where the CRC contraction rides the encode kernel, and
    off on the CPU, where the plain version costs more than the native
    crc32c pass it replaces."""
    env = os.environ.get("SEAWEEDFS_TPU_EC_FUSED_CRC")
    if env is not None:
        return env not in ("0", "false")
    return getattr(device, "type", None) == "cuda"


# `.ecc` checksum granularity (ec/integrity.BLOCK re-derived here to
# avoid an import cycle; asserted equal in tests).
BLOCK = SMALL_BLOCK_SIZE

_ZERO1 = b"\x00"


def _step(x: int, m: bytes) -> int:
    """Raw register evolution: linear in (x, m), no pre/post inversion."""
    return _MASK ^ crc32c(m, _MASK ^ x)


def _bits32(v: int) -> np.ndarray:
    return np.array([(v >> o) & 1 for o in range(32)], dtype=np.uint8)


def _pack32(bits: np.ndarray) -> int:
    return int(sum(int(b) << o for o, b in enumerate(bits)))


def _mat_from_value_map(fn) -> np.ndarray:
    """32x32 bit matrix of a GF(2)-linear value map: column i = fn(2^i)."""
    m = np.zeros((32, 32), dtype=np.uint8)
    for i in range(32):
        m[:, i] = _bits32(fn(1 << i))
    return m


def _f_inv(y: int) -> int:
    """Inverse of the table recurrence f(r) = (r>>1) ^ (P if r&1) —
    multiply-by-x^-1 in the reflected register domain."""
    if (y >> 31) & 1:
        return (((y ^ CASTAGNOLI_POLY) << 1) | 1) & _MASK
    return (y << 1) & _MASK


def _matmul2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64) % 2).astype(np.uint8)


def _mat_pow(m: np.ndarray, e: int) -> np.ndarray:
    out = np.eye(32, dtype=np.uint8)
    base = m
    while e:
        if e & 1:
            out = _matmul2(out, base)
        base = _matmul2(base, base)
        e >>= 1
    return out


class CrcFoldTables:
    """All constants for one (tile_n, block) geometry.

    Attributes (numpy 0/1 uint8):
      w0      (tile_n, 32) — bit-0 column contribution weights
      planes  (8, 32, 32)  — A_s = Sh^s, plane-fold matrices
      planes_t (256, 32)   — A_s transposed, stacked 2D
      posmats (tpb, 32, 32) — P^(tpb-1-j), position-in-block shift
      posmats_t (tpb*32, 32) — transposed, stacked 2D
      block_const  uint32  — crc32c of `block` zero bytes
      tpb     int          — tiles per `.ecc` block
    """

    def __init__(self, tile_n: int, block: int = BLOCK):
        if block % tile_n != 0:
            raise ValueError(
                f"crc tile {tile_n} must divide the .ecc block {block}")
        self.tile_n = tile_n
        self.block = block
        self.tpb = block // tile_n

        e1 = _step(0, b"\x01")
        smat = _mat_from_value_map(lambda v: _step(v, _ZERO1))
        shmat = _mat_from_value_map(_f_inv)
        # Structural checks (cheap, and they pin the two identities the
        # whole construction rests on to the crc32c implementation).
        v = e1
        for s in range(7):
            nxt = _step(0, bytes([1 << (s + 1)]))
            got = _pack32(_matmul2(shmat, _bits32(v).reshape(32, 1))[:, 0])
            if got != nxt:
                raise AssertionError("crc_fold: Sh(E(2^s)) != E(2^(s+1))")
            v = nxt
        if not np.array_equal(_matmul2(smat, shmat), _matmul2(shmat, smat)):
            raise AssertionError("crc_fold: S and Sh do not commute")

        # W0: contribution of bit 0 of the byte at tile offset c, i.e.
        # S^(T-1-c)(E(1)).  Built by walking the value backwards from
        # the last column — tile_n cheap 1-byte crc updates.
        w0 = np.zeros((tile_n, 32), dtype=np.uint8)
        val = e1
        for c in range(tile_n - 1, -1, -1):
            w0[c] = _bits32(val)
            val = _step(val, _ZERO1)
        self.w0 = w0

        planes = np.zeros((8, 32, 32), dtype=np.uint8)
        planes[0] = np.eye(32, dtype=np.uint8)
        for s in range(1, 8):
            planes[s] = _matmul2(shmat, planes[s - 1])
        self.planes = planes
        self.planes_t = np.concatenate(
            [planes[s].T for s in range(8)], axis=0)

        p_tile = _mat_pow(smat, tile_n)  # advance one whole tile
        posmats = np.zeros((self.tpb, 32, 32), dtype=np.uint8)
        posmats[self.tpb - 1] = np.eye(32, dtype=np.uint8)
        for j in range(self.tpb - 2, -1, -1):
            posmats[j] = _matmul2(p_tile, posmats[j + 1])
        self.posmats = posmats
        self.posmats_t = np.concatenate(
            [posmats[j].T for j in range(self.tpb)], axis=0)

        self.block_const = crc32c(b"\x00" * block) & _MASK


def byte_table() -> np.ndarray:
    """(256,) uint32: entry b = E(b) = step(0, [b]), the reflected CRC32-C
    byte table.  One byte of a message advances the raw register as
    ``c = T[(c ^ b) & 0xff] ^ (c >> 8)`` (K2's CRC step)."""
    return np.array([_step(0, bytes([b])) for b in range(256)],
                    dtype=np.uint32)


def shift_table(m: int) -> np.ndarray:
    """(4, 256) uint32 byte-sliced table of Z^m, the raw register advanced
    over m zero bytes: Z^m(x) = XOR_s table[s, (x >> 8s) & 0xff].  It joins
    two runs by linearity: step(0, AB) = Z^len(B)(step(0, A)) ^ step(0, B)."""
    zeros = bytes(m)
    images = np.array([_step(1 << i, zeros) for i in range(32)],
                      dtype=np.uint32).reshape(4, 8)
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1      # (256, 8)
    picked = np.where(bits[None].astype(bool), images[:, None, :],
                      np.uint32(0))                             # (4, 256, 8)
    return np.bitwise_xor.reduce(picked, axis=2).astype(np.uint32)


_TABLE_CACHE: dict = {}
_TABLE_LOCK = threading.Lock()


def tables(tile_n: int, block: int = BLOCK) -> CrcFoldTables:
    """The process-wide CrcFoldTables for one geometry (built once:
    ~tile_n one-byte CRC updates)."""
    key = (tile_n, block)
    with _TABLE_LOCK:
        t = _TABLE_CACHE.get(key)
        if t is None:
            t = _TABLE_CACHE[key] = CrcFoldTables(tile_n, block)
        return t


# ---------------------------------------------------------------------------
# numpy tile partials — the oracle the kernel and its plain version are
# held against.
# ---------------------------------------------------------------------------

def tile_partials_np(rows: np.ndarray, tile_n: int,
                     block: int = BLOCK) -> np.ndarray:
    """(R, n) uint8 rows -> (R, n//tile_n) uint32 position-shifted tile
    partials.  n must be a multiple of tile_n and the rows must start
    block-aligned."""
    t = tables(tile_n, block)
    r, n = rows.shape
    if n % tile_n:
        raise ValueError(f"width {n} not a multiple of tile {tile_n}")
    nt = n // tile_n
    x = rows.astype(np.int64)
    # plane-major bits, tiled: (8, R, nt, T)
    bits = np.stack([(x >> s) & 1 for s in range(8)]) \
        .reshape(8, r, nt, tile_n)
    # column contraction with the shared bit-0 weights
    u = np.einsum("srtc,co->srto", bits, t.w0.astype(np.int64))
    # plane fold: sum_s A_s @ u_s   (mod 2 once at the end — exact ints)
    v = np.einsum("srto,sio->rti", u, t.planes.astype(np.int64)) & 1
    # position shift within the .ecc block
    pos = t.posmats.astype(np.int64)
    nt_idx = np.arange(nt) % t.tpb
    shifted = np.einsum("rti,tio->rto", v, pos[nt_idx].transpose(0, 2, 1)
                        .astype(np.int64)) & 1
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return (shifted.astype(np.uint64) * weights).sum(axis=2) \
        .astype(np.uint32)


def block_crcs_from_partials(partials: np.ndarray, width: int,
                             tile_n: int, block: int = BLOCK) -> list[int]:
    """Fold position-shifted tile partials of ONE row into actual
    crc32c values, one per full `.ecc` block.  `width` is the true byte
    width (must be a multiple of `block`); partials beyond it (zero
    padding) are ignored."""
    t = tables(tile_n, block)
    if width % block:
        raise ValueError(f"width {width} not a multiple of block {block}")
    nb = width // block
    use = np.asarray(partials[: nb * t.tpb], dtype=np.uint32) \
        .reshape(nb, t.tpb)
    lin = np.bitwise_xor.reduce(use, axis=1)
    return [int(v) ^ t.block_const for v in lin]


def block_crcs_from_partials_batched(partials: np.ndarray, width: int,
                                     tile_n: int, block: int = BLOCK
                                     ) -> np.ndarray:
    """block_crcs_from_partials over every leading index at once:
    (..., tiles) position-shifted tile partials -> (..., width // block)
    uint32 crc32c values, row by row what the single-row fold gives.
    The batched encode and rebuild steps fold K2's partials of (V, rows)
    with it; partials past `width` (a multiple of `block`) are ignored."""
    t = tables(tile_n, block)
    if width % block:
        raise ValueError(f"width {width} not a multiple of block {block}")
    nb = width // block
    p = np.asarray(partials)
    p = p.view(np.uint32) if p.dtype == np.int32 \
        else p.astype(np.uint32, copy=False)
    use = p[..., : nb * t.tpb].reshape(*p.shape[:-1], nb, t.tpb)
    return np.bitwise_xor.reduce(use, axis=-1) ^ np.uint32(t.block_const)


# ---------------------------------------------------------------------------
# Host-side streaming combiner — consumes kernel tile partials chunk by
# chunk (plus optional ragged byte tails) and emits the same list of
# per-block CRCs BlockCrcAccumulator would have produced.
# ---------------------------------------------------------------------------

class FusedCrcAccumulator:
    """Per-shard-row `.ecc` accumulator fed from kernel outputs.

    ``feed_tiles(partials, width)`` consumes position-shifted tile
    partials covering `width` bytes (width % block == 0, and the stream
    must be block-aligned — i.e. no byte tail pending).
    ``feed_bytes(buf)`` is the CPU path for ragged chunks/tails; both
    may be mixed as long as tile feeds land on block boundaries.
    ``finalize()`` matches BlockCrcAccumulator.finalize() bit for bit.
    """

    def __init__(self, tile_n: int, block: int = BLOCK):
        self.tile_n = tile_n
        self.block = block
        self._crcs: list[int] = []
        self._cur = 0
        self._fill = 0

    def feed_tiles(self, partials, width: int) -> None:
        if self._fill:
            raise ValueError(
                "feed_tiles on a non-block-aligned stream "
                f"(pending tail of {self._fill} bytes)")
        self._crcs.extend(block_crcs_from_partials(
            partials, width, self.tile_n, self.block))

    def feed_bytes(self, buf) -> None:
        mv = memoryview(buf)
        while len(mv):
            take = min(self.block - self._fill, len(mv))
            self._cur = crc32c(bytes(mv[:take]), self._cur)
            self._fill += take
            mv = mv[take:]
            if self._fill == self.block:
                self._crcs.append(self._cur)
                self._cur = 0
                self._fill = 0

    def finalize(self) -> list[int]:
        if self._fill:
            self._crcs.append(self._cur)
            self._cur = 0
            self._fill = 0
        return list(self._crcs)
