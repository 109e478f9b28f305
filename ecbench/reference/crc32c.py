"""CRC32-C (Castagnoli: reflected polynomial 0x82F63B78, initial value
and final XOR 0xFFFFFFFF) of every fixed-size block of byte rows.

The register after a message is linear in the message's bits over
GF(2) (with the register started at 0): bit b of the byte i places from
the end adds T^i(1 << b), T being one byte of the shift register.  So a
4096-byte piece's register is one (32768 -> 32) product of its bits
in float32 (a count whose lowest bit is the GF(2) sum), a block's
register the product of its pieces' registers with the shifts that
carry each to the block's end, and its CRC that register XOR the CRC
of as many zero bytes.  A short last block is a full one with zeros in
front (leading zeros leave a register at 0 unchanged) and its own
constant.  `crc32c` is the bitwise definition, for tests."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


POLY = 0x82F63B78
PIECE = 4096
# Pieces per bit product: 16 MiB of bytes, 512 MiB of float planes.
PIECES_PER_PRODUCT = 4096


def crc32c(data: bytes, crc: int = 0) -> int:
    """Bitwise CRC32-C of `data`, continuing from `crc`."""
    crc ^= 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (POLY if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def _step_matrix() -> np.ndarray:
    """T, one zero byte through the register, as a 32 x 32 GF(2)
    matrix acting on column vectors of register bits."""
    t = np.zeros((32, 32), dtype=np.int64)
    for b in range(32):
        s = 1 << b
        for _ in range(8):
            s = (s >> 1) ^ (POLY if s & 1 else 0)
        for a in range(32):
            t[a, b] = (s >> a) & 1
    return t


def _gf2_power(m: np.ndarray, n: int) -> np.ndarray:
    out = np.eye(32, dtype=np.int64)
    while n:
        if n & 1:
            out = out @ m % 2
        m = m @ m % 2
        n >>= 1
    return out


def _bits_of(v: np.ndarray) -> int:
    return int(sum(int(x) << i for i, x in enumerate(v)))


@contextlib.contextmanager
def exact_float32():
    """Full-precision float32 matmuls (no TF32) inside the block: the
    bit counts are then exact, every one being far below 2^24."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


@functools.lru_cache(maxsize=None)
def _piece_matrix() -> np.ndarray:
    """(8 PIECE, 32): row 8i + b is T^(PIECE - i)(1 << b) in bits."""
    t = _step_matrix()
    out = np.zeros((8 * PIECE, 32), dtype=np.float32)
    cur = t.copy()  # T^(PIECE - i) for i = PIECE - 1
    for i in range(PIECE - 1, -1, -1):
        out[8 * i:8 * i + 8] = cur[:, :8].T
        cur = t @ cur % 2
    return out


@functools.lru_cache(maxsize=None)
def _join_matrix(pieces: int) -> np.ndarray:
    """(32 pieces, 32): row 32q + b is T^(PIECE (pieces - 1 - q))(1 << b)."""
    shift = _gf2_power(_step_matrix(), PIECE)
    out = np.zeros((32 * pieces, 32), dtype=np.float32)
    cur = np.eye(32, dtype=np.int64)
    for q in range(pieces - 1, -1, -1):
        out[32 * q:32 * q + 32] = cur.T
        cur = shift @ cur % 2
    return out


@functools.lru_cache(maxsize=None)
def zeros_crc(n: int) -> int:
    """CRC32-C of n zero bytes: T^n applied to the initial register."""
    ones = np.ones(32, dtype=np.int64)
    return _bits_of(_gf2_power(_step_matrix(), n) @ ones % 2) ^ 0xFFFFFFFF


class BlockCrc:
    """Block CRCs of (rows, n) uint8 tensors on one device."""

    def __init__(self, block: int, device):
        if block % PIECE:
            raise ValueError(f"block {block} is not a multiple of {PIECE}")
        self.block = block
        self.device = torch.device(device)
        self._piece = torch.from_numpy(_piece_matrix()).to(self.device)
        self._join = torch.from_numpy(
            _join_matrix(block // PIECE)).to(self.device)
        self._weights = torch.tensor([1 << b for b in range(32)],
                                     dtype=torch.int64, device=self.device)

    def _registers(self, blocks: torch.Tensor) -> torch.Tensor:
        """(B, block) uint8 -> (B,) int64 registers (started at 0)."""
        pieces = blocks.reshape(-1, PIECE)
        regs = torch.empty((pieces.shape[0], 32), dtype=torch.float32,
                           device=self.device)
        shifts = torch.arange(8, dtype=torch.uint8, device=self.device)
        with exact_float32():
            for lo in range(0, pieces.shape[0], PIECES_PER_PRODUCT):
                part = pieces[lo:lo + PIECES_PER_PRODUCT]
                bits = ((part.unsqueeze(-1) >> shifts) & 1).reshape(
                    part.shape[0], 8 * PIECE).float()
                regs[lo:lo + part.shape[0]] = (bits @ self._piece).to(
                    torch.int32).bitwise_and_(1).float()
            joined = regs.view(blocks.shape[0], -1) @ self._join
        bits = joined.to(torch.int64).bitwise_and_(1)
        return (bits * self._weights).sum(dim=1)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """(r, n) uint8 -> (r, ceil(n / block)) int64 CRC32-C values."""
        r, n = rows.shape
        full, tail = divmod(n, self.block)
        out = torch.empty((r, full + bool(tail)), dtype=torch.int64,
                          device=self.device)
        if full:
            regs = self._registers(
                rows[:, :full * self.block].reshape(r * full, self.block))
            out[:, :full] = regs.view(r, full) ^ zeros_crc(self.block)
        if tail:
            padded = torch.zeros((r, self.block), dtype=torch.uint8,
                                 device=self.device)
            padded[:, self.block - tail:] = rows[:, full * self.block:]
            out[:, full] = self._registers(padded) ^ zeros_crc(tail)
        return out
