"""RS(k, m) encode and rebuild of byte shards, column by column: each
output byte is the XOR over inputs of a product looked up in the
field's 256 x 256 multiplication table."""

from __future__ import annotations

import numpy as np
import torch

from . import gf256

# Columns per lookup pass: bounds the int64 indices to 8 bytes per
# input byte of 16 MiB of columns.
COLS = 1 << 24


class Code:
    """One RS(k, m) code on `device`; `kind` "cauchy" is the control's
    other code."""

    def __init__(self, k: int, m: int, device, kind: str = "vandermonde"):
        self.k, self.m = k, m
        self.parity = gf256.vandermonde_parity(k, m) if kind == "vandermonde" \
            else gf256.cauchy_parity(k, m)
        self.device = torch.device(device)
        self._table = torch.tensor(
            [[gf256.mul(a, b) for b in range(256)] for a in range(256)],
            dtype=torch.uint8, device=self.device)

    def mix(self, coeffs: np.ndarray, rows: torch.Tensor) -> torch.Tensor:
        """(r, c) GF(2^8) matrix x (c, n) uint8 rows -> (r, n) uint8."""
        out = torch.zeros((coeffs.shape[0], rows.shape[-1]),
                          dtype=torch.uint8, device=self.device)
        for lo in range(0, rows.shape[-1], COLS):
            idx = rows[:, lo:lo + COLS].long()
            for i, crow in enumerate(coeffs):
                acc = out[i, lo:lo + COLS]
                for j, c in enumerate(crow):
                    if c:
                        acc ^= self._table[int(c)][idx[j]]
        return out

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """(k, n) uint8 data shards -> (m, n) parity shards."""
        return self.mix(self.parity, data)

    def rebuild(self, shards: dict[int, torch.Tensor],
                wanted: list[int]) -> torch.Tensor:
        """Rows `wanted` (len(wanted), n) from k surviving shards."""
        rows, used = gf256.decode_rows(self.parity, sorted(shards), wanted)
        return self.mix(rows, torch.stack([shards[s] for s in used]))
