"""Pure-numpy Reed-Solomon coder — the semantic reference implementation.

Mirrors the behavior of klauspost/reedsolomon's `Encode`, `Reconstruct` and
`ReconstructData` as used by seaweedfs (`ec_encoder.go:198,235`,
`store_ec.go:325,367`), but via table-lookup numpy ops.  This is the slow,
obviously-correct oracle that the CUDA coder is tested against; it
is also the fallback when no accelerator is present.
"""

from __future__ import annotations

import numpy as np

from . import gf256


class NumpyCoder:
    """Systematic erasure coder over GF(2^8) for any registered codec
    (default: RS(data_shards, parity_shards))."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 matrix_kind: str = "vandermonde", codec=None):
        from ..codecs import get_codec, rs_codec
        self.codec = rs_codec(data_shards, parity_shards, matrix_kind) \
            if codec is None else get_codec(codec)
        self.data_shards = self.codec.data_shards
        self.parity_shards = self.codec.parity_shards
        self.total_shards = self.codec.total_shards
        self.matrix_kind = self.codec.matrix_kind
        self.parity_mat = self.codec.parity_matrix()

    # -- core GF matmul on byte planes ------------------------------------

    @staticmethod
    def _apply(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
        """out[r] = XOR_c mat[r,c] * shards[c]  (GF(2^8) row mix).

        shards: (k, n) uint8.  Returns (rows, n) uint8.
        """
        t = gf256.mul_table()
        rows = mat.shape[0]
        n = shards.shape[1]
        out = np.zeros((rows, n), dtype=np.uint8)
        for r in range(rows):
            acc = out[r]
            for c in range(mat.shape[1]):
                coef = mat[r, c]
                if coef == 0:
                    continue
                np.bitwise_xor(acc, t[coef][shards[c]], out=acc)
        return out

    # -- public API --------------------------------------------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data: (data_shards, n) uint8 -> parity (parity_shards, n) uint8."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.shape[0] != self.data_shards:
            raise ValueError(
                f"expected {self.data_shards} data shards, got {data.shape[0]}")
        return self._apply(self.parity_mat, data)

    def encode_all(self, data: np.ndarray) -> np.ndarray:
        """Returns all (total_shards, n) shards (data rows passed through)."""
        return np.concatenate([np.asarray(data, np.uint8),
                               self.encode(data)], axis=0)

    def reconstruct(self, shards: dict[int, np.ndarray],
                    wanted: list[int] | None = None) -> dict[int, np.ndarray]:
        """Recover missing shards from any >= data_shards survivors.

        `shards` maps shard id -> (n,) or (n,) uint8 rows.  Returns a dict of
        the reconstructed shards (id -> bytes).  Matches klauspost
        `Reconstruct` (all shards) / `ReconstructData` (wanted=[0..k)).
        """
        present = sorted(shards)
        bad = [s for s in present if not 0 <= s < self.total_shards]
        if bad:
            raise ValueError(
                f"survivor shard ids {bad} out of range [0, {self.total_shards})")
        if wanted is None:
            wanted = [s for s in range(self.total_shards) if s not in shards]
        bad = [w for w in wanted if not 0 <= w < self.total_shards]
        if bad:
            raise ValueError(
                f"shard ids {bad} out of range [0, {self.total_shards})")
        if not wanted:
            return {}
        if not self.codec.is_rs:
            # Generic codecs (LRC): one minimal-read GF solve covers
            # any mix of data/local-parity/global-parity shards.
            mat, used = self.codec.decode_matrix(
                tuple(present), tuple(wanted))
            stacked = np.stack([np.asarray(shards[s], np.uint8)
                                for s in used])
            rec = self._apply(mat, stacked)
            return {w: rec[i] for i, w in enumerate(wanted)}
        missing_parity = [w for w in wanted if w >= self.data_shards]
        # One decode solve covers wanted data shards plus any data shards
        # needed to re-encode wanted parity.
        solve_data = sorted({w for w in wanted if w < self.data_shards} |
                            ({d for d in range(self.data_shards)
                              if d not in shards} if missing_parity else set()))

        out: dict[int, np.ndarray] = {}
        solved: dict[int, np.ndarray] = {}
        if solve_data:
            mat, used = gf256.decode_matrix(
                self.data_shards, self.total_shards, present,
                wanted=solve_data, kind=self.matrix_kind)
            stacked = np.stack([np.asarray(shards[s], np.uint8) for s in used])
            rec = self._apply(mat, stacked)
            solved = {d: rec[i] for i, d in enumerate(solve_data)}
            out.update({d: solved[d] for d in solve_data if d in wanted})

        if missing_parity:
            data = np.stack([
                np.asarray(shards[d], np.uint8) if d in shards else solved[d]
                for d in range(self.data_shards)])
            parity = self.encode(data)
            for w in missing_parity:
                out[w] = parity[w - self.data_shards]
        return out

    def verify(self, shards: np.ndarray) -> bool:
        """shards: (total, n). True iff parity rows match the data rows."""
        parity = self.encode(shards[: self.data_shards])
        return bool(np.array_equal(parity, shards[self.data_shards:]))
