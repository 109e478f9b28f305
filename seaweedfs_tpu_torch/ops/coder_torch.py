"""Plain-PyTorch erasure coder: the GF(2) bit-matrix product as torch
matmuls, on whatever device it is given.

Port of seaweedfs_tpu/ops/coder_jax.py (the XLA coder).  The byte mix
of every codec becomes, per `rs_bitmatrix.py`,

    out_bits = (B @ in_bits) mod 2

with the bit layout *plane-major*: row `s*k + j` holds bit `s` of shard
`j`.  Sums over the contracting dimension are <= 8k, exact in float32.
This is the `torch` backend of `ops/erasure.py`, chosen by name; it is
not a fallback of the CUDA kernels and launches none of them.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .coder_cuda import plane_major
from .erasure import resolve_device

# Decode-matrix cache bound per coder; overflow clears.
_DECODE_CACHE_CAP = 256


def apply_bitmatrix(bmat_pm: torch.Tensor, shards: torch.Tensor,
                    out_rows: int) -> torch.Tensor:
    """out = GF-matrix mix of byte shards, via one GF(2) matmul.

    bmat_pm: (8*out_rows, 8*k) plane-major 0/1, on the shards' device.
    shards:  (k, n) uint8.
    Returns (out_rows, n) uint8.  TF32 is switched off for the call, so
    the product is exact on a CUDA device too."""
    x = shards.to(torch.int32)
    bits = torch.cat([(x >> s) & 1 for s in range(8)]).to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = bmat_pm.to(torch.float32) @ bits
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    pbits = acc.to(torch.int32) & 1
    out = pbits[0:out_rows]
    for s in range(1, 8):
        out = out | (pbits[s * out_rows:(s + 1) * out_rows] << s)
    return out.to(torch.uint8)


class TorchCoder:
    """Erasure coder whose byte mix is plain torch on `device` (default
    the card; raises without one unless ``device="cpu"``).  Results are
    tensors on that device."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 matrix_kind: str = "vandermonde", codec=None,
                 device="cuda"):
        from ..codecs import get_codec, rs_codec
        self.device = resolve_device(device)
        self.codec = rs_codec(data_shards, parity_shards, matrix_kind) \
            if codec is None else get_codec(codec)
        self.data_shards = self.codec.data_shards
        self.parity_shards = self.codec.parity_shards
        self.total_shards = self.codec.total_shards
        self.matrix_kind = self.codec.matrix_kind
        self._parity_pm = self._upload(plane_major(
            self.codec.parity_bitmatrix(), self.parity_shards,
            self.data_shards))
        self._decode_cache: dict = {}
        self._cache_lock = threading.Lock()

    def _upload(self, arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def encode(self, data) -> torch.Tensor:
        """(data_shards, n) uint8 -> (parity_shards, n) uint8."""
        data = self._upload(data)
        if data.shape[0] != self.data_shards:
            raise ValueError(
                f"expected {self.data_shards} data shards, got {data.shape[0]}")
        return apply_bitmatrix(self._parity_pm, data, self.parity_shards)

    def encode_all(self, data) -> torch.Tensor:
        data = self._upload(data)
        return torch.cat([data, self.encode(data)])

    def _decode_mat_pm(self, present: tuple[int, ...],
                       wanted: tuple[int, ...]
                       ) -> tuple[torch.Tensor, tuple[int, ...]]:
        key = (present, wanted)
        with self._cache_lock:
            hit = self._decode_cache.get(key)
        if hit is None:
            bmat, used = self.codec.decode_bitmatrix(present, wanted)
            pm = plane_major(np.asarray(bmat), len(wanted), len(used))
            hit = (self._upload(pm), used)
            with self._cache_lock:
                if len(self._decode_cache) >= _DECODE_CACHE_CAP:
                    self._decode_cache.clear()
                self._decode_cache[key] = hit
        return hit

    def reconstruct(self, shards: dict, wanted: list[int] | None = None
                    ) -> dict[int, torch.Tensor]:
        """Recover shards from survivors in one matmul: the decode
        matrix composes solve and re-encode."""
        present = tuple(sorted(shards))
        if wanted is None:
            wanted = [s for s in range(self.total_shards) if s not in shards]
        bad = [w for w in wanted if not 0 <= w < self.total_shards]
        if bad:
            raise ValueError(
                f"shard ids {bad} out of range [0, {self.total_shards})")
        if not wanted:
            return {}
        mat_pm, used = self._decode_mat_pm(present, tuple(wanted))
        stacked = torch.stack([self._upload(shards[s]) for s in used])
        rec = apply_bitmatrix(mat_pm, stacked, len(wanted))
        return {w: rec[i] for i, w in enumerate(wanted)}

    def verify(self, shards) -> bool:
        shards = self._upload(shards)
        parity = self.encode(shards[: self.data_shards])
        return bool(torch.equal(parity, shards[self.data_shards:]))
