"""Erasure coder on the hand-written CUDA kernels of ``csrc/``.

Two kernels, bound through ctypes (`cuda_build.py`):

- K1 `apply_bitmatrix` (csrc/rs_bitmatrix.cu): GF(2^8) matrix mix of
  byte shards as a GF(2) bit-matrix product — every encode, rebuild and
  degraded read; only the matrix changes.
- K2 `apply_bitmatrix_crc` (csrc/rs_bitmatrix_crc.cu): K1's parity plus
  one position-shifted CRC32-C partial per 4096-byte tile of every data
  and parity row, folded into `.ecc` block CRCs by
  `crc_fold.FusedCrcAccumulator`.

They replace `seaweedfs_tpu/ops/coder_pallas.py` apply_bitmatrix_pallas
and apply_bitmatrix_crc_pallas.  Each wrapper launches its kernel for a
tensor on a CUDA device (or raises) and runs the kernel's plain PyTorch
version (`apply_bitmatrix_torch`, `apply_bitmatrix_crc_torch`) for a
tensor on the CPU, and counts its launches in a `launches` attribute
(per instantiation in `variant_launches`, and the launches that carry
more than one volume in `volume_launches`).  Both take either one
volume, (rows, n), or a volume axis, (V, rows, n) with every volume
sharing the matrix: the batched steps of `parallel/sharded_codec.py`
launch each kernel once for all V.

Both kernels take the bit-matrix packed on the host (`pack_bitmatrix`):
one 8-bit mask per (output bit row, input row) of the plane-major
matrix — row `s*r + i` is bit s of output shard i, column `s*k + j` bit
s of input shard j (`plane_major`).  The wrappers take the masks as a
host (CPU) tensor: a shape with an instantiation of its own
(`K1_SPECIALISED`, `K2_SPECIALISED`) gets them as launch parameters
(`mask_words`), so no call copies them off the card or synchronises;
every other shape runs a generic instantiation that reads an
asynchronous device copy.  The plain versions take the masks on any
device.  K2's plain version takes the CRC constants of
`crc_fold.CrcFoldTables` packed into 32-bit words (`pack_crc_tables`);
the kernel reads the byte-table form of the same function
(`pack_crc_kernel_tables`), built once per device.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import crc_fold
from .erasure import host_array, resolve_device

# Byte columns per kernel tile: one K2 block, and the width every coder
# call is zero-padded to (so K2's partials equal seaweedfs_tpu's).
BLOCK_N = 4096

# Column group the plain versions work through at a time, which bounds
# their float32 intermediates to a few times the input.
_PLAIN_COLS = 1 << 18

# Shapes (in_rows, out_rows) with an instantiation of their own: fully
# unrolled, masks as launch parameters.  K1: encode/rebuild/verify
# (10 -> 4) and one missing shard per degraded-read interval (10 -> 1).
# Index i of *_VARIANTS names the instantiation the C entry point's
# `variant` argument i launches; every other accepted shape takes a
# generic one.
K1_SPECIALISED = ((10, 4), (10, 1))
K1_VARIANTS = ("10->4", "10->1", "generic<=16", "generic<=32")
K2_SPECIALISED = ((10, 4),)
K2_VARIANTS = ("10->4", "generic<=16")

# K2's CRC geometry (csrc/rs_bitmatrix_crc.cu): a row of a tile is
# CRC_RUNS runs, each CRC_CHAINS interleaved chains; CRC_SHIFT_LENGTHS are
# the zero-byte shifts that join chains (the first) and pairs of runs
# (the rest, level by level).
CRC_RUNS = 16
CRC_CHAINS = 4
CRC_SHIFT_LENGTHS = (BLOCK_N // CRC_RUNS // CRC_CHAINS,) + tuple(
    (BLOCK_N // CRC_RUNS) << k for k in range(4))


def plane_major(bmat: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Permute an interleaved (8r x 8k) bit matrix into plane-major order.

    Interleaved index 8*s + b (bit b of shard s)  ->  plane-major b*n + s.
    """
    r8, k8 = bmat.shape
    if r8 != 8 * rows or k8 != 8 * cols:
        raise ValueError(f"bit matrix {bmat.shape} is not (8*{rows}, 8*{cols})")
    row_perm = [8 * (q % rows) + (q // rows) for q in range(8 * rows)]
    col_perm = [8 * (q % cols) + (q // cols) for q in range(8 * cols)]
    return bmat[np.ix_(row_perm, col_perm)]


def pad_to_block(n: int, block_n: int = BLOCK_N) -> int:
    return -(-n // block_n) * block_n


def pack_bitmatrix(bmat_pm: np.ndarray) -> np.ndarray:
    """(8r, 8k) plane-major 0/1 -> (8r, k) uint8 masks: bit s of
    masks[q, j] is bmat_pm[q, s*k + j]."""
    b = np.asarray(bmat_pm, dtype=np.uint8)
    q, k8 = b.shape
    if q % 8 or k8 % 8:
        raise ValueError(f"bit matrix {b.shape} is not (8r, 8k)")
    planes = b.reshape(q, 8, k8 // 8).astype(np.uint16)
    shifts = np.arange(8, dtype=np.uint16)[None, :, None]
    return (planes << shifts).sum(axis=1).astype(np.uint8)


def unpack_bitmatrix(masks: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_bitmatrix: (8r, k) masks -> (8r, 8k) uint8 0/1."""
    q, k = masks.shape
    shifts = torch.arange(8, device=masks.device)[None, :, None]
    bits = (masks.to(torch.int32)[:, None, :] >> shifts) & 1
    return bits.reshape(q, 8 * k).to(torch.uint8)


def _pack_words(bits: np.ndarray) -> np.ndarray:
    """(..., 32) 0/1 -> (...,) int32 words, bit o = bits[..., o]."""
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return w.astype(np.uint32).view(np.int32)


def pack_crc_tables(t: crc_fold.CrcFoldTables
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CrcFoldTables as the packed words K2 takes, all int32:
    w0 (tile_n,) with bit o = w0[c, o]; plane columns (8*32,) with
    word s*32+o = column o of A_s; position columns (tpb*32,) with word
    j*32+i = column i of posmats[j]."""
    w0 = _pack_words(t.w0)
    plane_cols = _pack_words(t.planes.transpose(0, 2, 1)).reshape(-1)
    pos_cols = _pack_words(t.posmats.transpose(0, 2, 1)).reshape(-1)
    return w0, plane_cols, pos_cols


def pack_crc_kernel_tables() -> tuple[np.ndarray, np.ndarray]:
    """K2's form of the CRC constants, int32 words: the byte table
    (256,) and the shift tables (len(CRC_SHIFT_LENGTHS) * 4 * 256,), one
    byte-sliced `crc_fold.shift_table` per length in CRC_SHIFT_LENGTHS
    order.  The position columns are pack_crc_tables' third array."""
    byte_table = crc_fold.byte_table()
    shifts = np.stack([crc_fold.shift_table(m) for m in CRC_SHIFT_LENGTHS])
    return byte_table.view(np.int32), shifts.reshape(-1).view(np.int32)


def mask_words(masks: torch.Tensor) -> np.ndarray:
    """(8r, k) uint8 host masks -> (8r * k,) uint32 mask words, the
    launch parameter of a specialised kernel (csrc/rs_bitmatrix.cuh).
    Word (s*r + i)*k + j, for s < 4, is the byte (m[s] & 0x0F) |
    (m[s+4] & 0xF0) and, for s >= 4, (m[s-4] >> 4) | ((m[s] << 4) &
    0xF0), with m[s] = masks[s*r + i, j]; each replicated into the four
    byte lanes.  This folds the first level of the kernels' parity
    butterfly into the masks."""
    m = np.ascontiguousarray(masks.numpy(), dtype=np.uint32)
    lo, hi = np.split(m, 2)            # planes s < 4 and s + 4
    a1 = (lo & 0x0F) | (hi & 0xF0)
    a2 = (lo >> 4) | ((hi << 4) & 0xF0)
    return np.concatenate([a1, a2]).reshape(-1) * np.uint32(0x01010101)


def k1_variant(in_rows: int, out_rows: int) -> int:
    """Index into K1_VARIANTS of the instantiation for this shape."""
    if (in_rows, out_rows) in K1_SPECIALISED:
        return K1_SPECIALISED.index((in_rows, out_rows))
    return len(K1_SPECIALISED) + (in_rows > 16)


def k2_variant(in_rows: int, out_rows: int) -> int:
    """Index into K2_VARIANTS of the instantiation for this shape."""
    if (in_rows, out_rows) in K2_SPECIALISED:
        return K2_SPECIALISED.index((in_rows, out_rows))
    return len(K2_SPECIALISED)


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> (..., 32) float32 0/1, element o = bit o."""
    shifts = torch.arange(32, device=words.device)
    return ((words.to(torch.int64)[..., None] >> shifts) & 1) \
        .to(torch.float32)


def _pack_planes(pbits: torch.Tensor, rows: int) -> torch.Tensor:
    """(8*rows, n) plane-major 0/1 int32 -> (rows, n) uint8."""
    out = pbits[0:rows]
    for s in range(1, 8):
        out = out | (pbits[s * rows:(s + 1) * rows] << s)
    return out.to(torch.uint8)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def apply_bitmatrix_torch(masks: torch.Tensor,
                          shards: torch.Tensor) -> torch.Tensor:
    """K1's plain version: unpack one bit plane at a time, float32
    matmul (sums <= 8k are exact), &1, pack.  TF32 is switched off for
    the call, so the product is exact on a CUDA device too.  A (V, k, n)
    input is taken one volume at a time."""
    if shards.dim() == 3:
        return torch.stack([apply_bitmatrix_torch(masks, s) for s in shards])
    out_rows, in_rows = masks.shape[0] // 8, masks.shape[1]
    n = shards.shape[1]
    bmat = unpack_bitmatrix(masks).to(torch.float32)
    out = torch.empty((out_rows, n), dtype=torch.uint8, device=shards.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c0 in range(0, n, _PLAIN_COLS):
            x = shards[:, c0:c0 + _PLAIN_COLS].to(torch.int32)
            acc = torch.zeros((8 * out_rows, x.shape[1]),
                              dtype=torch.float32, device=shards.device)
            for s in range(8):
                acc += bmat[:, s * in_rows:(s + 1) * in_rows] \
                    @ ((x >> s) & 1).to(torch.float32)
            out[:, c0:c0 + x.shape[1]] = _pack_planes(
                acc.to(torch.int32) & 1, out_rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def apply_bitmatrix_crc_torch(masks: torch.Tensor, shards: torch.Tensor,
                              w0: torch.Tensor, plane_cols: torch.Tensor,
                              pos_cols: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: K1's plain parity, then the arithmetic of
    crc_fold.tile_partials_np with &1 after each contraction, one bit
    plane and one group of tiles at a time.  Returns (parity (r, n)
    uint8, partials (k + r, n // tile) int32); a (V, k, n) input is taken
    one volume at a time, each starting at tile position 0."""
    if shards.dim() == 3:
        outs = [apply_bitmatrix_crc_torch(masks, s, w0, plane_cols, pos_cols)
                for s in shards]
        return (torch.stack([p for p, _ in outs]),
                torch.stack([q for _, q in outs]))
    tile = w0.shape[0]
    tpb = pos_cols.shape[0] // 32
    n = shards.shape[1]
    if n % tile:
        raise ValueError(f"width {n} not a multiple of tile {tile}")
    parity = apply_bitmatrix_torch(masks, shards)
    w0_bits = _unpack_words(w0)                              # (T, 32 o)
    planes_t = _unpack_words(plane_cols.reshape(8, 32))      # (8, 32 o, 32 i)
    pos_t = _unpack_words(pos_cols.reshape(tpb, 32))         # (tpb, 32 i, 32 o)
    rows = shards.shape[0] + parity.shape[0]
    nt = n // tile
    partials = torch.empty((rows, nt), dtype=torch.int32, device=shards.device)
    group = max(1, _PLAIN_COLS // tile)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t0 in range(0, nt, group):
            t1 = min(nt, t0 + group)
            cols = slice(t0 * tile, t1 * tile)
            x = torch.cat([shards[:, cols], parity[:, cols]]).to(torch.int32)
            fold = torch.zeros((rows, t1 - t0, 32), dtype=torch.float32,
                               device=shards.device)
            for s in range(8):
                bits = ((x >> s) & 1).to(torch.float32) \
                    .reshape(rows, t1 - t0, tile)
                ub = ((bits @ w0_bits).to(torch.int32) & 1).to(torch.float32)
                fold += ub @ planes_t[s]
            v = (fold.to(torch.int32) & 1).to(torch.float32)
            pm = pos_t[torch.arange(t0, t1, device=shards.device) % tpb]
            sh = torch.einsum("rti,tio->rto", v, pm).to(torch.int64) & 1
            word = (sh << torch.arange(32, device=shards.device)).sum(-1)
            partials[:, t0:t1] = torch.where(
                word >= 1 << 31, word - (1 << 32), word).to(torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return parity, partials


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = {
    "rs_bitmatrix": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p],
    "rs_bitmatrix_crc": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    from . import cuda_build
    fn = getattr(cuda_build.load(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


@functools.lru_cache(maxsize=None)
def _crc_kernel_tables(device: torch.device
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).to(device)
                 for a in pack_crc_kernel_tables())


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _check_cuda(device: torch.device, **tensors) -> None:
    for key, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{key} on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{key} must be 16-byte aligned")


def _check_mix(masks: torch.Tensor, shards: torch.Tensor
               ) -> tuple[int, int, int, int]:
    """(volumes, in_rows, out_rows, n) of a (rows, n) or (V, rows, n)
    call."""
    if masks.dtype != torch.uint8 or shards.dtype != torch.uint8:
        raise ValueError("masks and shards must be uint8")
    if masks.dim() != 2 or shards.dim() not in (2, 3) or masks.shape[0] % 8 \
            or masks.shape[1] != shards.shape[-2]:
        raise ValueError(f"masks {tuple(masks.shape)} do not fit shards "
                         f"{tuple(shards.shape)}")
    volumes = shards.shape[0] if shards.dim() == 3 else 1
    if volumes < 1 or volumes > 65535:
        raise ValueError(f"{volumes} volumes; a launch takes 1 to 65535")
    return volumes, shards.shape[-2], masks.shape[0] // 8, shards.shape[-1]


def _count(fn, names, variant: int, volumes: int) -> None:
    fn.launches += 1
    fn.variant_launches[names[variant]] += 1
    if volumes > 1:
        fn.volume_launches += 1


def _kernel_masks(masks: torch.Tensor, specialised: bool, device
                  ) -> tuple[np.ndarray | None, torch.Tensor | None]:
    """(host mask words, device masks): the words for a specialised
    instantiation, else an asynchronous device copy for a generic one."""
    if masks.device.type != "cpu":
        raise ValueError("a kernel takes the host copy of its masks, "
                         f"got masks on {masks.device}")
    masks = masks.contiguous()
    if specialised:
        return mask_words(masks), None
    return None, masks.to(device, non_blocking=True)


def apply_bitmatrix(masks: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """(8r, k) packed masks x (k, n) uint8 shards -> (r, n) uint8, or
    (V, k, n) -> (V, r, n) for V volumes in one launch.

    A CUDA tensor launches K1 (n a multiple of 16, k and r <= 32, masks
    on the host) in the instantiation `k1_variant` picks; a CPU tensor
    runs apply_bitmatrix_torch."""
    volumes, in_rows, out_rows, n = _check_mix(masks, shards)
    if shards.device.type == "cpu":
        return apply_bitmatrix_torch(masks, shards)
    _check_cuda(shards.device, shards=shards)
    if out_rows > 32 or in_rows > 32 or n % 16:
        raise ValueError(f"K1 takes <= 32 rows in and out and n % 16 == 0, "
                         f"got {out_rows} x {in_rows}, n={n}")
    variant = k1_variant(in_rows, out_rows)
    words, dev_masks = _kernel_masks(masks, variant < len(K1_SPECIALISED),
                                     shards.device)
    out = torch.empty((*shards.shape[:-2], out_rows, n), dtype=torch.uint8,
                      device=shards.device)
    rc = _kernel("rs_bitmatrix")(
        variant, None if words is None else words.ctypes.data,
        None if dev_masks is None else dev_masks.data_ptr(), out_rows,
        in_rows, shards.data_ptr(), out.data_ptr(), n, volumes,
        shards.device.index,
        torch.cuda.current_stream(shards.device).cuda_stream)
    _check_launch("rs_bitmatrix", rc)
    _count(apply_bitmatrix, K1_VARIANTS, variant, volumes)
    return out


apply_bitmatrix.launches = 0
apply_bitmatrix.variant_launches = dict.fromkeys(K1_VARIANTS, 0)
apply_bitmatrix.volume_launches = 0


def apply_bitmatrix_crc(masks: torch.Tensor, shards: torch.Tensor,
                        w0: torch.Tensor, plane_cols: torch.Tensor,
                        pos_cols: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 plus fused `.ecc` CRC32-C tile partials: returns (parity
    (r, n) uint8, partials (k + r, n // 4096) int32 — the uint32 words
    of seaweedfs_tpu's kernel; take `.view(np.uint32)` on the host).  A
    (V, k, n) input gives (V, r, n) and (V, k + r, n // 4096), each
    volume's partials positioned within its own rows.

    A CUDA tensor launches K2 (n a multiple of 4096, k and r <= 16,
    masks on the host, each volume starting on an `.ecc` block boundary)
    in the instantiation `k2_variant` picks; it reads pos_cols and the
    device's `pack_crc_kernel_tables`, and w0 and plane_cols only set
    the tile.  A CPU tensor runs apply_bitmatrix_crc_torch."""
    volumes, in_rows, out_rows, n = _check_mix(masks, shards)
    if shards.device.type == "cpu":
        return apply_bitmatrix_crc_torch(masks, shards, w0, plane_cols,
                                         pos_cols)
    _check_cuda(shards.device, shards=shards, pos_cols=pos_cols)
    if w0.shape[0] != BLOCK_N or plane_cols.shape[0] != 8 * 32 \
            or pos_cols.shape[0] % 32:
        raise ValueError("crc tables do not fit the kernel's 4096-byte tile")
    if out_rows > 16 or in_rows > 16 or n % BLOCK_N:
        raise ValueError(f"K2 takes <= 16 rows in and out and n % {BLOCK_N} "
                         f"== 0, got {out_rows} x {in_rows}, n={n}")
    variant = k2_variant(in_rows, out_rows)
    words, dev_masks = _kernel_masks(masks, variant < len(K2_SPECIALISED),
                                     shards.device)
    byte_table, shifts = _crc_kernel_tables(shards.device)
    lead = shards.shape[:-2]
    parity = torch.empty((*lead, out_rows, n), dtype=torch.uint8,
                         device=shards.device)
    partials = torch.empty((*lead, in_rows + out_rows, n // BLOCK_N),
                           dtype=torch.int32, device=shards.device)
    rc = _kernel("rs_bitmatrix_crc")(
        variant, None if words is None else words.ctypes.data,
        None if dev_masks is None else dev_masks.data_ptr(), out_rows,
        in_rows, shards.data_ptr(), parity.data_ptr(), n, volumes,
        byte_table.data_ptr(), shifts.data_ptr(), pos_cols.data_ptr(),
        pos_cols.shape[0] // 32, partials.data_ptr(), shards.device.index,
        torch.cuda.current_stream(shards.device).cuda_stream)
    _check_launch("rs_bitmatrix_crc", rc)
    _count(apply_bitmatrix_crc, K2_VARIANTS, variant, volumes)
    return parity, partials


apply_bitmatrix_crc.launches = 0
apply_bitmatrix_crc.variant_launches = dict.fromkeys(K2_VARIANTS, 0)
apply_bitmatrix_crc.volume_launches = 0


# ---------------------------------------------------------------------------
# The coder
# ---------------------------------------------------------------------------

# Decode-matrix cache bound per coder (one entry per survivor set and
# wanted list); overflow clears, as the codec caches do.
_DECODE_CACHE_CAP = 256


class CudaCoder:
    """Erasure coder for any registered codec (RS, LRC) whose byte
    mixing runs in the CUDA kernels on `device` (or in their plain
    versions when `device` is the CPU).

    Results are tensors on the coder's device and are returned without
    a synchronize, so a caller can overlap host work with the kernel
    and bring them over later (`erasure.host_array`)."""

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
        self.block_n = BLOCK_N
        pm = plane_major(self.codec.parity_bitmatrix(), self.parity_shards,
                         self.data_shards)
        # Masks stay on the host: the kernels take them as launch
        # parameters (and the plain versions on the CPU as they are).
        self._parity_masks = torch.from_numpy(pack_bitmatrix(pm))
        self._crc_consts = None
        self._decode_cache: dict = {}
        self._cache_lock = threading.Lock()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _device_rows(self, rows) -> tuple[torch.Tensor, int]:
        """Stack equal-length rows (numpy or tensors) into one
        (len(rows), pad_to_block(n)) zero-padded uint8 tensor on the
        coder's device.  Returns (tensor, n)."""
        n = int(rows[0].shape[-1])
        padded = pad_to_block(n, self.block_n)
        if all(isinstance(r, torch.Tensor) for r in rows):
            out = torch.zeros((len(rows), padded), dtype=torch.uint8,
                              device=self.device)
            for i, r in enumerate(rows):
                out[i, :n] = r
            return out, n
        buf = np.zeros((len(rows), padded), dtype=np.uint8)
        for i, r in enumerate(rows):
            buf[i, :n] = host_array(r)
        return self._upload(buf), n

    def _data(self, data) -> tuple[torch.Tensor, int]:
        if data.shape[0] != self.data_shards:
            raise ValueError(
                f"expected {self.data_shards} data shards, got {data.shape[0]}")
        n = int(data.shape[1])
        if isinstance(data, np.ndarray) and data.dtype == np.uint8 \
                and n == pad_to_block(n, self.block_n) \
                and data.flags.c_contiguous and data.flags.writeable:
            return self._upload(data), n
        return self._device_rows(list(data))

    @property
    def fused_crc_ok(self) -> bool:
        """True when this coder can emit `.ecc` CRC32-C tile partials
        fused into the encode kernel: the tile must divide the sidecar
        block."""
        return crc_fold.BLOCK % self.block_n == 0

    def _crc_tables(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self._crc_consts is None:
            packed = pack_crc_tables(crc_fold.tables(self.block_n))
            self._crc_consts = tuple(self._upload(a) for a in packed)
        return self._crc_consts

    def encode_with_crc(self, data) -> tuple[torch.Tensor, torch.Tensor]:
        """Encode AND emit `.ecc` CRC tile partials in one kernel.

        Returns (parity (p, n) uint8, partials (k + p, padded_n //
        block_n) int32) — rows ordered data shards then parity shards,
        the shard-file order.  Feed the partials (as uint32) to
        crc_fold.FusedCrcAccumulator; `data` must start block-aligned in
        its shard files (the encoder's chunks do).
        """
        x, n = self._data(data)
        parity, partials = apply_bitmatrix_crc(self._parity_masks, x,
                                               *self._crc_tables())
        return parity[:, :n], partials

    def encode(self, data) -> torch.Tensor:
        """(data_shards, n) uint8 -> (parity_shards, n) uint8."""
        x, n = self._data(data)
        return apply_bitmatrix(self._parity_masks, x)[:, :n]

    def encode_all(self, data) -> torch.Tensor:
        x, n = self._data(data)
        parity = apply_bitmatrix(self._parity_masks, x)
        return torch.cat([x, parity])[:, :n]

    def _decode_masks(self, present: tuple[int, ...],
                      wanted: tuple[int, ...]
                      ) -> tuple[torch.Tensor, tuple[int, ...]]:
        """Packed host decode masks for one survivor set, cached so a
        degraded read pays no matrix solve."""
        key = (present, wanted)
        with self._cache_lock:
            hit = self._decode_cache.get(key)
        if hit is None:
            bmat, used = self.codec.decode_bitmatrix(present, wanted)
            pm = plane_major(np.asarray(bmat), len(wanted), len(used))
            hit = (torch.from_numpy(pack_bitmatrix(pm)), used)
            with self._cache_lock:
                if len(self._decode_cache) >= _DECODE_CACHE_CAP:
                    self._decode_cache.clear()
                self._decode_cache[key] = hit
        return hit

    def reconstruct(self, shards: dict, wanted: list[int] | None = None
                    ) -> dict[int, torch.Tensor]:
        """Recover shards from >= data_shards survivors in one launch:
        the decode matrix composes solve and re-encode, so any mix of
        lost data and parity shards is one bit-matrix product."""
        present = tuple(sorted(shards))
        if wanted is None:
            wanted = [s for s in range(self.total_shards) if s not in shards]
        bad = [w for w in wanted if not 0 <= w < self.total_shards]
        if bad:
            raise ValueError(
                f"shard ids {bad} out of range [0, {self.total_shards})")
        if not wanted:
            return {}
        masks, used = self._decode_masks(present, tuple(wanted))
        x, n = self._device_rows([shards[s] for s in used])
        rec = apply_bitmatrix(masks, x)[:, :n]
        return {w: rec[i] for i, w in enumerate(wanted)}

    def verify(self, shards) -> bool:
        """shards: (total, n). True iff parity rows match the data rows."""
        x, n = self._device_rows(list(shards))
        parity = apply_bitmatrix(self._parity_masks, x[: self.data_shards])
        return bool(torch.equal(parity[:, :n], x[self.data_shards:, :n]))
