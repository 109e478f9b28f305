"""The host-side pieces of the port's CUDA kernels, held on the CPU.

A CUDA kernel cannot run here, but what it reads is built in Python and
what it computes can be modelled in numpy step for step:

- the mask words K1 and K2 take as launch parameters (`mask_words`);
- the merged SWAR parity extraction of rs_bitmatrix.cuh, whose first
  level is folded into the mask words, and with it the whole per-word
  arithmetic of the kernels, against seaweedfs_tpu's Pallas kernel in
  interpret mode;
- K2's table-driven CRC: byte table, zero-byte shift tables, position
  columns, the kernel's run and chain lengths and its combine order,
  against seaweedfs_tpu's `crc_fold.tile_partials_np`, and its walk over
  (volume, tile) pairs with the position reset in every volume;
- the shape -> instantiation map the wrappers pass to the C entry points.

All of it is integer math: every comparison is equality.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import crc_fold as ref_crc_fold
from seaweedfs_tpu.ops.coder_pallas import apply_bitmatrix_pallas
from seaweedfs_tpu_torch import codecs
from seaweedfs_tpu_torch.core.crc import crc32c
from seaweedfs_tpu_torch.ops import crc_fold
from seaweedfs_tpu_torch.ops.coder_cuda import (
    BLOCK_N, CRC_CHAINS, CRC_RUNS, CRC_SHIFT_LENGTHS, K1_SPECIALISED,
    K1_VARIANTS, K2_SPECIALISED, K2_VARIANTS, _kernel_masks,
    apply_bitmatrix_crc, apply_bitmatrix_torch, k1_variant, k2_variant,
    mask_words,
    pack_bitmatrix, pack_crc_kernel_tables, pack_crc_tables, plane_major,
    unpack_bitmatrix)
from seaweedfs_tpu_torch.ops.coder_numpy import NumpyCoder

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

MIB = 1024 * 1024
U32 = np.uint32


def _shapes():
    """(id, plane-major bit matrix, in_rows, out_rows): both specialised
    shapes with their main-path matrices, and generic ones."""
    rs = codecs.get_codec("rs")
    out = [("parity_10x4", plane_major(rs.parity_bitmatrix(), 4, 10), 10, 4)]
    b, _ = rs.decode_bitmatrix(tuple(s for s in range(14) if s != 6), (6,))
    out.append(("read_10x1", plane_major(np.asarray(b), 1, 10), 10, 1))
    rng = np.random.default_rng(5)
    for k, r in ((12, 3), (20, 5), (5, 1)):
        out.append((f"random_{k}x{r}",
                    rng.integers(0, 2, (8 * r, 8 * k), dtype=np.uint8), k, r))
    return out


# ---------------------------------------------------------------------------
# Mask words
# ---------------------------------------------------------------------------

def _unfold_words(words, k, r):
    """Inverse of mask_words: the (8r, k) mask bytes."""
    b = words.view(np.uint8).reshape(-1, 4)[:, 0].reshape(8 * r, k)
    a1, a2 = b[:4 * r], b[4 * r:]
    lo = (a1 & 0x0F) | ((a2 & 0x0F) << 4)
    hi = (a1 & 0xF0) | (a2 >> 4)
    return np.concatenate([lo, hi])


@pytest.mark.parametrize("case", _shapes(), ids=lambda c: c[0])
def test_mask_words_round_trip(case):
    _, bmat, k, r = case
    masks = torch.from_numpy(pack_bitmatrix(bmat))
    words = mask_words(masks)
    assert words.dtype == U32 and words.shape == (8 * r * k,)
    # every word is one byte in all four byte lanes
    lanes = words.view(np.uint8).reshape(-1, 4)
    assert (lanes == lanes[:, :1]).all()
    back = _unfold_words(words, k, r)
    assert np.array_equal(back, masks.numpy())
    assert np.array_equal(unpack_bitmatrix(torch.from_numpy(back)).numpy(),
                          bmat)
    # word (s*r + i)*k + j, s < 4: low nibble from plane s, high nibble
    # from plane s + 4 of the same output row i and input row j
    s, i, j = 3, r - 1, k - 1
    a1 = int(words[(s * r + i) * k + j]) & 0xFF
    m = masks.numpy()
    assert a1 == (m[s * r + i, j] & 0x0F) | (m[(s + 4) * r + i, j] & 0xF0)


def test_kernel_masks_take_the_host_copy():
    masks = torch.from_numpy(pack_bitmatrix(_shapes()[0][1]))
    words, dev = _kernel_masks(masks, True, torch.device("cpu"))
    assert dev is None and np.array_equal(words, mask_words(masks))
    words, dev = _kernel_masks(masks, False, torch.device("cpu"))
    assert words is None and torch.equal(dev, masks)
    with pytest.raises(ValueError):
        _kernel_masks(masks.to("meta"), True, torch.device("cpu"))


# ---------------------------------------------------------------------------
# Merged parity and the per-word arithmetic
# ---------------------------------------------------------------------------

def _select(m, a, b):
    return (a & U32(m)) | (b & ~U32(m))


def merge_parity(t):
    """The three-level SWAR butterfly over 8 uint32 plane arrays t."""
    c = [_select(0x0F0F0F0F, t[s] ^ (t[s] >> U32(4)),
                 t[s + 4] ^ (t[s + 4] << U32(4))) for s in range(4)]
    d = [_select(0x33333333, c[s] ^ (c[s] >> U32(2)),
                 c[s + 2] ^ (c[s + 2] << U32(2))) for s in range(2)]
    return _select(0x55555555, d[0] ^ (d[0] >> U32(1)),
                   d[1] ^ (d[1] << U32(1)))


def _byte_parity_word(t):
    """Reference: bit s of byte b of the result = parity of byte b of t[s]."""
    out = np.zeros_like(t[0])
    for s in range(8):
        for b in range(4):
            byte = (t[s] >> U32(8 * b)) & U32(0xFF)
            par = np.array([bin(int(v)).count("1") & 1 for v in byte],
                           dtype=U32)
            out |= par << U32(8 * b + s)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_merged_parity_equals_per_byte_parity(seed):
    rng = np.random.default_rng(seed)
    t = [rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(U32)
         for _ in range(8)]
    assert np.array_equal(merge_parity(t), _byte_parity_word(t))
    # the corner words: all zero, all ones, one bit per plane
    for fill in (0, 0xFFFFFFFF):
        words = [np.full(1, fill, dtype=U32)] * 8
        assert np.array_equal(merge_parity(words), _byte_parity_word(words))
    one = [np.array([1 << (s + 8 * (s % 4))], dtype=U32) for s in range(8)]
    assert np.array_equal(merge_parity(one), _byte_parity_word(one))


def nibble_swap(x):
    return _select(0x0F0F0F0F, x >> U32(4), x << U32(4))


def merge_pairs(c):
    """numpy model of rsbm::merge_pairs: levels 2 and 1 of merge_parity."""
    d = [_select(0x33333333, c[s] ^ (c[s] >> U32(2)),
                 c[s + 2] ^ (c[s + 2] << U32(2))) for s in range(2)]
    return _select(0x55555555, d[0] ^ (d[0] >> U32(1)),
                   d[1] ^ (d[1] << U32(1)))


def test_first_level_folds_into_the_mask_words():
    """XOR_j (z & A1) ^ (swap(z) & A2) is the level-1 merge of planes s
    and s + 4, for random inputs and masks."""
    rng = np.random.default_rng(4)
    k, r = 10, 4
    masks = torch.from_numpy(rng.integers(0, 256, (8 * r, k), dtype=np.uint8))
    words = mask_words(masks)
    z = rng.integers(0, 1 << 32, (k, 512), dtype=np.uint64).astype(U32)
    rep = masks.numpy().astype(U32) * U32(0x01010101)
    for i in range(r):
        t = [np.bitwise_xor.reduce(z & rep[s * r + i][:, None], axis=0)
             for s in range(8)]
        for s in range(4):
            want = _select(0x0F0F0F0F, t[s] ^ (t[s] >> U32(4)),
                           t[s + 4] ^ (t[s + 4] << U32(4)))
            a1 = words[(s * r + i) * k:(s * r + i + 1) * k, None]
            a2 = words[((s + 4) * r + i) * k:((s + 4) * r + i + 1) * k, None]
            got = np.bitwise_xor.reduce((z & a1) ^ (nibble_swap(z) & a2),
                                        axis=0)
            assert np.array_equal(got, want)
        assert np.array_equal(
            merge_pairs([_select(0x0F0F0F0F, t[s] ^ (t[s] >> U32(4)),
                                 t[s + 4] ^ (t[s + 4] << U32(4)))
                         for s in range(4)]), merge_parity(t))


def _kernel_word_model(words, shards, k, r):
    """The kernels' arithmetic per 32-bit word (rsbm::mix_word): swap the
    nibbles of each input word, AND-XOR with the A1 and A2 mask words into
    4 plane pairs, then merge_pairs."""
    z = np.ascontiguousarray(shards).view("<u4")          # (k, n/4)
    y = nibble_swap(z)
    out = np.empty((r, z.shape[1]), dtype=U32)
    for i in range(r):
        c = []
        for s in range(4):
            acc = np.zeros(z.shape[1], dtype=U32)
            for j in range(k):
                acc ^= (z[j] & words[(s * r + i) * k + j]) \
                    ^ (y[j] & words[((s + 4) * r + i) * k + j])
            c.append(acc)
        out[i] = merge_pairs(c)
    return out.view(np.uint8)


@pytest.mark.parametrize("case", _shapes(), ids=lambda c: c[0])
def test_kernel_word_model_equals_pallas(case):
    _, bmat, k, r = case
    rng = np.random.default_rng(k * 10 + r)
    x = rng.integers(0, 256, (k, 2 * BLOCK_N), dtype=np.uint8)
    masks = torch.from_numpy(pack_bitmatrix(bmat))
    got = _kernel_word_model(mask_words(masks), x, k, r)
    want = np.asarray(apply_bitmatrix_pallas(
        jnp.asarray(bmat), jnp.asarray(x), r, k, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(
        apply_bitmatrix_torch(masks, torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------------------
# K2's CRC scheme
# ---------------------------------------------------------------------------

def _kernel_tables():
    byte_table, shifts = pack_crc_kernel_tables()
    shifts = shifts.view(U32).reshape(len(CRC_SHIFT_LENGTHS), 4, 256)
    return byte_table.view(U32), shifts


def _zshift(table, v):
    return (table[0][v & 0xFF] ^ table[1][(v >> U32(8)) & 0xFF]
            ^ table[2][(v >> U32(16)) & 0xFF] ^ table[3][v >> U32(24)])


def crc_kernel_model(rows: np.ndarray, positions=None) -> np.ndarray:
    """numpy model of rs_bitmatrix_crc.cu's CRC half: (R, n) uint8 ->
    (R, n // 4096) uint32 partials, with the kernel's tables, run and
    chain lengths, and combine order.  Tile t takes the position matrix
    positions[t] (default t mod tpb)."""
    byte_table, shifts = _kernel_tables()
    t = crc_fold.tables(BLOCK_N)
    pos = pack_crc_tables(t)[2].view(U32).reshape(t.tpb, 32)
    r, n = rows.shape
    nt = n // BLOCK_N
    chain = BLOCK_N // CRC_RUNS // CRC_CHAINS
    words = np.ascontiguousarray(rows).reshape(
        r, nt, CRC_RUNS, CRC_CHAINS, chain).view("<u4")
    c = np.zeros((r, nt, CRC_RUNS, CRC_CHAINS), dtype=U32)
    for w in range(chain // 4):            # one step per byte, per chain
        c ^= words[..., w]
        for _ in range(4):
            c = byte_table[c & 0xFF] ^ (c >> U32(8))
    v = c[..., 0]                          # Horner over the chains
    for h in range(1, CRC_CHAINS):
        v = _zshift(shifts[0], v) ^ c[..., h]
    q = np.arange(CRC_RUNS)                # the shuffle butterfly
    for lvl in range(4):
        z = _zshift(shifts[1 + lvl], v)
        v = np.where((q >> lvl) & 1, v, z)
        v = v ^ v[..., q ^ (1 << lvl)]
    assert (v == v[..., :1]).all(), "every lane holds the row's value"
    if positions is None:
        positions = np.arange(nt) % t.tpb
    pcols = pos[positions]                 # (nt, 32): P_(tile mod tpb)
    lane = np.zeros_like(v)
    for off in (0, 1):                     # lane q: columns 2q and 2q + 1
        b = 2 * q + off
        bit = (v >> b.astype(U32)) & U32(1)
        lane ^= np.where(bit == 1, pcols[None, :, b], U32(0))
    return np.bitwise_xor.reduce(lane, axis=-1)


def test_crc_tables_are_the_crc32c_algebra():
    byte_table, shifts = _kernel_tables()
    assert int(byte_table[0x80]) == 0x82F63B78  # reflected Castagnoli
    assert CRC_SHIFT_LENGTHS == (64, 256, 512, 1024, 2048)
    assert CRC_SHIFT_LENGTHS[0] * CRC_CHAINS * CRC_RUNS == BLOCK_N
    rng = np.random.default_rng(11)
    for lvl, m in enumerate(CRC_SHIFT_LENGTHS):
        for x in rng.integers(0, 1 << 32, 4, dtype=np.uint64):
            v = np.array([x], dtype=U32)
            assert int(_zshift(shifts[lvl], v)[0]) \
                == crc_fold._step(int(x), bytes(m))
    # joining two runs: step(0, AB) = Z^|B|(step(0, A)) ^ step(0, B)
    a, b = rng.bytes(300), rng.bytes(64)
    joined = _zshift(shifts[0], np.array([crc_fold._step(0, a)], dtype=U32))
    assert int(joined[0]) ^ crc_fold._step(0, b) == crc_fold._step(0, a + b)


@pytest.mark.parametrize("n_tiles", [3, 258])
def test_crc_kernel_model_equals_tile_partials(n_tiles):
    """Data rows and their parity rows; 3 tiles (indices 1 and 2 are not
    0 mod 256) and 258 tiles (a full 1 MiB block and two more, so tile
    256 wraps to position 0 and 257 to 1)."""
    rng = np.random.default_rng(n_tiles)
    data = rng.integers(0, 256, (10, n_tiles * BLOCK_N), dtype=np.uint8)
    rows = np.concatenate([data, NumpyCoder().encode(data)])
    got = crc_kernel_model(rows)
    assert np.array_equal(got, ref_crc_fold.tile_partials_np(rows, BLOCK_N))
    if n_tiles >= 256:
        folded = crc_fold.block_crcs_from_partials(got[0], MIB, BLOCK_N)
        assert folded == [crc32c(rows[0, :MIB].tobytes())]


def test_crc_kernel_model_on_edge_rows():
    """All-zero, all-ones and single-byte rows hit table entries 0, 0xff
    and the chain boundaries."""
    rows = np.zeros((4, 2 * BLOCK_N), dtype=np.uint8)
    rows[1] = 0xFF
    rows[2, 63] = 1
    rows[3, BLOCK_N + 255] = 0x80
    assert np.array_equal(crc_kernel_model(rows),
                          ref_crc_fold.tile_partials_np(rows, BLOCK_N))


def volume_tiles(volumes: int, ntiles: int, tpb: int):
    """The kernel's persistent walk over (volume, tile) pairs: for g in
    [0, V * ntiles), v = g // ntiles, tile = g % ntiles, and the position
    matrix of the tile within its volume."""
    g = np.arange(volumes * ntiles)
    v = g // ntiles
    tile = g - v * ntiles
    return v, tile, tile % tpb


def batched_crc_model(x: np.ndarray, flat_index: bool = False) -> np.ndarray:
    """(V, R, n) -> (V, R, n // 4096) partials, tiles visited in the
    kernel's g order; `flat_index` models the bug of positioning by g."""
    vols, rows, n = x.shape
    nt = n // BLOCK_N
    tpb = crc_fold.tables(BLOCK_N).tpb
    v, tile, pos = volume_tiles(vols, nt, tpb)
    if flat_index:
        pos = np.arange(vols * nt) % tpb
    tiles = x.reshape(vols, rows, nt, BLOCK_N)[v, :, tile]  # (g, R, 4096)
    flat = np.ascontiguousarray(tiles.transpose(1, 0, 2)).reshape(rows, -1)
    parts = crc_kernel_model(flat, positions=pos)           # (R, g)
    return parts.reshape(rows, vols, nt).transpose(1, 0, 2)


@pytest.mark.parametrize("ntiles", [3, 260])
def test_crc_volume_walk_resets_the_position_per_volume(ntiles):
    """Widths that are multiples of 4096 but not of 1 MiB: every
    volume's partials equal tile_partials_np of that volume alone, and a
    flat tile index would have put volumes 1 and 2 at the wrong block
    positions.  The port's plain K2 takes (V, k, n) alike."""
    rng = np.random.default_rng(ntiles)
    x = rng.integers(0, 256, (3, 5, ntiles * BLOCK_N), dtype=np.uint8)
    got = batched_crc_model(x)
    for v in range(3):
        assert np.array_equal(got[v],
                              ref_crc_fold.tile_partials_np(x[v], BLOCK_N))
    flat = batched_crc_model(x, flat_index=True)
    assert np.array_equal(flat[0], got[0])
    assert not np.array_equal(flat[1], got[1])
    consts = [torch.from_numpy(a) for a in pack_crc_tables(
        crc_fold.tables(BLOCK_N))]
    masks = torch.from_numpy(rng.integers(0, 256, (8, 5), dtype=np.uint8))
    _par, parts = apply_bitmatrix_crc(masks, torch.from_numpy(x), *consts)
    assert np.array_equal(parts.numpy().view(U32)[:, :5], got)


def test_crc_volume_walk_at_whole_blocks_cannot_show_the_bug():
    """At the batched path's whole-block widths (ntiles % 256 == 0) the
    flat and per-volume indices agree: why the walk is tested above."""
    v, tile, pos = volume_tiles(3, 512, 256)
    assert np.array_equal(pos, np.arange(3 * 512) % 256)
    v, tile, pos = volume_tiles(3, 260, 256)
    assert not np.array_equal(pos, np.arange(3 * 260) % 256)
    assert list(v[258:262]) == [0, 0, 1, 1] and list(tile[258:262]) == \
        [258, 259, 0, 1]


# ---------------------------------------------------------------------------
# Shape -> instantiation
# ---------------------------------------------------------------------------

def test_specialised_shapes_cover_the_main_path():
    assert (10, 4) in K1_SPECIALISED and (10, 1) in K1_SPECIALISED
    assert K2_SPECIALISED == ((10, 4),)
    assert K1_VARIANTS[k1_variant(10, 4)] == "10->4"
    assert K1_VARIANTS[k1_variant(10, 1)] == "10->1"
    assert K2_VARIANTS[k2_variant(10, 4)] == "10->4"


def test_every_other_shape_is_generic():
    for k in range(1, 33):
        for r in range(1, 33):
            v = k1_variant(k, r)
            if (k, r) in K1_SPECIALISED:
                assert v == K1_SPECIALISED.index((k, r))
            else:
                assert K1_VARIANTS[v] == ("generic<=16" if k <= 16
                                          else "generic<=32")
    for k in range(1, 17):
        for r in range(1, 17):
            if (k, r) not in K2_SPECIALISED:
                assert K2_VARIANTS[k2_variant(k, r)] == "generic<=16"
