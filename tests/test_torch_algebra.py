"""The PyTorch port's host algebra held against seaweedfs_tpu, exactly.

GF(2^8) tables, generator matrices, parity and decode bit-matrices with
their `used` read sets, the codec built from a handed-over generator
matrix, the kernels' mask packing and the fused-CRC constants.  All of
it is integer math: every comparison is equality.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from seaweedfs_tpu import codecs as ref_codecs
from seaweedfs_tpu.ops import crc_fold as ref_crc_fold
from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops import rs_bitmatrix as ref_rsb
from seaweedfs_tpu.ops.coder_jax import plane_major as ref_plane_major
from seaweedfs_tpu_torch import codecs
from seaweedfs_tpu_torch.ops import crc_fold, gf256, rs_bitmatrix
from seaweedfs_tpu_torch.ops.coder_cuda import (_unpack_words,
                                                pack_bitmatrix,
                                                pack_crc_tables, plane_major,
                                                unpack_bitmatrix)

pytestmark = pytest.mark.torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests in other files must not lose their cores.
torch.set_num_threads(1)

SCHEMES = [(10, 4, "vandermonde"), (8, 3, "vandermonde"),
           (16, 4, "vandermonde"), (10, 4, "cauchy"), (8, 3, "cauchy"),
           (16, 4, "cauchy")]


def _scheme_id(s):
    return f"rs{s[0]}_{s[1]}_{s[2]}"


def test_gf256_tables_equal():
    assert np.array_equal(gf256.GF_EXP, ref_gf256.GF_EXP)
    assert np.array_equal(gf256.GF_LOG, ref_gf256.GF_LOG)
    assert np.array_equal(gf256.MUL_TABLE, ref_gf256.MUL_TABLE)


@pytest.mark.parametrize("scheme", SCHEMES, ids=_scheme_id)
def test_generator_and_parity_bitmatrix_equal(scheme):
    k, p, kind = scheme
    mine, ref = codecs.rs_codec(k, p, kind), ref_codecs.rs_codec(k, p, kind)
    assert mine.name == ref.name
    assert np.array_equal(mine.matrix, ref.matrix)
    assert np.array_equal(mine.parity_bitmatrix(), ref.parity_bitmatrix())
    assert np.array_equal(plane_major(mine.parity_bitmatrix(), p, k),
                          ref_plane_major(ref.parity_bitmatrix(), p, k))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scheme", SCHEMES, ids=_scheme_id)
def test_decode_bitmatrix_and_used_equal(scheme, seed):
    k, p, kind = scheme
    rng = np.random.default_rng(seed)
    total = k + p
    mine, ref = codecs.rs_codec(k, p, kind), ref_codecs.rs_codec(k, p, kind)
    lost = int(rng.integers(1, p + 1))
    present = tuple(sorted(int(s) for s in rng.choice(total, total - lost,
                                                      replace=False)))
    wanted = tuple(s for s in range(total) if s not in present)
    b_mine, used_mine = mine.decode_bitmatrix(present, wanted)
    b_ref, used_ref = ref.decode_bitmatrix(present, wanted)
    assert used_mine == used_ref
    assert np.array_equal(b_mine, b_ref)
    assert mine.repair_plan(present, wanted) == \
        [codecs.RepairRead(r.sid, r.reads, r.local)
         for r in ref.repair_plan(present, wanted)]


def test_decode_refuses_too_few_survivors_like_reference():
    mine, ref = codecs.get_codec("rs"), ref_codecs.get_codec("rs")
    present = tuple(range(9))
    with pytest.raises(ValueError) as e_mine:
        mine.decode_matrix(present, (9,))
    with pytest.raises(ValueError) as e_ref:
        ref.decode_matrix(present, (9,))
    assert str(e_mine.value) == str(e_ref.value)


def test_only_rs_is_registered():
    """The registry holds exactly the reference's codecs: rs and, since
    the LRC slice, lrc; any other name raises."""
    assert codecs.codec_names() == ref_codecs.codec_names() == ["lrc", "rs"]
    with pytest.raises(ValueError):
        codecs.get_codec("lrc3")


@pytest.mark.parametrize("scheme", SCHEMES, ids=_scheme_id)
def test_codec_from_reference_rs(scheme):
    k, p, kind = scheme
    ref = ref_codecs.rs_codec(k, p, kind)
    mine = codecs.codec_from_reference(ref.name, np.asarray(ref.matrix), k,
                                       matrix_kind=kind)
    assert mine.name == ref.name and mine.total_shards == k + p
    assert np.array_equal(mine.parity_bitmatrix(), ref.parity_bitmatrix())


def test_codec_from_reference_refuses_a_foreign_matrix():
    ref = ref_codecs.rs_codec(10, 4, "cauchy")
    with pytest.raises(ValueError):
        codecs.codec_from_reference("x", np.asarray(ref.matrix), 10,
                                    matrix_kind="vandermonde")


def _port_lrc():
    ref = ref_codecs.get_codec("lrc")
    groups = tuple(codecs.LocalGroup(g.data, g.parity) for g in ref.locality)
    return ref, codecs.codec_from_reference(
        "lrc", np.asarray(ref.matrix), ref.data_shards, locality=groups,
        tolerance=ref.tolerance, matrix_kind=ref.matrix_kind)


@pytest.mark.parametrize("lost", [(0,), (3,), (10,), (12,), (1, 7),
                                  (2, 11), (0, 5, 12, 13)])
def test_codec_from_reference_lrc_solver_equal(lost):
    """The generic solver is kept whole: an LRC built from the handed-over
    generator matrix plans and decodes exactly as seaweedfs_tpu's."""
    ref, mine = _port_lrc()
    present = tuple(s for s in range(ref.total_shards) if s not in lost)
    got = mine.repair_plan(present, list(lost))
    want = ref.repair_plan(present, list(lost))
    assert [(r.sid, r.reads, r.local) for r in got] == \
        [(r.sid, r.reads, r.local) for r in want]
    b_mine, u_mine = mine.decode_bitmatrix(present, lost)
    b_ref, u_ref = ref.decode_bitmatrix(present, lost)
    assert u_mine == u_ref and np.array_equal(b_mine, b_ref)


@pytest.mark.parametrize("c", [0, 1, 2, 0x1D, 0x8E, 0xFF])
def test_mul_bitmatrix_equal(c):
    assert np.array_equal(rs_bitmatrix.mul_bitmatrix(c),
                          ref_rsb.mul_bitmatrix(c))


@pytest.mark.parametrize("rows,cols", [(4, 10), (1, 10), (3, 8), (4, 16),
                                       (2, 5)])
def test_pack_bitmatrix_round_trip(rows, cols):
    rng = np.random.default_rng(rows * 100 + cols)
    bmat = rng.integers(0, 2, (8 * rows, 8 * cols), dtype=np.uint8)
    masks = pack_bitmatrix(bmat)
    assert masks.shape == (8 * rows, cols)
    back = unpack_bitmatrix(torch.from_numpy(masks)).numpy()
    assert np.array_equal(back, bmat)
    # bit s of masks[q, j] is column s*cols + j
    q, j, s = 3, cols - 1, 5
    assert (masks[q, j] >> s) & 1 == bmat[q, s * cols + j]


def test_crc_fold_tables_equal():
    mine, ref = crc_fold.tables(4096), ref_crc_fold.tables(4096)
    for name in ("w0", "planes", "planes_t", "posmats", "posmats_t"):
        assert np.array_equal(getattr(mine, name), getattr(ref, name)), name
    assert mine.block_const == ref.block_const and mine.tpb == ref.tpb


def test_pack_crc_tables_unpack_to_the_tables():
    t = crc_fold.tables(4096)
    w0, plane_cols, pos_cols = (torch.from_numpy(a)
                                for a in pack_crc_tables(t))
    assert np.array_equal(_unpack_words(w0).numpy(), t.w0)
    planes_t = _unpack_words(plane_cols.reshape(8, 32)).numpy()
    assert np.array_equal(planes_t, t.planes.transpose(0, 2, 1))
    pos_t = _unpack_words(pos_cols.reshape(t.tpb, 32)).numpy()
    assert np.array_equal(pos_t, t.posmats.transpose(0, 2, 1))


@pytest.mark.parametrize("tile,block", list(itertools.product(
    [512, 4096], [4096, 1 << 20])))
def test_tile_partials_np_equal(tile, block):
    rng = np.random.default_rng(tile + block)
    rows = rng.integers(0, 256, (3, 2 * max(block, tile)), dtype=np.uint8)
    assert np.array_equal(crc_fold.tile_partials_np(rows, tile, block),
                          ref_crc_fold.tile_partials_np(rows, tile, block))


# ---------------------------------------------------------------------------
# The registered LRC(10,2,2)
# ---------------------------------------------------------------------------

def test_lrc_codec_equal():
    from seaweedfs_tpu.codecs import lrc as ref_lrc
    from seaweedfs_tpu.ops import lrc_bitmatrix as ref_lrcb
    from seaweedfs_tpu_torch.codecs import lrc
    from seaweedfs_tpu_torch.ops import lrc_bitmatrix
    mine, ref = codecs.get_codec("lrc"), ref_codecs.get_codec("lrc")
    assert mine is lrc.LRC_10_2_2
    assert np.array_equal(mine.matrix, ref.matrix)
    assert np.array_equal(lrc.lrc_matrix(), ref_lrc.lrc_matrix())
    assert (mine.data_shards, mine.parity_shards, mine.tolerance) == \
        (ref.data_shards, ref.parity_shards, ref.tolerance)
    assert [(g.data, g.parity) for g in mine.locality] == \
        [(g.data, g.parity) for g in ref.locality]
    assert (lrc.GLOBALS, lrc.GROUP_A.members, lrc.GROUP_B.members) == \
        (ref_lrc.GLOBALS, ref_lrc.GROUP_A.members, ref_lrc.GROUP_B.members)
    assert np.array_equal(mine.parity_bitmatrix(), ref.parity_bitmatrix())
    assert np.array_equal(lrc_bitmatrix.parity_bitmatrix(),
                          ref_lrcb.parity_bitmatrix())
    assert np.array_equal(plane_major(mine.parity_bitmatrix(), 4, 10),
                          ref_plane_major(ref.parity_bitmatrix(), 4, 10))
    b, u = lrc_bitmatrix.decode_bitmatrix(tuple(range(1, 14)), (0,))
    b_ref, u_ref = ref_lrcb.decode_bitmatrix(tuple(range(1, 14)), (0,))
    assert u == u_ref and np.array_equal(b, b_ref)
    for sid in range(14):
        assert mine.min_repair_reads(sid) == ref.min_repair_reads(sid)


def _lrc_pattern_equal(lost: tuple[int, ...]) -> None:
    """Bit-matrices, `used` sets and repair plans for one loss pattern
    equal the reference's, or both refuse the pattern alike."""
    mine, ref = codecs.get_codec("lrc"), ref_codecs.get_codec("lrc")
    present = tuple(s for s in range(14) if s not in lost)
    try:
        b_ref, u_ref = ref.decode_bitmatrix(present, lost)
    except ValueError as e_ref:
        with pytest.raises(ValueError) as e_mine:
            mine.decode_bitmatrix(present, lost)
        assert str(e_mine.value) == str(e_ref)
        with pytest.raises(ValueError):
            mine.repair_plan(present, list(lost))
        return
    b_mine, u_mine = mine.decode_bitmatrix(present, lost)
    assert u_mine == u_ref, lost
    assert np.array_equal(b_mine, b_ref), lost
    assert [(r.sid, r.reads, r.local)
            for r in mine.repair_plan(present, list(lost))] == \
        [(r.sid, r.reads, r.local) for r in ref.repair_plan(present, list(lost))]


@pytest.mark.parametrize("first", range(12))
def test_lrc_every_three_loss_pattern_equal(first):
    """All C(14,3) = 364 three-loss patterns, grouped by their lowest
    lost shard: each decodes, exactly as the reference decodes it."""
    mine = codecs.get_codec("lrc")
    for rest in itertools.combinations(range(first + 1, 14), 2):
        lost = (first, *rest)
        _lrc_pattern_equal(lost)
        present = tuple(s for s in range(14) if s not in lost)
        mine.decode_matrix(present, lost)  # decodable: tolerance 3


def test_lrc_one_per_group_and_both_globals_equal():
    for a in range(5):
        for b in range(5, 10):
            _lrc_pattern_equal((a, b, 12, 13))
    _lrc_pattern_equal((3, 7, 10, 11))


def test_lrc_undecodable_patterns_raise_in_both():
    """Four losses in one local group exceed the code: both packages
    refuse them with the same message."""
    mine, ref = codecs.get_codec("lrc"), ref_codecs.get_codec("lrc")
    for lost in [(0, 1, 2, 3), (5, 6, 7, 8), (1, 2, 3, 10), (0, 1, 12, 13)]:
        present = tuple(s for s in range(14) if s not in lost)
        with pytest.raises(ValueError) as e_ref:
            ref.decode_matrix(present, lost)
        with pytest.raises(ValueError) as e_mine:
            mine.decode_matrix(present, lost)
        assert str(e_mine.value) == str(e_ref.value)
        _lrc_pattern_equal(lost)
