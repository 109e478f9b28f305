"""The port's multi-card reconstructions (X4: `all_to_all_reconstruct`,
`ring_reconstruct` in `parallel/sharded_codec.py`, `shard_row_block` in
`parallel/mesh.py`) held against the JAX package's.

Each case of tests/test_parallel.py that drives X4 runs here twice: the
JAX package's function on its virtual CPU mesh (the shard rows over the
mesh's "col" axis of D devices), and the port's over `torch.distributed`
in D spawned gloo ranks on the CPU (`_torch_x4`), each holding its
whole shard rows.  Every rank's column block, and the output gathered
from them, must be byte-equal to the JAX package's output (and to the
shards the numpy oracle encoded); a layout the reference refuses, the
port refuses on every rank with the same ValueError message.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import _torch_x4
from seaweedfs_tpu.ops.coder_numpy import NumpyCoder
from seaweedfs_tpu.parallel import sharded_codec as ref_sc
from seaweedfs_tpu.parallel.mesh import make_mesh as ref_make_mesh
from seaweedfs_tpu_torch.parallel import mesh as port_mesh

pytestmark = pytest.mark.torch

ORACLE = NumpyCoder(10, 4)


def _volumes(v, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (v, 10, n)).astype(np.uint8)


def _survivors(v, n, seed, lost):
    data = _volumes(v, n, seed)
    present = tuple(s for s in range(14) if s not in lost)
    shards = np.stack([ORACLE.encode_all(data[i]) for i in range(v)])
    return shards, present, np.ascontiguousarray(
        shards[:, list(present[:10]), :])


def _ref_mesh(d: int):
    if d == 2:
        return ref_make_mesh(8, vol_axis=4)
    devs = np.array(jax.devices()[:d]).reshape(1, d)
    return jax.sharding.Mesh(devs, ("vol", "col"))


# (function, volumes, width, seed, lost shards, ranks D): the cases of
# tests/test_parallel.py that drive X4.
CASES = {
    "test_all_to_all_reconstruct": (
        "all_to_all_reconstruct", 4, 512, 3, (2, 7, 10, 12), 2),
    "test_ring_reconstruct_matches_oracle": (
        "ring_reconstruct", 4, 512, 5, (1, 6, 11, 13), 2),
    "test_ring_reconstruct_single_lost_shard": (
        "ring_reconstruct", 4, 640, 6, (4,), 2),
    "test_ring_reconstruct_deeper_ring": (
        "ring_reconstruct", 1, 500, 7, (0, 13), 5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_x4_case_in_both_packages(case, tmp_path):
    fn, v, n, seed, lost, d = CASES[case]
    shards, present, stacked = _survivors(v, n, seed, lost)
    ref = np.asarray(getattr(ref_sc, fn)(stacked, present, lost,
                                         _ref_mesh(d)))
    assert ref.shape == (v, len(lost), n)
    assert np.array_equal(ref, shards[:, list(lost)])
    got = _torch_x4.run(fn, d, stacked, present, lost, tmp_path)
    chunk = n // d
    for rank in range(d):
        assert np.array_equal(got["whole"][rank], ref), rank
        assert np.array_equal(got["local"][rank],
                              ref[:, :, rank * chunk:(rank + 1) * chunk])


@pytest.mark.parametrize("fn", ["all_to_all_reconstruct",
                                "ring_reconstruct"])
def test_x4_validates_divisibility_in_both_packages(fn, tmp_path):
    """tests/test_parallel.py's `test_all_to_all_validates_divisibility`
    and `test_ring_reconstruct_validates_divisibility`: a col axis of 4
    ranks does not divide 10 data shards."""
    data = _volumes(2, 512, 4)
    with pytest.raises(ValueError, match="divide") as ref:
        getattr(ref_sc, fn)(data, tuple(range(10)), (10,),
                            ref_make_mesh(8, vol_axis=2))
    got = _torch_x4.run(fn, 4, data, tuple(range(10)), (10,), tmp_path)
    assert got["errors"] == [str(ref.value)] * 4


def test_x4_validates_survivor_rows_and_width(tmp_path):
    """The other two refusals of the shared prologue: a stack without
    the data_shards survivor rows, and a width that does not split over
    the ranks."""
    data = _volumes(1, 512, 8)
    for stacked, n in ((data[:, :9], 512), (_volumes(1, 511, 8), 511)):
        with pytest.raises(ValueError) as ref:
            ref_sc.ring_reconstruct(stacked, tuple(range(10)), (10,),
                                    ref_make_mesh(8, vol_axis=4))
        got = _torch_x4.run("ring_reconstruct", 2, stacked,
                            tuple(range(10)), (10,), tmp_path / str(n))
        assert got["errors"] == [str(ref.value)] * 2


def test_shard_row_block_is_the_col_axis_placement():
    """shard_row_block gives each rank the rows the JAX package's
    shard_row_sharding places on that column of the mesh."""
    from seaweedfs_tpu.parallel.mesh import shard_row_sharding
    data = _volumes(4, 64, 9)
    mesh = ref_make_mesh(8, vol_axis=4)
    placed = jax.device_put(data, shard_row_sharding(mesh))
    for shard in placed.addressable_shards:
        col = int(np.argwhere(mesh.devices == shard.device)[0][1])
        vols = shard.index[0]
        assert np.array_equal(
            np.asarray(shard.data),
            port_mesh.shard_row_block(data, col, 2)[vols])
