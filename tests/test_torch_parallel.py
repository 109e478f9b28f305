"""The port's batched multi-volume codec and stream pipeline held against
seaweedfs_tpu's (parallel/sharded_codec.py, parallel/stream_pipeline.py).

`batched_*` run the kernels' plain versions here (CPU tensors); the JAX
functions run under JAX_PLATFORMS=cpu on their XLA path.  Everything is
exact integer math: parity, rebuilt shards and block CRCs must be equal.
A mesh of several CPU devices splits volumes and columns as a mesh of
cards would.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu import codecs as ref_codecs
from seaweedfs_tpu.core.crc import crc32c
from seaweedfs_tpu.parallel import sharded_codec as ref_sc
from seaweedfs_tpu.parallel.mesh import make_mesh as ref_make_mesh
from seaweedfs_tpu_torch.ops import crc_fold
from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix,
                                                apply_bitmatrix_crc)
from seaweedfs_tpu_torch.parallel import sharded_codec as sc
from seaweedfs_tpu_torch.parallel.mesh import MeshArray, make_mesh
from seaweedfs_tpu_torch.parallel.stream_pipeline import (PipelineRecorder,
                                                          run_pipeline)

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

MIB = 1024 * 1024
CPU = torch.device("cpu")


def _data(v: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (v, 10, n),
                                                dtype=np.uint8)


def _numpy_parity(data: np.ndarray) -> np.ndarray:
    from seaweedfs_tpu.ops.coder_numpy import NumpyCoder
    return NumpyCoder().encode(data)


def _lost(codec: str) -> tuple[int, ...]:
    return (3,) if codec == "lrc" else (1, 3, 9, 12)


def _stack(codec: str, full: np.ndarray):
    """(present, lost, used rows) of a loss pattern for a (V, 14, N)
    stack of every shard."""
    lost = _lost(codec)
    present = tuple(s for s in range(14) if s not in lost)
    _m, used = ref_codecs.get_codec(codec).decode_matrix(present, lost)
    return present, lost, np.ascontiguousarray(full[:, list(used)])


@pytest.mark.parametrize("v", [1, 3])
@pytest.mark.parametrize("codec", ["rs", "lrc"])
def test_batched_encode_and_reconstruct_equal_reference(codec, v):
    data = _data(v, 5000, v)
    parity = sc.batched_encode(data, codec=codec, device="cpu")
    assert isinstance(parity, torch.Tensor) and parity.shape == (v, 4, 5000)
    want = np.asarray(ref_sc.batched_encode(data, codec=codec))
    assert np.array_equal(parity.numpy(), want)
    full = np.concatenate([data, want], axis=1)
    present, lost, stacked = _stack(codec, full)
    rebuilt = sc.batched_reconstruct(stacked, present, lost, codec=codec,
                                     device="cpu")
    ref = np.asarray(ref_sc.batched_reconstruct(stacked, present, lost,
                                                codec=codec))
    assert np.array_equal(rebuilt.numpy(), ref)
    assert np.array_equal(rebuilt.numpy(), full[:, list(lost)])


@pytest.mark.parametrize("v", [1, 3])
@pytest.mark.parametrize("codec", ["rs", "lrc"])
def test_batched_with_crc_equal_reference(codec, v):
    """N = 1 MiB, one `.ecc` block: parity and CRCs of every row equal
    the JAX step's, and the crc32c of the bytes."""
    data = _data(v, MIB, 10 + v)
    parity, crcs = sc.batched_encode_with_crc(data, codec=codec,
                                              device="cpu")
    ref_parity, ref_crcs = ref_sc.batched_encode_with_crc(data, codec=codec)
    assert np.array_equal(parity.numpy(), np.asarray(ref_parity))
    assert crcs.dtype == np.uint32 and crcs.shape == (v, 14, 1)
    assert np.array_equal(crcs, np.asarray(ref_crcs))
    full = np.concatenate([data, parity.numpy()], axis=1)
    assert int(crcs[v - 1, 13, 0]) == crc32c(full[v - 1, 13].tobytes())
    present, lost, stacked = _stack(codec, full)
    rebuilt, rcrcs = sc.batched_reconstruct_with_crc(
        stacked, present, lost, codec=codec, device="cpu")
    ref_rebuilt, ref_rcrcs = ref_sc.batched_reconstruct_with_crc(
        stacked, present, lost, codec=codec)
    assert np.array_equal(rebuilt.numpy(), np.asarray(ref_rebuilt))
    assert rcrcs.shape == (v, len(lost), 1)
    assert np.array_equal(rcrcs, np.asarray(ref_rcrcs))


def test_mesh_split_equals_no_mesh():
    """A 2 x 2 mesh of CPU devices: volumes over "vol", columns over
    "col", one block per device; the assembled results equal the
    unsplit step.  The CRC step on a 1 x 2 mesh: each device folds the
    `.ecc` blocks of its own columns."""
    mesh = make_mesh(devices=[CPU] * 4, vol_axis=2)
    assert mesh.shape == {"vol": 2, "col": 2}
    data = _data(2, 2 * 8192, 7)
    parity = sc.batched_encode(data, mesh)
    assert isinstance(parity, MeshArray) and len(parity.blocks) == 4
    assert parity.blocks[(1, 1)].shape == (1, 4, 8192)
    want = sc.batched_encode(data, device="cpu").numpy()
    assert np.array_equal(np.asarray(parity), want)
    full = np.concatenate([data, want], axis=1)
    present, lost, stacked = _stack("rs", full)
    r_mesh = sc.batched_reconstruct(stacked, present, lost, mesh)
    assert np.array_equal(np.asarray(r_mesh), full[:, list(lost)])
    data = _data(1, 2 * MIB, 8)
    p_mesh, c_mesh = sc.batched_encode_with_crc(
        data, make_mesh(devices=[CPU] * 2, vol_axis=1))
    full = np.concatenate([data, np.asarray(p_mesh)], axis=1)
    assert np.array_equal(full[0, 10:], _numpy_parity(data[0]))
    assert c_mesh.shape == (1, 14, 2)
    for r, b in itertools.product(range(14), range(2)):
        assert int(c_mesh[0, r, b]) == crc32c(
            full[0, r, b * MIB:(b + 1) * MIB].tobytes())


def test_divisibility_errors_match_reference():
    mesh = make_mesh(devices=[CPU] * 4, vol_axis=2)
    ref_mesh = ref_make_mesh(4, vol_axis=2)
    cases = [(_data(3, 512, 1), {}),            # 3 volumes over vol 2
             (_data(2, 513, 2), {}),            # odd width over col 2
             (_data(2, MIB, 3), {"crc": True})]  # 1 MiB over 2 x 1 MiB
    for data, kw in cases:
        fn, ref_fn = ((sc.batched_encode_with_crc,
                       ref_sc.batched_encode_with_crc) if kw
                      else (sc.batched_encode, ref_sc.batched_encode))
        with pytest.raises(ValueError) as e_ref:
            ref_fn(data, ref_mesh)
        with pytest.raises(ValueError) as e_mine:
            fn(data, mesh)
        assert str(e_mine.value) == str(e_ref.value)
    with pytest.raises(ValueError) as e_ref:
        ref_sc.batched_reconstruct(_data(1, 64, 4)[:, :9], tuple(range(4, 14)),
                                   (0, 1, 2, 3))
    with pytest.raises(ValueError) as e_mine:
        sc.batched_reconstruct(_data(1, 64, 4)[:, :9], tuple(range(4, 14)),
                               (0, 1, 2, 3), device="cpu")
    assert str(e_mine.value) == str(e_ref.value)


def test_batched_steps_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.batched_encode(_data(1, 64, 5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_batched_steps_make_no_distributed_calls(monkeypatch):
    """The counterpart of the reference's zero-collectives HLO check:
    no torch.distributed function runs in a batched step on a mesh."""
    import torch.distributed as dist
    calls = []
    for name in dir(dist):
        fn = getattr(dist, name)
        if callable(fn) and not isinstance(fn, type) \
                and not name.startswith("_"):
            monkeypatch.setattr(dist, name, lambda *a, _n=name, **k:
                                calls.append(_n))
    mesh = make_mesh(devices=[CPU] * 2, vol_axis=2)
    data = _data(2, MIB, 6)
    parity, _ = sc.batched_encode_with_crc(data, mesh)
    full = np.concatenate([data, np.asarray(parity)], axis=1)
    present, lost, stacked = _stack("rs", full)
    np.asarray(sc.batched_reconstruct(stacked, present, lost,
                                      make_mesh(devices=[CPU] * 4,
                                                vol_axis=2)))
    assert calls == []


def test_one_launch_per_step_and_device(monkeypatch):
    """Each batched step calls its kernel wrapper once per mesh device,
    with that device's volumes as one (V, rows, n) block."""
    from seaweedfs_tpu_torch.parallel import sharded_codec
    seen = []

    def k1(masks, x):
        seen.append(("k1", tuple(x.shape)))
        return apply_bitmatrix(masks, x)

    def k2(masks, x, *consts):
        seen.append(("k2", tuple(x.shape)))
        return apply_bitmatrix_crc(masks, x, *consts)

    monkeypatch.setattr(sharded_codec, "apply_bitmatrix", k1)
    monkeypatch.setattr(sharded_codec, "apply_bitmatrix_crc", k2)
    sc.batched_encode(_data(4, 4096, 8), device="cpu")
    assert seen == [("k1", (4, 10, 4096))]
    seen.clear()
    mesh = make_mesh(devices=[CPU] * 2, vol_axis=2)
    sc.batched_encode_with_crc(_data(2, MIB, 9), mesh)
    assert seen == [("k2", (1, 10, MIB))] * 2


def test_block_crc_fold_batched_equals_single_row():
    rng = np.random.default_rng(13)
    parts = rng.integers(0, 1 << 32, (3, 14, 2 * 256 + 7),
                         dtype=np.uint64).astype(np.uint32)
    got = crc_fold.block_crcs_from_partials_batched(parts, 2 * MIB, 4096)
    assert got.shape == (3, 14, 2) and got.dtype == np.uint32
    for v, r in itertools.product(range(3), range(14)):
        assert list(got[v, r]) == crc_fold.block_crcs_from_partials(
            parts[v, r], 2 * MIB, 4096)
    same = crc_fold.block_crcs_from_partials_batched(parts.view(np.int32),
                                                     2 * MIB, 4096)
    assert np.array_equal(same, got)


# ---------------------------------------------------------------------------
# The stream pipeline (mirrors tests/test_ecpipe.py's overlap tests)
# ---------------------------------------------------------------------------

def test_pipeline_issues_next_h2d_before_prev_device_completes():
    """Draining chunk k blocks until dispatch(k+1) has been recorded: a
    serialized pipeline would deadlock here (bounded by the timeout)."""
    counter = itertools.count()
    rec = PipelineRecorder(clock=lambda: next(counter))
    n_items = 6
    drained = []

    def drain(handle):
        if handle < n_items - 1:
            assert rec.wait_for("dispatched", handle + 1, timeout=30.0), \
                f"next H2D never issued while chunk {handle} in flight"
        drained.append(handle)

    n = run_pipeline(range(n_items), dispatch=lambda x: x, drain=drain,
                     depth=2, recorder=rec)
    assert n == n_items and drained == list(range(n_items))
    for k in range(n_items - 1):
        assert rec.first_time("dispatched", k + 1) < \
            rec.first_time("drained", k)


def test_pipeline_depth0_is_serialized():
    counter = itertools.count()
    rec = PipelineRecorder(clock=lambda: next(counter))
    run_pipeline(range(3), dispatch=lambda x: x, drain=lambda h: None,
                 depth=0, recorder=rec)
    for k in range(2):
        assert rec.first_time("drained", k) < \
            rec.first_time("dispatched", k + 1)


def test_pipeline_error_paths_no_deadlock():
    with pytest.raises(RuntimeError, match="boom"):
        run_pipeline(range(100), dispatch=lambda x: x,
                     drain=lambda h: (_ for _ in ()).throw(
                         RuntimeError("boom")), depth=2)

    def gen():
        yield 1
        raise ValueError("genfail")
    with pytest.raises(ValueError, match="genfail"):
        run_pipeline(gen(), dispatch=lambda x: x,
                     drain=lambda h: None, depth=2)
    with pytest.raises(ZeroDivisionError):
        run_pipeline(range(10), dispatch=lambda x: 1 // 0,
                     drain=lambda h: None, depth=2)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("ecpipe-")]


def test_recorder_stage_sums_and_occupancy():
    rec = PipelineRecorder()
    rec.note_span("stack", 0, 0.0, 1.0)
    rec.note_span("device", 0, 0.5, 2.0)
    rec.note_span("drain", 0, 2.0, 2.5)
    rec.note_span("device", 1, 1.5, 3.0)
    assert rec.stage_seconds() == {"stack": 1.0, "device": 3.0, "drain": 0.5}
    occ = rec.device_occupancy()
    assert occ["busy_seconds"] == 2.5 and occ["window"] == [0.0, 3.0]
    assert rec.bubble_attribution()["by_stage"] == {"stack": 0.5}
