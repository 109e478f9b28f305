"""The port's kernels, through their plain PyTorch versions on the CPU,
held against seaweedfs_tpu's Pallas kernels (interpret mode) and the
NumpyCoder oracle.

K1 (`apply_bitmatrix`) and K2 (`apply_bitmatrix_crc`) dispatch to their
plain versions for CPU tensors; the CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.  All of it
is exact integer math, so the tolerance is zero: bytes and CRC words
must be identical.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu import codecs as ref_codecs
from seaweedfs_tpu.ops import crc_fold as ref_crc_fold
from seaweedfs_tpu.ops.coder_jax import plane_major as ref_plane_major
from seaweedfs_tpu.ops.coder_numpy import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu.ops.coder_pallas import (apply_bitmatrix_crc_pallas,
                                            apply_bitmatrix_pallas)
from seaweedfs_tpu_torch import codecs
from seaweedfs_tpu_torch.core.crc import crc32c
from seaweedfs_tpu_torch.ops import crc_fold
from seaweedfs_tpu_torch.ops.coder_cuda import (BLOCK_N, CudaCoder,
                                                apply_bitmatrix,
                                                apply_bitmatrix_crc,
                                                pack_bitmatrix,
                                                pack_crc_tables, pad_to_block,
                                                plane_major)
from seaweedfs_tpu_torch.ops.coder_numpy import NumpyCoder
from seaweedfs_tpu_torch.ops.erasure import host_array, new_coder

pytestmark = pytest.mark.torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests in other files must not lose their cores.
torch.set_num_threads(1)

MIB = 1024 * 1024


def _masks(bmat_pm: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(pack_bitmatrix(bmat_pm))


def _pallas_k1(bmat_pm, x, out_rows):
    return np.asarray(apply_bitmatrix_pallas(
        jnp.asarray(bmat_pm), jnp.asarray(x), out_rows, x.shape[0],
        interpret=True))


def _cases():
    """(id, plane-major bit matrix, out_rows, in_rows) on the main path's
    matrix kinds: RS parity, decode for a survivor set, wider schemes."""
    out = []
    rs = codecs.get_codec("rs")
    out.append(("rs_parity", plane_major(rs.parity_bitmatrix(), 4, 10), 4, 10))
    b, used = rs.decode_bitmatrix((0, 2, 4, 5, 6, 7, 8, 10, 11, 13),
                                  (1, 3, 9, 12))
    out.append(("rs_rebuild", plane_major(np.asarray(b), 4, 10), 4, 10))
    b, used = rs.decode_bitmatrix(tuple(s for s in range(14) if s != 6),
                                  (6,))
    out.append(("rs_degraded_read", plane_major(np.asarray(b), 1, 10), 1, 10))
    r16 = codecs.rs_codec(16, 4, "cauchy")
    out.append(("rs16_parity", plane_major(r16.parity_bitmatrix(), 4, 16),
                4, 16))
    return out


@pytest.mark.parametrize("width", [BLOCK_N, 3 * BLOCK_N])
@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_k1_plain_equals_pallas(case, width):
    _, bmat_pm, out_rows, in_rows = case
    rng = np.random.default_rng(width + in_rows)
    x = rng.integers(0, 256, (in_rows, width), dtype=np.uint8)
    got = apply_bitmatrix(_masks(bmat_pm), torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8 and got.shape == (out_rows, width)
    assert np.array_equal(got, _pallas_k1(bmat_pm, x, out_rows))


def test_k2_plain_equals_pallas():
    """n = 2 MiB + 4096: two full `.ecc` blocks plus a partial tile
    group, the shape of tests/test_ecpipe.py's fused case."""
    n = 2 * MIB + 4096
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (10, n), dtype=np.uint8)
    rs = codecs.get_codec("rs")
    bmat_pm = plane_major(rs.parity_bitmatrix(), 4, 10)
    t = crc_fold.tables(4096)
    consts = [torch.from_numpy(a) for a in pack_crc_tables(t)]
    parity, parts = apply_bitmatrix_crc(_masks(bmat_pm), torch.from_numpy(x),
                                        *consts)
    assert parts.dtype == torch.int32 and parts.shape == (14, n // 4096)
    ref_t = ref_crc_fold.tables(4096)
    ref_parity, ref_parts = apply_bitmatrix_crc_pallas(
        jnp.asarray(bmat_pm), jnp.asarray(x), jnp.asarray(ref_t.w0),
        jnp.asarray(ref_t.planes_t), jnp.asarray(ref_t.posmats_t), 4, 10,
        interpret=True)
    assert np.array_equal(parity.numpy(), np.asarray(ref_parity))
    assert np.array_equal(parts.numpy().view(np.uint32),
                          np.asarray(ref_parts))


def test_k2_folds_to_crc32c_with_ragged_tail():
    """encode_with_crc's partials fold to the crc32c of every `.ecc`
    block of every data and parity row; the ragged tail goes to the CPU
    fold (the encoder's path)."""
    n = 2 * MIB + 4096
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (10, n), dtype=np.uint8)
    coder = CudaCoder(device="cpu")
    assert coder.fused_crc_ok
    parity, parts = coder.encode_with_crc(data)
    parity, parts = host_array(parity), host_array(parts).view(np.uint32)
    assert np.array_equal(parity, RefNumpyCoder().encode(data))
    rows = np.concatenate([data, parity])
    for r in range(rows.shape[0]):
        acc = crc_fold.FusedCrcAccumulator(coder.block_n)
        acc.feed_tiles(parts[r], 2 * MIB)
        acc.feed_bytes(rows[r, 2 * MIB:].tobytes())
        want = [crc32c(rows[r, b * MIB:(b + 1) * MIB].tobytes())
                for b in range(2)] + [crc32c(rows[r, 2 * MIB:].tobytes())]
        assert acc.finalize() == want, f"row {r}"


@pytest.mark.parametrize("n", [1, 15, 4095, 4097, 10000])
def test_coder_encode_ragged_widths(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (10, n), dtype=np.uint8)
    coder = new_coder(device="cpu")
    want = RefNumpyCoder().encode(data)
    assert np.array_equal(host_array(coder.encode(data)), want)
    full = host_array(coder.encode_all(data))
    assert np.array_equal(full, np.concatenate([data, want]))
    assert np.array_equal(NumpyCoder().encode(data), want)


@pytest.mark.parametrize("seed", range(6))
def test_coder_reconstruct_random_survivors(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 3 * BLOCK_N))
    data = rng.integers(0, 256, (10, n), dtype=np.uint8)
    full = RefNumpyCoder().encode_all(data)
    lost = sorted(int(s) for s in rng.choice(14, int(rng.integers(1, 5)),
                                             replace=False))
    have = {s: full[s] for s in range(14) if s not in lost}
    coder = CudaCoder(device="cpu")
    got = coder.reconstruct(have)
    assert sorted(got) == lost
    ref = RefNumpyCoder().reconstruct(have)
    for s in lost:
        assert np.array_equal(host_array(got[s]), full[s])
        assert np.array_equal(host_array(got[s]), ref[s])
    # a single wanted shard, the degraded-read call
    w = lost[0]
    one = coder.reconstruct(have, wanted=[w])
    assert list(one) == [w] and np.array_equal(host_array(one[w]), full[w])


def test_coder_reconstruct_accepts_tensors_and_rejects_bad_ids():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (10, 5000), dtype=np.uint8)
    full = RefNumpyCoder().encode_all(data)
    coder = CudaCoder(device="cpu")
    have = {s: torch.from_numpy(full[s]) for s in range(4, 14)}
    got = coder.reconstruct(have, wanted=[0, 3])
    assert all(np.array_equal(host_array(got[s]), full[s]) for s in (0, 3))
    with pytest.raises(ValueError):
        coder.reconstruct(have, wanted=[14])
    assert coder.reconstruct(have, wanted=[]) == {}


def test_coder_verify():
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (10, 777), dtype=np.uint8)
    full = RefNumpyCoder().encode_all(data)
    coder = CudaCoder(device="cpu")
    assert coder.verify(full)
    bad = full.copy()
    bad[12, 5] ^= 1
    assert not coder.verify(bad)


def test_lrc_five_row_local_decode():
    """in_rows follows the stacked survivors: an LRC local repair feeds
    5 rows to K1, not data_shards."""
    ref = ref_codecs.get_codec("lrc")
    groups = tuple(codecs.LocalGroup(g.data, g.parity) for g in ref.locality)
    lrc = codecs.codec_from_reference(
        "lrc", np.asarray(ref.matrix), 10, locality=groups,
        tolerance=ref.tolerance, matrix_kind=ref.matrix_kind)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (10, 3000), dtype=np.uint8)
    full = RefNumpyCoder(codec="lrc").encode_all(data)
    coder = CudaCoder(codec=lrc, device="cpu")
    assert np.array_equal(host_array(coder.encode(data)), full[10:])
    have = {s: full[s] for s in range(14) if s != 2}
    _, used = coder._decode_masks(tuple(sorted(have)), (2,))
    assert len(used) == 5
    got = coder.reconstruct(have, wanted=[2])
    assert np.array_equal(host_array(got[2]), full[2])


def test_decode_masks_cached_per_survivor_set():
    coder = CudaCoder(device="cpu")
    key = (tuple(range(1, 11)), (0,))
    first = coder._decode_masks(*key)
    assert coder._decode_masks(*key)[0] is first[0]


def test_wrappers_take_plain_versions_for_cpu_tensors():
    """A CPU tensor runs the plain version and launches nothing."""
    k1, k2 = apply_bitmatrix.launches, apply_bitmatrix_crc.launches
    coder = CudaCoder(device="cpu")
    data = np.random.default_rng(10).integers(0, 256, (10, 4096),
                                              dtype=np.uint8)
    coder.encode(data)
    coder.encode_with_crc(data)
    assert (apply_bitmatrix.launches, apply_bitmatrix_crc.launches) == (k1, k2)


def test_wrappers_check_shapes_and_types():
    rs = codecs.get_codec("rs")
    masks = _masks(plane_major(rs.parity_bitmatrix(), 4, 10))
    with pytest.raises(ValueError):
        apply_bitmatrix(masks, torch.zeros((9, 4096), dtype=torch.uint8))
    with pytest.raises(ValueError):
        apply_bitmatrix(masks, torch.zeros((10, 4096), dtype=torch.int32))
    with pytest.raises(ValueError):
        CudaCoder(device="cpu").encode(np.zeros((9, 16), dtype=np.uint8))


def test_pad_to_block():
    assert pad_to_block(1) == BLOCK_N
    assert pad_to_block(BLOCK_N) == BLOCK_N
    assert pad_to_block(BLOCK_N + 1) == 2 * BLOCK_N


def test_plane_major_equal_reference():
    rng = np.random.default_rng(11)
    b = rng.integers(0, 2, (24, 40), dtype=np.uint8)
    assert np.array_equal(plane_major(b, 3, 5), ref_plane_major(b, 3, 5))


# ---------------------------------------------------------------------------
# The coder backends: torch, native, and the selection seam
# ---------------------------------------------------------------------------

def _codec_data(codec: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (10, n), dtype=np.uint8)
    return data, RefNumpyCoder(codec=codec).encode_all(data)


@pytest.mark.parametrize("codec", ["rs", "lrc"])
@pytest.mark.parametrize("n", [1, 777, 4097])
def test_torch_coder_equals_jax_and_numpy(codec, n):
    from seaweedfs_tpu.ops.coder_jax import JaxCoder
    from seaweedfs_tpu_torch.ops.coder_torch import TorchCoder
    data, full = _codec_data(codec, n, n)
    coder = TorchCoder(codec=codec, device="cpu")
    jax_coder = JaxCoder(codec=codec)
    assert np.array_equal(host_array(coder.encode(data)),
                          np.asarray(jax_coder.encode(data)))
    assert np.array_equal(host_array(coder.encode_all(data)), full)
    assert coder.verify(full)
    lost = [3] if codec == "lrc" else [1, 6, 10, 13]
    have = {s: full[s] for s in range(14) if s not in lost}
    got = coder.reconstruct(have)
    want = jax_coder.reconstruct(have)
    assert sorted(got) == lost
    for s in lost:
        assert np.array_equal(host_array(got[s]), np.asarray(want[s]))
        assert np.array_equal(host_array(got[s]), full[s])


@pytest.mark.parametrize("codec", ["rs", "lrc"])
def test_native_coder_equals_numpy(codec):
    from seaweedfs_tpu_torch.utils import native as native_mod
    if native_mod.load() is None:
        pytest.skip("native library not built")
    from seaweedfs_tpu.ops.coder_native import NativeCoder as RefNativeCoder
    from seaweedfs_tpu_torch.ops.coder_native import NativeCoder
    data, full = _codec_data(codec, 12345, 1)
    coder = NativeCoder(codec=codec)
    assert np.array_equal(coder.encode(data), full[10:])
    assert np.array_equal(coder.encode(data), RefNativeCoder(codec=codec)
                          .encode(data))
    lost = (3, 7) if codec == "lrc" else (1, 6, 10, 13)
    have = {i: full[i] for i in range(14) if i not in lost}
    rec = coder.reconstruct(have)
    assert all(np.array_equal(rec[s], full[s]) for s in lost)
    assert coder.verify(full)


@pytest.mark.parametrize("backend", ["cuda", "torch", "native", "numpy"])
@pytest.mark.parametrize("codec", ["rs", "lrc"])
def test_new_coder_backends_agree(backend, codec):
    from seaweedfs_tpu_torch.utils import native as native_mod
    if backend == "native" and native_mod.load() is None:
        pytest.skip("native library not built")
    data, full = _codec_data(codec, 5000, 2)
    coder = new_coder(backend=backend, codec=codec, device="cpu")
    assert coder.codec.name == codec
    assert np.array_equal(host_array(coder.encode(data)), full[10:])
    have = {s: full[s] for s in range(14) if s not in (2, 12)}
    got = coder.reconstruct(have, wanted=[2, 12])
    assert all(np.array_equal(host_array(got[s]), full[s]) for s in (2, 12))


def test_backend_selection_by_environment(monkeypatch):
    from seaweedfs_tpu_torch.ops import erasure
    from seaweedfs_tpu_torch.ops.coder_numpy import NumpyCoder as PortNumpy
    from seaweedfs_tpu_torch.ops.coder_torch import TorchCoder
    monkeypatch.delenv("SEAWEEDFS_TORCH_CODER", raising=False)
    assert erasure.default_backend() == "cuda"
    assert isinstance(new_coder(device="cpu"), CudaCoder)
    monkeypatch.setenv("SEAWEEDFS_TORCH_CODER", "torch")
    assert isinstance(new_coder(device="cpu"), TorchCoder)
    monkeypatch.setenv("SEAWEEDFS_TORCH_CODER", "numpy")
    assert isinstance(new_coder(device="cpu"), PortNumpy)
    # an explicit backend wins over the environment
    assert isinstance(new_coder(backend="cuda", device="cpu"), CudaCoder)
    # the reference's variable does not select the port's backend
    monkeypatch.delenv("SEAWEEDFS_TORCH_CODER")
    monkeypatch.setenv("SEAWEEDFS_TPU_CODER", "numpy")
    assert erasure.default_backend() == "cuda"
    monkeypatch.setenv("SEAWEEDFS_TORCH_CODER", "pallas")
    with pytest.raises(ValueError, match="SEAWEEDFS_TORCH_CODER"):
        new_coder(device="cpu")


def test_host_backends_refuse_a_card_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for backend in ("numpy", "native", "torch", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            new_coder(backend=backend)
    with pytest.raises(ValueError, match="unknown erasure backend"):
        new_coder(backend="jax", device="cpu")


def test_cuda_coder_runs_lrc_by_name():
    """CudaCoder(codec="lrc"): the registered codec runs end to end on
    the kernels' plain versions, local repair with 5 rows."""
    data, full = _codec_data("lrc", 9000, 3)
    coder = CudaCoder(codec="lrc", device="cpu")
    assert coder.codec is codecs.get_codec("lrc")
    assert np.array_equal(host_array(coder.encode(data)), full[10:])
    parity, parts = coder.encode_with_crc(data)
    assert np.array_equal(host_array(parity), full[10:])
    have = {s: full[s] for s in range(14) if s != 8}
    _, used = coder._decode_masks(tuple(sorted(have)), (8,))
    assert used == (5, 6, 7, 9, 11)
    assert np.array_equal(host_array(coder.reconstruct(have, [8])[8]), full[8])


def test_wrappers_take_a_volume_axis():
    """(V, k, n) inputs: the plain versions give every volume what a
    single-volume call gives, K2's partials positioned per volume."""
    rs = codecs.get_codec("rs")
    masks = _masks(plane_major(rs.parity_bitmatrix(), 4, 10))
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(0, 256, (3, 10, 3 * BLOCK_N),
                                      dtype=np.uint8))
    out = apply_bitmatrix(masks, x)
    assert out.shape == (3, 4, 3 * BLOCK_N)
    consts = [torch.from_numpy(a) for a in pack_crc_tables(crc_fold.tables(4096))]
    par, parts = apply_bitmatrix_crc(masks, x, *consts)
    assert par.shape == (3, 4, 3 * BLOCK_N) and parts.shape == (3, 14, 3)
    for v in range(3):
        assert torch.equal(out[v], apply_bitmatrix(masks, x[v]))
        p1, q1 = apply_bitmatrix_crc(masks, x[v], *consts)
        assert torch.equal(par[v], p1) and torch.equal(parts[v], q1)
    with pytest.raises(ValueError):
        apply_bitmatrix(masks, torch.zeros((2, 9, 16), dtype=torch.uint8))
