"""The port's `write_ec_files` pipeline: a stripe ring the read-ahead
fills in place, and one writer thread for every shard-file write.

Held byte for byte (every shard, the `.ecc`, the `.ecx`, the `.vif`
where the reference writes one)
against the JAX package's `write_ec_files` over block geometries that
give large-block rows, small-block rows, a ragged last row, a volume of
one chunk, one of fewer chunks than the ring, ones that wrap the ring
several times, and the fused-CRC geometry.  Besides:

- a writer slowed by a delay inside `_shard_write` (the armed
  `volume.corrupt` point's `delay`) still writes exact bytes: no buffer
  is refilled before its rows are written, and the read-ahead waits;
- the ring makes at most `PIPELINE_DEPTH + 2` buffers per call however
  many chunks the volume has, the read-ahead allocates nothing per
  chunk, and every shard row is written from an array, not a copy;
- a failure at chunk k (a shard file's `write`, the coder's submit, a
  read of the `.dat`) is raised within seconds, both threads end,
  every output is closed and nothing is written after it;
- the armed `volume.corrupt` fault flips one byte of the chosen shard
  and leaves the written buffer, the other shards and the `.ecc` exact.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ops.coder_numpy import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu_torch.core.needle import Needle
from seaweedfs_tpu_torch.ec import encoder, to_ext
from seaweedfs_tpu_torch.fault import registry as fault
from seaweedfs_tpu_torch.ops.coder_cuda import CudaCoder
from seaweedfs_tpu_torch.storage.dat_writer import DatWriter

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

MIB = 1024 * 1024
RING = encoder.PIPELINE_DEPTH + 2
EC_EXTS = [to_ext(i) for i in range(14)] + [".ecx", ".ecc", ".vif"]
THREADS = ("ec-read-ahead", "ec-shard-writer")
# name: (large block, small block, chunk, needle bytes, fused CRC, how
# many chunks the volume has).  The shrunken blocks are the Go test's.
GEOMETRIES = {
    "large_rows": (10000, 100, 1000, 330_000, "0", lambda n: n > 3 * RING),
    "small_rows": (10000, 100, 1000, 95_000, "0", lambda n: n > 2 * RING),
    "ragged_last_row": (10000, 100, 500, 52_000, "0",
                        lambda n: n > RING),
    "one_chunk": (10000, 100, 1000, 6_000, "0", lambda n: n == 1),
    "fewer_chunks_than_ring": (10000, 100, 1000, 22_000, "0",
                               lambda n: 1 < n < RING),
    "fused": (1024 * MIB, MIB, MIB, 43 * MIB, "1", lambda n: n > RING),
}


def _volume(root, needle_bytes: int) -> str:
    os.makedirs(root, exist_ok=True)
    base = os.path.join(str(root), "1")
    rng = random.Random(needle_bytes)
    cap = max(2, min(40_000, needle_bytes // 20))
    with DatWriter(base) as w:
        i, left = 1, needle_bytes
        while left > 0:
            n = min(left, rng.randrange(1, cap))
            w.write_needle(Needle(cookie=i, id=i, data=rng.randbytes(n)))
            left -= n
            i += 1
    return base


def _clone(base: str, root) -> str:
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(str(root), os.path.basename(base))
    for ext in (".dat", ".idx"):
        with open(base + ext, "rb") as a, open(dst + ext, "wb") as b:
            b.write(a.read())
    return dst


def _files(base: str) -> dict:
    """Each EC file's bytes, None where there is no such file."""
    out = {}
    for ext in EC_EXTS:
        if os.path.exists(base + ext):
            with open(base + ext, "rb") as f:
                out[ext] = f.read()
        else:
            out[ext] = None
    return out


def _kw(geometry: str) -> dict:
    large, small, chunk = GEOMETRIES[geometry][:3]
    return dict(large_block_size=large, small_block_size=small,
                chunk_size=chunk)


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Each geometry's volume, and the JAX package's encode of it."""
    made = {}

    def get(geometry: str):
        if geometry not in made:
            root = tmp_path_factory.mktemp(geometry)
            base = _volume(root / "src", GEOMETRIES[geometry][3])
            ref = _clone(base, root / "ref")
            ref_encoder.write_sorted_file_from_idx(ref)
            ref_encoder.write_ec_files(ref, coder=RefNumpyCoder(),
                                       **_kw(geometry))
            made[geometry] = (base, _files(ref))
        return made[geometry]
    return get


class _Rings:
    """Every `_StripeRing` write_ec_files makes, kept for the test."""

    def __init__(self, monkeypatch):
        self.made: list = []
        real = encoder._StripeRing
        rings = self

        class Ring(real):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                rings.made.append(self)
        monkeypatch.setattr(encoder, "_StripeRing", Ring)


def _encode(volumes, geometry, tmp_path, monkeypatch, name="port"):
    base, ref_files = volumes(geometry)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", GEOMETRIES[geometry][4])
    port = _clone(base, tmp_path / name)
    encoder.write_sorted_file_from_idx(port)
    encoder.write_ec_files(port, coder=CudaCoder(device="cpu"),
                           **_kw(geometry))
    return port, ref_files


def _chunks(base: str, geometry: str) -> int:
    large, small, chunk = GEOMETRIES[geometry][:3]
    return sum(1 for _ in encoder._stripes(os.path.getsize(base + ".dat"),
                                           large, small, chunk))


def _no_pipeline_threads() -> bool:
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if not any(t.name in THREADS and t.is_alive()
                   for t in threading.enumerate()):
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_ring_encode_equals_reference(volumes, geometry, tmp_path,
                                      monkeypatch):
    rings = _Rings(monkeypatch)
    port, ref_files = _encode(volumes, geometry, tmp_path, monkeypatch)
    n = _chunks(port, geometry)
    assert GEOMETRIES[geometry][5](n), n
    if geometry == "ragged_last_row":
        large, small, chunk = GEOMETRIES[geometry][:3]
        dat = os.path.getsize(port + ".dat")
        *_, (width, reads) = encoder._stripes(dat, large, small, chunk)
        # The last chunk is narrower than the ring's buffers, and the
        # .dat ends inside its last row, whose tail is zeroed.
        assert width < encoder._widest(large, small, chunk)
        assert reads[-1][3] >= dat > reads[0][3]
    assert _files(port) == ref_files
    (ring,) = rings.made
    assert 1 <= ring.made <= min(n, RING)


def test_slow_writer_writes_exact_bytes(volumes, tmp_path, monkeypatch):
    """A delay inside every `_shard_write` makes the writer the pace:
    the read-ahead then waits for the ring, which has made all of its
    buffers, and the bytes are still exact."""
    rings = _Rings(monkeypatch)
    fault.arm("volume.corrupt", "delay:0.002")
    try:
        port, ref_files = _encode(volumes, "large_rows", tmp_path,
                                  monkeypatch)
    finally:
        fault.disarm_all()
    assert _files(port) == ref_files
    (ring,) = rings.made
    assert ring.made == RING
    assert ring._stages["encode_ring_wait"][0] > 0.01


def test_switching_threads_often_keeps_the_bytes(volumes, tmp_path,
                                                 monkeypatch):
    """The ring's free list and its taken buffers are shared by the
    read-ahead and the writer: with the interpreter switching threads
    every microsecond, a buffer given back twice or refilled early
    would show in the shard bytes."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outcome: list = []
        th = threading.Thread(target=lambda: outcome.append(_encode(
            volumes, "large_rows", tmp_path, monkeypatch)), daemon=True)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    ((port, ref_files),) = outcome
    assert _files(port) == ref_files


def test_ring_allocations_are_bounded(volumes, tmp_path, monkeypatch):
    """The encode allocates its stripe buffers only through the ring,
    at most PIPELINE_DEPTH + 2, while the volume has many more chunks;
    each data row is written from one of them, and every row is written
    as an array, none through a bytes copy."""
    rings = _Rings(monkeypatch)
    allocations = []

    class CountingNumpy:
        def __getattr__(self, name):
            return getattr(np, name)

        def empty(self, *args, **kwargs):
            allocations.append(args)
            return np.empty(*args, **kwargs)

        def zeros(self, *args, **kwargs):
            allocations.append(args)
            return np.zeros(*args, **kwargs)

    written = []
    real_write = encoder._shard_write

    def spy(f, sid, buf, accs):
        written.append((sid, buf))
        real_write(f, sid, buf, accs)

    monkeypatch.setattr(encoder, "np", CountingNumpy())
    monkeypatch.setattr(encoder, "_shard_write", spy)
    port, ref_files = _encode(volumes, "large_rows", tmp_path, monkeypatch)
    assert _files(port) == ref_files
    (ring,) = rings.made
    assert len(allocations) == ring.made <= RING
    assert _chunks(port, "large_rows") > 3 * RING
    assert all(isinstance(buf, np.ndarray) for _, buf in written)
    data_bases = {id(buf.base) for sid, buf in written if sid < 10}
    assert len(data_bases) == ring.made


class _FailingFile:
    """A shard file whose `write` raises at its k-th call; it records
    every write to any file made after a write failed."""

    def __init__(self, f, fail_at: int | None, failed: threading.Event,
                 late: list):
        self._f, self._fail_at, self._failed, self._late = \
            f, fail_at, failed, late
        self.calls = 0

    def write(self, buf):
        if self._failed.is_set():
            self._late.append(self._f.name)
        self.calls += 1
        if self.calls == self._fail_at:
            self._failed.set()
            raise OSError(28, "No space left on device")
        return self._f.write(buf)

    def close(self):
        self._f.close()

    @property
    def closed(self):
        return self._f.closed


@pytest.mark.parametrize("where", ["write", "submit", "read"])
def test_failure_at_chunk_k_is_raised_and_ends_both_threads(
        volumes, tmp_path, monkeypatch, where):
    k = 7
    base, _ = volumes("large_rows")
    port = _clone(base, tmp_path / "port")
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", "0")
    failed, late, opened, calls = threading.Event(), [], [], []

    def spy_open(path, mode="r", *args, **kwargs):
        f = open(path, mode, *args, **kwargs)
        if path.endswith(".ec03"):
            f = _FailingFile(f, k if where == "write" else None, failed,
                             late)
        elif "w" in mode:
            f = _FailingFile(f, None, failed, late)
        opened.append(f)
        return f

    encoder.write_sorted_file_from_idx(port)
    monkeypatch.setattr(encoder, "open", spy_open, raising=False)
    coder = CudaCoder(device="cpu")
    if where == "submit":
        real = coder.encode

        def encode(data):
            calls.append(data.shape)
            if len(calls) == k:
                failed.set()
                raise OSError(5, "Input/output error")
            return real(data)
        monkeypatch.setattr(coder, "encode", encode)
    if where == "read":
        real_read = encoder._read_into

        def read_into(fd, row, offset):
            calls.append(offset)
            if len(calls) == 10 * (k - 1) + 3:
                failed.set()
                raise OSError(5, "Input/output error")
            real_read(fd, row, offset)
        monkeypatch.setattr(encoder, "_read_into", read_into)
    outcome: list = []

    def run():
        try:
            encoder.write_ec_files(port, coder=coder, **_kw("large_rows"))
            outcome.append(None)
        except OSError as e:
            outcome.append(e)

    t0 = time.monotonic()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=15)
    assert not th.is_alive(), "write_ec_files hung after a failure"
    assert time.monotonic() - t0 < 10
    (err,) = outcome
    assert isinstance(err, OSError) and failed.is_set(), err
    assert err.errno == (28 if where == "write" else 5)
    assert _no_pipeline_threads()
    shards = [f for f in opened if isinstance(f, _FailingFile)]
    assert len(shards) == 14 and all(f.closed for f in shards)
    # The writer that failed wrote nothing more; a failure elsewhere
    # stops the writes well before the volume's end.
    assert late == [] if where == "write" else \
        sum(f.calls for f in shards) < 14 * _chunks(port, "large_rows") // 2
    assert not os.path.exists(port + ".ecc")


@pytest.mark.parametrize("sid", [7, 12])
def test_armed_corrupt_fault_flips_one_byte(volumes, tmp_path, monkeypatch,
                                            sid):
    """The fault corrupts a copy: the written buffer keeps its bytes,
    the chosen shard differs from the reference in exactly one byte (the
    first of the write it hit), and the `.ecc` holds the true bytes."""
    real_write = encoder._shard_write
    mutated = []

    def spy(f, s, buf, accs):
        before = bytes(buf)
        real_write(f, s, buf, accs)
        if bytes(buf) != before:
            mutated.append(s)

    monkeypatch.setattr(encoder, "_shard_write", spy)
    fault.arm("volume.corrupt", f"fail*1~{sid}")
    try:
        port, ref_files = _encode(volumes, "small_rows", tmp_path,
                                  monkeypatch)
    finally:
        fault.disarm_all()
    assert mutated == []
    got = _files(port)
    for ext in EC_EXTS:
        if ext != to_ext(sid):
            assert got[ext] == ref_files[ext], ext
    a = np.frombuffer(got[to_ext(sid)], np.uint8)
    b = np.frombuffer(ref_files[to_ext(sid)], np.uint8)
    assert a.shape == b.shape
    assert int((a != b).sum()) == 1
