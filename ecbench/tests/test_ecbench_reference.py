"""The plain reference against its published definitions and against
the port's CPU path, byte for byte.  The definitions: klauspost/
reedsolomon's RS(10,4) matrix (the (k + m) x k Vandermonde matrix
V[r][c] = r^c over GF(2^8) mod 0x11D, times the inverse of its top
square; vandermonde() and buildMatrix() in its matrix.go and
reedsolomon.go), written out below and built again here by shifts and
XORs alone; CRC-32C's check value.  The port, on a small volume made as
the benchmark makes its inputs: RS(10,4) encode, the rebuild of shards
{1, 3, 9, 12}, the `.ecc` CRC32-C entries, the Go layout and the
`.ecx`."""

import functools
import os
import shutil

import numpy as np
import pytest
import torch

from ecbench import volumes
from ecbench.reference import crc32c, gf256, index, layout, rs, sidecar

K, M, LOST = 10, 4, [1, 3, 9, 12]
LARGE, SMALL = 4 << 20, 1 << 20   # large rows of 4 MiB blocks, to have two
NEEDLES = {"median_bytes": 65536, "sigma": 1.2, "min_bytes": 1024,
           "max_bytes": 8 << 20}
# The parity rows of klauspost/reedsolomon's New(10, 4).
KLAUSPOST_10_4 = [
    [0x81, 0x96, 0xaf, 0xb8, 0xd2, 0xc4, 0xfe, 0xe8, 0x03, 0x02],
    [0x96, 0x81, 0xb8, 0xaf, 0xc4, 0xd2, 0xe8, 0xfe, 0x02, 0x03],
    [0xbf, 0xd6, 0x62, 0x0a, 0x06, 0x6f, 0xdf, 0xb7, 0x05, 0x04],
    [0xd6, 0xbf, 0x0a, 0x62, 0x6f, 0x06, 0xb7, 0xdf, 0x04, 0x05],
]
# Its parity of the column of data bytes 1, 2, ..., 10.
PARITY_OF_1_TO_10 = [69, 242, 18, 118]


def _mul(a, b):
    """GF(2^8) product mod 0x11D by shifts and XORs (no tables)."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11D
        b >>= 1
    return out


def _dot(row, col):
    return functools.reduce(lambda x, y: x ^ y, map(_mul, row, col), 0)


def _klauspost_parity(k, m):
    """vandermonde(k + m, k) times the inverse of its top k x k square,
    by Gauss-Jordan elimination; its bottom m rows."""
    vm = [[functools.reduce(_mul, [r] * c, 1) for c in range(k)]
          for r in range(k + m)]
    a = [vm[i] + [int(i == j) for j in range(k)] for i in range(k)]
    for col in range(k):
        piv = next(r for r in range(col, k) if a[r][col])
        a[col], a[piv] = a[piv], a[col]
        scale = next(x for x in range(1, 256) if _mul(a[col][col], x) == 1)
        a[col] = [_mul(scale, x) for x in a[col]]
        for r in range(k):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [x ^ _mul(f, y) for x, y in zip(a[r], a[col])]
    top_inv = [row[k:] for row in a]
    return [[_dot(vm[r], [top_inv[t][j] for t in range(k)])
             for j in range(k)] for r in range(k, k + m)]


def test_generator_is_klauspost_rs_10_4():
    assert _klauspost_parity(K, M) == KLAUSPOST_10_4
    assert gf256.vandermonde_parity(K, M).tolist() == KLAUSPOST_10_4


def test_parity_equals_the_published_matrix():
    code = rs.Code(K, M, "cpu")
    ones = torch.arange(1, K + 1, dtype=torch.uint8).view(K, 1)
    assert code.encode(ones).view(-1).tolist() == PARITY_OF_1_TO_10
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (K, 300), dtype=np.uint8)
    got = code.encode(torch.from_numpy(data)).numpy()
    want = [[_dot(row, data[:, c].tolist()) for c in range(data.shape[1])]
            for row in KLAUSPOST_10_4]
    assert got.tolist() == want


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """A .dat over two large rows (so large rows, the row boundary and
    small rows all appear) and its .idx."""
    d = tmp_path_factory.mktemp("vol")
    dat, idx = volumes.make_volume(11, 0, 2 * K * LARGE + 3 * K * SMALL
                                   + 12345, NEEDLES, "cpu")
    base = str(d / "1")
    with open(base + ".dat", "wb") as f:
        f.write(dat.numpy().tobytes())
    with open(base + ".idx", "wb") as f:
        f.write(idx)
    return base


def _expected(base):
    raw = open(base + ".dat", "rb").read()
    size = layout.shard_size(len(raw), K, LARGE, SMALL)
    data = layout.data_rows(lambda at, n: raw[at:at + n], len(raw), K,
                            LARGE, SMALL, 0, size)
    code = rs.Code(K, M, "cpu")
    full = torch.cat([torch.from_numpy(data),
                      code.encode(torch.from_numpy(data))])
    crcs = crc32c.BlockCrc(SMALL, "cpu")(full).numpy()
    return full.numpy(), crcs, index.sorted_index(
        open(base + ".idx", "rb").read())


def test_the_ports_encode_and_rebuild_equal_the_reference(volume, tmp_path):
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.ops.erasure import new_coder
    coder = functools.partial(new_coder, device="cpu")
    base = str(tmp_path / "1")
    for ext in (".dat", ".idx"):
        shutil.copy(volume + ext, base + ext)
    full, crcs, ecx = _expected(base)
    assert layout.rows(os.path.getsize(base + ".dat"), K, LARGE, SMALL)[0] \
        == 2
    encoder.write_sorted_file_from_idx(base)
    encoder.write_ec_files(base, coder=coder(), large_block_size=LARGE,
                           small_block_size=SMALL)
    for s in range(K + M):
        got = np.fromfile(base + f".ec{s:02d}", dtype=np.uint8)
        assert np.array_equal(got, full[s]), f"shard {s}"
    assert open(base + ".ecx", "rb").read() == ecx
    want = {s: crcs[s].tolist() for s in range(K + M)}
    assert sidecar.entries_wrong(open(base + ".ecc").read(), SMALL,
                                 want) == 0
    for s in LOST:
        os.remove(base + f".ec{s:02d}")
    assert encoder.rebuild_ec_files(base, coder=coder()) == LOST
    for s in LOST:
        got = np.fromfile(base + f".ec{s:02d}", dtype=np.uint8)
        assert np.array_equal(got, full[s]), f"rebuilt shard {s}"
    assert sidecar.entries_wrong(open(base + ".ecc").read(), SMALL,
                                 want) == 0


def test_reference_rebuild_and_generator():
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(0, 256, (K, 5000), dtype=np.uint8))
    code = rs.Code(K, M, "cpu")
    full = torch.cat([data, code.encode(data)])
    shards = {s: full[s] for s in range(K + M) if s not in LOST}
    assert torch.equal(code.rebuild(shards, LOST), full[LOST])
    # The systematic matrix: identity on top, and any k rows invertible.
    parity = gf256.vandermonde_parity(K, M)
    gen = [[int(i == j) for j in range(K)] for i in range(K)] + \
        parity.tolist()
    for drop in ([0, 1, 2, 3], [10, 11, 12, 13], LOST):
        gf256.invert([gen[s] for s in range(K + M) if s not in drop][:K])
    assert not np.array_equal(parity, gf256.cauchy_parity(K, M))


def test_crc32c_matches_the_definition():
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 256, (2, 3 * 8192 + 100), dtype=np.uint8)
    got = crc32c.BlockCrc(8192, "cpu")(torch.from_numpy(rows)).tolist()
    want = [[crc32c.crc32c(r[i:i + 8192].tobytes())
             for i in range(0, len(r), 8192)] for r in rows]
    assert got == want


def test_sorted_index_applies_deletes_and_overwrites():
    e = np.array([(5, 1, 10), (3, 2, 20), (5, 3, 30), (7, 4, 40),
                  (3, 0, 0), (9, 5, index.TOMBSTONE)], dtype=index.ENTRY)
    got = np.frombuffer(index.sorted_index(e.tobytes()), dtype=index.ENTRY)
    assert got.tolist() == [(5, 3, 30), (7, 4, 40)]
