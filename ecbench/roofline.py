"""The yardstick of a kernel's roofline share, frozen here.

Peaks: one NVIDIA H100 SXM's data sheet, at its 700 W limit: 3.35 TB/s
of HBM and 1 979 TOP/s dense int8.  A GF(2) MAC (the AND and XOR of one
bit) counts as one operation against the int8 rate, the convention of
PERF.md's kernel table; the card can do fewer bit MACs than that (a
LOP3 per 32-bit lane: 132 SMs x 128 lanes x 32 bits x 1.98 GHz, about
1.07e15 a second), so the bound stays a bound.

Work of one launch of the bit-matrix kernels (K1 csrc/rs_bitmatrix.cu,
K2 csrc/rs_bitmatrix_crc.cu) on `in_rows` rows of n bytes giving
`out_rows` rows, copied from the cost model of
seaweedfs_tpu_torch/stats/roofline.py: bytes (in + out) x n, and
64 x out x in x n MACs; K2's CRC adds 8 x (in + out) x 32 MACs per
column and writes one 4-byte partial per 4096 columns of every row,
which the bytes here count too."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 1.979e15
CRC_TILE = 4096


def work(out_rows: int, in_rows: int, n: int, crc: bool) -> dict:
    nbytes = (in_rows + out_rows) * n
    macs = 64 * out_rows * in_rows * n
    if crc:
        macs += 8 * (in_rows + out_rows) * 32 * n
        nbytes += (in_rows + out_rows) * (n // CRC_TILE) * 4
    return {"bytes": nbytes, "ops": macs}


def bound_seconds(out_rows: int, in_rows: int, n: int, crc: bool
                  ) -> tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    w = work(out_rows, in_rows, n, crc)
    by_bytes = w["bytes"] / HBM_BYTES_PER_S
    by_ops = w["ops"] / OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "ops")
