"""The frozen roofline count at the kernel table's shapes gives the
bounds PERF.md's table states, to its three digits.  The table counts
the payload rows alone; K2's CRC partials add 0.1 % to its bytes."""

import pytest

from ecbench import roofline

MIB = 1 << 20


@pytest.mark.parametrize("out_rows,in_rows,n,ms", [
    (4, 10, 4 * MIB, 0.0175),    # K1 and K2 10->4, 4 MiB
    (4, 10, 18 * MIB, 0.0789),   # K2 decode, a column step
    (1, 10, 1 * MIB, 0.00344),   # K1 10->1, 1 MiB
])
def test_bound_ms_at_the_kernel_tables_shapes(out_rows, in_rows, n, ms):
    secs, by = roofline.bound_seconds(out_rows, in_rows, n, crc=False)
    assert by == "bytes" and f"{secs * 1e3:.3g}" == f"{ms:.3g}"
    fused, by = roofline.bound_seconds(out_rows, in_rows, n, crc=True)
    assert by == "bytes" and fused == pytest.approx(secs * 1.001,
                                                    rel=1e-4)


def test_crc_partials_are_counted():
    plain = roofline.work(4, 10, 4 * MIB, False)
    fused = roofline.work(4, 10, 4 * MIB, True)
    assert fused["bytes"] - plain["bytes"] == 14 * (4 * MIB // 4096) * 4
    assert fused["ops"] > plain["ops"]
