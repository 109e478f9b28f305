"""`ec_ring_wait_pct.encode`, the share of the window in which the EC
file pipeline's read-ahead waits for a free stripe buffer: listed for
the encode cell beside the other stage metrics, its reader reads
nothing where the program has no such stage (as a program without the
ring has not), and it reads the program's stage counters in a small run
on the CPU."""

import time

from ecbench import cells, run
from ecbench.tests import small

ENCODE = "rs10_4-1000mb.encode"
NAME = "ec_ring_wait_pct.encode"


def test_ring_wait_is_listed_and_read_where_the_ring_is(tmp_path):
    bench = cells.load_benchmark()
    (metric,) = [m for m in cells.metrics(bench, ENCODE)[1]
                 if m["name"] == NAME]
    assert metric == {"name": NAME, "unit": "%", "better": "lower",
                      "source": "program_counter",
                      "layer": "EC file pipeline", "moves": "encode_GBps",
                      "workloads": [ENCODE]}
    empty = run.Context(cell=None, setup_s=1.0, window_s=51.0, progress={},
                        before={}, after={})
    assert cells.reader(NAME).read(empty) is None
    got = run.run_cell(small.cell(ENCODE, tmp_path), 1.0, False,
                       time.monotonic())
    values = {k: v["value"] for k, v in run._values(got["ctx"],
                                                    [metric]).items()}
    assert 0.0 <= values[NAME] <= 100.0
