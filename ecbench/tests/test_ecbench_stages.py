"""The EC file pipeline's six per-layer metrics: each resolves to its
reader by name, reads nothing where the program has no such stage (as a
program without the stages has not), and reads the program's stage
counters in a small run on the CPU."""

import time
import types

import pytest

from ecbench import cells, run
from ecbench.tests import small

ENCODE = "rs10_4-1000mb.encode"
STAGE_METRICS = ("ec_read_GBps.encode", "ec_starved_pct.encode",
                 "ec_submit_pct.encode", "ec_write_pct.encode",
                 "ec_fetch_pct.encode", "ec_index_pct.encode")
MAIN_THREAD = STAGE_METRICS[1:]


def test_the_stage_metrics_are_listed_for_the_encode_cell():
    bench = cells.load_benchmark()
    _, layer = cells.metrics(bench, ENCODE)
    mine = {m["name"]: m for m in layer if m["name"] in STAGE_METRICS}
    assert set(mine) == set(STAGE_METRICS)
    for m in mine.values():
        assert m["source"] == "program_counter"
        assert m["layer"] == "EC file pipeline"
        assert m["moves"] == "encode_GBps"
        assert m["workloads"] == [ENCODE]
        assert m["better"] == ("higher" if m["unit"] == "GB/s" else "lower")


@pytest.mark.parametrize("name", STAGE_METRICS)
def test_reader_resolves_and_reads_nothing_without_the_stage(name):
    ctx = run.Context(cell=None, setup_s=1.0, window_s=51.0, progress={},
                      before={}, after={})
    assert cells.reader(name).read(ctx) is None


def test_readers_read_the_stage_counters_of_a_small_run(tmp_path):
    got = run.run_cell(small.cell(ENCODE, tmp_path), 1.0, False,
                       time.monotonic())
    bench = cells.load_benchmark()
    layer = [m for m in cells.metrics(bench, ENCODE)[1]
             if m["name"] in STAGE_METRICS]
    values = {k: v["value"] for k, v in run._values(got["ctx"],
                                                    layer).items()}
    assert set(values) == set(STAGE_METRICS)
    assert values["ec_read_GBps.encode"] > 0
    assert all(values[m] >= 0 for m in MAIN_THREAD)
    # The main thread's stages do not overlap: together they fit the
    # window, but for a stage that ends as the window's counters are read.
    assert sum(values[m] for m in MAIN_THREAD) <= 101.0


def test_the_traced_line_carries_the_stage_metrics(tmp_path):
    got = run.run_cell(small.cell(ENCODE, tmp_path), 0.5, False,
                       time.monotonic())
    got["ctx"].trace = types.SimpleNamespace(
        busy_s=0.1, device_ops=lambda: [], idle_gaps=lambda: [],
        kernels=lambda *a, **k: [], copies=lambda *a: [])
    line = run.result_line(cells.load_benchmark(), ENCODE, 1, "cpu", True,
                           got, 700.0)
    assert line["correct"], line
    assert set(STAGE_METRICS) <= set(line["metrics"])
    assert not set(STAGE_METRICS) & set(line["compared"])
