"""Cells of BENCHMARK.json cut to a size a test can hold, on the CPU."""

from __future__ import annotations

import os
import time

import torch

from ecbench import cells, run

# volume_size_limit_mb per configuration: shards of a few MiB.
SMALL_MB = {"rs10_4-1000mb": 12}


def cell(name: str, work, seed: int = 7, control: bool = False,
         device: str = "cpu") -> cells.Cell:
    """The cell `<config>.<traffic>` from its files, whether or not
    BENCHMARK.json lists it."""
    config_name, traffic = name.split(".", 1)
    config = dict(cells.load_json(os.path.join(
        cells.HERE, "configs", f"{config_name}.json")))
    config["volume_size_limit_mb"] = SMALL_MB.get(
        config_name, config["volume_size_limit_mb"])
    w = {"name": name, "config": config_name, "traffic": traffic,
         "chips": 1}
    return cells.Cell(name, w, config, cells.mix(traffic), seed,
                      torch.device(device), str(work), control)


def result(c: cells.Cell, seconds: float = 1.0, trace: bool = False,
           bench: dict | None = None) -> dict:
    bench = bench or cells.load_benchmark()
    got = run.run_cell(c, seconds, trace, time.monotonic())
    return run.result_line(bench, c.name, 1, c.device.type, trace, got)
