"""Find a cell's parts by name: BENCHMARK.json's entries, the
configuration's file, the mix's data file (mixes/<traffic>.json), the
driver the mix names (drivers/<driver>.py) and each metric's reader
(metrics/<metric>.py, else metrics/<metric up to its first dot>.py)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    seed: int
    device: object
    work: str
    control: bool = False


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> tuple[dict, dict]:
    """(the workload entry, its configuration's entry)."""
    for w in bench["workloads"]:
        if w["name"] == name:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"workload {name}: no configuration "
                           f"{w['config']!r} in BENCHMARK.json")
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def load_json(path: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, path)) as f:
        return json.load(f)


def mix(traffic: str) -> dict:
    return load_json(os.path.join(HERE, "mixes", f"{traffic}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """The driver class of drivers/<name>.py."""
    return _module(os.path.join(HERE, "drivers", f"{name}.py"),
                   f"ecbench.drivers.{name}").DRIVER


def reader(metric: str):
    """The reader module of one metric."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return _module(path, "ecbench.metrics." + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{os.path.join(HERE, 'metrics')}")


def metrics(bench: dict, name: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) a workload reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return e2e, layer
