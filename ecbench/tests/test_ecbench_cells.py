"""Every cell of BENCHMARK.json resolves to its files by name, the file
keeps to the benchmark's contract, the cells of both drivers run and
judge on the CPU at a small size, and a cell of a new mix and a new
metric needs only new files and BENCHMARK.json entries."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from ecbench import cells
from ecbench.tests import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_by_name():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        _, c = cells.workload(bench, w["name"])
        config = cells.load_json(c["file"])
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        mix = cells.mix(w["traffic"])
        assert cells.driver(mix["driver"]) is not None
        e2e, layer = cells.metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in e2e + layer:
            assert hasattr(cells.reader(m["name"]), "read")


def test_benchmark_json_keeps_to_the_contract():
    bench = cells.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["ecbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ecbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        for w in m["workloads"]:
            e2e, _ = cells.metrics(bench, w)
            assert m["moves"] in {e["name"] for e in e2e}
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("name", ["rs10_4-1000mb.encode"])
def test_small_cell_runs_correct_on_the_cpu(name, tmp_path):
    line = small.result(small.cell(name, tmp_path), seconds=1.0)
    assert line["correct"], line
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cells.metrics(
        cells.load_benchmark(), name)[0]}
    # A pass on the CPU may outlast the window: a rate of 0 is possible.
    assert all(v["value"] >= 0 for v in line["metrics"].values())
    assert line["metrics"]["setup_s"]["value"] > 0
    assert list(line)[-1] == "compared"


def test_a_new_mix_and_metric_are_new_files_alone(tmp_path):
    """A copy of the checkout's benchmark gains a configuration (another
    collection of volumes), a mix (of the encode driver), a metric with
    its reader, and the entries of a cell of them, all new files and
    entries; the cell runs from the copy, and no file of the original
    benchmark differs in the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), root)
    config = cells.load_json("ecbench/configs/rs10_4-1000mb.json")
    config.update(name="rs10_4-8mb", volume_size_limit_mb=8, volumes=2,
                  fill=[1.0])
    (root / "ecbench" / "configs" / "rs10_4-8mb.json").write_text(
        json.dumps(config))
    (root / "ecbench" / "mixes" / "encode-2.json").write_text(
        json.dumps({"driver": "encode", "about": "a throwaway mix"}))
    (root / "ecbench" / "metrics" / "passes.py").write_text(
        "def read(ctx):\n    return float(ctx.progress['encoded_bytes'])\n")
    name = "rs10_4-8mb.encode-2"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "rs10_4-8mb", "source": "x",
                             "file": "ecbench/configs/rs10_4-8mb.json",
                             "reduced": ["volume_size_limit_mb"],
                             "why": "a throwaway entry"})
    bench["workloads"].append({"name": name, "config": "rs10_4-8mb",
                               "traffic": "encode-2", "chips": 1,
                               "why": "a throwaway cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_GBps":
            m["workloads"].append(name)
    bench["per_layer"].append({"name": "passes", "unit": "B",
                               "better": "higher", "source": "host_clock",
                               "layer": "EC file pipeline",
                               "moves": "encode_GBps",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, time\n"
        "from ecbench import cells, run\n"
        "from ecbench.tests import small\n"
        "bench = cells.load_benchmark()\n"
        f"name = {name!r}\n"
        f"c = small.cell(name, {str(tmp_path / 'work')!r})\n"
        "w, _ = cells.workload(bench, name)\n"
        "assert cells.mix(w['traffic'])['about'] == 'a throwaway mix'\n"
        "got = run.run_cell(c, 1.0, False, time.monotonic())\n"
        "line = run.result_line(bench, name, 1, 'cpu', False, got)\n"
        "line['layer'] = run._values(got['ctx'], cells.metrics(bench, name)[1])\n"
        "print(json.dumps(line))\n")
    os.makedirs(tmp_path / "work")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{cells.ROOT}")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["metrics"]) == {"encode_GBps", "setup_s"}
    assert "passes" in line["layer"]
    for dirpath, _, files in os.walk(cells.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), cells.HERE)
            with open(os.path.join(dirpath, f), "rb") as a, \
                    open(root / "ecbench" / rel, "rb") as b:
                assert a.read() == b.read(), rel
