"""What a run may import and where it may run: no module whose
top-level name is jax, jaxlib, flax or seaweedfs_tpu (the name is
compared whole: seaweedfs_tpu_torch begins with it); the reference
imports nothing of the program; a run without a CUDA card, or in a
directory without the program, prints no result and fails."""

import ast
import json
import os
import shutil
import subprocess
import sys

from ecbench import cells, run

REF = os.path.join(cells.HERE, "reference")


def _python(code: str, cwd: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=600)


def test_the_runner_loads_no_jax_and_no_jax_package():
    code = (
        "import json, sys\n"
        "from ecbench import cells, run, trace\n"
        "import ecbench.reference.crc32c, ecbench.reference.gf256, "
        "ecbench.reference.index, ecbench.reference.layout, "
        "ecbench.reference.rs, ecbench.reference.sidecar\n"
        "import os\n"
        "for kind, load in (('drivers', cells.driver), "
        "('metrics', cells.reader)):\n"
        "    for f in os.listdir(os.path.join(cells.HERE, kind)):\n"
        "        if f.endswith('.py'):\n"
        "            load(f[:-3])\n"
        "import seaweedfs_tpu_torch.ec.encoder, "
        "seaweedfs_tpu_torch.stats.metrics\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _python(code, cells.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert "seaweedfs_tpu_torch" in top and "ecbench" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def _imports(path: str) -> list[str]:
    """The absolute module names a Python file imports, anywhere in it."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    found = []
    for dirpath, _, files in os.walk(cells.HERE):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                found += [(os.path.relpath(path, cells.ROOT), m)
                          for m in _imports(path)
                          if run.forbidden_modules([m])]
    assert found == []


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["seaweedfs_tpu_torch",
                                  "seaweedfs_tpu_torch.ops.coder_cuda",
                                  "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["seaweedfs_tpu.ec.encoder", "jaxlib.xla",
                                  "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "seaweedfs_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        for m in _imports(os.path.join(REF, name)):
            assert m.split(".")[0] in ("numpy", "torch", "json",
                                       "contextlib", "functools",
                                       "__future__"), (name, m)
    out = _python("import sys, ecbench.reference.rs, ecbench.reference.crc32c,"
                  " ecbench.reference.layout, ecbench.reference.index,"
                  " ecbench.reference.sidecar\n"
                  "print(sorted(m for m in sys.modules "
                  "if m.startswith('seaweedfs')))", cells.ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return  # this machine has a card: the check below is for one without
    out = subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload",
         "rs10_4-1000mb.encode", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and ecbench/: the run
    fails before it prints anything."""
    shutil.copytree(cells.HERE, tmp_path / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload",
         "rs10_4-1000mb.encode", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
