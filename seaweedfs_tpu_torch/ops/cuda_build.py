"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with ctypes.  Libraries are named by a digest of the sources and flags
and kept in the git-ignored ``seaweedfs_tpu_torch/_build/``, so a
checkout builds them at first use and reuses them after.  ``build()``
starts one ``nvcc`` per missing source, all at once, and waits for
every one before it reports a failure.  The ``-Xptxas -v`` report of
each build (registers, shared memory, spills) is kept beside its
library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

KERNEL_SOURCES = ("rs_bitmatrix", "rs_bitmatrix_crc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> str:
    """Where the library of csrc/<name>.cu lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, in parallel.
    Returns {name: library path}; raises RuntimeError with nvcc's output
    when any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, tmp, proc in procs:
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        with open(paths[name] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build((name,))[name])
        return lib


def ptxas_report(name: str) -> str:
    """The -Xptxas -v output kept from the build of csrc/<name>.cu."""
    with open(library_path(name) + ".log") as f:
        return f.read()


def sass_counts(name: str, library: str | None = None
                ) -> dict[str, dict[str, int]]:
    """Static SASS instruction counts of each kernel in the library of
    csrc/<name>.cu (or in `library`), from `cuobjdump -sass`: {kernel:
    {"total": count, opcode: count, ...}}, opcodes without their
    modifiers, NOPs left out, most frequent first.  Empty when the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", library or library_path(name)],
                         capture_output=True, text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            current = counts.setdefault(line.split(":", 1)[1].strip(), {})
            continue
        if current is None or not line.startswith("/*") or "*/" not in line:
            continue
        tokens = line.split("*/", 1)[1].split()
        if tokens and tokens[0].startswith("@"):  # predicate guard
            tokens = tokens[1:]
        if not tokens or tokens[0].startswith("/*"):
            continue
        op = tokens[0].rstrip(";").split(".")[0]
        if op != "NOP":
            current[op] = current.get(op, 0) + 1
    return {fn: {"total": sum(c.values()),
                 **dict(sorted(c.items(), key=lambda kv: -kv[1]))}
            for fn, c in counts.items()}
