#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against each other on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 kernel_variants.py [--reps 200] [--seed 0] [--checkout DIR]

A variant is the shipped ``seaweedfs_tpu_torch/csrc/`` with a few exact
text replacements (VARIANTS below; a replacement that does not match
fails the run).  Each variant is compiled as ``ops/cuda_build.py``
compiles the shipped one, into the git-ignored ``_smoke_work/variants/``
(one nvcc per source and variant, all started together), and its
ptxas registers and spills and its static SASS opcode counts
(``cuda_build.sass_counts``) are printed.  The wrappers of
``ops/coder_cuda.py`` are then pointed at each variant's libraries in
turn: each is first held byte for byte against the plain versions (K1
10->4 and 10->1, K2 10->4 with its partials), then timed with
chip_smoke.py's queue-filled CUDA events at K1 (10 -> 4, 4 MiB), K1
(10 -> 1, 1 MiB) and K2 (10 -> 4, 4 MiB).  The variants run in turns,
shipped first and last, so a drift of the card shows as a gap between
the two shipped rows.  ``--checkout DIR`` adds the kernels of another
checkout of the repository (an unpacked earlier commit, say), built from
its own sources in a process of its own and timed the same way, first
and last, with the SASS opcode counts of its libraries.  Prints nvidia-smi's name and power limit, then one JSON line
{"variants": [...]}; exits non-zero on any failure or without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke as cs

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "_smoke_work", "variants")

# name -> {source file: [(old text, new text), ...]}
VARIANTS = {
    "shipped": {},
    "k1_fixed_2_blocks_per_sm": {"rs_bitmatrix.cu": [(
        "__launch_bounds__(kThreads, 3)\n    rs_fixed",
        "__launch_bounds__(kThreads, 2)\n    rs_fixed")]},
    "k1_fixed_4_blocks_per_sm": {"rs_bitmatrix.cu": [(
        "__launch_bounds__(kThreads, 3)\n    rs_fixed",
        "__launch_bounds__(kThreads, 4)\n    rs_fixed")]},
    "k2_fixed_1_block_per_sm": {"rs_bitmatrix_crc.cu": [(
        "__launch_bounds__(kThreads, 2)\n    rs_crc_fixed",
        "__launch_bounds__(kThreads, 1)\n    rs_crc_fixed")]},
}


def build_variants() -> dict[str, dict[str, str]]:
    """Compile every variant; returns {variant: {source: library path}}."""
    from seaweedfs_tpu_torch.ops import cuda_build
    shutil.rmtree(WORK, ignore_errors=True)
    procs, libs = [], {}
    for name, edits in VARIANTS.items():
        src = os.path.join(WORK, name)
        shutil.copytree(cuda_build.CSRC_DIR, src)
        for fname, subs in edits.items():
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            for old, new in subs:
                cs.check(old in text, f"variant {name}: {old!r} not in {fname}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
        libs[name] = {}
        for kname in cuda_build.KERNEL_SOURCES:
            lib = os.path.join(src, f"lib{kname}.so")
            libs[name][kname] = lib
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                   os.path.join(src, f"{kname}.cu")]
            procs.append((name, kname, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for name, kname, proc in procs:
        out = proc.communicate()[0].decode(errors="replace")
        cs.check(proc.returncode == 0, f"nvcc {name}/{kname}.cu:\n{out}")
        for line in out.splitlines():
            if re.search(r"registers|spill", line):
                cs.log(f"ptxas {name}/{kname}: {line.strip()}")
    for name, paths in libs.items():
        for kname, path in paths.items():
            log_sass(f"{name}/{kname}", path)
    return libs


def log_sass(label: str, library: str) -> None:
    from seaweedfs_tpu_torch.ops import cuda_build
    for fn, counts in cuda_build.sass_counts("", library).items():
        top = dict(list(counts.items())[:12])
        cs.log(f"sass {label} {fn}: {json.dumps(top)}")


def use_variant(paths: dict[str, str]) -> None:
    """Point coder_cuda's wrappers at one variant's libraries."""
    from seaweedfs_tpu_torch.ops import coder_cuda
    fns = {}
    for kname, path in paths.items():
        fn = getattr(ctypes.CDLL(path), kname)
        fn.restype = ctypes.c_int
        fn.argtypes = coder_cuda._ARGTYPES[kname]
        fns[kname] = fn
    coder_cuda._kernel = fns.__getitem__


def check_and_time(torch, dev, inputs, reps: int) -> dict:
    from seaweedfs_tpu_torch.ops import coder_cuda
    from seaweedfs_tpu_torch.ops.coder_cuda import (
        apply_bitmatrix, apply_bitmatrix_crc, apply_bitmatrix_crc_torch,
        apply_bitmatrix_torch)
    par, rd, consts, xs, xq = inputs
    if not hasattr(coder_cuda, "mask_words"):  # wrappers of device masks
        par, rd = par.to(dev), rd.to(dev)
    for masks, x in ((par, xs[0]), (rd, xq[0])):
        want = apply_bitmatrix_torch(masks.to(dev), x)
        cs.check(torch.equal(apply_bitmatrix(masks, x), want),
                 "K1 differs from its plain version")
    x1 = xs[0][:, :cs.MIB].contiguous()
    got = apply_bitmatrix_crc(par, x1, *consts)
    want = apply_bitmatrix_crc_torch(par.to(dev), x1, *consts)
    cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
             "K2 differs from its plain version")
    k1 = cs.cuda_ms(torch, lambda i: apply_bitmatrix(par, xs[i % 4]), reps)
    k1q = cs.cuda_ms(torch, lambda i: apply_bitmatrix(rd, xq[i % 8]), reps)
    k2 = cs.cuda_ms(torch, lambda i: apply_bitmatrix_crc(
        par, xs[i % 4], *consts), reps)
    return {"k1_10x4_4mib_ms": k1["ms"], "k1_10x1_1mib_ms": k1q["ms"],
            "k2_10x4_4mib_ms": k2["ms"],
            "queue_filled": k1["queue_filled"] and k1q["queue_filled"]
            and k2["queue_filled"]}


def make_inputs(torch, dev, seed: int):
    from seaweedfs_tpu_torch.codecs import get_codec
    from seaweedfs_tpu_torch.ops import crc_fold
    from seaweedfs_tpu_torch.ops.coder_cuda import (pack_bitmatrix,
                                                    pack_crc_tables,
                                                    plane_major)
    codec = get_codec("rs")
    par = torch.from_numpy(pack_bitmatrix(plane_major(
        codec.parity_bitmatrix(), 4, 10)))
    bmat, used = codec.decode_bitmatrix(tuple(range(1, 14)), (0,))
    rd = torch.from_numpy(pack_bitmatrix(plane_major(
        np.asarray(bmat), 1, len(used))))
    consts = tuple(torch.from_numpy(a).to(dev)
                   for a in pack_crc_tables(crc_fold.tables(4096)))
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randint(0, 256, (10, cs.KERNEL_N), dtype=torch.uint8,
                        device=dev, generator=g) for _ in range(4)]
    xq = [torch.randint(0, 256, (10, cs.MIB), dtype=torch.uint8,
                        device=dev, generator=g) for _ in range(8)]
    return par, rd, consts, xs, xq


def time_checkout(root: str, reps: int, seed: int) -> dict:
    """The kernels of the checkout at root, timed in a process of its own
    (both trees name their package seaweedfs_tpu_torch)."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reps", str(reps),
         "--seed", str(seed), "--in-checkout", os.path.abspath(root)],
        capture_output=True, text=True, cwd=root)
    cs.check(out.returncode == 0, f"checkout {root}:\n{out.stdout}"
             f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkout", default=None,
                    help="another checkout whose kernels to time as well")
    ap.add_argument("--in-checkout", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.in_checkout:
        sys.path.insert(0, args.in_checkout)
        from seaweedfs_tpu_torch.ops import cuda_build
        cuda_build.build()
        print(json.dumps(check_and_time(
            torch, dev, make_inputs(torch, dev, args.seed), args.reps)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rows = []
    if args.checkout:
        rows.append({"variant": f"checkout {args.checkout}",
                     **time_checkout(args.checkout, args.reps, args.seed)})
        cs.log(json.dumps(rows[-1]))
        for lib in sorted(glob.glob(os.path.join(
                args.checkout, "seaweedfs_tpu_torch", "_build", "lib*.so"))):
            log_sass(f"checkout/{os.path.basename(lib)}", lib)
    try:
        libs = build_variants()
        inputs = make_inputs(torch, dev, args.seed)
        for name in list(VARIANTS) + ["shipped"]:
            use_variant(libs[name])
            rows.append({"variant": name,
                         **check_and_time(torch, dev, inputs, args.reps)})
            cs.log(json.dumps(rows[-1]))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if args.checkout:
        rows.append({"variant": f"checkout {args.checkout}",
                     **time_checkout(args.checkout, args.reps, args.seed)})
        cs.log(json.dumps(rows[-1]))
    print(smi)
    print(json.dumps({"variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
