#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's EC main path on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--dat-mib 1024]

Phases; any failure raises and the script exits non-zero:

1. card    — require torch.cuda.is_available(); print nvidia-smi's name
             and power limit;
2. build   — compile csrc/*.cu (one nvcc per source, in parallel) and
             load the native CRC32-C library;
3. kernels — every instantiation of K1 (rs_bitmatrix) and K2
             (rs_bitmatrix_crc) on the card against their plain PyTorch
             versions, byte for byte: K1 10->4 with the RS parity matrix
             at (10, 4 MiB) and with the decode matrix of a seeded
             10-of-14 survivor set at a ragged width, K1 10->1 with a
             degraded read's matrix at a ragged 1 MiB, K1 generic<=16
             (RS(16,4) parity) and generic<=32 (random 20 -> 5); K2 10->4
             at (10, 4 MiB) and generic<=16 (random 12 -> 3), each with
             its folded block CRCs against the host crc32c;
4. main    — `weed shell ec.encode` on a volume at its size limit, cut
             from 30000 MB to --dat-mib: write a seeded .dat/.idx,
             .ecx, write_ec_files (fused CRC, K2), delete shards
             1/3/9/12 and rebuild_ec_files (K1), delete 4 shards again
             and EcVolume.read_needle on 300 seeded needles (K1);
             checks .ecc against the shard bytes, rebuilt shards against
             the originals, every read against its payload, and that
             both kernels launched;
5. timings — each kernel, its plain version and a torch.matmul yardstick
             at the main path's shapes: K1 at (10 -> 4, 4 MiB) and
             (10 -> 1, 1 MiB), K2 at (10 -> 4, 4 MiB).  CUDA events
             around 200 launches that the host has all issued before the
             card reaches the start event (a torch.cuda._sleep fills the
             queue), inputs rotated through more than the 50 MB L2; the
             host microseconds per wrapper call beside each.

The build phase also logs ptxas's registers per kernel and, where the
toolkit has cuobjdump, static SASS opcode counts per kernel.

Prints a {"main_path": ...} line, nvidia-smi's line, a {"kernels": [...]}
line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# int8 tensor-core rate, against which each single-bit AND/XOR counts
# as one operation.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 1979e12

# torch.cuda._sleep spins for a count of SM clock cycles; the H100's
# boost clock is below 2 GHz, so this many cycles last at least a second.
SLEEP_CYCLES_PER_S = 2e9

MIB = 1024 * 1024
KERNEL_N = 4 * MIB  # DEFAULT_CHUNK: one coder call on the main path
REBUILD_LOST = (1, 3, 9, 12)
READ_LOST = (0, 4, 8, 13)
READS = 300


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for buf in iter(lambda: f.read(8 * MIB), b""):
            h.update(buf)
    return h.hexdigest()


def cuda_ms(torch, fn, reps: int) -> dict:
    """Device milliseconds per call of fn(i) over reps calls, between
    CUDA events that the card reaches only after the host has issued
    every call: the queue is filled behind a torch.cuda._sleep that
    outlasts the host's issue, so the events time the card, not the
    host.  Also returns the host microseconds per call (the issue cost)
    and whether the queue was indeed still filled when the host was done
    (the start event not yet reached)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Spin the card 3x the measured issue time (+2 ms) at up to 2 GHz.
    torch.cuda._sleep(int((3 * host_s + 2e-3) * SLEEP_CYCLES_PER_S))
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    filled = not start.query()
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / reps,
            "host_us": host_s / reps * 1e6, "queue_filled": filled}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def write_volume(base: str, dat_bytes: int, seed: int):
    """Seeded .dat/.idx of needles log-uniform in 1 KiB..4 MiB, filled
    to dat_bytes.  Returns {needle id: payload memoryview}."""
    from seaweedfs_tpu_torch.core.needle import Needle, get_actual_size
    from seaweedfs_tpu_torch.storage.dat_writer import DatWriter

    rng = np.random.default_rng(seed)
    blob = rng.bytes(dat_bytes)
    view = memoryview(blob)
    payloads = {}
    pos = 0
    with DatWriter(base) as w:
        nid = 0
        while True:
            size = int(math.exp(rng.uniform(math.log(1024), math.log(4 * MIB))))
            room = dat_bytes - w.size - get_actual_size(0, w.version) - 16
            size = min(size, room, len(blob) - pos)
            if size < 1024:
                break
            nid += 1
            data = view[pos:pos + size]
            pos += size
            n = Needle(cookie=int(rng.integers(1 << 32)), id=nid, data=data)
            n.append_at_ns = nid
            w.write_needle(n)
            payloads[nid] = data
    return payloads


def _k1_case(torch, dev, masks, x, name):
    """K1 on the card against its plain version (masks on the card) for
    one input; returns (kernel output, max_abs_err)."""
    from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix,
                                                    apply_bitmatrix_torch)
    got = apply_bitmatrix(masks, x)
    want = apply_bitmatrix_torch(masks.to(dev), x)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    check(err == 0, f"K1 {name} differs from its plain version ({err})")
    return got, err


def _k2_case(torch, dev, masks, x, consts, name):
    """K2 on the card against its plain version, and its partials folded
    into block CRCs against the host crc32c of every row."""
    from seaweedfs_tpu_torch.core.crc import crc32c
    from seaweedfs_tpu_torch.ops import crc_fold
    from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix_crc,
                                                    apply_bitmatrix_crc_torch)
    par, parts = apply_bitmatrix_crc(masks, x, *consts)
    par_p, parts_p = apply_bitmatrix_crc_torch(masks.to(dev), x, *consts)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, par, par_p),
              max_abs_err(torch, parts, parts_p))
    check(err == 0, f"K2 {name} differs from its plain version ({err})")
    n = x.shape[1]
    rows = torch.cat([x, par]).cpu().numpy()
    parts_np = parts.cpu().numpy().view(np.uint32)
    for i in range(rows.shape[0]):
        folded = crc_fold.block_crcs_from_partials(parts_np[i], n, 4096)
        host = [crc32c(rows[i, b * MIB:(b + 1) * MIB].tobytes())
                for b in range(n // MIB)]
        check(folded == host, f"K2 {name}: block CRCs of row {i} differ "
              "from crc32c")
    return par, err


def phase_kernels(torch, dev, seed: int) -> dict:
    """Every instantiation either wrapper can pick, on the card, byte for
    byte against its plain version."""
    from seaweedfs_tpu_torch.codecs import get_codec, rs_codec
    from seaweedfs_tpu_torch.ops import crc_fold
    from seaweedfs_tpu_torch.ops.coder_cuda import (
        K1_VARIANTS, K2_VARIANTS, apply_bitmatrix, apply_bitmatrix_crc,
        pack_bitmatrix, pack_crc_tables, pad_to_block, plane_major)

    rng = np.random.default_rng(seed + 1)
    codec = get_codec("rs")
    k, r = codec.data_shards, codec.parity_shards
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    host_masks = lambda b, rows, cols: torch.from_numpy(  # noqa: E731
        pack_bitmatrix(plane_major(np.asarray(b), rows, cols)))
    for counts in (apply_bitmatrix.variant_launches,
                   apply_bitmatrix_crc.variant_launches):
        counts.update(dict.fromkeys(counts, 0))
    parity_masks = host_masks(codec.parity_bitmatrix(), r, k)
    x = up(rng.integers(0, 256, (k, KERNEL_N), dtype=np.uint8))
    errs = []

    got, err = _k1_case(torch, dev, parity_masks, x, "10->4 parity")
    errs.append(err)
    log("K1 10->4 parity (10, 4 MiB): identical to the plain version")

    present = tuple(sorted(int(s) for s in rng.choice(codec.total_shards,
                                                      k, replace=False)))
    wanted = tuple(s for s in range(codec.total_shards) if s not in present)
    bmat, used = codec.decode_bitmatrix(present, wanted)
    decode_masks = host_masks(bmat, len(wanted), len(used))
    full = torch.cat([x, got])
    n_ragged = KERNEL_N - 4096 + 1234
    xr = torch.zeros((len(used), pad_to_block(n_ragged)), dtype=torch.uint8,
                     device=dev)
    xr[:, :n_ragged] = full[list(used), :n_ragged]
    got_d, err = _k1_case(torch, dev, decode_masks, xr, "10->4 decode")
    errs.append(err)
    check(torch.equal(got_d[:, :n_ragged], full[list(wanted), :n_ragged]),
          "K1 decode did not restore the erased shards")
    log(f"K1 10->4 decode survivors {present} -> {wanted}, n={n_ragged}: "
        "identical to the plain version and to the erased shards")

    lost = wanted[0]
    read_present = tuple(s for s in range(codec.total_shards) if s != lost)
    bmat, used1 = codec.decode_bitmatrix(read_present, (lost,))
    read_masks = host_masks(bmat, 1, len(used1))
    n_read = MIB - 4096 + 777
    xq = torch.zeros((len(used1), pad_to_block(n_read)), dtype=torch.uint8,
                     device=dev)
    xq[:, :n_read] = full[list(used1), :n_read]
    got_q, err = _k1_case(torch, dev, read_masks, xq, "10->1 read")
    errs.append(err)
    check(torch.equal(got_q[0, :n_read], full[lost, :n_read]),
          "K1 10->1 did not restore the erased shard")
    log(f"K1 10->1 degraded read of shard {lost}, n={n_read}: identical to "
        "the plain version and to the erased shard")

    r16 = rs_codec(16, 4, "cauchy")
    x16 = up(rng.integers(0, 256, (16, MIB), dtype=np.uint8))
    _, err = _k1_case(torch, dev, host_masks(r16.parity_bitmatrix(), 4, 16),
                      x16, "generic<=16 (RS(16,4) parity)")
    errs.append(err)
    wide = torch.from_numpy(rng.integers(0, 256, (8 * 5, 20), dtype=np.uint8))
    x20 = up(rng.integers(0, 256, (20, MIB + 48), dtype=np.uint8))
    _, err = _k1_case(torch, dev, wide, x20, "generic<=32 (random 20 -> 5)")
    errs.append(err)
    log("K1 generic<=16 (16 -> 4, 1 MiB) and generic<=32 (20 -> 5, "
        "1 MiB + 48): identical to the plain version")

    consts = tuple(up(a) for a in pack_crc_tables(crc_fold.tables(4096)))
    par2, err_k2 = _k2_case(torch, dev, parity_masks, x, consts, "10->4")
    check(torch.equal(par2, got), "K2 parity differs from K1 parity")
    log("K2 10->4 (10, 4 MiB): parity and partials identical to the plain "
        "version; folded block CRCs equal crc32c")
    masks12 = torch.from_numpy(rng.integers(0, 256, (8 * 3, 12),
                                            dtype=np.uint8))
    x12 = up(rng.integers(0, 256, (12, 2 * MIB), dtype=np.uint8))
    _, err = _k2_case(torch, dev, masks12, x12, consts, "generic<=16")
    err_k2 = max(err_k2, err)
    log("K2 generic<=16 (random 12 -> 3, 2 MiB): identical to the plain "
        "version; folded block CRCs equal crc32c")

    for fn, names in ((apply_bitmatrix, K1_VARIANTS),
                      (apply_bitmatrix_crc, K2_VARIANTS)):
        for name in names:
            check(fn.variant_launches[name] > 0,
                  f"instantiation {name} of {fn.__name__} not launched")
    return {"k1_err": max(errs), "k2_err": err_k2,
            "parity_masks": parity_masks, "decode_masks": decode_masks,
            "read_masks": read_masks, "crc_consts": consts}


def phase_main_path(torch, dev, args) -> dict:
    from seaweedfs_tpu_torch.ec import to_ext
    from seaweedfs_tpu_torch.ec.encoder import (rebuild_ec_files,
                                                write_ec_files,
                                                write_sorted_file_from_idx)
    from seaweedfs_tpu_torch.ec.integrity import (ShardChecksums,
                                                  file_block_crcs)
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix,
                                                    apply_bitmatrix_crc)

    work = os.path.join(REPO, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        base = os.path.join(work, "1")
        t0 = time.perf_counter()
        payloads = write_volume(base, args.dat_mib * MIB, args.seed)
        write_sorted_file_from_idx(base)
        dat_size = os.path.getsize(base + ".dat")
        log(f"wrote {len(payloads)} needles, .dat {dat_size} bytes "
            f"in {time.perf_counter() - t0:.1f} s")

        for fn in (apply_bitmatrix, apply_bitmatrix_crc):
            fn.launches = 0
            fn.variant_launches.update(dict.fromkeys(fn.variant_launches, 0))

        t0 = time.perf_counter()
        write_ec_files(base, device=dev)
        encode_s = time.perf_counter() - t0
        k2_encode = apply_bitmatrix_crc.launches
        ecc = ShardChecksums.load(base)
        for sid in range(14):
            check(ecc.get(sid) == file_block_crcs(base + to_ext(sid)),
                  f".ecc of shard {sid} differs from its bytes")
        log(f"encode {encode_s:.3f} s; .ecc matches all 14 shards")

        digests = {sid: sha256_file(base + to_ext(sid)) for sid in REBUILD_LOST}
        for sid in REBUILD_LOST:
            os.remove(base + to_ext(sid))
        t0 = time.perf_counter()
        rebuilt = rebuild_ec_files(base, device=dev)
        rebuild_s = time.perf_counter() - t0
        k1_rebuild = apply_bitmatrix.launches
        check(rebuilt == list(REBUILD_LOST), f"rebuilt {rebuilt}")
        ecc = ShardChecksums.load(base)
        for sid in REBUILD_LOST:
            check(sha256_file(base + to_ext(sid)) == digests[sid],
                  f"rebuilt shard {sid} differs from the original")
            check(ecc.get(sid) == file_block_crcs(base + to_ext(sid)),
                  f".ecc of rebuilt shard {sid} differs from its bytes")
        log(f"rebuild {rebuild_s:.3f} s; shards {rebuilt} identical")

        for sid in READ_LOST:
            os.remove(base + to_ext(sid))
        rng = np.random.default_rng(args.seed + 2)
        ids = sorted(payloads)
        sample = [ids[i] for i in rng.choice(len(ids), min(READS, len(ids)),
                                             replace=False)]
        lat_degraded, lat_local = [], []
        vol = EcVolume(base, device=dev)
        try:
            for nid in sample:
                before = apply_bitmatrix.launches
                t0 = time.perf_counter()
                n = vol.read_needle(nid)
                dt = time.perf_counter() - t0
                check(n.data == payloads[nid], f"needle {nid} read back wrong")
                (lat_degraded if apply_bitmatrix.launches > before
                 else lat_local).append(dt)
        finally:
            vol.close()
        launches = {"rs_bitmatrix": apply_bitmatrix.launches,
                    "rs_bitmatrix_crc": apply_bitmatrix_crc.launches}
        log(f"{len(sample)} reads verified, {len(lat_degraded)} degraded; "
            f"launches {launches}")
        for name, count in launches.items():
            check(count > 0, f"{name} never launched on the main path")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None

    return {
        "dat_bytes": dat_size, "needles": len(payloads),
        "reduced": f"volume 30000 MB -> {args.dat_mib} MiB",
        "encode_s": encode_s, "encode_gb_s": dat_size / encode_s / 1e9,
        "rebuild_s": rebuild_s, "rebuild_gb_s": dat_size / rebuild_s / 1e9,
        "reads": len(sample), "degraded_reads": len(lat_degraded),
        "degraded_read_p50_ms": pct(lat_degraded, 50),
        "degraded_read_p99_ms": pct(lat_degraded, 99),
        "local_read_p50_ms": pct(lat_local, 50),
        "launches": launches,
        "launches_by_instantiation": {
            "rs_bitmatrix": dict(apply_bitmatrix.variant_launches),
            "rs_bitmatrix_crc": dict(apply_bitmatrix_crc.variant_launches)},
        "launches_by_step": {"encode_rs_bitmatrix_crc": k2_encode,
                             "rebuild_rs_bitmatrix": k1_rebuild,
                             "reads_rs_bitmatrix":
                                 launches["rs_bitmatrix"] - k1_rebuild},
    }


def phase_timings(torch, dev, kern: dict, seed: int) -> dict:
    """Each kernel, its plain version and a torch.matmul yardstick at the
    main path's shapes: K1 at (10 -> 4, 4 MiB) with the rebuild's decode
    matrix and at (10 -> 1, 1 MiB) with a degraded read's, K2 at
    (10 -> 4, 4 MiB).  Inputs rotate through more than the 50 MB L2."""
    from seaweedfs_tpu_torch.ops.coder_cuda import (
        apply_bitmatrix, apply_bitmatrix_crc, apply_bitmatrix_crc_torch,
        apply_bitmatrix_torch, unpack_bitmatrix)

    k, r, n = 10, 4, KERNEL_N
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                        generator=g) for _ in range(4)]  # 168 MB > L2
    xq = [torch.randint(0, 256, (k, MIB), dtype=torch.uint8, device=dev,
                        generator=g) for _ in range(8)]  # 84 MB > L2
    dec, par, consts = kern["decode_masks"], kern["parity_masks"], kern["crc_consts"]
    rd = kern["read_masks"]
    dec_d, par_d, rd_d = dec.to(dev), par.to(dev), rd.to(dev)

    k1 = cuda_ms(torch, lambda i: apply_bitmatrix(dec, xs[i % 4]), 200)
    k1_plain = cuda_ms(torch, lambda i: apply_bitmatrix_torch(dec_d, xs[i % 4]), 3)
    k1q = cuda_ms(torch, lambda i: apply_bitmatrix(rd, xq[i % 8]), 200)
    k1q_plain = cuda_ms(torch, lambda i: apply_bitmatrix_torch(rd_d, xq[i % 8]), 3)
    k2 = cuda_ms(torch, lambda i: apply_bitmatrix_crc(par, xs[i % 4], *consts), 200)
    k2_plain = cuda_ms(torch, lambda i: apply_bitmatrix_crc_torch(
        par_d, xs[i % 4], *consts), 3)

    # Yardsticks: torch.matmul on pre-unpacked bf16 bit planes.
    planes = torch.cat([((xs[0] >> s) & 1) for s in range(8)]).to(torch.bfloat16)
    bm = unpack_bitmatrix(dec_d).to(torch.bfloat16)
    k1_lib = cuda_ms(torch, lambda i: torch.matmul(bm, planes), 20)
    planes_q = torch.cat([((xq[0] >> s) & 1) for s in range(8)]).to(torch.bfloat16)
    bmq = unpack_bitmatrix(rd_d).to(torch.bfloat16)
    k1q_lib = cuda_ms(torch, lambda i: torch.matmul(bmq, planes_q), 20)
    pbits = unpack_bitmatrix(par_d).to(torch.bfloat16)
    rows_planes = torch.cat([planes, torch.zeros((8 * r, n), dtype=torch.bfloat16,
                                                 device=dev)])
    w0 = ((consts[0].to(torch.int64)[:, None]
           >> torch.arange(32, device=dev)) & 1).to(torch.bfloat16)
    tiles = rows_planes.reshape(-1, 4096)
    k2_lib = cuda_ms(torch, lambda i: (torch.matmul(pbits, planes),
                                       torch.matmul(tiles, w0)), 20)
    del planes, planes_q, rows_planes, tiles

    def entry(t, plain, lib, k_in, k_out, width, crc):
        nbytes = (k_in + k_out) * width
        ops = 8 * k_out * 8 * k_in * width
        if crc:
            nbytes += 4 * (k_in + k_out) * (width // 4096)
            ops += (k_in + k_out) * 8 * 32 * width
        b, by = bound(nbytes, ops)
        return dict(ms=t["ms"], plain_ms=plain["ms"], bound_ms=b, bound_by=by,
                    library_ms=lib["ms"], host_us=t["host_us"],
                    queue_filled=t["queue_filled"],
                    shape=f"{k_in}->{k_out}, n={width}")

    k1_entry = entry(k1, k1_plain, k1_lib, k, r, n, False)
    k1_entry["at_10_to_1_1mib"] = entry(k1q, k1q_plain, k1q_lib, k, 1, MIB, False)
    return {"rs_bitmatrix": k1_entry,
            "rs_bitmatrix_crc": entry(k2, k2_plain, k2_lib, k, r, n, True)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dat-mib", type=int, default=1024)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    from seaweedfs_tpu_torch.core import crc
    from seaweedfs_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"built {cuda_build.KERNEL_SOURCES} in {time.perf_counter() - t0:.1f} s")
    for name in cuda_build.KERNEL_SOURCES:
        for line in cuda_build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
        for fn, counts in cuda_build.sass_counts(name).items():
            log(f"sass {name} {fn}: {json.dumps(counts)}")
    check(crc.native_loaded(), "the native CRC32-C library did not load")

    kern = phase_kernels(torch, dev, args.seed)
    main_path = phase_main_path(torch, dev, args)
    timings = phase_timings(torch, dev, kern, args.seed)

    kernels = [
        {"name": "rs_bitmatrix", "route": "cuda",
         "source": "seaweedfs_tpu_torch/csrc/rs_bitmatrix.cu",
         "replaces": "seaweedfs_tpu/ops/coder_pallas.py:104",
         "launches": main_path["launches"]["rs_bitmatrix"],
         "max_abs_err": kern["k1_err"], **timings["rs_bitmatrix"]},
        {"name": "rs_bitmatrix_crc", "route": "cuda",
         "source": "seaweedfs_tpu_torch/csrc/rs_bitmatrix_crc.cu",
         "replaces": "seaweedfs_tpu/ops/coder_pallas.py:200",
         "launches": main_path["launches"]["rs_bitmatrix_crc"],
         "max_abs_err": kern["k2_err"], **timings["rs_bitmatrix_crc"]},
    ]
    print(json.dumps({"main_path": main_path}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
