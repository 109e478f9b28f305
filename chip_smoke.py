#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's EC main path on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--dat-mib 1024]

Phases; any failure raises and the script exits non-zero:

1. card    — require torch.cuda.is_available(); print nvidia-smi's name
             and power limit;
2. build   — compile csrc/*.cu (one nvcc per source, in parallel) and
             load the native CRC32-C library;
3. kernels — K1 (rs_bitmatrix) and K2 (rs_bitmatrix_crc) on the card
             against their plain PyTorch versions, byte for byte, at the
             main path's shapes: K1 with the RS parity matrix at
             (10, 4 MiB), K1 with the decode matrix of a seeded 10-of-14
             survivor set at a ragged width, K2 at (10, 4 MiB) with its
             folded block CRCs against the host crc32c;
4. main    — `weed shell ec.encode` on a volume at its size limit, cut
             from 30000 MB to --dat-mib: write a seeded .dat/.idx,
             .ecx, write_ec_files (fused CRC, K2), delete shards
             1/3/9/12 and rebuild_ec_files (K1), delete 4 shards again
             and EcVolume.read_needle on 300 seeded needles (K1);
             checks .ecc against the shard bytes, rebuilt shards against
             the originals, every read against its payload, and that
             both kernels launched;
5. timings — each kernel, its plain version and a torch.matmul yardstick
             at the main path's shapes (CUDA events, inputs rotated
             through more than the 50 MB L2).

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


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one
    warm-up call, between CUDA events."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_kernels(torch, dev, seed: int) -> dict:
    from seaweedfs_tpu_torch.codecs import get_codec
    from seaweedfs_tpu_torch.core.crc import crc32c
    from seaweedfs_tpu_torch.ops import crc_fold
    from seaweedfs_tpu_torch.ops.coder_cuda import (
        apply_bitmatrix, apply_bitmatrix_crc, apply_bitmatrix_crc_torch,
        apply_bitmatrix_torch, pack_bitmatrix, pack_crc_tables,
        pad_to_block, plane_major)

    rng = np.random.default_rng(seed + 1)
    codec = get_codec("rs")
    k, r = codec.data_shards, codec.parity_shards
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    parity_masks = up(pack_bitmatrix(plane_major(codec.parity_bitmatrix(), r, k)))
    x = up(rng.integers(0, 256, (k, KERNEL_N), dtype=np.uint8))

    got = apply_bitmatrix(parity_masks, x)
    want = apply_bitmatrix_torch(parity_masks, x)
    torch.cuda.synchronize()
    err_k1 = max_abs_err(torch, got, want)
    check(err_k1 == 0, f"K1 parity differs from its plain version ({err_k1})")
    log("K1 parity (10, 4 MiB): identical to the plain version")

    present = tuple(sorted(int(s) for s in rng.choice(codec.total_shards,
                                                      k, replace=False)))
    wanted = tuple(s for s in range(codec.total_shards) if s not in present)
    bmat, used = codec.decode_bitmatrix(present, wanted)
    decode_masks = up(pack_bitmatrix(plane_major(np.asarray(bmat),
                                                 len(wanted), len(used))))
    n_ragged = KERNEL_N - 4096 + 1234
    full = torch.cat([x, got])[:, :n_ragged]
    xr = torch.zeros((len(used), pad_to_block(n_ragged)), dtype=torch.uint8,
                     device=dev)
    xr[:, :n_ragged] = full[list(used)]
    got_d = apply_bitmatrix(decode_masks, xr)[:, :n_ragged]
    want_d = apply_bitmatrix_torch(decode_masks, xr)[:, :n_ragged]
    torch.cuda.synchronize()
    err_dec = max_abs_err(torch, got_d, want_d)
    check(err_dec == 0, f"K1 decode differs from its plain version ({err_dec})")
    check(torch.equal(got_d, full[list(wanted)]),
          "K1 decode did not restore the erased shards")
    log(f"K1 decode survivors {present} -> {wanted}, n={n_ragged}: "
        "identical to the plain version and to the erased shards")

    consts = tuple(up(a) for a in pack_crc_tables(crc_fold.tables(4096)))
    par2, parts = apply_bitmatrix_crc(parity_masks, x, *consts)
    par2_p, parts_p = apply_bitmatrix_crc_torch(parity_masks, x, *consts)
    torch.cuda.synchronize()
    err_k2 = max(max_abs_err(torch, par2, par2_p),
                 max_abs_err(torch, parts, parts_p))
    check(err_k2 == 0, f"K2 differs from its plain version ({err_k2})")
    check(torch.equal(par2, got), "K2 parity differs from K1 parity")
    rows = torch.cat([x, par2]).cpu().numpy()
    parts_np = parts.cpu().numpy().view(np.uint32)
    for i in range(rows.shape[0]):
        folded = crc_fold.block_crcs_from_partials(parts_np[i], KERNEL_N, 4096)
        host = [crc32c(rows[i, b * MIB:(b + 1) * MIB].tobytes())
                for b in range(KERNEL_N // MIB)]
        check(folded == host, f"K2 block CRCs of row {i} differ from crc32c")
    log("K2 (10, 4 MiB): parity and partials identical to the plain "
        "version; folded block CRCs equal crc32c")
    return {"k1_err": max(err_k1, err_dec), "k2_err": err_k2,
            "parity_masks": parity_masks, "decode_masks": decode_masks,
            "crc_consts": consts}


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

        apply_bitmatrix.launches = 0
        apply_bitmatrix_crc.launches = 0

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
        "launches_by_step": {"encode_rs_bitmatrix_crc": k2_encode,
                             "rebuild_rs_bitmatrix": k1_rebuild,
                             "reads_rs_bitmatrix":
                                 launches["rs_bitmatrix"] - k1_rebuild},
    }


def phase_timings(torch, dev, kern: dict, seed: int) -> dict:
    from seaweedfs_tpu_torch.ops.coder_cuda import (
        apply_bitmatrix, apply_bitmatrix_crc, apply_bitmatrix_crc_torch,
        apply_bitmatrix_torch, unpack_bitmatrix)

    k, r, n = 10, 4, KERNEL_N
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                        generator=g) for _ in range(4)]  # 160 MB > L2
    dec, par, consts = kern["decode_masks"], kern["parity_masks"], kern["crc_consts"]

    k1_ms = cuda_ms(torch, lambda i: apply_bitmatrix(dec, xs[i % 4]), 50)
    k1_plain = cuda_ms(torch, lambda i: apply_bitmatrix_torch(dec, xs[i % 4]), 3)
    k2_ms = cuda_ms(torch, lambda i: apply_bitmatrix_crc(par, xs[i % 4], *consts), 50)
    k2_plain = cuda_ms(torch, lambda i: apply_bitmatrix_crc_torch(
        par, xs[i % 4], *consts), 3)

    # Yardsticks: torch.matmul on pre-unpacked bf16 bit planes.
    planes = torch.cat([((xs[0] >> s) & 1) for s in range(8)]).to(torch.bfloat16)
    bm = unpack_bitmatrix(dec).to(torch.bfloat16)
    k1_lib = cuda_ms(torch, lambda i: torch.matmul(bm, planes), 20)
    pbits = unpack_bitmatrix(par).to(torch.bfloat16)
    rows_planes = torch.cat([planes, torch.zeros((8 * r, n), dtype=torch.bfloat16,
                                                 device=dev)])
    w0 = ((consts[0].to(torch.int64)[:, None]
           >> torch.arange(32, device=dev)) & 1).to(torch.bfloat16)
    tiles = rows_planes.reshape(-1, 4096)
    k2_lib = cuda_ms(torch, lambda i: (torch.matmul(pbits, planes),
                                       torch.matmul(tiles, w0)), 20)
    del planes, rows_planes, tiles

    k1_bytes = (k + r) * n
    k2_bytes = (k + r) * n + 4 * (k + r) * (n // 4096)
    k1_ops = 8 * r * 8 * k * n
    k2_ops = k1_ops + (k + r) * 8 * 32 * n
    b1, by1 = bound(k1_bytes, k1_ops)
    b2, by2 = bound(k2_bytes, k2_ops)
    return {"rs_bitmatrix": dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=b1,
                                 bound_by=by1, library_ms=k1_lib),
            "rs_bitmatrix_crc": dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=b2,
                                     bound_by=by2, library_ms=k2_lib)}


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
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
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
