#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's EC main path on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--dat-mib 1024] [--batch-div 1]

Phases; any failure raises and the script exits non-zero:

1. card    — require torch.cuda.is_available(); print nvidia-smi's name
             and power limit;
2. build   — compile csrc/*.cu (one nvcc per source, in parallel) and
             load the native CRC32-C library; probe the roofline plane's
             peaks on the card (stats/roofline.py probe_peaks: int8 and
             bf16 matmul, memory bandwidth, host<->device copies), so the
             first ledger row does not pay the probe inside phase 4's
             walls, and log them beside the data sheet's;
3. kernels — every instantiation of K1 (rs_bitmatrix) and K2
             (rs_bitmatrix_crc) on the card against their plain PyTorch
             versions, byte for byte: K1 10->4 with the RS parity matrix
             at (10, 4 MiB) and with the decode matrix of a seeded
             10-of-14 survivor set at a ragged width, K1 10->1 with a
             degraded read's matrix at a ragged 1 MiB, K1 generic<=16
             (RS(16,4) parity) and generic<=32 (random 20 -> 5); K2 10->4
             at (10, 4 MiB) and generic<=16 (random 12 -> 3), each with
             its folded block CRCs against the host crc32c; then the
             volume axis: K1 and K2 10->4 at V = 3 with 1027 tiles per
             volume (not a multiple of 256), the LRC local repair 5->1
             (K1 at 1 MiB, K2 at a whole 26 MiB LRC shard), and a
             rebuild-sized (2, 10, 26 MiB) decode;
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
             (10 -> 1, 1 MiB), K2 at (10 -> 4, 4 MiB); at the batched
             path's (4, 10, 4 MiB) encode step and its largest rebuild
             step, and at LRC's 5 -> 1 (K1 1 MiB, K2 one LRC shard).
             CUDA events around many launches that the host has all
             issued before the card reaches the start event (a
             torch.cuda._sleep fills the queue), inputs rotated through
             more than the 50 MB L2; the host microseconds per wrapper
             call beside each.
6. batch   — the batched multi-volume path (parallel/): four RS volumes
             of 512/384/256/160 MiB (/ --batch-div), `ec.encode -batch`
             at -fullPercent of one collection, cut from 30000 MB, go
             through batch_encode_files in one group (max_batch_bytes
             2 GiB: steps of (4, 10, 4 MiB) shrinking as volumes end),
             once with the CRC fused (K2) and once on the host (K1), and
             must equal write_ec_files's files (sha256); shards 1/3/9/12
             of all four are deleted and batch_rebuild_files rebuilds
             them in whole-shard steps (2, 10, ~52 MiB) and (2, 10,
             ~26 MiB); one 256 MiB LRC volume is batch-encoded, loses
             shard 3 and is rebuilt by the 5-read local repair, then
             loses shards 3 and 7 for 300 seeded degraded reads.  Each
             of these paths runs with the launch counts reset just
             before it and read just after, and must have launched its
             instantiations (with a volume axis where it stacks).
7. observability — phases 4, 6 and 8 run with the roofline ledger armed
             and the EC stage timing on (the defaults), and each of their
             paths is a window: the ledger's rows, the
             SeaweedFS_ec_stage_* histograms and the repair-read bytes
             are read just before and just after it.  Phase 7 checks that
             each window's ledger rows equal its kernel launches under the
             catalog key of its call site, that every stage's bytes equal
             the bytes the path moved (from the shard sizes), that every
             achieved fraction is in (0, 1], the ledger's conservation,
             the exposition against promcheck, an encode and a rebuild
             occupancy doc, and the LRC volume's ec.repair.local event.
             Phase 8's three kernel steps are windows like phase 4's.
             The hooks' cost, outside the counted windows and after the
             launch counts are read: phase 4's degraded reads run again
             with the hooks off, with the stage timing alone and armed
             (SEAWEEDFS_TPU_EC_PROF, roofline.set_armed), in turns, and
             so does one degraded read's coder call, beside each piece
             the armed mode adds timed alone; phase 6's RS batched
             encode runs again off and armed in turns.  Beside the
             ledger's K1 10->4 row: that launch alone, timed by the
             ledger's event pair, with the card busy and after idling.

8. storage — one volume's life through the storage engine
             (storage/): `weed volume -dir=... -max=7` with the compact
             needle map under `weed master -volumeSizeLimitMB=30000`, the
             volume cut to --dat-mib.  Store.write_needle fills it with
             needles log-uniform in 1 KiB..4 MiB, one of them written with
             volume.corrupt armed; half a record appended to the .dat (a
             torn tail) must be truncated exactly by the remount's
             recover_volume_files; ScrubDaemon.scrub_volume quarantines the
             rotten needle; 10 % of the needles are deleted and vacuum must
             leave exactly the live records; ec.generate (readonly, sync,
             .ecx, write_ec_files with fused CRC: K2 10->4, .vif); the EC
             volume is mounted, the source deleted, 5 needles deleted
             through the EC volume (.ecj); one byte flipped in a 1 MiB
             block of shard 3 and of shard 12 (different blocks), and
             ScrubDaemon.scrub_ec_volume(repair=True) with the local
             block-repair callback must repair both (K1 10->1) and restore
             every shard's sha256; shards 2/5/11/13 are deleted and rebuilt
             (K1 10->4); ec.to_volume (.dat from the data shards, .idx from
             .ecx + .ecj) is mounted through Store, every live needle reads
             back with its CRC checked, every deleted or quarantined one
             raises NotFoundError, and the decoded volume scrubs clean.  The
             scrub's throttle is off (mbps=0, its documented "disabled").

Phase 6 runs before phase 8, and phase 8 before phase 5, whose timings
include phase 6's shapes; phase 7 runs last.

The build phase also logs ptxas's registers per kernel and, where the
toolkit has cuobjdump, static SASS opcode counts per kernel.

Prints a {"main_path": ...} line, a {"batch_path": ...} line, a
{"storage_path": ...} line (walls and GB/s per step, needles written,
deleted and quarantined, bytes reclaimed, launches per step and
instantiation, device busy share), an {"observability": ...} line,
nvidia-smi's line, a {"kernels": [...]} line, and last {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
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
# The same data sheet's dense bf16 tensor-core rate, and PCIe Gen5 x16's
# 64 GB/s per direction: what the roofline probes are read against.
BF16_FLOPS_PER_S = 989.5e12
PCIE_BYTES_PER_S = 64e9

# torch.cuda._sleep spins for a count of SM clock cycles; the H100's
# boost clock is below 2 GHz, so this many cycles last at least a second.
SLEEP_CYCLES_PER_S = 2e9

MIB = 1024 * 1024
KERNEL_N = 4 * MIB  # DEFAULT_CHUNK: one coder call on the main path
REBUILD_LOST = (1, 3, 9, 12)
READ_LOST = (0, 4, 8, 13)
READS = 300
# The batched path: full volumes of one collection (MiB), its group
# bound, and the LRC volume with its losses.
BATCH_MIB = (512, 384, 256, 160)
BATCH_BYTES = 2 << 30
LRC_MIB = 256
LRC_REBUILD_LOST = (3,)
LRC_READ_LOST = (3, 7)
EC_EXTS = tuple(f".ec{i:02d}" for i in range(14)) + (".ecx", ".vif", ".ecc")
PHASE6_STEPS = ("rs_encode", "rs_encode_unfused", "rs_rebuild", "lrc_encode",
                "lrc_rebuild", "lrc_reads")
# The stages of the SeaweedFS_ec_stage_* histograms the EC paths feed.
EC_STAGES = ("encode_kernel", "encode_crc_kernel", "reconstruct_kernel",
             "batch_stack", "batch_encode_device", "batch_write",
             "batch_gather", "batch_rebuild_device", "batch_scatter")
# Catalog keys the ledger must hold after phases 4 and 6 (encode_kernel,
# the unfused single-volume encode, runs on no path of the card).
PATH_KERNELS = ("encode_crc_kernel", "reconstruct_kernel", "batch_encode",
                "batch_reconstruct")
# The hooks' modes: both off (SEAWEEDFS_TPU_EC_PROF=0, ledger disarmed);
# the stage timing alone (event pair, settle, histograms); and armed
# (timing plus a ledger row per launch, the default).
# Reads and coder calls take the modes in turns call by call (the order
# rotated from one call to the next); the batched encode's turns run
# forwards then backwards, so no mode always runs later.
HOOK_MODES = ("off", "timing", "armed")
HOOK_ROUNDS = 2  # times each degraded read runs in each mode
HOOK_TURNS_BATCH = ("off", "armed", "armed", "off", "off", "armed")
SPLIT_N = 64 * 1024  # width of the per-call cost's coder calls
# The storage path (phase 8): `weed volume -max=7` with the default
# compact needle map; the needle written while volume.corrupt is armed;
# the share of needles deleted before the encode and the count deleted
# from the EC volume; the data and parity shard whose blocks rot; the
# shards lost before the rebuild (four, so it runs K1 10->4).
STORAGE_VID = 1
STORAGE_COLLECTION = "smoke"
STORAGE_MAX_VOLUMES = 7
STORAGE_CORRUPT_NID = 7
STORAGE_DELETE_SHARE = 0.1
STORAGE_EC_DELETES = 5
STORAGE_ROT_SHARDS = (3, 12)
STORAGE_REBUILD_LOST = (2, 5, 11, 13)
STORAGE_STEPS = ("storage_generate", "storage_ec_scrub", "storage_rebuild")


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
    into block CRCs against the host crc32c of every row (of every
    volume, for a (V, rows, n) input)."""
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
    n = x.shape[-1]
    nb = n // MIB
    rows = torch.cat([x, par], dim=-2).cpu().numpy().reshape(
        -1, x.shape[-2] + par.shape[-2], n)
    parts_np = parts.cpu().numpy().view(np.uint32).reshape(
        rows.shape[0], rows.shape[1], -1)
    for v in range(rows.shape[0]):
        for i in range(rows.shape[1]):
            folded = crc_fold.block_crcs_from_partials(parts_np[v, i],
                                                       nb * MIB, 4096)
            host = [crc32c(rows[v, i, b * MIB:(b + 1) * MIB].tobytes())
                    for b in range(nb)]
            check(folded == host, f"K2 {name}: block CRCs of volume {v} "
                  f"row {i} differ from crc32c")
    return par, err


def _volume_cases(torch, dev, rng, parity_masks, consts) -> tuple[int, int]:
    """The batched path's shapes on the card against the plain versions:
    K1 and K2 10->4 at V = 3 with 1027 tiles per volume (a flat tile
    index would give wrong CRCs for volumes 1 and 2), LRC's local repair
    5 -> 1 (K1 at 1 MiB, K2 at a whole 26 MiB LRC shard), and K1 and K2
    at a (2, 10, 26 MiB) rebuild decode.  Returns (K1 err, K2 err)."""
    from seaweedfs_tpu_torch.codecs import get_codec
    from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix,
                                                    apply_bitmatrix_crc,
                                                    pack_bitmatrix,
                                                    plane_major)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    host_masks = lambda b, rows, cols: torch.from_numpy(  # noqa: E731
        pack_bitmatrix(plane_major(np.asarray(b), rows, cols)))
    e1, e2 = [], []

    n3 = 4 * MIB + 3 * 4096
    x3 = up(rng.integers(0, 256, (3, 10, n3), dtype=np.uint8))
    got, err = _k1_case(torch, dev, parity_masks, x3, "10->4 V=3")
    e1.append(err)
    par, err = _k2_case(torch, dev, parity_masks, x3, consts, "10->4 V=3")
    e2.append(err)
    check(torch.equal(par, got), "K2 parity differs from K1 parity at V=3")
    single = apply_bitmatrix_crc(parity_masks, x3[2], *consts)[1]
    check(torch.equal(apply_bitmatrix_crc(parity_masks, x3, *consts)[1][2],
                      single), "K2 partials of volume 2 differ from its "
          "single-volume launch")
    log(f"K1, K2 10->4 at (3, 10, {n3}) (1027 tiles per volume): identical "
        "to the plain versions; every volume's block CRCs equal crc32c")

    lrc = get_codec("lrc")
    lrc_par = host_masks(lrc.parity_bitmatrix(), 4, 10)
    local = tuple(s for s in lrc.repair_plan(
        tuple(s for s in range(14) if s != 3), [3])[0].reads)
    bmat, used = lrc.decode_bitmatrix(local, (3,))
    check(len(used) == 5, f"LRC local repair reads {used}")
    rd5 = host_masks(bmat, 1, 5)
    for n, label in ((MIB, "K1"), (26 * MIB, "K2")):
        data = up(rng.integers(0, 256, (10, n), dtype=np.uint8))
        full = torch.cat([data, apply_bitmatrix(lrc_par, data)])
        x5 = full[list(used)].contiguous()
        if label == "K1":
            rec, err = _k1_case(torch, dev, rd5, x5, "generic 5->1")
            e1.append(err)
        else:
            rec, err = _k2_case(torch, dev, rd5, x5, consts, "generic 5->1")
            e2.append(err)
        check(torch.equal(rec[0], full[3]), f"{label} 5->1 did not restore "
              "LRC shard 3")
        del data, full, x5
    log(f"LRC local repair {used} -> 3: K1 at 1 MiB and K2 at 26 MiB "
        "identical to the plain versions and to the erased shard")

    rs = get_codec("rs")
    data = up(rng.integers(0, 256, (2, 10, 26 * MIB), dtype=np.uint8))
    full = torch.cat([data, apply_bitmatrix(parity_masks, data)], dim=1)
    present = tuple(s for s in range(14) if s not in REBUILD_LOST)
    bmat, used = rs.decode_bitmatrix(present, REBUILD_LOST)
    dec = host_masks(bmat, len(REBUILD_LOST), len(used))
    stacked = full[:, list(used)].contiguous()
    want = full[:, list(REBUILD_LOST)]
    rec, err = _k1_case(torch, dev, dec, stacked, "10->4 decode V=2")
    e1.append(err)
    check(torch.equal(rec, want), "K1 (2, 10, 26 MiB) decode did not "
          "restore the erased shards")
    rec, err = _k2_case(torch, dev, dec, stacked, consts, "10->4 decode V=2")
    e2.append(err)
    check(torch.equal(rec, want), "K2 (2, 10, 26 MiB) decode did not "
          "restore the erased shards")
    log("K1, K2 10->4 decode at (2, 10, 26 MiB): identical to the plain "
        "versions and to the erased shards")
    return max(e1), max(e2)


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

    for fn in (apply_bitmatrix, apply_bitmatrix_crc):
        fn.volume_launches = 0
    v1, v2 = _volume_cases(torch, dev, rng, parity_masks, consts)
    errs.append(v1)
    err_k2 = max(err_k2, v2)

    for fn, names in ((apply_bitmatrix, K1_VARIANTS),
                      (apply_bitmatrix_crc, K2_VARIANTS)):
        for name in names:
            check(fn.variant_launches[name] > 0,
                  f"instantiation {name} of {fn.__name__} not launched")
        check(fn.volume_launches > 0,
              f"{fn.__name__} never launched with a volume axis")
    return {"k1_err": max(errs), "k2_err": err_k2,
            "parity_masks": parity_masks, "decode_masks": decode_masks,
            "read_masks": read_masks, "crc_consts": consts}


def reset_counts() -> None:
    """Every kernel wrapper's launch counts to 0."""
    from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix,
                                                    apply_bitmatrix_crc)
    for fn in (apply_bitmatrix, apply_bitmatrix_crc):
        fn.launches = 0
        fn.volume_launches = 0
        fn.variant_launches.update(dict.fromkeys(fn.variant_launches, 0))


def read_counts() -> dict:
    """Launch counts of both kernels since the last reset_counts."""
    from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix,
                                                    apply_bitmatrix_crc)
    return {fn_name: {"launches": fn.launches,
                      "volume_axis_launches": fn.volume_launches,
                      "by_instantiation": dict(fn.variant_launches)}
            for fn_name, fn in (("rs_bitmatrix", apply_bitmatrix),
                                ("rs_bitmatrix_crc", apply_bitmatrix_crc))}


@contextlib.contextmanager
def hooks(mode: str):
    """The EC stage timing (SEAWEEDFS_TPU_EC_PROF) and the roofline
    ledger (roofline.set_armed) in one of HOOK_MODES, restored after."""
    from seaweedfs_tpu_torch.stats import roofline
    check(mode in HOOK_MODES, f"hook mode {mode}")
    armed, prof = roofline.ARMED, os.environ.get("SEAWEEDFS_TPU_EC_PROF")
    roofline.set_armed(mode == "armed")
    os.environ["SEAWEEDFS_TPU_EC_PROF"] = "0" if mode == "off" else "1"
    try:
        yield
    finally:
        roofline.set_armed(armed)
        if prof is None:
            del os.environ["SEAWEEDFS_TPU_EC_PROF"]
        else:
            os.environ["SEAWEEDFS_TPU_EC_PROF"] = prof


def obs_snapshot(torch) -> dict:
    """The observability counters phase 7 reads, once the card has run
    every launch issued so far (so each timed launch is settled into the
    ledger): ledger rows and analytic bytes per catalog key, bytes and
    observations per EC stage, repair-read bytes per codec, and the
    kernel wrappers' launches since the last reset_counts."""
    from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix,
                                                    apply_bitmatrix_crc)
    from seaweedfs_tpu_torch.stats import metrics, roofline
    torch.cuda.synchronize()
    rows: dict = {}
    nbytes: dict = {}
    for r in roofline.LEDGER.kernel_table():
        rows[r["kernel"]] = rows.get(r["kernel"], 0) + r["count"]
        nbytes[r["kernel"]] = nbytes.get(r["kernel"], 0) + r["bytes"]
    return {
        "rows": rows, "bytes": nbytes,
        "stage_bytes": {s: metrics.ec_stage_bytes.value(stage=s)
                        for s in EC_STAGES},
        "stage_count": {s: metrics.ec_stage_seconds.count(stage=s)
                        for s in EC_STAGES},
        "repair": {c: metrics.ec_repair_read_bytes_total.value(codec=c)
                   for c in ("rs", "lrc")},
        "launches": apply_bitmatrix.launches + apply_bitmatrix_crc.launches}


def obs_window(before: dict, after: dict) -> dict:
    """What one path added to the planes (the non-zero differences of two
    obs_snapshot's), with the ledger rows it recorded under `_rows`."""
    from seaweedfs_tpu_torch.stats import roofline
    out: dict = {}
    for part in ("rows", "bytes", "stage_bytes", "stage_count", "repair"):
        diff = {k: v - before[part].get(k, 0) for k, v in after[part].items()}
        out[part] = {k: v for k, v in diff.items() if v}
    out["launches"] = after["launches"] - before["launches"]
    n = sum(out["rows"].values())
    out["_rows"] = roofline.LEDGER.recent(n) if n else []
    return out


def read_pass(vol, sample, payloads) -> tuple[list, list]:
    """Read every needle of `sample` and check it; returns the seconds of
    the reads that launched K1 (degraded) and of the others."""
    from seaweedfs_tpu_torch.ops.coder_cuda import apply_bitmatrix
    degraded, local = [], []
    for nid in sample:
        before = apply_bitmatrix.launches
        t0 = time.perf_counter()
        n = vol.read_needle(nid)
        dt = time.perf_counter() - t0
        check(n.data == payloads[nid], f"needle {nid} read back wrong")
        (degraded if apply_bitmatrix.launches > before else local).append(dt)
    return degraded, local


def pct_ms(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None


def in_turns(items, run, rounds: int) -> dict:
    """run(item) once in each hook mode for every item, `rounds` times,
    the modes' order rotated from one item to the next: {mode: [seconds
    per call]}, the lists in the same item order, so they pair up."""
    out: dict = {m: [] for m in HOOK_MODES}
    turn = 0
    for _ in range(rounds):
        for item in items:
            for j in range(len(HOOK_MODES)):
                mode = HOOK_MODES[(turn + j) % len(HOOK_MODES)]
                with hooks(mode):
                    t0 = time.perf_counter()
                    run(item)
                    out[mode].append(time.perf_counter() - t0)
            turn += 1
    return out


def turns_summary(t: dict, scale: float) -> dict:
    """Per mode the median call, and per mode the median of its paired
    difference to the same call with the hooks off, in seconds x scale."""
    off = np.asarray(t["off"])
    return {"median": {m: float(np.median(v)) * scale for m, v in t.items()},
            "paired_minus_off": {
                m: float(np.median(np.asarray(v) - off)) * scale
                for m, v in t.items() if m != "off"},
            "calls_per_mode": len(off)}


def _median_us(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


def hooks_per_call(torch, dev, reps: int = 300) -> dict:
    """Where the hooks' cost of a degraded read goes, on the host: a
    degraded read's coder call (CudaCoder reconstruct 10 -> 1 at
    SPLIT_N, host copies in and out) `reps` times in each hook mode
    (in_turns), in microseconds; and each piece the armed mode adds to
    a launch, alone: the stage histograms, a ledger row (on a ledger of
    its own), a settle with nothing pending, a timer's pooled event pair
    taken, seen complete, read and given back, and how much more a
    launch and a wait for it take with the pair recorded around the
    launch than without (paired call by call)."""
    from seaweedfs_tpu_torch.ops.coder_cuda import CudaCoder, apply_bitmatrix
    from seaweedfs_tpu_torch.ops.erasure import host_array
    from seaweedfs_tpu_torch.stats import metrics, roofline

    rng = np.random.default_rng(5)
    coder = CudaCoder(device=dev)
    shards = {i: rng.integers(0, 256, SPLIT_N, dtype=np.uint8)
              for i in range(1, 11)}

    def call():
        host_array(coder.reconstruct(shards, wanted=[0])[0])

    call()
    calls = turns_summary(in_turns(range(reps), lambda _i: call(), 1), 1e6)

    ledger = roofline.RooflineLedger()
    torch.cuda.synchronize()  # every pooled pair's events complete

    def timer():
        t = roofline.KernelTimer(dev)
        t.events()
        return t.seconds()

    # One launch and a wait for it, without and with a timer (the pair
    # recorded by the launcher, then read and given back).
    masks = coder._decode_masks(tuple(range(1, 11)), (0,))[0]
    x = torch.from_numpy(np.stack(list(shards.values()))).to(dev)

    def launch(timed):
        t0 = time.perf_counter()
        t = roofline.KernelTimer(dev) if timed else None
        apply_bitmatrix(masks, x, timer=t)
        torch.cuda.synchronize()
        if t is not None:
            t.seconds()
        return time.perf_counter() - t0

    pair_extra = []
    for i in range(reps):
        first = bool(i % 2)
        a, b = launch(first), launch(not first)
        pair_extra.append((a - b) if first else (b - a))

    pieces = {
        "observe_ec_stage": _median_us(lambda: metrics.observe_ec_stage(
            "reconstruct_kernel", 1e-5, 10 * SPLIT_N), reps),
        "ledger_record": _median_us(lambda: ledger.record(
            "reconstruct_kernel", "rs", "int8", out_rows=1, in_rows=10,
            n=SPLIT_N, seconds=1e-5, measured_bytes=11 * SPLIT_N,
            device=dev), reps),
        "settle_empty": _median_us(roofline.settle, reps),
        "timer_pair": _median_us(timer, reps),
        "launch_and_wait_with_pair_minus_without":
            float(np.median(pair_extra)) * 1e6}
    log(f"coder call 10->1 at {SPLIT_N} B, median us per hook mode: "
        f"{calls}; armed pieces alone, us: {pieces}")
    return {"coder_call_us": calls, "armed_pieces_us": pieces}


def phase_probe(torch, dev) -> dict:
    """The roofline plane's peaks, probed on the card (never read from a
    cache), beside the data sheet's figures.  A failed probe or a zero
    peak fails the phase."""
    from seaweedfs_tpu_torch.stats import roofline
    # Keep the probe cache inside the checkout (removed with _smoke_work).
    os.environ.setdefault("SEAWEEDFS_TPU_ROOFLINE_CACHE",
                          os.path.join(REPO, "_smoke_work", "peaks"))
    doc = roofline.probe_peaks(dev, force=True)
    check("error" not in doc, f"roofline probe failed: {doc.get('error')}")
    flops = doc["matmul_flops"]
    probed = {"int8_ops_s": flops.get("int8", 0.0),
              "bf16_flops_s": flops.get("bf16", 0.0),
              "membw_bytes_s": doc["membw_bps"],
              "h2d_bytes_s": doc["h2d_bps"], "d2h_bytes_s": doc["d2h_bps"]}
    sheet = {"int8_ops_s": INT_OPS_PER_S, "bf16_flops_s": BF16_FLOPS_PER_S,
             "membw_bytes_s": HBM_BYTES_PER_S,
             "h2d_bytes_s": PCIE_BYTES_PER_S, "d2h_bytes_s": PCIE_BYTES_PER_S}
    for k, v in probed.items():
        check(v > 0, f"roofline probe: {k} is {v}")
    ratio = {k: probed[k] / sheet[k] for k in sheet}
    log(f"roofline peaks of {doc['device_kind']} in {doc['probe_seconds']} s: "
        + ", ".join(f"{k} {probed[k]:.4g} ({ratio[k]:.3f} of the data sheet)"
                    for k in probed))
    return {"device_kind": doc["device_kind"], "probed": probed,
            "data_sheet": sheet, "probed_over_data_sheet": ratio,
            "host_stream_bytes_s": doc["host_stream_bps"],
            "probe_seconds": doc["probe_seconds"]}


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

        reset_counts()
        obs: dict = {}
        last = [obs_snapshot(torch)]

        def close_window(name):
            now = obs_snapshot(torch)
            obs[name] = obs_window(last[0], now)
            last[0] = now

        t0 = time.perf_counter()
        write_ec_files(base, device=dev)
        encode_s = time.perf_counter() - t0
        close_window("main_encode")
        k2_encode = apply_bitmatrix_crc.launches
        shard_bytes = os.path.getsize(base + to_ext(0))
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
        close_window("main_rebuild")
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
        vol = EcVolume(base, device=dev)
        try:
            lat_degraded, lat_local = read_pass(vol, sample, payloads)
            close_window("main_reads")
            launches = {"rs_bitmatrix": apply_bitmatrix.launches,
                        "rs_bitmatrix_crc": apply_bitmatrix_crc.launches}
            by_instantiation = {
                "rs_bitmatrix": dict(apply_bitmatrix.variant_launches),
                "rs_bitmatrix_crc": dict(apply_bitmatrix_crc.variant_launches)}
            log(f"{len(sample)} reads verified, {len(lat_degraded)} degraded; "
                f"launches {launches}")
            for name, count in launches.items():
                check(count > 0, f"{name} never launched on the main path")
            # The hooks' cost: the degraded reads again, after the counts
            # were read and outside the counted windows, in each mode.
            degraded = []
            for nid in sample:
                before = apply_bitmatrix.launches
                vol.read_needle(nid)
                if apply_bitmatrix.launches > before:
                    degraded.append(nid)

            def read(nid):
                check(vol.read_needle(nid).data == payloads[nid],
                      f"needle {nid} read back wrong")

            cost: dict = {"degraded_read_ms": turns_summary(
                in_turns(degraded, read, HOOK_ROUNDS), 1e3)}
            log(f"degraded reads per hook mode, ms: "
                f"{cost['degraded_read_ms']}")
        finally:
            vol.close()
        cost.update(hooks_per_call(torch, dev))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    return {
        "dat_bytes": dat_size, "needles": len(payloads),
        "reduced": f"volume 30000 MB -> {args.dat_mib} MiB",
        "shard_bytes": shard_bytes,
        "encode_s": encode_s, "encode_gb_s": dat_size / encode_s / 1e9,
        "rebuild_s": rebuild_s, "rebuild_gb_s": dat_size / rebuild_s / 1e9,
        "reads": len(sample), "degraded_reads": len(lat_degraded),
        "degraded_read_p50_ms": pct_ms(lat_degraded, 50),
        "degraded_read_p99_ms": pct_ms(lat_degraded, 99),
        "local_read_p50_ms": pct_ms(lat_local, 50),
        "hooks_cost": cost,
        "obs": obs,
        "launches": launches,
        "launches_by_instantiation": by_instantiation,
        "launches_by_step": {"encode_rs_bitmatrix_crc": k2_encode,
                             "rebuild_rs_bitmatrix": k1_rebuild,
                             "reads_rs_bitmatrix":
                                 launches["rs_bitmatrix"] - k1_rebuild},
    }


def _same_files(a: str, b: str, what: str) -> None:
    """Every EC file of base a equals base b's (sha256)."""
    for ext in EC_EXTS:
        check(os.path.exists(a + ext) == os.path.exists(b + ext),
              f"{what}: {ext} exists in one tree only")
        if os.path.exists(a + ext):
            check(sha256_file(a + ext) == sha256_file(b + ext),
                  f"{what}: {ext} differs from write_ec_files's")


def _reference_encode(base: str, ref: str, dev, codec: str) -> None:
    """write_ec_files of the port on hard links of base's .dat/.idx."""
    from seaweedfs_tpu_torch.ec.encoder import (write_ec_files,
                                                write_sorted_file_from_idx)
    for ext in (".dat", ".idx"):
        os.link(base + ext, ref + ext)
    write_sorted_file_from_idx(ref)
    write_ec_files(ref, codec=codec, device=dev)


def _check_rebuilt(base: str, ref: str, lost, what: str) -> None:
    from seaweedfs_tpu_torch.ec import to_ext
    from seaweedfs_tpu_torch.ec.integrity import (ShardChecksums,
                                                  file_block_crcs)
    ecc = ShardChecksums.load(base)
    for sid in lost:
        check(sha256_file(base + to_ext(sid)) == sha256_file(ref + to_ext(sid)),
              f"{what}: rebuilt shard {sid} differs from the original")
        check(ecc.get(sid) == file_block_crcs(base + to_ext(sid)),
              f"{what}: .ecc of rebuilt shard {sid} differs from its bytes")


def phase_batch(torch, dev, args) -> dict:
    """The batched multi-volume path at full width: RS encode of
    four volumes in one group and their whole-shard rebuild, an LRC
    volume's encode, 5-read local rebuild and degraded reads.  Each
    path is driven with the launch counts reset just before it and read
    just after; every file is held against write_ec_files's."""
    from seaweedfs_tpu_torch.codecs import get_codec
    from seaweedfs_tpu_torch.ec import to_ext
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.ops.coder_cuda import apply_bitmatrix
    from seaweedfs_tpu_torch.parallel.cluster_encode import (
        batch_encode_files, pipeline_depth)
    from seaweedfs_tpu_torch.parallel.cluster_rebuild import (
        batch_rebuild_files, plan_repair_reads)
    from seaweedfs_tpu_torch.parallel.mesh import make_mesh
    from seaweedfs_tpu_torch.parallel.stream_pipeline import PipelineRecorder

    work = os.path.join(REPO, "_smoke_work", "batch")
    shutil.rmtree(work, ignore_errors=True)
    for sub in ("rs", "rs_ref", "lrc", "lrc_ref"):
        os.makedirs(os.path.join(work, sub))
    mesh = make_mesh()
    out: dict = {"mesh": mesh.shape, "max_batch_bytes": BATCH_BYTES}
    try:
        mibs = [m // args.batch_div for m in BATCH_MIB]
        bases = [os.path.join(work, "rs", str(i + 1)) for i in range(len(mibs))]
        refs = [os.path.join(work, "rs_ref", str(i + 1)) for i in range(len(mibs))]
        t0 = time.perf_counter()
        for i, (base, mib) in enumerate(zip(bases, mibs)):
            write_volume(base, mib * MIB, args.seed + 10 + i)
        dat_bytes = sum(os.path.getsize(b + ".dat") for b in bases)
        log(f"wrote RS volumes {mibs} MiB in {time.perf_counter() - t0:.1f} s")

        def timed(name, fn):
            """Run one path with fresh launch counts and peak device
            memory; the steps in flight must stay within
            max_batch_bytes x (depth + 1)."""
            rec = PipelineRecorder(maxlen=1 << 16)
            reset_counts()
            before = obs_snapshot(torch)
            torch.cuda.reset_peak_memory_stats(dev)
            base_bytes = torch.cuda.memory_allocated(dev)
            t = time.perf_counter()
            result = fn(rec)
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated(dev) - base_bytes
            out[name] = {"wall_s": wall, "launches": read_counts(),
                         "obs": obs_window(before, obs_snapshot(torch)),
                         "stage_seconds": rec.stage_seconds(),
                         "steps": len({i for _s, i, _a, _b in rec.spans()}),
                         "peak_device_bytes": peak}
            out[name]["stage_sum_over_wall"] = \
                sum(out[name]["stage_seconds"].values()) / wall
            check(peak <= BATCH_BYTES * (pipeline_depth() + 1),
                  f"{name}: {peak} bytes on the card at once")
            return result

        timed("rs_encode", lambda rec: batch_encode_files(
            bases, mesh, max_batch_bytes=BATCH_BYTES, codec="rs",
            recorder=rec))
        out["rs_encode"]["gb_s"] = dat_bytes / out["rs_encode"]["wall_s"] / 1e9
        out["rs_encode"]["dat_bytes"] = dat_bytes
        out["rs_encode"]["shard_bytes"] = sum(
            os.path.getsize(b + to_ext(0)) for b in bases)
        for base, ref in zip(bases, refs):
            _reference_encode(base, ref, dev, "rs")
            _same_files(base, ref, f"RS volume {os.path.basename(base)}")
        log(f"batched RS encode of {len(bases)} volumes "
            f"{out['rs_encode']['wall_s']:.3f} s "
            f"({out['rs_encode']['gb_s']:.3f} GB/s): every shard, .ecx, "
            ".vif and .ecc equals write_ec_files's")

        # The hooks' cost: the same group again on links of its .dat/.idx,
        # outside the counted windows, off and armed in turns, each
        # without a caller's recorder (armed, the path makes its own).
        cost: dict = {"off_wall_s": [], "armed_wall_s": []}
        for turn, mode in enumerate(HOOK_TURNS_BATCH):
            sub = os.path.join(work, f"rs_hooks{turn}")
            os.makedirs(sub)
            copies = [os.path.join(sub, str(i + 1)) for i in range(len(bases))]
            for base, copy in zip(bases, copies):
                for ext in (".dat", ".idx"):
                    os.link(base + ext, copy + ext)
            # Each turn writes ~2 GB of shards: start every turn with no
            # dirty pages, or a writeback stall lands on whichever turn
            # crosses the kernel's dirty threshold.
            os.sync()
            with hooks(mode):
                t = time.perf_counter()
                batch_encode_files(copies, mesh, max_batch_bytes=BATCH_BYTES,
                                   codec="rs")
                wall = time.perf_counter() - t
            cost[f"{mode}_wall_s"].append(wall)
            if turn == 0:
                for copy, ref in zip(copies, refs):
                    _same_files(copy, ref, f"RS volume "
                                f"{os.path.basename(copy)}, hooks off")
            shutil.rmtree(sub)
        out["rs_encode"]["hooks_cost"] = cost
        log(f"batched RS encode again: hooks off {cost['off_wall_s']} s, "
            f"armed {cost['armed_wall_s']} s")

        # The same group with the CRC left to the host: K1 with a volume
        # axis, then the .ecc from the written shards.
        unfused = [os.path.join(work, "rs_k1", str(i + 1))
                   for i in range(len(bases))]
        os.makedirs(os.path.join(work, "rs_k1"))
        for base, copy in zip(bases, unfused):
            for ext in (".dat", ".idx"):
                os.link(base + ext, copy + ext)
        os.environ["SEAWEEDFS_TPU_EC_FUSED_CRC"] = "0"
        try:
            timed("rs_encode_unfused", lambda rec: batch_encode_files(
                unfused, mesh, max_batch_bytes=BATCH_BYTES, codec="rs",
                recorder=rec))
        finally:
            del os.environ["SEAWEEDFS_TPU_EC_FUSED_CRC"]
        for copy, ref in zip(unfused, refs):
            _same_files(copy, ref, f"RS volume {os.path.basename(copy)}, "
                        "CRC on the host")
        shutil.rmtree(os.path.join(work, "rs_k1"))
        log(f"batched RS encode with the CRC on the host (K1) "
            f"{out['rs_encode_unfused']['wall_s']:.3f} s: identical")

        for base in bases:
            for sid in REBUILD_LOST:
                os.remove(base + to_ext(sid))
        msgs = timed("rs_rebuild", lambda rec: batch_rebuild_files(
            bases, mesh, max_batch_bytes=BATCH_BYTES, recorder=rec))
        out["rs_rebuild"]["gb_s"] = \
            dat_bytes / out["rs_rebuild"]["wall_s"] / 1e9
        check(len(msgs) == len(bases) and all("rebuilt" in m for m in msgs),
              f"RS batched rebuild: {msgs}")
        for base, ref in zip(bases, refs):
            _check_rebuilt(base, ref, REBUILD_LOST,
                           f"RS volume {os.path.basename(base)}")
        log(f"batched RS rebuild of shards {REBUILD_LOST} x {len(bases)} "
            f"{out['rs_rebuild']['wall_s']:.3f} s: identical, .ecc matches")
        shutil.rmtree(os.path.join(work, "rs"))
        shutil.rmtree(os.path.join(work, "rs_ref"))

        lrc = os.path.join(work, "lrc", "1")
        lrc_ref = os.path.join(work, "lrc_ref", "1")
        payloads = write_volume(lrc, LRC_MIB // args.batch_div * MIB,
                                args.seed + 20)
        timed("lrc_encode", lambda rec: batch_encode_files(
            [lrc], mesh, max_batch_bytes=BATCH_BYTES, codec="lrc",
            recorder=rec))
        out["lrc_encode"]["shard_bytes"] = os.path.getsize(lrc + to_ext(0))
        out["lrc_vid"] = lrc
        _reference_encode(lrc, lrc_ref, dev, "lrc")
        _same_files(lrc, lrc_ref, "LRC volume")
        codec = get_codec("lrc")
        present = tuple(s for s in range(14) if s not in LRC_REBUILD_LOST)
        plan = plan_repair_reads(codec, present, LRC_REBUILD_LOST)
        out["lrc_repair_plan"] = plan
        check(plan["planned_read_shards"] == 5,
              f"LRC local repair plans {plan['planned_read_shards']} reads")
        for sid in LRC_REBUILD_LOST:
            os.remove(lrc + to_ext(sid))
        msgs = timed("lrc_rebuild", lambda rec: batch_rebuild_files(
            [lrc], mesh, max_batch_bytes=BATCH_BYTES, recorder=rec))
        check(len(msgs) == 1 and "read 5 shards" in msgs[0],
              f"LRC batched rebuild: {msgs}")
        _check_rebuilt(lrc, lrc_ref, LRC_REBUILD_LOST, "LRC volume")
        log(f"LRC: batched encode identical to write_ec_files; local rebuild "
            f"of {LRC_REBUILD_LOST} read {plan['union_reads']}: identical")

        for sid in LRC_READ_LOST:
            os.remove(lrc + to_ext(sid))
        rng = np.random.default_rng(args.seed + 21)
        ids = sorted(payloads)
        sample = [ids[i] for i in rng.choice(len(ids), min(READS, len(ids)),
                                             replace=False)]
        degraded = [0]

        def reads(_rec):
            vol = EcVolume(lrc, device=dev)
            try:
                for nid in sample:
                    before = apply_bitmatrix.launches
                    check(vol.read_needle(nid).data == payloads[nid],
                          f"LRC needle {nid} read back wrong")
                    degraded[0] += apply_bitmatrix.launches > before
            finally:
                vol.close()

        timed("lrc_reads", reads)
        out["lrc_reads"].update(reads=len(sample), degraded_reads=degraded[0])
        log(f"LRC: {len(sample)} reads with shards {LRC_READ_LOST} lost "
            f"verified, {degraded[0]} degraded")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    c = {k: out[k]["launches"] for k in PHASE6_STEPS}
    for step, fn, variant in (("rs_encode", "rs_bitmatrix_crc", "10->4"),
                              ("rs_encode_unfused", "rs_bitmatrix", "10->4"),
                              ("rs_rebuild", "rs_bitmatrix_crc", "10->4"),
                              ("lrc_encode", "rs_bitmatrix_crc", "10->4"),
                              ("lrc_rebuild", "rs_bitmatrix_crc",
                               "generic<=16"),
                              ("lrc_reads", "rs_bitmatrix", "generic<=16")):
        check(c[step][fn]["by_instantiation"][variant] > 0,
              f"{step}: {fn} {variant} never launched")
    for step, fn in (("rs_encode", "rs_bitmatrix_crc"),
                     ("rs_rebuild", "rs_bitmatrix_crc"),
                     ("rs_encode_unfused", "rs_bitmatrix")):
        check(c[step][fn]["volume_axis_launches"] > 0,
              f"{step}: no {fn} launch with a volume axis")
    return out


def _journal_seq() -> int:
    from seaweedfs_tpu_torch.events import JOURNAL
    return max((e["seq"] for e in JOURNAL.snapshot()), default=0)


def _events_since(type_: str, seq: int) -> list:
    from seaweedfs_tpu_torch.events import JOURNAL
    return [e["attrs"] for e in JOURNAL.snapshot(type_=type_) if e["seq"] > seq]


def _flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes((b[0] ^ 0xFF,)))


def phase_storage(torch, dev, args) -> dict:
    """Phase 8: one volume's whole life through the storage engine, as
    `weed volume -dir=... -max=7` under `weed master
    -volumeSizeLimitMB=30000` runs it, cut to --dat-mib.  Every needle
    goes through Store; each K1/K2 step runs with the launch counts reset
    just before it and read just after, as a phase 7 window."""
    from seaweedfs_tpu_torch.core.needle import Needle, get_actual_size
    from seaweedfs_tpu_torch.ec import to_ext
    from seaweedfs_tpu_torch.ec.decoder import (find_dat_file_size,
                                                write_dat_file,
                                                write_idx_file_from_ec_index)
    from seaweedfs_tpu_torch.ec.encoder import (rebuild_ec_files,
                                                write_ec_files,
                                                write_sorted_file_from_idx)
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.ec.volume_info import save_volume_info
    from seaweedfs_tpu_torch.fault import registry as fault
    from seaweedfs_tpu_torch.storage.scrub import (ScrubDaemon,
                                                   repair_ec_block_locally)
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.vacuum import vacuum
    from seaweedfs_tpu_torch.storage.volume import NotFoundError

    work = os.path.join(REPO, "_smoke_work", "storage")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed + 30)
    limit = args.dat_mib * MIB
    vid = STORAGE_VID
    walls: dict = {}
    windows: dict = {}
    launches: dict = {}

    def window(name, fn):
        reset_counts()
        before = obs_snapshot(torch)
        t0 = time.perf_counter()
        result = fn()
        walls[name] = time.perf_counter() - t0
        windows[name] = obs_window(before, obs_snapshot(torch))
        launches[name] = read_counts()
        return result

    store = Store([work], max_volume_counts=[STORAGE_MAX_VOLUMES])
    try:
        # 1. Writes through Store until the volume is full, one of them
        # bit-rotted on its way to disk; then a torn tail and a remount.
        v = store.add_volume(vid, STORAGE_COLLECTION)
        base = v.file_name()
        blob = rng.bytes(limit)
        view = memoryview(blob)
        payloads: dict = {}
        cookies: dict = {}
        sizes: dict = {}
        pos = 0
        t0 = time.perf_counter()
        while True:
            size = int(math.exp(rng.uniform(math.log(1024), math.log(4 * MIB))))
            room = limit - v.dat_size() - get_actual_size(0, v.version) - 16
            size = min(size, room, len(blob) - pos)
            if size < 1024:
                break
            nid = len(payloads) + 1
            n = Needle(cookie=int(rng.integers(1 << 32)), id=nid,
                       data=view[pos:pos + size])
            pos += size
            if nid == STORAGE_CORRUPT_NID:
                fault.arm("volume.corrupt", "fail*1")
            try:
                store.write_needle(vid, n)
            finally:
                fault.disarm_all()
            payloads[nid], cookies[nid], sizes[nid] = n.data, n.cookie, n.size
        v.sync()
        walls["write"] = time.perf_counter() - t0
        dat_bytes = v.dat_size()
        check(len(payloads) > STORAGE_CORRUPT_NID,
              f"only {len(payloads)} needles fit in {args.dat_mib} MiB")
        log(f"wrote {len(payloads)} needles through Store, .dat {dat_bytes} "
            f"bytes in {walls['write']:.3f} s")

        torn = Needle(cookie=1, id=len(payloads) + 1,
                      data=bytes(4096)).to_bytes(v.version)
        torn = torn[:len(torn) // 2]
        with open(base + ".dat", "ab") as f:
            f.write(torn)
        seq = _journal_seq()
        t0 = time.perf_counter()
        store.unmount_volume(vid)
        v = store.mount_volume(vid)
        walls["remount"] = time.perf_counter() - t0
        recovered = _events_since("volume.recovered", seq)
        check(v.dat_size() == dat_bytes == os.path.getsize(base + ".dat"),
              f"remount left {os.path.getsize(base + '.dat')} bytes, "
              f"expected {dat_bytes}")
        check(len(recovered) == 1
              and recovered[0]["dat_truncated"] == len(torn)
              and not recovered[0]["idx_appended"]
              and not recovered[0]["idx_regenerated"],
              f"recovery of a {len(torn)}-byte torn tail: {recovered}")

        # 2. The scrub quarantines the rotten needle; deletes; vacuum.
        seq = _journal_seq()
        scrub = ScrubDaemon(store, {}, node="smoke", mbps=0, interval=0)
        t0 = time.perf_counter()
        report = scrub.scrub_volume(v)
        walls["scrub"] = time.perf_counter() - t0
        check(report["corrupt"] == report["quarantined"] == 1
              and set(v.repair_tickets) == {STORAGE_CORRUPT_NID},
              f"scrub of the written volume: {report}, tickets "
              f"{sorted(v.repair_tickets)}")
        check([e["key"] for e in _events_since("volume.quarantine", seq)]
              == [f"{STORAGE_CORRUPT_NID:x}"], "no volume.quarantine event")
        candidates = [i for i in payloads if i != STORAGE_CORRUPT_NID]
        deleted = sorted(int(i) for i in rng.choice(
            candidates, max(1, int(len(candidates) * STORAGE_DELETE_SHARE)),
            replace=False))
        for nid in deleted:
            check(store.delete_needle(vid, nid) > 0, f"delete of {nid}")
        live = [i for i in payloads
                if i not in set(deleted) and i != STORAGE_CORRUPT_NID]
        before = v.dat_size()
        seq = _journal_seq()
        t0 = time.perf_counter()
        vacuum(v)
        walls["vacuum"] = time.perf_counter() - t0
        want = v.super_block.block_size() + sum(
            get_actual_size(sizes[i], v.version) for i in live)
        reclaimed = before - v.dat_size()
        check(v.dat_size() == want, f"vacuum left {v.dat_size()} bytes, the "
              f"{len(live)} live needles take {want}")
        check([e["reclaimed_bytes"] for e in _events_since("volume.vacuum", seq)]
              == [reclaimed], "volume.vacuum event")
        vacuumed_bytes = v.dat_size()
        log(f"scrub quarantined needle {STORAGE_CORRUPT_NID}; deleted "
            f"{len(deleted)}; vacuum reclaimed {reclaimed} bytes in "
            f"{walls['vacuum']:.3f} s")

        # 3. ec.generate in the volume server's order, then the EC volume
        # is mounted, the source volume deleted, and a few more needles
        # deleted through the EC volume (.ecj).
        def generate():
            store.mark_volume_readonly(vid, True)
            v.sync()
            write_sorted_file_from_idx(base)
            write_ec_files(base, device=dev)
            save_volume_info(base, v.version, codec="rs")

        window("storage_generate", generate)
        c = launches["storage_generate"]["rs_bitmatrix_crc"]
        check(c["by_instantiation"]["10->4"] > 0 and c["launches"] ==
              c["by_instantiation"]["10->4"], f"ec.generate launched {c}")
        shard_bytes = os.path.getsize(base + to_ext(0))
        ev = EcVolume(base, vid=vid, device=dev)
        store.delete_volume(vid)
        ec_deleted = sorted(int(i) for i in rng.choice(
            live, STORAGE_EC_DELETES, replace=False))
        for nid in ec_deleted:
            ev.delete_needle(nid)
        check(os.path.getsize(base + ".ecj") == 8 * len(ec_deleted), ".ecj")
        log(f"ec.generate {walls['storage_generate']:.3f} s; EC volume "
            f"mounted, {len(ec_deleted)} needles deleted through it")

        # 4. Rot in a data and a parity shard, at different block indices;
        # the EC scrub repairs both through K1 10->1.
        digests = {sid: sha256_file(base + to_ext(sid)) for sid in range(14)}
        blocks = shard_bytes // MIB
        check(blocks >= 2, f"shards of {shard_bytes} bytes hold one 1 MiB block")
        rot = dict(zip(STORAGE_ROT_SHARDS, (blocks // 3, 2 * blocks // 3)))
        for sid, b in rot.items():
            _flip_byte(base + to_ext(sid), b * MIB + 4321)
        seq = _journal_seq()
        ec_scrub = ScrubDaemon(store, {vid: ev}, node="smoke", mbps=0,
                               interval=0,
                               repair_ec_block=repair_ec_block_locally)
        ec_report = window("storage_ec_scrub",
                           lambda: ec_scrub.scrub_ec_volume(ev, repair=True))
        ev.close()
        check(ec_report["corrupt"] == ec_report["repaired"] == len(rot)
              and ec_report["unrepaired"] == 0, f"EC scrub: {ec_report}")
        for sid in range(14):
            check(sha256_file(base + to_ext(sid)) == digests[sid],
                  f"shard {sid} differs from its sha256 after the repair")
        repaired = sorted((e["shard"], e["block"]) for e in
                          _events_since("needle.repaired", seq))
        check(repaired == sorted(rot.items()), f"needle.repaired {repaired}")
        c = launches["storage_ec_scrub"]["rs_bitmatrix"]
        check(c["launches"] == c["by_instantiation"]["10->1"] == len(rot),
              f"EC scrub launched {c}")
        check(windows["storage_ec_scrub"]["repair"].get("rs") ==
              len(rot) * 10 * MIB, f"repair reads {windows['storage_ec_scrub']}")
        log(f"EC scrub {walls['storage_ec_scrub']:.3f} s: {ec_report}")

        # 5. Four shards lost, .ec02 among them: rebuild_ec_files.
        for sid in STORAGE_REBUILD_LOST:
            os.remove(base + to_ext(sid))
        rebuilt = window("storage_rebuild",
                         lambda: rebuild_ec_files(base, device=dev))
        check(rebuilt == list(STORAGE_REBUILD_LOST), f"rebuilt {rebuilt}")
        for sid in STORAGE_REBUILD_LOST:
            check(sha256_file(base + to_ext(sid)) == digests[sid],
                  f"rebuilt shard {sid} differs from its sha256")
        c = launches["storage_rebuild"]["rs_bitmatrix"]
        check(c["by_instantiation"]["10->4"] > 0 and c["launches"] ==
              c["by_instantiation"]["10->4"], f"rebuild launched {c}")

        # 6. ec.to_volume: back to a .dat/.idx, mounted through Store.
        t0 = time.perf_counter()
        write_dat_file(base, find_dat_file_size(base))
        write_idx_file_from_ec_index(base)
        v = store.mount_volume(vid)
        walls["decode"] = time.perf_counter() - t0
        final = [i for i in live if i not in set(ec_deleted)]
        t0 = time.perf_counter()
        for nid in final:
            n = store.read_needle(vid, nid, cookies[nid])
            check(n.data == payloads[nid], f"needle {nid} read back wrong")
        walls["reads"] = time.perf_counter() - t0
        gone = deleted + ec_deleted + [STORAGE_CORRUPT_NID]
        for nid in gone:
            try:
                store.read_needle(vid, nid)
            except NotFoundError:
                continue
            check(False, f"needle {nid} reads back after its delete")
        log(f"ec.to_volume {walls['decode']:.3f} s; {len(final)} needles read "
            f"back in {walls['reads']:.3f} s; {len(gone)} raise NotFoundError")

        # 7. The decoded volume scrubs clean.
        t0 = time.perf_counter()
        final_report = ScrubDaemon(store, {}, node="smoke", mbps=0,
                                   interval=0).scrub_volume(v)
        walls["final_scrub"] = time.perf_counter() - t0
        check(final_report["corrupt"] == 0
              and final_report["checked"] == len(final),
              f"scrub of the decoded volume: {final_report}")
        decoded_bytes = v.dat_size()
    finally:
        fault.disarm_all()
        store.close()
        shutil.rmtree(work, ignore_errors=True)

    gb = lambda nbytes, s: nbytes / s / 1e9  # noqa: E731
    return {
        "reduced": f"volume 30000 MB -> {args.dat_mib} MiB",
        "max_volumes": STORAGE_MAX_VOLUMES, "needle_map": "compact",
        "scrub_mbps": 0,
        "dat_bytes": dat_bytes, "vacuumed_dat_bytes": vacuumed_bytes,
        "decoded_dat_bytes": decoded_bytes, "shard_bytes": shard_bytes,
        "needles_written": len(payloads),
        "needles_deleted": len(deleted) + len(ec_deleted),
        "needles_deleted_before_encode": len(deleted),
        "needles_deleted_after_encode": len(ec_deleted),
        "needles_quarantined": 1, "needles_read_back": len(final),
        "torn_bytes_truncated": len(torn), "bytes_reclaimed": reclaimed,
        "walls_s": walls,
        "gb_s": {"write": gb(dat_bytes, walls["write"]),
                 "scrub": gb(dat_bytes, walls["scrub"]),
                 "vacuum": gb(before, walls["vacuum"]),
                 "ec_generate": gb(vacuumed_bytes, walls["storage_generate"]),
                 "ec_scrub": gb(14 * shard_bytes, walls["storage_ec_scrub"]),
                 "ec_rebuild": gb(vacuumed_bytes, walls["storage_rebuild"]),
                 "dat_decode": gb(decoded_bytes, walls["decode"])},
        "scrub_report": report, "ec_scrub_report": ec_report,
        "final_scrub_report": final_report,
        "launches": launches, "obs": windows,
    }


def entry(t, plain, lib, k_in, k_out, width, crc, volumes=1):
    """A timing row: kernel, plain and library ms, and the bound for
    `volumes` volumes of (k_in -> k_out, width)."""
    cols = volumes * width
    nbytes = (k_in + k_out) * cols
    ops = 8 * k_out * 8 * k_in * cols
    if crc:
        nbytes += 4 * (k_in + k_out) * (cols // 4096)
        ops += (k_in + k_out) * 8 * 32 * cols
    b, by = bound(nbytes, ops)
    shape = f"{k_in}->{k_out}, n={width}"
    return dict(ms=t["ms"], plain_ms=plain["ms"], bound_ms=b, bound_by=by,
                library_ms=lib["ms"], host_us=t["host_us"],
                queue_filled=t["queue_filled"],
                shape=shape if volumes == 1 else f"{volumes} x ({shape})")


def _library_ms(torch, dev, masks_d, x, consts=None) -> dict:
    """The torch.matmul yardstick on pre-unpacked bf16 bit planes of x
    ((k, n) or (V, k, n), volumes side by side): the bit-matrix product,
    and for K2 (consts given) also the CRC contraction of every row's
    planes with W0, (8 (k + r) n / 4096, 4096) @ (4096, 32)."""
    from seaweedfs_tpu_torch.ops.coder_cuda import unpack_bitmatrix
    k = x.shape[-2]
    flat = x if x.dim() == 2 else x.transpose(0, 1).reshape(k, -1)
    out_rows = masks_d.shape[0] // 8
    rows = k + (out_rows if consts is not None else 0)
    planes = torch.zeros((8 * rows, flat.shape[1]), dtype=torch.bfloat16,
                         device=dev)
    for s in range(8):
        planes[s * k:(s + 1) * k] = (flat >> s) & 1
    data_planes = planes[:8 * k]
    bm = unpack_bitmatrix(masks_d).to(torch.bfloat16)
    if consts is None:
        t = cuda_ms(torch, lambda i: torch.matmul(bm, data_planes), 20)
    else:
        w0 = ((consts[0].to(torch.int64)[:, None]
               >> torch.arange(32, device=dev)) & 1).to(torch.bfloat16)
        tiles = planes.reshape(-1, 4096)
        t = cuda_ms(torch, lambda i: (torch.matmul(bm, data_planes),
                                      torch.matmul(tiles, w0)), 20)
    del planes, data_planes, flat
    torch.cuda.empty_cache()
    return t


def batch_timings(torch, dev, kern: dict, args) -> dict:
    """K1 and K2 at the batched path's shapes: the (4, 10, 4 MiB) encode
    step with the RS parity matrix, the largest whole-shard rebuild step
    (2, 10, ceil(512 MiB / 10) MiB) with the decode matrix of shards
    1/3/9/12, and LRC's local repair 5 -> 1 (K1 at 1 MiB, K2 at one
    26 MiB LRC shard).  Each kernel's timing keeps the queue filled;
    its plain version and the matmul yardstick beside it."""
    from seaweedfs_tpu_torch.codecs import get_codec
    from seaweedfs_tpu_torch.ops.coder_cuda import (
        apply_bitmatrix, apply_bitmatrix_crc, apply_bitmatrix_crc_torch,
        apply_bitmatrix_torch, pack_bitmatrix, plane_major)

    def host_masks(b, rows, cols):
        return torch.from_numpy(pack_bitmatrix(plane_major(
            np.asarray(b), rows, cols)))

    rs, lrc = get_codec("rs"), get_codec("lrc")
    par, consts = kern["parity_masks"], kern["crc_consts"]
    present = tuple(s for s in range(14) if s not in REBUILD_LOST)
    bmat, used = rs.decode_bitmatrix(present, REBUILD_LOST)
    dec = host_masks(bmat, len(REBUILD_LOST), len(used))
    local = lrc.repair_plan(tuple(s for s in range(14) if s != 3),
                            [3])[0].reads
    bmat, used5 = lrc.decode_bitmatrix(local, (3,))
    rd5 = host_masks(bmat, 1, len(used5))
    shard_mib = -(-BATCH_MIB[0] // args.batch_div // 10)
    lrc_shard_mib = -(-LRC_MIB // args.batch_div // 10)
    g = torch.Generator(device=dev).manual_seed(args.seed + 3)

    def rand(shape, count):
        return [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                              generator=g) for _ in range(count)]

    cases = (  # (key, masks, inputs, k_out, reps, plain reps)
        ("at_batch_4x10x4mib", par, rand((4, 10, KERNEL_N), 2), 4, 200, 2),
        ("at_rebuild_2x10x%dmib" % shard_mib, dec,
         rand((2, 10, shard_mib * MIB), 2), 4, 50, 1),
        ("at_5_to_1", rd5, None, 1, 200, 2))
    out = {"rs_bitmatrix": {}, "rs_bitmatrix_crc": {}}
    for key, masks, xs, k_out, reps, preps in cases:
        md = masks.to(dev)
        for crc in (False, True):
            if key == "at_5_to_1":
                n = lrc_shard_mib * MIB if crc else MIB
                xs = rand((5, n), 2 if crc else 8)
                label = f"at_5_to_1_{n // MIB}mib"
            else:
                label = key
            m = len(xs)
            if crc:
                t = cuda_ms(torch, lambda i: apply_bitmatrix_crc(
                    masks, xs[i % m], *consts), reps)
                plain = cuda_ms(torch, lambda i: apply_bitmatrix_crc_torch(
                    md, xs[i % m], *consts), preps)
            else:
                t = cuda_ms(torch, lambda i: apply_bitmatrix(
                    masks, xs[i % m]), reps)
                plain = cuda_ms(torch, lambda i: apply_bitmatrix_torch(
                    md, xs[i % m]), preps)
            lib = _library_ms(torch, dev, md, xs[0], consts if crc else None)
            x0 = xs[0]
            out["rs_bitmatrix_crc" if crc else "rs_bitmatrix"][label] = entry(
                t, plain, lib, x0.shape[-2], k_out, x0.shape[-1], crc,
                x0.shape[0] if x0.dim() == 3 else 1)
        del xs
        torch.cuda.empty_cache()
    return out


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

    k1_entry = entry(k1, k1_plain, k1_lib, k, r, n, False)
    k1_entry["at_10_to_1_1mib"] = entry(k1q, k1q_plain, k1q_lib, k, 1, MIB, False)
    return {"rs_bitmatrix": k1_entry,
            "rs_bitmatrix_crc": entry(k2, k2_plain, k2_lib, k, r, n, True)}


def isolated_launch_ms(torch, dev, kern, reps: int = 30) -> dict:
    """K1 at (10 -> 4, 4 MiB) with the rebuild's decode matrix, one
    launch at a time, timed by the event pair a ledger row reads
    (roofline.KernelTimer): median ms with the card kept busy (the
    launch queued behind a 1 ms torch.cuda._sleep) and after the host
    idled 0, 1, 10 and 100 ms with the card idle, as a single-volume
    path leaves it between its coder calls."""
    from seaweedfs_tpu_torch.ops.coder_cuda import apply_bitmatrix
    from seaweedfs_tpu_torch.stats import roofline
    g = torch.Generator(device=dev).manual_seed(7)
    xs = [torch.randint(0, 256, (10, KERNEL_N), dtype=torch.uint8,
                        device=dev, generator=g) for _ in range(4)]
    out = {}
    for label, idle, spin in (("busy", 0.01, True), ("idle_0ms", 0, False),
                              ("idle_1ms", 1e-3, False),
                              ("idle_10ms", 1e-2, False),
                              ("idle_100ms", 0.1, False)):
        ts = []
        for i in range(reps if idle < 0.1 else reps // 3):
            torch.cuda.synchronize()
            time.sleep(idle)
            if spin:
                torch.cuda._sleep(int(1e-3 * SLEEP_CYCLES_PER_S))
            t = roofline.KernelTimer(dev)
            apply_bitmatrix(kern["decode_masks"], xs[i % 4], timer=t)
            torch.cuda.synchronize()
            ts.append(t.seconds() * 1e3)
        out[label] = float(np.median(ts))
    log(f"K1 10->4 at 4 MiB alone, ledger pair, median ms: {out}")
    return out


def _window_expectation(name: str, w: dict, main_shard: int, rs_shards: int,
                        lrc_shard: int, storage_shard: int
                        ) -> tuple[str, dict, dict]:
    """(catalog key, bytes per EC stage, repair-read bytes per codec) that
    window `name` must show, from the shard sizes of its volumes: RS reads
    10 survivors and LRC's local repair 5; a batched step's device stage
    counts its stacked input, the ledger's bytes without the output rows.
    A degraded read's or a scrub repair's bytes are its intervals' reads,
    which only the repair counter sees: the kernel stage must equal them."""
    def stacked(key, k_in, k_out):
        return w["bytes"].get(key, 0) * k_in // (k_in + k_out)

    single = {"main_encode": main_shard, "storage_generate": storage_shard,
              "main_rebuild": main_shard, "storage_rebuild": storage_shard}
    if name in ("main_encode", "storage_generate"):
        return ("encode_crc_kernel",
                {"encode_crc_kernel": 10 * single[name]}, {})
    if name in ("main_rebuild", "storage_rebuild"):
        return ("reconstruct_kernel",
                {"reconstruct_kernel": 10 * single[name]},
                {"rs": 10 * single[name]})
    if name in ("main_reads", "lrc_reads", "storage_ec_scrub"):
        codec = "lrc" if name == "lrc_reads" else "rs"
        got = w["repair"].get(codec, 0)
        check(got > 0, f"{name}: no repair-read bytes")
        return "reconstruct_kernel", {"reconstruct_kernel": got}, {codec: got}
    if name.endswith("encode") or name == "rs_encode_unfused":
        s = lrc_shard if name == "lrc_encode" else rs_shards
        return "batch_encode", {
            "batch_stack": 10 * s, "batch_write": 14 * s,
            "batch_encode_device": stacked("batch_encode", 10, 4)}, {}
    if name == "rs_rebuild":
        return "batch_reconstruct", {
            "batch_gather": 10 * rs_shards, "batch_scatter": 4 * rs_shards,
            "batch_rebuild_device": stacked("batch_reconstruct", 10, 4)}, \
            {"rs": 10 * rs_shards}
    check(name == "lrc_rebuild", f"no expectation for window {name}")
    return "batch_reconstruct", {
        "batch_gather": 5 * lrc_shard, "batch_scatter": lrc_shard,
        "batch_rebuild_device": stacked("batch_reconstruct", 5, 1)}, \
        {"lrc": 5 * lrc_shard}


def phase_observability(torch, probe: dict, main_path: dict, batch: dict,
                        storage: dict, timings: dict) -> dict:
    """Phase 7: the ledger, the stage histograms, the journal and the
    exposition after phases 4, 6 and 8, held against what those paths
    launched and moved; the hooks' cost from the turns in each mode."""
    from seaweedfs_tpu_torch.events import JOURNAL
    from seaweedfs_tpu_torch.events.journal import events_total
    from seaweedfs_tpu_torch.fault.registry import faults_injected_total
    from seaweedfs_tpu_torch.stats import contention, metrics, promcheck
    from seaweedfs_tpu_torch.stats import roofline

    torch.cuda.synchronize()
    windows = dict(main_path.pop("obs"))
    for step in PHASE6_STEPS:
        windows[step] = batch[step].pop("obs")
    windows.update(storage.pop("obs"))
    shard = (main_path["shard_bytes"], batch["rs_encode"]["shard_bytes"],
             batch["lrc_encode"]["shard_bytes"], storage["shard_bytes"])
    seconds: dict = {}  # (kernel, geometry) -> the windows' seconds
    by_window: dict = {}  # (window, kernel, geometry) -> seconds
    capped = 0
    for name, w in windows.items():
        key, stage_bytes, repair = _window_expectation(name, w, *shard)
        check(sum(w["rows"].values()) == w["launches"] > 0,
              f"{name}: {w['rows']} ledger rows for {w['launches']} launches")
        check(set(w["rows"]) == {key},
              f"{name}: ledger rows under {sorted(w['rows'])}, not {key}")
        for stage in EC_STAGES:
            got, want = w["stage_bytes"].get(stage, 0), stage_bytes.get(stage, 0)
            check(got == want, f"{name}: stage {stage} counted {got} bytes, "
                  f"the path moved {want}")
        check(w["repair"] == repair,
              f"{name}: repair-read bytes {w['repair']}, expected {repair}")
        if key in EC_STAGES:
            check(w["stage_count"].get(key, 0) == w["rows"][key],
                  f"{name}: {w['stage_count']} stage observations for "
                  f"{w['rows'][key]} launches")
        rows = w.pop("_rows")
        check(len(rows) == w["launches"], f"{name}: ring holds {len(rows)} "
              f"of the window's {w['launches']} rows")
        for r in rows:
            check(r["achieved"] is not None and 0 < r["achieved"] <= 1,
                  f"{name}: achieved {r['achieved']} in {r}")
            capped += r["achieved"] == 1.0
            seconds.setdefault((r["kernel"], r["geometry"]), []).append(
                r["seconds"])
            by_window.setdefault((name, r["kernel"], r["geometry"]),
                                 []).append(r["seconds"])

    table = roofline.LEDGER.kernel_table()
    ran = {r["kernel"] for r in table if r["count"]}
    check(ran >= set(PATH_KERNELS), f"ledger ran {sorted(ran)}")
    # One short row per series (a degraded read's width is a geometry of
    # its own, so there are hundreds); seconds_p50 over the windows' rows.
    columns = ("kernel", "codec", "geometry", "count", "seconds_p50",
               "achieved_p50")
    compact = []
    for r in table:
        s = seconds.get((r["kernel"], r["geometry"]))
        r["seconds_p50"] = float(np.median(s)) if s else None
        compact.append([r[c] for c in columns])
    conservation = roofline.LEDGER.conservation()
    check(conservation["ok"] and conservation["checked"] > 0,
          f"conservation {conservation}")

    for m in (metrics.ec_stage_seconds, metrics.ec_stage_bytes,
              metrics.ec_repair_read_bytes_total,
              roofline.kernel_seconds_total, roofline.kernel_bytes_total,
              roofline.kernel_work_total, roofline.device_occupancy,
              events_total, faults_injected_total,
              contention.lock_wait_seconds, contention.lock_hold_seconds):
        metrics.global_registry.register_once(m)
    text = metrics.global_registry.expose()
    problems = promcheck.validate_exposition(text)
    check(not problems, f"exposition fails promcheck: {problems[:5]}")

    docs = roofline.LEDGER.pipelines(64)
    for kind in ("encode", "rebuild"):
        check(any(d["kind"] == kind and d["occupancy"]["fraction"] is not None
                  and "starving_stage" in d["bubbles"] for d in docs),
              f"no {kind} occupancy doc")
    lrc_shard = shard[2]
    repairs = [e["attrs"] for e in JOURNAL.snapshot(type_="ec.repair.local")
               if e["attrs"].get("vid") == batch["lrc_vid"]]
    check(repairs == [{"vid": batch["lrc_vid"], "codec": "lrc",
                       "shard": list(LRC_REBUILD_LOST), "reads": 5,
                       "bytes": 5 * lrc_shard}],
          f"ec.repair.local events of the LRC volume: {repairs}")

    def ledger_vs_queued(window, kernel, geometry, kname, key=None):
        s = by_window.get((window, kernel, geometry))
        t = timings[kname] if key is None else timings[kname][key]
        return {"window": window, "geometry": geometry,
                "ledger_rows": len(s or ()),
                "ledger_p50_ms": float(np.median(s)) * 1e3 if s else None,
                "queued_ms": t["ms"]}

    g4 = f"4x10x{KERNEL_N}"
    out = {
        "peaks": probe,
        "kernel_table": {"columns": columns, "rows": compact},
        "rows_at_achieved_cap": capped,
        "conservation": conservation,
        "ledger_vs_phase5": {
            "k1_10_to_4_4mib": ledger_vs_queued(
                "main_rebuild", "reconstruct_kernel", g4, "rs_bitmatrix"),
            "k2_10_to_4_4mib": ledger_vs_queued(
                "main_encode", "encode_crc_kernel", g4, "rs_bitmatrix_crc"),
            "k1_batch_4x10x4mib": ledger_vs_queued(
                "rs_encode_unfused", "batch_encode", g4 + "b4",
                "rs_bitmatrix", "at_batch_4x10x4mib"),
            "k2_batch_4x10x4mib": ledger_vs_queued(
                "rs_encode", "batch_encode", g4 + "b4", "rs_bitmatrix_crc",
                "at_batch_4x10x4mib")},
        "occupancy": [{k: d[k] for k in ("kind", "occupancy", "bubbles")}
                      for d in docs],
        "device_slow_events": len(JOURNAL.snapshot(type_="device.slow")),
        "ec_repair_local": repairs,
        "windows": windows,
        "exposition_lines": len(text.splitlines()),
        "locks": contention.totals(),
        "hooks_cost": {
            "single_volume": main_path.pop("hooks_cost"),
            "batched_rs_encode_wall_s": batch["rs_encode"].pop("hooks_cost")},
    }
    log(f"observability: {sum(r['count'] for r in table)} ledger rows over "
        f"{len(table)} series, conservation ok over "
        f"{conservation['checked']} rows, exposition promcheck-clean, "
        f"{len(docs)} occupancy docs, LRC ec.repair.local seen")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dat-mib", type=int, default=1024)
    ap.add_argument("--batch-div", type=int, default=1,
                    help="divide the batched path's volume sizes by this")
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
    probe = phase_probe(torch, dev)

    kern = phase_kernels(torch, dev, args.seed)
    with hooks("armed"):
        main_path = phase_main_path(torch, dev, args)
        batch = phase_batch(torch, dev, args)
        storage = phase_storage(torch, dev, args)
    timings = phase_timings(torch, dev, kern, args.seed)
    for name, rows in batch_timings(torch, dev, kern, args).items():
        timings[name].update(rows)
    batch["single_volume_encode_gb_s"] = main_path["encode_gb_s"]
    # Device busy share: launches x kernel ms at the step's shape (the
    # encode's (4, 10, 4 MiB) and the rebuild's largest step, both upper
    # bounds for the smaller steps) over the step's wall.
    k2 = timings["rs_bitmatrix_crc"]
    rebuild_key = next(k for k in k2 if k.startswith("at_rebuild"))
    for step, ms in (("rs_encode", k2["at_batch_4x10x4mib"]["ms"]),
                     ("rs_rebuild", k2[rebuild_key]["ms"])):
        n = batch[step]["launches"]["rs_bitmatrix_crc"]["launches"]
        batch[step]["device_busy_share"] = \
            n * ms / 1e3 / batch[step]["wall_s"]
    # The same for the storage path's K1/K2 steps, at their shapes: K2
    # 10->4 and K1 10->4 at 4 MiB, K1 10->1 at 1 MiB.
    k1 = timings["rs_bitmatrix"]
    busy = {}
    for step, fn, ms in (
            ("storage_generate", "rs_bitmatrix_crc", k2["ms"]),
            ("storage_ec_scrub", "rs_bitmatrix", k1["at_10_to_1_1mib"]["ms"]),
            ("storage_rebuild", "rs_bitmatrix", k1["ms"])):
        n = storage["launches"][step][fn]["launches"]
        busy[step] = n * ms / 1e3 / storage["walls_s"][step]
    storage["device_busy_share"] = busy

    kernels = [
        {"name": "rs_bitmatrix", "route": "cuda",
         "source": "seaweedfs_tpu_torch/csrc/rs_bitmatrix.cu",
         "replaces": "seaweedfs_tpu/ops/coder_pallas.py:104",
         "launches": main_path["launches"]["rs_bitmatrix"] + sum(
             batch[s]["launches"]["rs_bitmatrix"]["launches"]
             for s in PHASE6_STEPS) + sum(
             storage["launches"][s]["rs_bitmatrix"]["launches"]
             for s in STORAGE_STEPS),
         "max_abs_err": kern["k1_err"], **timings["rs_bitmatrix"]},
        {"name": "rs_bitmatrix_crc", "route": "cuda",
         "source": "seaweedfs_tpu_torch/csrc/rs_bitmatrix_crc.cu",
         "replaces": "seaweedfs_tpu/ops/coder_pallas.py:200",
         "launches": main_path["launches"]["rs_bitmatrix_crc"] + sum(
             batch[s]["launches"]["rs_bitmatrix_crc"]["launches"]
             for s in PHASE6_STEPS) + sum(
             storage["launches"][s]["rs_bitmatrix_crc"]["launches"]
             for s in STORAGE_STEPS),
         "max_abs_err": kern["k2_err"], **timings["rs_bitmatrix_crc"]},
    ]
    obs = phase_observability(torch, probe, main_path, batch, storage, timings)
    obs["ledger_vs_phase5"]["k1_10_to_4_4mib"]["alone_ms"] = \
        isolated_launch_ms(torch, dev, kern)
    print(json.dumps({"main_path": main_path}))
    print(json.dumps({"batch_path": batch}))
    print(json.dumps({"storage_path": storage}))
    print(json.dumps({"observability": obs}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
