#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's EC main path on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--main-mib 30000] [--dat-mib 1024]
                          [--batch-div 1] [--live-mib 256] [--ha-mib 512]
                          [--filer-mib 256] [--gateway-mib 1024]

`--main-only` runs phases 1, 2 and 4 alone (phase 4 at --main-mib);
`--ha-runs N` phase 11 alone N times; `--gateway-runs N` phase 13 alone
N times (`--gateway-small-div D` divides its small objects and messages);
`--wire-mib M --wire-parent DIR` the wire measurement (wire_turns).

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
4. main    — `weed shell ec.encode` on a volume at upstream's
             `-volumeSizeLimitMB=30000` (--main-mib): a seeded .dat/.idx
             (payloads sliced from one 1 GiB blob) and .ecx, write_ec_files
             (fused CRC, K2: one launch per 4 MiB of the two 1 GiB
             large-block rows and per four of the 952 small rows, checked
             against the layout computed apart from the encoder); the
             .ecc against all 14 shards' bytes; the first and last 4 MiB
             of every large-block row and of the small rows against the
             .dat at the Go layout's offsets and against coder_native's
             parity; shards 1/3/9/12 deleted and rebuild_ec_files (K1,
             one per 4 MiB), the rebuilt shards held to the originals'
             block CRCs; the same loss rebuilt again by
             batch_rebuild_files at its 256 MiB budget (K2 decode in
             column steps of (1, 10, 18 MiB)), byte-equal to
             rebuild_ec_files's, each step within the budget, the card's
             peak memory under 2 GiB and the RSS growth under 4 GiB;
             then shards 0/4/8/13 deleted and EcVolume.read_needle on 300
             seeded needles plus every needle across a 1 GiB block
             boundary (the last of them into the small rows), each equal
             to its payload, K1 launched once per lost interval read.
             The 14 shards are kept in memory (memfd), the .dat and the
             rebuilt shards on disk: the GPU host caps how far a run's
             disk grows (DISK_CAP);
5. timings — each kernel, its plain version and a torch.matmul yardstick
             at the main path's shapes: K1 at (10 -> 4, 4 MiB) and
             (10 -> 1, 1 MiB), K2 at (10 -> 4, 4 MiB); at the batched
             path's (4, 10, 4 MiB) encode step, its largest rebuild step
             and phase 4's (1, 10, 18 MiB) column step, and at LRC's
             5 -> 1 (K1 1 MiB, K2 one LRC shard).
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

9. cluster — the control plane on the card's host: an upstream `weed
             master -volumeSizeLimitMB=30000 -defaultReplication=010
             -pulseSeconds=5` over 64 `weed volume -max=7` servers (2 DCs
             x 4 racks x 8), which this process plays by heartbeats: 224
             volumes of placement 010 fill every slot below the size
             limit, and phase 8's EC volume (id 1, collection "smoke")
             has its 14 shards on 14 nodes across both DCs; node 0's
             beats carry this process's roofline ledger.  Per transport
             (-transport=threads, then aio) the port's master starts as
             `python -m seaweedfs_tpu_torch master` in a process that
             blocks jax, jaxlib and seaweedfs_tpu; after one full beat
             per node and one delta per pulse, 8 client threads on
             rpc.call's keep-alive pool send 2 500 /dir/assign
             (count=1, replication=010) and 2 500 /dir/lookup over the
             224 volumes and the EC volume; then /vol/list,
             /cluster/healthz, one node's goodbye and lookups of what it
             held, and /cluster/device.  Every fid must name a declared
             volume and its replicas, every lookup equal the declared
             locations, the goodbye remove the node, the master emit no
             volume.grow or volume.assign event (it never dials a
             simulated node), /cluster/device's peaks come from the card
             (backend cuda, an H100 kind) and its rows equal the ledger's;
             then a 64 MiB volume is encoded (K2) and rebuilt (K1) with
             the counts reset, node 0's next delta beat carries the
             ledger, and /cluster/device must move by exactly that
             window's rows, equal to its K1 and K2 launches.  Assign and
             lookup rates with p50/p99, full-beat apply ms and the
             master's RSS (before and after /cluster/device brings up
             the card in it) are printed per transport; no bound on them
             is asserted.

10. live   — a live port cluster: upstream `weed master
             -volumeSizeLimitMB=30000 -defaultReplication=000` and six
             `weed volume -max=7` servers in 2 racks x 3, each
             `python -m seaweedfs_tpu_torch master|volume -device=cuda`
             in its own process (jax and the JAX package blocked), on
             one host and card, the size limit cut to --live-mib.  Three
             volumes of one collection are grown and filled through
             WeedClient (8 threads) until each passes 95 % of the limit;
             each is sealed and a copy of its .dat encoded here by
             write_ec_files.  Volume A: `ec.encode -volumeId A` through a
             `python -m seaweedfs_tpu_torch shell` process (K2 10->4 in
             the holder); B and C: `ec.encode -volumeId B,C -batch
             -maxBatchMB 2048` through CommandEnv(device=dev) here (K2
             with V = 2).  Every
             shard file and .ecc entry on the servers' disks must equal
             the copy's, and sit where the master says.  A server holding
             1-3 shards of every volume is killed with SIGKILL; 300
             seeded needles are read through the client (K1 10->1 in the
             volume servers for each interval on a lost shard), the dead
             node is swept, `ec.rebuild -batch` runs here (K2 with the
             decode masks), every rebuilt shard must equal its original,
             each target's own /debug/flows rows must show at least one
             ec.scatter request per rebuilt shard per column step of its
             volume (a split volume's pieces go as each step drains) and
             exactly the rebuilt shards' bytes beside the .ecc fragment,
             and every needle read back byte-equal.  Launches are counted
             here by the wrappers and in the volume servers through the
             master's /cluster/device (per node, from a beat after each
             step; the killed node read before the kill) and must equal
             what each step needs: the holder's encode as many K2 as the
             copy's, the batch one step per chunk of the longer volume
             with V = 2 while both last, one K1 per lost interval read,
             the rebuild one launch per sub-batch.  Then an LRC(10,2,2)
             pass in the master and surviving servers, with its own
             launch windows (the reference's acceptance flow,
             tests/test_codecs.py): one volume of collection "lrc10"
             filled past 95 % of 128 MiB (of the limit where less); `lock; ec.encode -volumeId V
             -codec lrc` through a shell process (K2 10->4 in the
             holder), every shard, .ecx and .ecc entry held against
             write_ec_files(codec="lrc") of its sealed copy; shards 1 and
             6 deleted (one per local group) and every needle read back
             (K1 generic<=16, 5->1, in the volume servers; it must
             launch), then `ec.rebuild -volumeId V -batch` here; shards
             4, 9, 12 and 13 deleted, 300 seeded reads, a rebuild; shard
             3 deleted and rebuilt from 5 shards, which the shell must
             say and SeaweedFS_ec_repair_read_bytes_total{codec="lrc"}
             here must count (exactly 5 x the shard size).  Every
             rebuilt shard and its .ecc entry must equal the original's;
             K1 in the volume servers must lie between the lost intervals
             read and those of every loss so far.

11. ha     — an HA cluster, its mirror and the autopilot: upstream's
             `weed master -peers=m1,m2,m3 -volumeSizeLimitMB=30000
             -defaultReplication=000 -repair -repair.delay=3` (three raft
             masters) and four `weed volume -max=7 -replicate.peer=<standby
             master> -device=cuda` servers in 2 racks x 2, mirroring into
             a standby of one master and two volume servers; every role a
             `python -m seaweedfs_tpu_torch` process, the size limit cut
             to --ha-mib.  One collection's volume fills past 95 %
             through WeedClient with all three masters as seeds (8
             threads) while the raft leader is SIGKILLed at 40 %: every
             acked write reads back at the end, no file id or needle key
             repeats, the seconds to a new leader and the client errors
             retried are logged.  `weed backup` (full, started with the
             writes; incremental after the last one), `weed fix` and
             `weed export` on the copy, whose needle set (id, cookie,
             size, CRC) must equal the primary's.  Every shipper drains;
             `cluster.mirror.status` says CAUGHT UP and the standby's
             fsck CRC map of the volume (HEAD X-Needle-Checksum of every
             needle through each master) equals the primary's.  `ec.encode
             -volumeId` through a `weed shell` process on each cluster (K2
             10->4 in each holder, as many as write_ec_files of the same
             .dat here); the 14 shards and .ecc entries of the two
             clusters are compared by sha256 (and the .dat files, where
             they differ).  A primary holder of 1-4 shards is SIGKILLed;
             300 seeded degraded reads (K1 10->1 in the survivors, one
             per interval on a lost shard); the new leader's repair
             daemon rebuilds the lost shards (one batched K2 decode step
             per column step in the leader's process, read from its
             /cluster/device rows), each equal to its original, the
             leader's RSS read just before the kill and after the repair
             with its peak between (sampled as the repair is polled);
             every needle reads back.
             `cluster.check`, `cluster.roofline` (the card's K1/K2 rows),
             `cluster.flows` and `events.ls` on the leader; `weed
             benchmark -n 5000 -size 1024 -c 16` against it.

12. filer  — a filer-fronted EC cluster: upstream's `weed master
             -volumeSizeLimitMB=30000 -defaultReplication=000`, six `weed
             volume -max=7 -device=cuda` in 2 racks x 3 and `weed filer
             -dir=<work>/filer` (its default embedded store for a
             directory, the ordered KV store; files cut into 4 MiB
             chunks), every role a `python -m seaweedfs_tpu_torch`
             process, the limit cut to --filer-mib.  A namespace from
             --seed goes in through the filer's HTTP API from 8 threads:
             twice the limit in large files (log-uniform 64 KiB..16
             MiB), 10 000 small ones (1..16 KiB) per 1024 MiB of limit
             (5 000 at the default 512) over 256 directories three levels
             deep, every acknowledged write recorded with its sha256;
             `fs.ls` of every directory and `fs.du /` must match it; the
             filer is SIGKILLed and restarted on the same -dir, and every
             entry and a sample of 1000 files must read back equal.
             `lock; ec.encode` of the volumes that hold the namespace (the
             full ones and the overflow) runs in a shell process (K2 in
             the holders, as many as write_ec_files of their sealed .dat
             copies here, every shard and .ecc entry equal); the holder of
             the most shards of one volume is SIGKILLed; every file reads
             back through the filer (K1 10->1 in the survivors, as many as
             the lost intervals of the chunks read, less those of chunks
             the filer's chunk cache held), then 300 ranges across chunk
             boundaries; `volume.fsck -orphans` through CommandEnv.filer()
             finds 0 missing and 0 orphans; after the dead-node sweep
             `ec.rebuild` restores the lost shards byte for byte; `fs.rm
             -r` of one directory, until its chunk deletes have landed (no
             live needle that no entry names).

13. gateway — a gateway-fronted EC cluster: phase 12's layout (`weed
             master -volumeSizeLimitMB=30000 -defaultReplication=000`, six
             `weed volume -max=7 -device=cuda` in 2 racks x 3, `weed filer
             -dir=...`) with `weed s3 -config=s3.json` (an admin and a
             read-only identity in upstream's s3.json shape), `weed
             webdav` and `weed msg.broker` in front, every role a `python
             -m seaweedfs_tpu_torch` process, the limit cut to
             --gateway-mib.  From --seed, 8 threads write through S3 with
             SigV4 and aws-chunked bodies (STREAMING-AWS4-HMAC-SHA256-
             PAYLOAD, as SDKs send them): 512 MiB of objects log-uniform
             64 KiB..16 MiB, 4 multipart uploads of 64 MiB in 8 MiB parts,
             5 000 small objects of 1..16 KiB and 16 CSV objects of 4 MiB;
             128 MiB of files through WebDAV (MKCOL, PUT) two levels deep;
             20 000 messages of 1 KiB to a 4-partition topic through the
             broker; one 64 MiB file through the mount's WFS (in this
             process; FUSE is a kernel interface of the host) in 1 MiB
             writes at random offsets; `filer.copy` of a seeded local
             tree of 200 files.  ListObjectsV2 paginated at 1000 keys and
             PROPFIND Depth: 1 of every WebDAV directory must equal what
             was written, the read-only identity's PUT must get 403.  The
             broker is stopped (its tails flushed to the filer), the
             volume Query RPC runs a SELECT on a CSV needle and must equal
             Python's csv module's answer; `lock; ec.encode` of every
             volume holding the namespace in a shell process (K2 in the
             holders, every shard and .ecc entry held against
             write_ec_files of a sealed copy); a holder of 3 or more
             shards of a volume is SIGKILLed and swept.  Then each gateway
             reads everything back, each pass counted in the survivors (K1
             10->1 per lost interval of the chunks it reads, less those the
             filer's chunk cache held): S3 Select over every CSV object
             (equal to the plain evaluation), 300 S3 Range GETs across
             chunk boundaries, every S3 object, every WebDAV file, every
             message from offset 0 of every partition in order (the broker
             restarted, reading sealed segments), the WFS file through a
             fresh WFS, and `filer.replicate -once -sink=local://...` of
             the copied tree; every byte must equal what was acknowledged.
             Beside each pass's K1: its wire rows (the survivors' and the
             filer's requests in by purpose, the survivors' answers by
             status class, the chunk reads the pass asks for, the chunks it
             reads and those the cache did not hold).
             `ec.rebuild` restores the lost shards byte for byte and
             `volume.fsck -orphans` finds 0 missing and 0 orphans.  Last,
             X4 on the card: 2 gloo ranks (NCCL refuses two ranks on one
             device) run all_to_all_reconstruct and ring_reconstruct on
             seeded (2, 10, 64 MiB) survivors of 4 lost shards, each rank's
             K1 on the card, and must equal batched_reconstruct's answer.
             Every process of the phase writes an `RPC-FAIL` line (its
             pid, the method and URL) for each call of the port's client
             that meets a closed connection or times out, counted per
             process in `rpc_fails`, and its threads' stacks on SIGUSR1:
             a failed phase prints those lines and every live process's
             stacks before the log tails, and so does a `filer.copy`
             still running after 30 s.

Phase 6 runs before phase 8, phase 8 before phase 9, phase 9 before phase
10, phase 10 before phase 11, phase 11 before phase 12, phase 12 before
phase 13, and phase 13 before phase 5, whose timings include phase 6's
shapes; phase 7 runs last.

The build phase also logs ptxas's registers per kernel and, where the
toolkit has cuobjdump, static SASS opcode counts per kernel.

Prints a {"main_path": ...} line, a {"batch_path": ...} line, a
{"storage_path": ...} line (walls and GB/s per step, needles written,
deleted and quarantined, bytes reclaimed, launches per step and
instantiation, device busy share), an {"observability": ...} line, a
{"control_plane": ...} line (per transport: assign and lookup rates and
p50/p99 ms, full-beat apply ms, the master's RSS, the device rows), a
{"live_cluster": ...} line (walls and GB/s of the write, both encodes,
the rebuild and the read-back, degraded-read p50/p99, launches per kernel
and step in the shell's process and the volume servers, device busy
share, every process's RSS; under "lrc" the LRC pass's walls, GB/s,
degraded p50/p99, launches per instantiation and process, repair-read
bytes), a {"ha_cluster": ...} line (walls and GB/s
per step, seconds to a new leader, to mirror convergence and to repair,
degraded-read p50/p99, the backup's and the mirror's checks, benchmark
rates, launches per kernel, step and process, every process's RSS), a
{"filer_cluster": ...} line (write GB/s, small-file creates/s and p99,
listing and filer-restart seconds, degraded-read and range p50/p99,
chunk-cache hits, K1/K2 launches per step in the volume servers, the
fsck reports, every process's RSS, device busy share), a
{"gateway_cluster": ...} line (S3 PUT GB/s and p50/p99 of large and
small objects, multipart GB/s, ListObjectsV2 seconds, WebDAV PUT and GET
GB/s, broker publish and consume messages/s, degraded S3 GET and range
p50/p99, Select MB/s, the replicate wall, K1/K2 launches per pass and
process, the chunk cache's hits, each gateway's RSS, device busy share
per step, X4's walls), nvidia-smi's line, a {"kernels": [...]} line, and last {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.parse

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
LARGE_BLOCK = 1024 * MIB  # the Go layout's blocks
SMALL_BLOCK = MIB
# Phase 4's volume: upstream's `weed master -volumeSizeLimitMB=30000`
# (--main-mib; 12 000 MiB is the least that still has a large-block row
# and its boundary into the small rows).
MAIN_MIB = 30000
DISK_SLACK = 1 << 30  # .idx, .ecx and the rest beside the volume
MEM_SLACK = 8 << 30  # this process, its pinned staging and the cache
# The GPU host this script is sized for lets a run's disk grow by at most
# 45 GiB (freed blocks are reused, so what counts is the most held at once).
DISK_CAP = 45 << 30
MAIN_BATCH_BYTES = 1 << 28  # batch_rebuild_files's default budget
MAIN_DEVICE_PEAK_MAX = 2 << 30
MAIN_RSS_GROWTH_MAX = 4 << 30
VOLUME_BLOB = 1024 * MIB  # write_volume's payloads, at most
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
# The control plane (phase 9): `weed master -volumeSizeLimitMB=30000
# -defaultReplication=010 -pulseSeconds=5` over 2 DCs x 4 racks x 8
# `weed volume -max=7` servers played by heartbeats from this process at
# 127.0.0.1:CLUSTER_BASE_PORT + i (nothing listens there); per transport
# 8 client threads send the assigns and lookups; the window K1/K2 run in
# the phase (a volume of CLUSTER_WINDOW_MIB encoded and rebuilt) reaches
# the master in node 0's next delta beat.
CLUSTER_DCS, CLUSTER_RACKS, CLUSTER_NODES = 2, 4, 8
CLUSTER_MAX_VOLUMES = 7
CLUSTER_SIZE_LIMIT_MB = 30000
CLUSTER_REPLICATION = "010"
CLUSTER_PULSE_S = 5
# Cut from 20 000 each per transport when phase 12 joined the script,
# to keep the whole script well within its time limit.
CLUSTER_ASSIGNS = 2500  # 10000 before phase 13 joined
CLUSTER_LOOKUPS = 2500
CLUSTER_CLIENTS = 8
CLUSTER_TRANSPORTS = ("threads", "aio")
CLUSTER_BASE_PORT = 41000
CLUSTER_EPOCH_S = 1_700_000_000
CLUSTER_WINDOW_MIB = 64
CLUSTER_WINDOW_LOST = (0, 6, 10, 13)
# The live cluster (phase 10): upstream `weed master
# -volumeSizeLimitMB=30000 -defaultReplication=000` and LIVE_NODES `weed
# volume -max=7` servers in LIVE_RACKS racks, then `weed shell`: lock,
# ec.encode of one collection's volumes past -fullPercent 95, a node
# lost, ec.rebuild (SeaweedFS's erasure-coding wiki page).  The size limit
# is cut to LIVE_LIMIT_MB and every server shares this host and card.
# Needles are seeded slices of a LIVE_BLOB_MIB blob, written by
# LIVE_WRITERS client threads (which also read everything back).
LIVE_NODES = 6
LIVE_RACKS = 2
LIVE_MAX_VOLUMES = 7
LIVE_REPLICATION = "000"
LIVE_LIMIT_MB = 256  # --live-mib (1024 before phase 12, 512 before 13)
LIVE_COLLECTION = "ec10"
LIVE_VOLUMES = 3
LIVE_FULL_PERCENT = 95
LIVE_WRITERS = 8
LIVE_BLOB_MIB = 64
LIVE_READS = 300
# `ec.encode -batch -maxBatchMB`: both volumes in one group (the
# default 256 would give each 1 GiB volume a group of its own), as phase
# 6's BATCH_BYTES; `ec.rebuild -batch` keeps its default.
LIVE_BATCH_MB = 2048
LIVE_REBUILD_BUDGET = 256 << 20  # ec.rebuild's -maxBatchMB default
# Phase 10's LRC(10,2,2) pass: its collection, the offset of its needles'
# seed from --seed, and its losses in the reference's acceptance flow
# (tests/test_codecs.py): one shard of each local group; one of each
# group and both global parities; one shard alone (a 5-shard rebuild).
LRC_COLLECTION = "lrc10"
LRC_SEED = 20
# The LRC volume is sealed once it holds LIVE_FULL_PERCENT of this many
# MiB (of --live-mib where that is less): the script's time limit.
LRC_FILL_MIB = 128
LRC_LOSSES = ((1, 6), (4, 9, 12, 13), (3,))
# Phase 11: upstream's HA layout, `weed master -peers=m1,m2,m3` (three
# raft masters, each armed with -repair), HA_NODES `weed volume -max=7
# -replicate.peer=<standby master>` servers in HA_RACKS racks, and a
# standby of one master and HA_STANDBY_NODES volume servers.
HA_MASTERS = 3
HA_NODES = 4
HA_RACKS = 2
HA_STANDBY_NODES = 2
HA_MAX_VOLUMES = 7
HA_REPLICATION = "000"
HA_LIMIT_MB = 512  # --ha-mib (1024 before phase 4 grew to 30000 MiB)
HA_COLLECTION = "ha"
HA_FILLER = "hafill"  # empty volumes in every other slot during the write
HA_BACKUP_PERCENT = 20  # the full `weed backup` starts as it passes this
HA_KILL_PERCENT = 40  # the raft leader is killed as the volume passes this
HA_FULL_PERCENT = 95
HA_WRITERS = 8
HA_READS = 300
HA_REPAIR_DELAY_S = 3  # -repair.delay
HA_BENCH_N = 5000  # upstream's `weed benchmark -n` is 1048576 (20000
# before phase 12 joined)
HA_BENCH_SIZE = 1024
HA_BENCH_C = 16
# Phase 12 (`phase_filer_cluster`): upstream's production layout, six
# `weed volume -max=7` in 2 racks x 3 under `weed master
# -volumeSizeLimitMB=30000 -defaultReplication=000` and `weed filer
# -dir=...` (its default embedded store for a directory, files cut into
# 4 MiB chunks), the limit cut to --filer-mib.
FILER_NODES = 6
FILER_RACKS = 2
FILER_MAX_VOLUMES = 7
FILER_REPLICATION = "000"
FILER_LIMIT_MB = 256  # --filer-mib (1024 before phase 13 joined, 512
# before phase 4 grew to 30000 MiB)
FILER_COLLECTION = "fs12"
FILER_PREGROW = 2  # volumes the large files fill
FILER_FULL_PERCENT = 95
FILER_LARGE_PER_LIMIT = 2  # twice the limit in large files
FILER_LARGE_RANGE = (64 << 10, 16 << 20)
FILER_SMALL = 10000  # small files per 1024 MiB of limit (20000 before phase 13)
FILER_SMALL_RANGE = (1 << 10, 16 << 10)
FILER_DIRS = (4, 8, 8)  # three levels, 256 leaf directories
FILER_BLOB_MIB = 64
FILER_WRITERS = 8
FILER_SAMPLE = 1000  # files read back after the filer's restart
FILER_RANGES = 300
FILER_RM_DIR = "/a0/b0"
# `python -m seaweedfs_tpu_torch <args>` (runpy.run_module is what -m
# runs) with the JAX package and JAX itself blocked in sys.modules.
# Phase 13 (a gateway-fronted EC cluster): upstream's `weed master
# -volumeSizeLimitMB=30000 -defaultReplication=000`, six `weed volume
# -max=7` in 2 racks x 3, `weed filer -dir=`, `weed s3 -config=s3.json`,
# `weed webdav`, `weed msg.broker`; the limit cut by --gateway-mib.
GW_NODES = 6
GW_RACKS = 2
GW_MAX_VOLUMES = 7
GW_REPLICATION = "000"
GW_LIMIT_MB = 1024  # --gateway-mib
GW_COLLECTION = "gw13"
GW_BUCKET = "gw13"
GW_PREGROW = 1  # the volume the first writes fill
GW_FULL_PERCENT = 95
GW_WRITERS = 8
GW_BLOB_MIB = 96
GW_LARGE_MIB = 512  # S3 objects, log-uniform GW_LARGE_RANGE
GW_LARGE_RANGE = (64 << 10, 16 << 20)
GW_MULTIPARTS = 4  # uploads of GW_MULTIPART_MIB in GW_PART_MIB parts
GW_MULTIPART_MIB = 64
GW_PART_MIB = 8  # the AWS CLI's default part size
GW_SMALL = 5000
GW_SMALL_RANGE = (1 << 10, 16 << 10)
GW_CSVS = 16
GW_CSV_MIB = 4
GW_DAV_MIB = 128  # WebDAV files, two levels deep
GW_DAV_RANGE = (64 << 10, 4 << 20)
GW_DAV_DIRS = (4, 4)
GW_MESSAGES = 20000  # 100 000 cut to fit the script's time (reduced)
GW_MESSAGE_BYTES = 1024
GW_PARTITIONS = 4
GW_NS, GW_TOPIC = "gw", "events"
GW_WFS_MIB = 64  # one file through the mount's WFS
GW_WFS_WRITE = 1 << 20  # in 1 MiB writes at random offsets
GW_COPY_FILES = 200  # filer.copy of a local tree
GW_COPY_RANGE = (1 << 10, 1 << 20)
GW_RANGES = 300
GW_AWS_CHUNK = 64 << 10  # aws-chunked chunk size of the SDKs
GW_ADMIN = ("AKIDGW13ADMIN", "gw13/admin/secret")
GW_READER = ("AKIDGW13READER", "gw13/reader/secret")
GW_SELECT_FLOOR = 900
GW_SELECT = f"SELECT id, score FROM S3Object WHERE score > {GW_SELECT_FLOOR}"
# Phase 13's read passes after the holder's kill, one per gateway.
GW_PASSES = ("s3_select", "s3_get_all", "s3_ranges", "webdav_get_all",
             "broker_consume", "wfs_read", "filer_replicate")
X4_RANKS = 2  # gloo ranks on the one card (data_shards 10 divides by 2)
X4_VOLUMES = 2
X4_MIB = 64  # bytes per shard row at --gateway-mib 1024
X4_LOST = (1, 5, 10, 12)

MASTER_LAUNCH = (
    "import runpy, sys\n"
    "for name in ('jax', 'jaxlib', 'seaweedfs_tpu'):\n"
    "    sys.modules[name] = None\n"
    "runpy.run_module('seaweedfs_tpu_torch', run_name='__main__',"
    " alter_sys=True)\n")

# The calls of this process that met a closed connection or timed out
# (`watch_rpc`), one line each.
RPC_FAILS: list[str] = []


def watch_rpc(rpc, say) -> None:
    """Report, through say(line), every call of the port's client (`rpc`)
    that meets a closed connection or times out: the process, the method
    and the URL, before the error goes on to the caller."""
    inner = rpc._request
    if getattr(inner, "watched", False):
        return

    def _request(url, method, *a, **kw):
        try:
            return inner(url, method, *a, **kw)
        except (ConnectionResetError, BrokenPipeError, TimeoutError) as e:
            say(f"RPC-FAIL pid {os.getpid()}: {method} {url}: "
                f"{type(e).__name__}: {e}")
            raise

    _request.watched = True
    rpc._request = _request


def gateway_launch() -> str:
    """MASTER_LAUNCH for phase 13's processes, which also write every
    thread's stack to their log on SIGUSR1 (`dump_stacks`) and an
    `RPC-FAIL` line for each call that meets a closed connection or
    times out (`watch_rpc`)."""
    import inspect
    blocked, run = MASTER_LAUNCH.split("runpy.run_module")
    return ("import faulthandler, os, signal\n"
            "faulthandler.register(signal.SIGUSR1, all_threads=True)\n"
            + blocked + inspect.getsource(watch_rpc) +
            "from seaweedfs_tpu_torch.cluster import rpc\n"
            "watch_rpc(rpc, lambda m: print(m, file=sys.stderr, flush=True))\n"
            "runpy.run_module" + run)


def dump_stacks(procs, why: str) -> None:
    """SIGUSR1 to each live process of `procs` started with
    gateway_launch(); print the stacks each writes to its log."""
    import signal
    marks = {}
    for p in procs:
        if p.poll() is None and "SIGUSR1" in getattr(p, "launch", ""):
            marks[p] = os.path.getsize(p.log_path)
            os.kill(p.pid, signal.SIGUSR1)
    time.sleep(1.0)
    for p, at in marks.items():
        with open(p.log_path, "rb") as f:
            f.seek(at)
            text = f.read().decode(errors="replace")
        log(f"{why}: the stacks of {os.path.basename(p.log_path)} (pid "
            f"{p.pid}):\n{text[-30000:]}")


def rpc_fail_lines(work: str) -> dict:
    """The `RPC-FAIL` lines of every process log under `work`."""
    import glob
    out = {}
    for path in sorted(glob.glob(os.path.join(work, "*.log"))):
        with open(path, errors="replace") as f:
            lines = [s for s in f.read().splitlines()
                     if s.startswith("RPC-FAIL ")]
        if lines:
            out[os.path.basename(path)] = lines
    return out


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
    to dat_bytes.  The payloads are consecutive slices of one random blob
    of at most VOLUME_BLOB bytes, from its start again where the next
    would run past its end: a volume of any size holds only the blob in
    memory, and one no larger than the blob has the bytes it had when
    the blob was as large as the volume.  Returns {needle id: payload
    memoryview}."""
    from seaweedfs_tpu_torch.core.needle import Needle, get_actual_size
    from seaweedfs_tpu_torch.storage.dat_writer import DatWriter

    rng = np.random.default_rng(seed)
    blob = rng.bytes(min(dat_bytes, VOLUME_BLOB))
    view = memoryview(blob)
    payloads = {}
    pos = 0
    with DatWriter(base) as w:
        nid = 0
        while True:
            size = int(math.exp(rng.uniform(math.log(1024), math.log(4 * MIB))))
            room = dat_bytes - w.size - get_actual_size(0, w.version) - 16
            size = min(size, room)
            if size < 1024:
                break
            if pos + size > len(blob):
                pos = 0
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


def ec_layout(dat_size: int) -> dict:
    """The Go encoder's layout of a .dat of dat_size bytes, computed
    without the encoder: large-block rows while more than one full row
    remains (encodeDatFile's strict >), then 1 MiB small-block rows;
    each shard's size, and write_ec_files's coder calls (one per 4 MiB
    of a large block, one per four small rows)."""
    large_rows, rest = 0, dat_size
    while rest > LARGE_BLOCK * 10:
        large_rows += 1
        rest -= LARGE_BLOCK * 10
    small_rows = -(-rest // (SMALL_BLOCK * 10))
    return {"large_rows": large_rows, "small_rows": small_rows,
            "shard_bytes": large_rows * LARGE_BLOCK + small_rows * SMALL_BLOCK,
            "encode_calls": large_rows * (LARGE_BLOCK // KERNEL_N)
            + -(-small_rows // (KERNEL_N // SMALL_BLOCK))}


def check_stripes(base: str, dat_size: int, layout: dict) -> list:
    """The first and last 4 MiB of every large-block row and of the
    small-block region: each data shard's bytes equal the .dat at the Go
    layout's offsets (a small row's tail past the .dat's end is zeros),
    and the parity shards equal the host AVX2 coder's (ops/coder_native)
    parity of those data rows.  Returns the shard offsets checked."""
    from seaweedfs_tpu_torch.ec import to_ext
    from seaweedfs_tpu_torch.ops.coder_native import NativeCoder
    coder = NativeCoder(10, 4)
    large_end = layout["large_rows"] * LARGE_BLOCK
    windows = []  # (shard offset, width)
    for r in range(layout["large_rows"]):
        windows += [(r * LARGE_BLOCK, KERNEL_N),
                    ((r + 1) * LARGE_BLOCK - KERNEL_N, KERNEL_N)]
    width = min(KERNEL_N, layout["shard_bytes"] - large_end)
    if width:
        windows += [(large_end, width),
                    (layout["shard_bytes"] - width, width)]

    def dat_offset(shard_off: int, sid: int) -> int:
        if shard_off < large_end:
            row, inner = divmod(shard_off, LARGE_BLOCK)
            return (row * 10 + sid) * LARGE_BLOCK + inner
        row, inner = divmod(shard_off - large_end, SMALL_BLOCK)
        return large_end * 10 + (row * 10 + sid) * SMALL_BLOCK + inner

    files = {sid: open(base + to_ext(sid), "rb") for sid in range(14)}
    try:
        with open(base + ".dat", "rb") as dat:
            for off, width in windows:
                rows = np.zeros((14, width), np.uint8)
                for sid in range(14):
                    raw = os.pread(files[sid].fileno(), width, off)
                    check(len(raw) == width, f"shard {sid} short at {off}")
                    rows[sid] = np.frombuffer(raw, np.uint8)
                for sid in range(10):
                    # A window never crosses a large block, but one in the
                    # small rows spans up to 4 of them.
                    for k in range(0, width, SMALL_BLOCK):
                        raw = os.pread(dat.fileno(), SMALL_BLOCK,
                                       dat_offset(off + k, sid))
                        want = np.zeros(SMALL_BLOCK, np.uint8)
                        want[:len(raw)] = np.frombuffer(raw, np.uint8)
                        check(np.array_equal(rows[sid, k:k + SMALL_BLOCK],
                                             want),
                              f"shard {sid} at {off + k} is not the .dat "
                              f"at {dat_offset(off + k, sid)}")
                check(np.array_equal(coder.encode(rows[:10]), rows[10:]),
                      f"parity at shard offset {off} differs from "
                      "coder_native's")
    finally:
        for f in files.values():
            f.close()
    return windows


def block_crcs(paths: dict) -> dict:
    """file_block_crcs of each path, {key: crcs}, 8 files at a time (the
    native CRC32-C releases the interpreter lock)."""
    import concurrent.futures
    from seaweedfs_tpu_torch.ec.integrity import file_block_crcs
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futs = {k: pool.submit(file_block_crcs, p) for k, p in paths.items()}
        return {k: f.result() for k, f in futs.items()}


def same_bytes(pairs: list) -> None:
    """Each (a, b) pair of files holds the same bytes, read 64 MiB at a
    time, 4 pairs at a time."""
    import concurrent.futures

    def one(a: str, b: str) -> None:
        check(os.path.getsize(a) == os.path.getsize(b),
              f"{a} and {b} differ in size")
        with open(a, "rb") as fa, open(b, "rb") as fb:
            off = 0
            while True:
                x = os.pread(fa.fileno(), 64 * MIB, off)
                if not x:
                    return
                check(x == os.pread(fb.fileno(), 64 * MIB, off),
                      f"{a} and {b} differ in [{off}, {off + len(x)})")
                off += len(x)

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(one, a, b) for a, b in pairs]:
            f.result()


class RamFiles:
    """Files kept in this process's memory (memfd_create), each reached
    through a symlink at its path, so every open, stat and pread of the
    path sees it.  The GPU host lets a run's disk grow by at most
    DISK_CAP; phase 4's volume and its 14 shards together would pass
    that at the north-star size."""

    def __init__(self):
        self.fds: dict = {}

    def make(self, path: str) -> None:
        fd = os.memfd_create(os.path.basename(path))
        os.symlink(f"/proc/self/fd/{fd}", path)
        self.fds[path] = fd

    def drop(self, path: str) -> None:
        os.remove(path)
        os.close(self.fds.pop(path))

    def close(self) -> None:
        for fd in self.fds.values():
            os.close(fd)
        self.fds.clear()


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("chip_smoke: no MemAvailable in /proc/meminfo")


class PeakRss:
    """This process's VmRSS before a `with` block and its highest,
    sampled every 20 ms, while the block runs."""

    def __enter__(self):
        self.before = self.peak = rss_mib(os.getpid())
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, rss_mib(os.getpid()))

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_mib(os.getpid()))


def needle_spans(base: str) -> dict:
    """{needle id: (.dat offset, record bytes)} from the .idx."""
    from seaweedfs_tpu_torch.core.needle import (CURRENT_VERSION,
                                                 get_actual_size)
    from seaweedfs_tpu_torch.core.types import NEEDLE_PADDING_SIZE
    idx = np.fromfile(base + ".idx", dtype=[("key", ">u8"), ("off", ">u4"),
                                            ("size", ">u4")])
    return {int(k): (int(o) * NEEDLE_PADDING_SIZE,
                     get_actual_size(int(s), CURRENT_VERSION))
            for k, o, s in zip(idx["key"], idx["off"], idx["size"])}


def boundary_needles(spans: dict, layout: dict) -> dict:
    """The needles whose record crosses a 1 GiB large-block boundary of
    the .dat, {needle id: boundary}, the last large-row boundary being
    the transition into the small rows."""
    bounds = [k * LARGE_BLOCK for k in range(1, layout["large_rows"] * 10 + 1)]
    out = {}
    for nid, (off, size) in spans.items():
        for b in bounds:
            if off < b < off + size:
                out[nid] = b
    return out


def read_kind(ivs) -> str:
    """Where a needle's record lies, from its shard intervals: "large"
    (one large block), "small" (small rows only), "large_boundary" (two
    large blocks) or "large_to_small" (the last large block and the
    first small row)."""
    kinds = {iv.is_large_block for iv in ivs}
    if kinds == {True, False}:
        return "large_to_small"
    if kinds == {False}:
        return "small"
    return "large" if len(ivs) == 1 else "large_boundary"


def main_batch_rebuild(torch, base: str) -> dict:
    """batch_rebuild_files of one volume at the default budget, with the
    card's peak memory and this process's RSS growth during the call and
    every device step's staged input plus output."""
    from seaweedfs_tpu_torch.parallel import cluster_rebuild
    steps: list = []
    observe = cluster_rebuild.observe_batch_stage

    def record(stages, stage, seconds, nbytes):
        if stage == "batch_rebuild_device":
            steps.append(nbytes)
        observe(stages, stage, seconds, nbytes)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cluster_rebuild.observe_batch_stage = record
    try:
        with PeakRss() as rss:
            t0 = time.perf_counter()
            lines = cluster_rebuild.batch_rebuild_files(
                [base], max_batch_bytes=MAIN_BATCH_BYTES)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        cluster_rebuild.observe_batch_stage = observe
    rows = 10 + len(REBUILD_LOST)
    staged = [n // 10 * rows for n in steps]
    return {"wall_s": wall, "lines": lines, "steps": len(steps),
            "max_staged_bytes": max(staged),
            "device_peak_bytes": torch.cuda.max_memory_allocated(),
            "rss_before_mib": rss.before,
            "rss_growth_mib": rss.peak - rss.before}


def phase_main_path(torch, dev, args) -> dict:
    from seaweedfs_tpu_torch.ec import to_ext
    from seaweedfs_tpu_torch.ec.encoder import (rebuild_ec_files,
                                                write_ec_files,
                                                write_sorted_file_from_idx)
    from seaweedfs_tpu_torch.ec.integrity import ShardChecksums
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.ops.coder_cuda import (apply_bitmatrix,
                                                    apply_bitmatrix_crc)

    work = os.path.join(REPO, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dat_bytes = args.main_mib * MIB
    shard_max = ec_layout(dat_bytes)["shard_bytes"]
    # The 14 shards the encode writes are kept in memory (RamFiles); on
    # the disk are the .dat until the encode's checks are done, then the
    # two rebuilds' 4 + 4 shards.
    need = {"memory": 14 * shard_max + MEM_SLACK,
            "disk": max(dat_bytes, 8 * shard_max) + DISK_SLACK}
    have = {"memory": mem_available(),
            "disk": min(shutil.disk_usage(work).free, DISK_CAP)}
    for what in need:
        check(have[what] >= need[what],
              f"phase 4: a {args.main_mib} MiB volume needs {need[what]} "
              f"bytes of {what}, {have[what]} are free: "
              f"{need[what] - have[what]} bytes short (--main-mib sets the "
              "size)")
    walls: dict = {}
    ram = RamFiles()
    try:
        base = os.path.join(work, "1")
        for sid in range(14):
            ram.make(base + to_ext(sid))
        t0 = time.perf_counter()
        payloads = write_volume(base, dat_bytes, args.seed)
        write_sorted_file_from_idx(base)
        dat_size = os.path.getsize(base + ".dat")
        walls["write"] = time.perf_counter() - t0
        layout = ec_layout(dat_size)
        log(f"wrote {len(payloads)} needles, .dat {dat_size} bytes in "
            f"{walls['write']:.1f} s; layout {layout}; free {have}")

        reset_counts()
        obs: dict = {}
        last = [obs_snapshot(torch)]

        def close_window(name):
            now = obs_snapshot(torch)
            obs[name] = obs_window(last[0], now)
            last[0] = now

        t0 = time.perf_counter()
        write_ec_files(base, device=dev)
        walls["encode"] = time.perf_counter() - t0
        close_window("main_encode")
        k2_encode = apply_bitmatrix_crc.launches
        check(k2_encode == layout["encode_calls"],
              f"{k2_encode} K2 launches in write_ec_files for "
              f"{layout['encode_calls']} coder calls of the layout")
        shard_bytes = os.path.getsize(base + to_ext(0))
        for sid in range(14):
            check(os.path.getsize(base + to_ext(sid)) == layout["shard_bytes"],
                  f"shard {sid}: {os.path.getsize(base + to_ext(sid))} bytes, "
                  f"the layout's {layout['shard_bytes']}")
        t0 = time.perf_counter()
        originals = block_crcs({sid: base + to_ext(sid) for sid in range(14)})
        ecc = ShardChecksums.load(base)
        for sid in range(14):
            check(ecc.get(sid) == originals[sid],
                  f".ecc of shard {sid} differs from its bytes")
        windows = check_stripes(base, dat_size, layout)
        walls["encode_checks"] = time.perf_counter() - t0
        os.remove(base + ".dat")
        log(f"encode {walls['encode']:.3f} s, {k2_encode} K2 launches; .ecc "
            f"matches all 14 shards; stripes at {len(windows)} offsets equal "
            f"the .dat and coder_native ({walls['encode_checks']:.1f} s)")

        for sid in REBUILD_LOST:
            ram.drop(base + to_ext(sid))
        t0 = time.perf_counter()
        rebuilt = rebuild_ec_files(base, device=dev)
        walls["rebuild"] = time.perf_counter() - t0
        close_window("main_rebuild")
        k1_rebuild = apply_bitmatrix.launches
        check(rebuilt == list(REBUILD_LOST), f"rebuilt {rebuilt}")
        check(k1_rebuild == -(-shard_bytes // KERNEL_N),
              f"{k1_rebuild} K1 launches rebuilding {shard_bytes}-byte shards")
        ecc = ShardChecksums.load(base)
        now = block_crcs({sid: base + to_ext(sid) for sid in REBUILD_LOST})
        for sid in REBUILD_LOST:
            check(now[sid] == originals[sid],
                  f"rebuilt shard {sid}'s block CRCs differ from the "
                  "original's")
            check(ecc.get(sid) == originals[sid],
                  f".ecc of rebuilt shard {sid} differs from the original's")
        log(f"rebuild {walls['rebuild']:.3f} s, {k1_rebuild} K1 launches; "
            f"shards {rebuilt} have the originals' block CRCs")

        # The same loss again, rebuilt by the batched path in column
        # steps; rebuild_ec_files's shards are kept aside to compare.
        for sid in REBUILD_LOST:
            os.replace(base + to_ext(sid), base + to_ext(sid) + ".single")
        k2_before = apply_bitmatrix_crc.launches
        batch = main_batch_rebuild(torch, base)
        close_window("main_batch_rebuild")
        batch["k2_launches"] = apply_bitmatrix_crc.launches - k2_before
        check(batch["lines"] == [f"volume {base}: rebuilt shards "
                                 f"{list(REBUILD_LOST)}"], f"{batch['lines']}")
        check(batch["k2_launches"] == batch["steps"] > 1,
              f"{batch['k2_launches']} K2 launches for {batch['steps']} steps")
        check(batch["max_staged_bytes"] <= MAIN_BATCH_BYTES,
              f"a batched step staged {batch['max_staged_bytes']} bytes")
        check(batch["device_peak_bytes"] < MAIN_DEVICE_PEAK_MAX,
              f"the batched rebuild's device peak "
              f"{batch['device_peak_bytes']}")
        check(batch["rss_growth_mib"] * MIB < MAIN_RSS_GROWTH_MAX,
              f"the batched rebuild grew RSS {batch['rss_growth_mib']} MiB")
        same_bytes([(base + to_ext(sid), base + to_ext(sid) + ".single")
                    for sid in REBUILD_LOST])
        ecc = ShardChecksums.load(base)
        for sid in REBUILD_LOST:
            os.remove(base + to_ext(sid) + ".single")
            check(ecc.get(sid) == originals[sid],
                  f".ecc of batch-rebuilt shard {sid} differs")
        walls["batch_rebuild"] = batch.pop("wall_s")
        batch.pop("lines")
        log(f"batched rebuild {walls['batch_rebuild']:.3f} s in "
            f"{batch['steps']} steps, equal to rebuild_ec_files's: {batch}")

        for sid in READ_LOST:
            ram.drop(base + to_ext(sid))
        crossing = boundary_needles(needle_spans(base), layout)
        rng = np.random.default_rng(args.seed + 2)
        ids = sorted(payloads)
        sample = [ids[i] for i in rng.choice(len(ids), min(READS, len(ids)),
                                             replace=False)]
        reads = sample + sorted(set(crossing) - set(sample))
        vol = EcVolume(base, device=dev)
        try:
            vol.version  # shard 0 is lost: its superblock is a K1 launch
            k1_before = apply_bitmatrix.launches
            lost_intervals = 0
            by_kind: dict = {}
            lat_degraded, lat_local = [], []
            for nid in reads:
                _off, _size, ivs = vol.locate_needle(nid)
                kind = read_kind(ivs)
                lost_intervals += sum(
                    iv.to_shard_id_and_offset(LARGE_BLOCK, SMALL_BLOCK)[0]
                    in READ_LOST for iv in ivs)
                before = apply_bitmatrix.launches
                t0 = time.perf_counter()
                n = vol.read_needle(nid)
                dt = time.perf_counter() - t0
                check(n.data == payloads[nid], f"needle {nid} read back wrong")
                by_kind.setdefault(kind, []).append(dt)
                (lat_degraded if apply_bitmatrix.launches > before
                 else lat_local).append(dt)
            k1_reads = apply_bitmatrix.launches - k1_before
            close_window("main_reads")
            check(k1_reads == lost_intervals,
                  f"{k1_reads} K1 launches for {lost_intervals} lost "
                  "intervals read")
            check("large_to_small" in by_kind or not layout["large_rows"],
                  "no read across the large-to-small transition")
            launches = {"rs_bitmatrix": apply_bitmatrix.launches,
                        "rs_bitmatrix_crc": apply_bitmatrix_crc.launches}
            by_instantiation = {
                "rs_bitmatrix": dict(apply_bitmatrix.variant_launches),
                "rs_bitmatrix_crc": dict(apply_bitmatrix_crc.variant_launches)}
            log(f"{len(reads)} reads verified ({len(crossing)} across a "
                f"large-block boundary), {len(lat_degraded)} degraded, "
                f"{k1_reads} K1 = lost intervals read; by kind "
                f"{ {k: len(v) for k, v in by_kind.items()} }; launches "
                f"{launches}")
            for name, count in launches.items():
                check(count > 0, f"{name} never launched on the main path")
            # The hooks' cost: the seeded sample's degraded reads again,
            # after the counts were read and outside the counted windows,
            # in each mode.
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
        ram.close()

    out = {
        "dat_bytes": dat_size, "needles": len(payloads), "layout": layout,
        "shard_bytes": shard_bytes, "walls_s": walls,
        "encode_s": walls["encode"],
        "encode_gb_s": dat_size / walls["encode"] / 1e9,
        "rebuild_s": walls["rebuild"],
        "rebuild_gb_s": dat_size / walls["rebuild"] / 1e9,
        "batch_rebuild": {**batch, "gb_s": dat_size / walls["batch_rebuild"]
                          / 1e9},
        "stripes_checked": len(windows),
        "reads": len(reads), "degraded_reads": len(lat_degraded),
        "boundary_needles": len(crossing), "lost_intervals": lost_intervals,
        "reads_by_kind": {k: {"reads": len(v), "p50_ms": pct_ms(v, 50),
                              "p99_ms": pct_ms(v, 99)}
                          for k, v in by_kind.items()},
        "degraded_read_p50_ms": pct_ms(lat_degraded, 50),
        "degraded_read_p99_ms": pct_ms(lat_degraded, 99),
        "local_read_p50_ms": pct_ms(lat_local, 50),
        "hooks_cost": cost,
        "obs": obs,
        "launches": launches,
        "launches_by_instantiation": by_instantiation,
        "launches_by_step": {"encode_rs_bitmatrix_crc": k2_encode,
                             "rebuild_rs_bitmatrix": k1_rebuild,
                             "batch_rebuild_rs_bitmatrix_crc":
                                 batch["k2_launches"],
                             "reads_rs_bitmatrix": k1_reads},
    }
    if args.main_mib < MAIN_MIB:
        out["reduced"] = f"volume {MAIN_MIB} MiB -> {args.main_mib} MiB"
    return out


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


# -- phase 9: the control plane ----------------------------------------------


def cluster_heartbeats(dcs: int, racks: int, nodes: int, max_volumes: int, *,
                       size_limit: int, seed: int, base_port: int,
                       ec_vid: int, ec_collection: str,
                       collections: tuple = ("",), tenants: tuple = (),
                       device: dict | None = None) -> list[dict]:
    """Full heartbeat bodies of dcs x racks x nodes simulated volume
    servers at 127.0.0.1:base_port + i (DC-major), shaped as volume
    servers send them.  Every slot holds a volume of placement 010 (its
    two copies on node n of racks 2p and 2p+1 of one DC; ids from
    ec_vid + 1, collections in turn, seeded sizes below size_limit); the
    EC volume's 14 shards lie one per node on 14 nodes spread over the
    DCs and racks.  Each node carries an SLO view (a tracker fed seeded
    latencies), a flow row, a disk, the `tenants` rows (tenant,
    collection, bytes, objects) and node 0 the `device` view."""
    from seaweedfs_tpu_torch.stats.slo import SloTracker
    check(racks % 2 == 0, "placement 010 pairs the racks")
    rng = np.random.default_rng(seed)
    layout = [(d, r, n) for d in range(dcs) for r in range(racks)
              for n in range(nodes)]
    index = {pos: i for i, pos in enumerate(layout)}
    hbs = []
    for i, (d, r, n) in enumerate(layout):
        port = base_port + i
        tracker = SloTracker("volume", clock=lambda: float(CLUSTER_EPOCH_S))
        for s in rng.lognormal(-7.0, 1.0, 48):
            tracker.observe("/needle", "GET", 200, float(s))
        for s in rng.lognormal(-6.0, 1.0, 16):
            tracker.observe("/needle", "POST", 201, float(s))
        used = int(rng.integers(1 << 40, 6 << 40))
        peer = base_port + (i + 1) % len(layout)
        hbs.append({
            "ip": "127.0.0.1", "port": port,
            "public_url": f"127.0.0.1:{port}",
            "data_center": f"dc{d}", "rack": f"rack{r}",
            "seq": 1, "seq_epoch": seed * 1000 + i + 1,
            "max_volume_count": max_volumes, "volumes": [], "ec_shards": [],
            "disks": [{"dir": "/data", "all": 8 << 40, "used": used,
                       "free": (8 << 40) - used,
                       "percent_used": round(100 * used / (8 << 40), 2)}],
            "ec_corrupt": {}, "draining": False, "low_disk": False,
            "slo": tracker.heartbeat_view(),
            "tenants": [{"tenant": t, "collection": c, "bytes": b,
                         "objects": o} for t, c, b, o in tenants],
            "flows": {"rows": [{
                "local": f"127.0.0.1:{port}", "peer": f"127.0.0.1:{peer}",
                "peer_role": "volume", "purpose": "replicate.fanout",
                "direction": "out", "bytes": int(rng.integers(1 << 30)),
                "ops": int(rng.integers(1 << 16))}], "budgets": {}}})
    vid = ec_vid
    for d in range(dcs):
        for r in range(0, racks, 2):
            for n in range(nodes):
                for _ in range(max_volumes):
                    vid += 1
                    files = int(rng.integers(1, 1 << 20))
                    deleted = int(rng.integers(0, files))
                    v = {"id": vid,
                         "collection": collections[vid % len(collections)],
                         "size": int(rng.integers(1 << 20, size_limit)),
                         "file_count": files, "delete_count": deleted,
                         "deleted_byte_count": deleted * 4096,
                         "read_only": False, "replica_placement": 10,
                         "ttl": 0, "compact_revision": 0,
                         "max_file_key": files, "version": 3,
                         "corrupt_count": 0, "modified_at": CLUSTER_EPOCH_S,
                         "tiered": False}
                    for rr in (r, r + 1):
                        hbs[index[(d, rr, n)]]["volumes"].append(dict(v))
    for sid in range(14):
        d, r, n = sid % dcs, (sid // dcs) % racks, sid // (dcs * racks)
        hbs[index[(d, r, n)]]["ec_shards"].append(
            {"id": ec_vid, "collection": ec_collection,
             "shard_bits": 1 << sid, "codec": "rs"})
    if device is not None:
        hbs[0]["device"] = device
    return hbs


def node_key(hb: dict) -> str:
    return f"{hb['ip']}:{hb['port']}"


def delta_beat(hb: dict, seq: int, **extra) -> dict:
    """A pulse's beat of the node whose full beat is `hb`: the same
    identity and process generation, no volume change."""
    keep = ("ip", "port", "public_url", "data_center", "rack", "seq_epoch",
            "max_volume_count")
    return {**{k: hb[k] for k in keep}, "seq": seq, "new_volumes": [],
            "deleted_volumes": [], **extra}


def goodbye_beat(hb: dict) -> dict:
    return {"ip": hb["ip"], "port": hb["port"], "goodbye": True,
            "seq_epoch": hb["seq_epoch"]}


def declared_locations(hbs: list[dict]) -> tuple[dict, dict]:
    """What the beats declare: vid -> sorted node urls of each replicated
    volume, and shard id -> [node url] of the EC volume."""
    vols: dict = {}
    ec: dict = {}
    for hb in hbs:
        for v in hb["volumes"]:
            vols.setdefault(v["id"], []).append(node_key(hb))
        for e in hb["ec_shards"]:
            for sid in range(32):
                if e["shard_bits"] >> sid & 1:
                    ec.setdefault(str(sid), []).append(node_key(hb))
    return {vid: sorted(urls) for vid, urls in vols.items()}, ec


class Pulse:
    """Keeps the simulated volume servers alive as real ones keep
    themselves: one delta beat per live node every CLUSTER_PULSE_S, from
    a thread of its own.  A node's beats are serialised (the master drops
    a beat whose seq is not newer)."""

    def __init__(self, url: str, hbs: list[dict]):
        self.url, self.hbs = url, hbs
        self.live = set(range(len(hbs)))
        self.seq = [hb["seq"] for hb in hbs]
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.errors: list = []
        self.beats = 0
        self.thread = threading.Thread(target=self._run, daemon=True)

    def post(self, body: dict) -> None:
        from seaweedfs_tpu_torch.cluster import rpc
        rpc.call(f"{self.url}/heartbeat", "POST", json.dumps(body).encode())

    def beat(self, i: int, **extra) -> None:
        with self.lock:
            self.seq[i] += 1
            self.post(delta_beat(self.hbs[i], self.seq[i], **extra))
            self.beats += 1

    def goodbye(self, i: int) -> None:
        with self.lock:
            self.live.discard(i)
            self.post(goodbye_beat(self.hbs[i]))

    def _run(self) -> None:
        while not self.stop.wait(CLUSTER_PULSE_S):
            for i in sorted(self.live):
                try:
                    self.beat(i)
                except Exception as e:  # noqa: BLE001 — checked at the end
                    self.errors.append(f"node {i}: {type(e).__name__}: {e}")


def drive(url: str, paths: list[str], clients: int) -> tuple[list, dict]:
    """GET every path from `clients` threads on rpc.call's keep-alive
    pool; (answers in path order, {requests, per_s, p50_ms, p99_ms})."""
    from seaweedfs_tpu_torch.cluster import rpc
    answers: list = [None] * len(paths)
    lat = [0.0] * len(paths)
    errors: list = []

    def worker(k: int) -> None:
        j = k
        try:
            for j in range(k, len(paths), clients):
                t = time.perf_counter()
                answers[j] = rpc.call(url + paths[j])
                lat[j] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{paths[j]}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    check(not errors, f"{len(errors)} requests failed: {errors[:3]}")
    return answers, {"requests": len(paths), "wall_s": wall,
                     "per_s": len(paths) / wall, "p50_ms": pct_ms(lat, 50),
                     "p99_ms": pct_ms(lat, 99)}


def start_master(transport: str, port: int, work: str):
    """The port's master as `python -m seaweedfs_tpu_torch master` with the
    upstream flags, in a process whose sys.modules blocks jax, jaxlib and
    seaweedfs_tpu; returns (process, url, log path) once /dir/status
    answers."""
    from seaweedfs_tpu_torch.cluster import rpc
    mdir = os.path.join(work, f"master_{transport}")
    os.makedirs(mdir)
    log_path = mdir + ".log"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-c", MASTER_LAUNCH, "master", f"-port={port}",
             f"-mdir={mdir}", f"-volumeSizeLimitMB={CLUSTER_SIZE_LIMIT_MB}",
             f"-defaultReplication={CLUSTER_REPLICATION}",
             f"-pulseSeconds={CLUSTER_PULSE_S}", f"-transport={transport}"],
            cwd=REPO, env=env, stdout=log_f, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 60
    while True:
        if proc.poll() is not None:
            with open(log_path) as f:
                tail = f.read()[-2000:]
            raise RuntimeError(f"chip_smoke: master ({transport}) exited "
                               f"{proc.returncode}: {tail}")
        try:
            rpc.call(url + "/dir/status", timeout=2.0)
            return proc, url, log_path
        except OSError:
            check(time.monotonic() < deadline,
                  f"master ({transport}) did not answer within 60 s")
            time.sleep(0.1)


def stop_master(proc) -> None:
    """SIGTERM (the master drains and stops), then SIGKILL after 10 s."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def rss_mib(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError(f"chip_smoke: no VmRSS for process {pid}")


def device_counts(doc: dict) -> dict:
    """A kernel table (/cluster/device's merged one, or a ledger's
    heartbeat view) as {catalog key: count}."""
    out: dict = {}
    for r in doc["kernels"]:
        out[r["kernel"]] = out.get(r["kernel"], 0) + r["count"]
    return out


def cluster_window(torch, dev, seed: int) -> tuple[dict, dict]:
    """Phase 9's own K1/K2 window on the card: a CLUSTER_WINDOW_MIB
    volume encoded by write_ec_files (K2 10->4) and four shards rebuilt
    (K1 10->4), with the launch counts reset just before; (launches,
    ledger rows per catalog key)."""
    from seaweedfs_tpu_torch.ec import to_ext
    from seaweedfs_tpu_torch.ec.encoder import (rebuild_ec_files,
                                                write_ec_files,
                                                write_sorted_file_from_idx)
    work = os.path.join(REPO, "_smoke_work", "cluster_window")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        base = os.path.join(work, "1")
        write_volume(base, CLUSTER_WINDOW_MIB * MIB, seed)
        write_sorted_file_from_idx(base)
        reset_counts()
        before = obs_snapshot(torch)
        write_ec_files(base, device=dev)
        for sid in CLUSTER_WINDOW_LOST:
            os.remove(base + to_ext(sid))
        rebuilt = rebuild_ec_files(base, device=dev)
        window = obs_window(before, obs_snapshot(torch))
        launches = read_counts()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(rebuilt == list(CLUSTER_WINDOW_LOST), f"window rebuilt {rebuilt}")
    return launches, window["rows"]


def phase_cluster(torch, dev, args) -> dict:
    """Phase 9: the port's master on each transport, fed the simulated
    cluster's heartbeats and driven by 8 client threads; every answer
    held against what the beats declared, the card's K1/K2 ledger rows
    against the launch counts through /cluster/device."""
    from seaweedfs_tpu_torch.cluster import rpc
    from seaweedfs_tpu_torch.stats import roofline

    t_phase = time.perf_counter()
    work = os.path.join(REPO, "_smoke_work", "cluster")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    hbs = cluster_heartbeats(
        CLUSTER_DCS, CLUSTER_RACKS, CLUSTER_NODES, CLUSTER_MAX_VOLUMES,
        size_limit=CLUSTER_SIZE_LIMIT_MB * MIB, seed=args.seed,
        base_port=CLUSTER_BASE_PORT, ec_vid=STORAGE_VID,
        ec_collection=STORAGE_COLLECTION)
    vols, ec = declared_locations(hbs)
    vids = sorted(vols)
    check(len(vids) == CLUSTER_DCS * CLUSTER_RACKS * CLUSTER_NODES
          * CLUSTER_MAX_VOLUMES // 2 and len(ec) == 14,
          f"{len(vids)} volumes, {len(ec)} EC shards declared")
    gone = next(i for i, hb in enumerate(hbs) if i and hb["ec_shards"])
    gone_url = node_key(hbs[gone])
    out: dict = {"reduced": {"requests_per_transport": [20000,
                                                        CLUSTER_ASSIGNS]},
                 "config": {
        "master": f"weed master -volumeSizeLimitMB={CLUSTER_SIZE_LIMIT_MB} "
                  f"-defaultReplication={CLUSTER_REPLICATION} "
                  f"-pulseSeconds={CLUSTER_PULSE_S}",
        "volume_servers": len(hbs), "layout": f"{CLUSTER_DCS} DCs x "
        f"{CLUSTER_RACKS} racks x {CLUSTER_NODES} nodes, -max="
        f"{CLUSTER_MAX_VOLUMES}", "volumes": len(vids),
        "ec_volume": STORAGE_VID, "clients": CLUSTER_CLIENTS,
        "entry_point": "runpy.run_module('seaweedfs_tpu_torch') (what "
                       "python -m runs) with jax, jaxlib and seaweedfs_tpu "
                       "set to None in sys.modules"}}
    window_launches = {"rs_bitmatrix": 0, "rs_bitmatrix_crc": 0}
    log(f"control plane: {out['config']['master']} over {len(hbs)} "
        f"simulated volume servers; the master starts as "
        f"{out['config']['entry_point']}")
    try:
        for transport in CLUSTER_TRANSPORTS:
            res: dict = {}
            walls: dict = {}  # where the phase's seconds go, per step
            t_step = [time.perf_counter()]

            def step(name: str) -> None:
                now = time.perf_counter()
                walls[name] = now - t_step[0]
                t_step[0] = now

            proc, url, log_path = start_master(transport, rpc.free_port(),
                                               work)
            step("start_master")
            pulse = Pulse(url, hbs)
            try:
                # Full beats: node 0 carries this process's ledger.
                hbs[0]["device"] = roofline.LEDGER.heartbeat_view()
                local = device_counts(hbs[0]["device"])
                apply_ms = []
                for hb in hbs:
                    t = time.perf_counter()
                    pulse.post(hb)
                    apply_ms.append((time.perf_counter() - t) * 1e3)
                res["full_heartbeat_apply_ms"] = {
                    "p50": float(np.median(apply_ms)), "max": max(apply_ms),
                    "total": sum(apply_ms)}
                pulse.thread.start()
                step("full_beats")
                top = rpc.call(url + "/dir/status")["topology"]
                check(top["volumes"] == 2 * len(vids) and top["ecShards"] == 14
                      and top["max"] == len(hbs) * CLUSTER_MAX_VOLUMES,
                      f"{transport}: topology {top}")

                answers, res["assign"] = drive(
                    url, ["/dir/assign?count=1&replication="
                          + CLUSTER_REPLICATION] * CLUSTER_ASSIGNS,
                    CLUSTER_CLIENTS)
                fids = set()
                for a in answers:
                    vid_s, rest = a["fid"].split(",")
                    vid = int(vid_s)
                    check(vid in vols and a["count"] == 1
                          and len(rest) > 8 and int(rest[:-8], 16) > 0,
                          f"{transport}: assign answered {a}")
                    check(sorted([a["url"]] + [r["url"] for r in a["replicas"]])
                          == vols[vid], f"{transport}: assign {a} vs {vols[vid]}")
                    fids.add(a["fid"])
                check(len(fids) == CLUSTER_ASSIGNS,
                      f"{transport}: {CLUSTER_ASSIGNS - len(fids)} repeated fids")
                step("assigns")

                targets = [vids[j % len(vids)] if j % (len(vids) + 1)
                           else STORAGE_VID for j in range(CLUSTER_LOOKUPS)]
                answers, res["lookup"] = drive(
                    url, [f"/dir/lookup?volumeId={v}" for v in targets],
                    CLUSTER_CLIENTS)
                for v, a in zip(targets, answers):
                    if v == STORAGE_VID:
                        got = {s: [x["url"] for x in locs]
                               for s, locs in a["ecShards"].items()}
                        check(got == ec, f"{transport}: EC lookup {got}")
                    else:
                        check(sorted(x["url"] for x in a["locations"])
                              == vols[v], f"{transport}: lookup {v}: {a}")
                step("lookups")

                vl = rpc.call(url + "/vol/list")["topology"]["data_centers"]
                listed = [n for dc in vl for rack in dc["racks"]
                          for n in rack["nodes"]]
                check(len(listed) == len(hbs) and sum(
                    len(n["volumes"]) for n in listed) == 2 * len(vids)
                    and sum(len(n["ec_shards"]) for n in listed) == 14,
                    f"{transport}: /vol/list lists {len(listed)} nodes")
                status, health = rpc.call_status(url + "/cluster/healthz")
                check(status == 200 and health["healthy"]
                      and len(health["nodes"]) == len(hbs),
                      f"{transport}: healthz {status} "
                      f"{health.get('problems')}")

                pulse.goodbye(gone)
                held = [v for v, urls in vols.items() if gone_url in urls]
                answers, res["lookup_after_goodbye"] = drive(
                    url, [f"/dir/lookup?volumeId={v}"
                          for v in held + [STORAGE_VID]], CLUSTER_CLIENTS)
                for v, a in zip(held, answers):
                    check(sorted(x["url"] for x in a["locations"])
                          == [u for u in vols[v] if u != gone_url],
                          f"{transport}: lookup {v} after goodbye: {a}")
                check(all(x["url"] != gone_url for locs in
                          answers[-1]["ecShards"].values() for x in locs)
                      and len(answers[-1]["ecShards"]) == 13,
                      f"{transport}: EC lookup after goodbye {answers[-1]}")

                # The control plane's own footprint, before the rollup's
                # probe_peaks brings the card up in the master process.
                res["master_rss_mib_before_device"] = rss_mib(proc.pid)
                step("list_healthz_goodbye")
                doc = rpc.call(url + "/cluster/device", timeout=120.0)
                step("first_cluster_device")
                peaks = doc["peaks"]
                check(peaks.get("backend") == dev.type and (
                    dev.type != "cuda" or "H100" in peaks.get("device_kind")),
                      f"{transport}: /cluster/device peaks {peaks}")
                check(node_key(hbs[0]) in doc["nodes"],
                      f"{transport}: node 0 missing from /cluster/device")
                counts = device_counts(doc)
                check(counts == local and local.get("encode_crc_kernel")
                      and local.get("reconstruct_kernel"),
                      f"{transport}: /cluster/device rows {counts}, the "
                      f"ledger {local}")
                launches, rows = cluster_window(torch, dev, args.seed)
                step("window")
                for name in window_launches:
                    window_launches[name] += launches[name]["launches"]
                pulse.beat(0, device=roofline.LEDGER.heartbeat_view())
                after = device_counts(rpc.call(url + "/cluster/device",
                                               timeout=120.0))
                moved = {k: v - counts.get(k, 0) for k, v in after.items()
                         if v != counts.get(k, 0)}
                k1 = launches["rs_bitmatrix"]["launches"]
                k2 = launches["rs_bitmatrix_crc"]["launches"]
                check(moved == rows and moved.get("encode_crc_kernel") == k2
                      and moved.get("reconstruct_kernel") == k1 and k1 and k2,
                      f"{transport}: window moved /cluster/device by {moved}; "
                      f"ledger {rows}, launches K1 {k1} K2 {k2}")
                res["device"] = {"peaks_backend": peaks["backend"],
                                 "device_kind": peaks["device_kind"],
                                 "rows_at_full_beat": counts,
                                 "window_launches": {"rs_bitmatrix": k1,
                                                     "rs_bitmatrix_crc": k2},
                                 "window_rows": moved}

                grows = rpc.call(url + "/debug/events?type=volume.grow")
                dials = rpc.call(url + "/debug/events?type=volume.assign")
                check(not grows["events"] and not dials["events"],
                      f"{transport}: the master grew or allocated volumes")
                res["master_rss_mib"] = rss_mib(proc.pid)
                pulse.stop.set()
                pulse.thread.join()
                check(not pulse.errors, f"{transport}: pulse {pulse.errors[:3]}")
                res["pulse_beats"] = pulse.beats
            finally:
                pulse.stop.set()
                if pulse.thread.is_alive():
                    pulse.thread.join()
                stop_master(proc)
            step("rest_and_stop")
            res["walls_s"] = walls
            with open(log_path) as f:
                log_text = f.read()
            check("Traceback" not in log_text,
                  f"{transport}: the master logged {log_text[-2000:]}")
            out[transport] = res
            log(f"control plane ({transport}): assign "
                f"{res['assign']['per_s']:.0f}/s p50 "
                f"{res['assign']['p50_ms']:.3f} ms p99 "
                f"{res['assign']['p99_ms']:.3f} ms; lookup "
                f"{res['lookup']['per_s']:.0f}/s p50 "
                f"{res['lookup']['p50_ms']:.3f} ms p99 "
                f"{res['lookup']['p99_ms']:.3f} ms; full beat "
                f"{res['full_heartbeat_apply_ms']['p50']:.3f} ms; master RSS "
                f"{res['master_rss_mib_before_device']:.0f} MiB, "
                f"{res['master_rss_mib']:.0f} MiB after /cluster/device")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["window_launches"] = window_launches
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# -- phase 10: a live port cluster on the card -------------------------------


def port_process(args: list[str], log_path: str,
                 launch: str = MASTER_LAUNCH, tree: str = REPO):
    """`python -m seaweedfs_tpu_torch <args>` with jax, jaxlib and
    seaweedfs_tpu blocked (`launch`), its output in log_path; the package
    is the one in `tree` (a checkout of this repository)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (tree, os.environ.get("PYTHONPATH", "")) if p))
    with open(log_path, "w") as log_f:
        p = subprocess.Popen(
            [sys.executable, "-c", launch, *args], cwd=tree, env=env,
            stdout=log_f, stderr=subprocess.STDOUT)
    p.log_path = log_path
    p.launch = launch
    return p


def log_tails(work: str, lines: int = 30) -> None:
    """The last `lines` lines of every process log under `work`, for a
    failed phase whose directory is removed."""
    import glob
    for path in sorted(glob.glob(os.path.join(work, "*.log"))):
        with open(path, errors="replace") as f:
            tail = f.read().splitlines()[-lines:]
        log(f"{os.path.basename(path)}:\n" + "\n".join(tail))


def wait_for(pred, what: str, procs, timeout: float = 90.0):
    """Poll pred() until it returns a true value; fail if a process of
    `procs` exits or `timeout` passes."""
    deadline = time.monotonic() + timeout
    while True:
        for p in procs:
            if p.poll() is not None:
                tail = ""
                if getattr(p, "log_path", None):
                    with open(p.log_path, errors="replace") as f:
                        tail = f.read()[-1500:]
                check(False, f"{what}: a cluster process exited "
                             f"({p.args[3:6]}): {tail}")
        try:
            got = pred()
            if got:
                return got
        except OSError:
            pass
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.1)


def node_device_rows(murl: str, nodes, since: float, procs,
                     counts=None) -> dict:
    """/cluster/device's kernel rows of each of `nodes` (volume server
    URLs) from a heartbeat the master received after `since` (its
    clock), as {node: {catalog key: count}} (or what `counts` makes of a
    node's table): every beat carries the node's absolute ledger rows,
    so a beat after a step holds them all."""
    from seaweedfs_tpu_torch.cluster import rpc
    counts = counts or device_counts

    def fresh():
        doc = rpc.call(murl + "/cluster/device", timeout=120.0)
        got = doc["nodes"]
        if all(n in got and (got[n]["ts"] or 0) > since for n in nodes):
            return {n: counts(got[n]) for n in nodes}
        return None
    return wait_for(fresh, "fresh heartbeats on /cluster/device", procs)


def inbound_flows(node: str) -> dict:
    """{purpose: [bytes, requests]} a server took in, from its own
    /debug/flows rows (`node` is its host:port)."""
    from seaweedfs_tpu_torch.cluster import rpc
    out: dict = {}
    for r in rpc.call(f"http://{node}/debug/flows", timeout=60.0)["rows"]:
        if r["direction"] == "in" and r["local"] == node:
            row = out.setdefault(r["purpose"], [0, 0])
            row[0] += r["bytes"]
            row[1] += r["ops"]
    return out


def flows_delta(before: dict, after: dict) -> dict:
    """{purpose: [bytes, requests]} `after` adds over `before`."""
    out = {}
    for p, (b, n) in after.items():
        b0, n0 = before.get(p, (0, 0))
        if (b - b0, n - n0) != (0, 0):
            out[p] = [b - b0, n - n0]
    return out


def answer_classes(node: str, subsystem: str) -> dict:
    """{status class: requests} a server answered, from its /metrics
    request histogram (SeaweedFS_<subsystem>_request_seconds)."""
    from seaweedfs_tpu_torch.cluster import rpc
    text = rpc.call(f"http://{node}/metrics", timeout=60.0)
    if isinstance(text, bytes):
        text = text.decode()
    out: dict = {}
    for labels, v in re.findall(
            rf"^SeaweedFS_{subsystem}_request_seconds_count\{{([^}}]*)\}} "
            r"(\S+)$", text, re.M):
        m = re.search(r'status="(\w+)"', labels)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + int(float(v))
    return out


def column_steps(shard_bytes: int, rows: int, budget: int) -> int:
    """The pushes `ec.rebuild -batch` makes of one rebuilt shard: one
    per column step of a volume whose `rows` (survivors read plus
    shards rebuilt) do not fit `budget` whole, else one whole push."""
    if shard_bytes * rows > budget and shard_bytes > MIB:
        return -(-shard_bytes // max(MIB, budget // rows // MIB * MIB))
    return 1


def ecc_fragment_bytes(sids, shard_bytes: int) -> int:
    """The body of one `/admin/ec/receive_ecc` push (cluster_encode's
    _ecc_push_plan): the block CRCs of `sids`, shards of `shard_bytes`."""
    nb = -(-shard_bytes // SMALL_BLOCK)
    return len(json.dumps({"block": SMALL_BLOCK, "shards": {
        str(s): ["0" * 8] * nb for s in sids}}).encode())


def rebuild_pieces(lost: dict, shard_bytes: dict, placed: dict,
                   before: dict, after: dict,
                   budget: int = LIVE_REBUILD_BUDGET) -> dict:
    """Per target of an `ec.rebuild -batch`: the `ec.scatter` requests
    and bytes it took in (its /debug/flows rows `before` and `after`),
    less the one `.ecc` fragment per volume the fused CRCs send, against
    its rebuilt shards (`placed`: {(vid, sid): node}).  Fails when a
    target took fewer shard requests than its shards' column steps, or
    shard bytes other than the rebuilt shards' length."""
    out = {}
    for node in sorted(set(placed.values())):
        mine = sorted(k for k, n in placed.items() if n == node)
        got_b, got_n = flows_delta(before[node], after[node]).get(
            "ec.scatter", [0, 0])
        want_b = sum(shard_bytes[v] for v, _s in mine)
        vols = sorted({v for v, _s in mine})
        frag_b = sum(ecc_fragment_bytes(
            [s for vv, s in mine if vv == v], shard_bytes[v]) for v in vols)
        frags = len(vols) if got_b == want_b + frag_b else 0
        need = sum(column_steps(shard_bytes[v], 10 + len(lost[v]), budget)
                   for v, _s in mine)
        row = {"shards": [f"{v}.{s}" for v, s in mine],
               "shard_requests": got_n - frags, "column_steps": need,
               "shard_bytes": got_b - (frag_b if frags else 0),
               "rebuilt_bytes": want_b, "ecc_fragments": frags}
        check(row["shard_bytes"] == want_b,
              f"target {node} took {row['shard_bytes']} shard bytes for "
              f"rebuilt shards of {want_b}: {row}")
        check(row["shard_requests"] >= need,
              f"target {node} took {row['shard_requests']} shard requests "
              f"for {need} column steps of its rebuilt shards: {row}")
        out[node] = row
    return out


def geometry_counts(doc: dict) -> dict:
    """A kernel table as {"catalog key geometry": count}."""
    out: dict = {}
    for r in doc["kernels"]:
        key = f"{r['kernel']} {r['geometry']}"
        out[key] = out.get(key, 0) + r["count"]
    return out


def by_instantiation(rows: dict) -> dict:
    """geometry_counts rows of a volume server as launches per kernel
    and instantiation: the catalog key names the kernel (as in
    vs_kernel_launches), the geometry's rows in and out the
    instantiation coder_cuda picks for them."""
    from seaweedfs_tpu_torch.ops.coder_cuda import (K1_VARIANTS,
                                                    K2_VARIANTS, k1_variant,
                                                    k2_variant)
    out: dict = {"rs_bitmatrix": {}, "rs_bitmatrix_crc": {}}
    for key, n in rows.items():
        kernel, geometry = key.split()
        out_rows, in_rows = map(int, geometry.split("x")[:2])
        if kernel == "encode_crc_kernel":
            side, name = "rs_bitmatrix_crc", \
                K2_VARIANTS[k2_variant(in_rows, out_rows)]
        elif kernel in ("reconstruct_kernel", "encode_kernel"):
            side, name = "rs_bitmatrix", \
                K1_VARIANTS[k1_variant(in_rows, out_rows)]
        else:
            check(False, f"a volume server recorded {key}")
        out[side][name] = out[side].get(name, 0) + n
    return out


def rows_delta(before: dict, after: dict) -> dict:
    """Per catalog key, the rows `after` adds over `before`, summed over
    the nodes of `after` (a node missing from `before` starts at 0)."""
    out: dict = {}
    for node, rows in after.items():
        for key, n in rows.items():
            d = n - before.get(node, {}).get(key, 0)
            if d:
                out[key] = out.get(key, 0) + d
    return out


def vs_kernel_launches(rows: dict) -> dict:
    """A volume server's catalog keys as launches per kernel: the
    single-volume encode with fused CRC is K2, decode and the unfused
    encode K1 (the batched keys run in the shell's process)."""
    k1 = rows.get("reconstruct_kernel", 0) + rows.get("encode_kernel", 0)
    k2 = rows.get("encode_crc_kernel", 0)
    return {"rs_bitmatrix": k1, "rs_bitmatrix_crc": k2}


def live_needles(seed: int, blob_bytes: int):
    """Payloads log-uniform 1 KiB..4 MiB from `seed`, as slices at seeded
    offsets of one random blob: needle i is blob[off:off + size]."""
    rng = np.random.default_rng(seed)
    blob = rng.bytes(blob_bytes)

    def gen():
        while True:
            size = int(math.exp(rng.uniform(math.log(1 << 10),
                                            math.log(4 << 20))))
            off = int(rng.integers(0, blob_bytes - size))
            yield off, size
    return memoryview(blob), gen()


def shard_files(dirs: dict, vid: int) -> dict:
    """{shard id: (node, path)} of every shard file of `vid` on disk
    across the volume servers' directories (node -> dir)."""
    import glob
    out = {}
    for node, d in dirs.items():
        for path in glob.glob(os.path.join(d, f"*{vid}.ec[0-9][0-9]")):
            stem = os.path.basename(path)[:-5]
            if stem.split("_")[-1] != str(vid):
                continue
            sid = int(path[-2:])
            check(sid not in out, f"volume {vid} shard {sid} held twice")
            out[sid] = (node, path)
    return out


def ecc_entries(path: str) -> dict:
    with open(path) as f:
        return {int(s): c for s, c in json.load(f)["shards"].items()}


def encode_sealed_copies(env, vids, work: str, dev, codec: str = "rs"
                         ) -> tuple[dict, dict]:
    """Seal each volume of `vids` (readonly on every holder), copy its
    .dat and .idx here and encode the copy with write_ec_files on `dev`
    under `codec`:
    ({vid: sha256 of each shard, .ecc entries, .ecx sha256, base, .dat
    bytes}, {vid: launches per kernel}).  Each copy keeps its .ecx, .vif
    and shard 0 (for locating needles); the rest is removed."""
    from seaweedfs_tpu_torch.cluster import rpc
    from seaweedfs_tpu_torch.ec.encoder import (write_ec_files,
                                                write_sorted_file_from_idx)
    reference: dict = {}
    launches: dict = {}
    for vid in vids:
        for node in env.volume_locations(vid):
            env.vs_call(node, "/admin/readonly",
                        {"volume": vid, "readonly": True})
        holder = env.volume_locations(vid)[0]
        base = os.path.join(work, "ref", str(vid))
        os.makedirs(os.path.dirname(base), exist_ok=True)
        for ext in (".dat", ".idx"):
            rpc.call_to_file(f"http://{holder}/admin/volume_file?"
                             f"volume={vid}&ext={ext}", base + ext)
        write_sorted_file_from_idx(base)
        reset_counts()
        write_ec_files(base, device=dev, codec=codec)
        launches[vid] = {k: c["launches"] for k, c in read_counts().items()}
        reference[vid] = {
            "shards": {s: sha256_file(f"{base}.ec{s:02d}")
                       for s in range(14)},
            "ecc": ecc_entries(base + ".ecc"),
            "ecx": sha256_file(base + ".ecx"), "base": base,
            "dat_bytes": os.path.getsize(base + ".dat")}
        for path in [base + ".dat"] + [f"{base}.ec{s:02d}"
                                       for s in range(1, 14)]:
            os.remove(path)
    return reference, launches


def check_encoded_shards(env, dirs: dict, reference: dict,
                         ecc_required=()) -> tuple[dict, int]:
    """Every volume of `reference` must have its 14 shards on the
    servers' disks where the master says, each equal to the copy's, with
    the copy's .ecx; a .ecc entry present must be the copy's, and must be
    present for the volumes of `ecc_required` (a shard the per-volume
    flow copied has none until its first scrub).  Returns ({vid: {shard:
    node}}, .ecc entries checked)."""
    holders: dict = {}
    ecc_checked = 0
    for vid, ref in reference.items():
        files = shard_files(dirs, vid)
        check(sorted(files) == list(range(14)),
              f"volume {vid} shards on disk: {sorted(files)}")
        locs = env.ec_shard_locations(vid)
        for sid, (node, path) in files.items():
            check(locs.get(sid) == [node],
                  f"volume {vid} shard {sid}: master says {locs.get(sid)}"
                  f", disk {node}")
            check(sha256_file(path) == ref["shards"][sid],
                  f"volume {vid} shard {sid} differs from write_ec_files")
            entry_ = ecc_entries(path[:-5] + ".ecc").get(sid)
            check(entry_ in (None, ref["ecc"][sid]),
                  f"volume {vid} shard {sid}: .ecc entry differs")
            check(entry_ is not None or vid not in ecc_required,
                  f"volume {vid} shard {sid}: no .ecc entry after -batch")
            ecc_checked += entry_ is not None
            check(sha256_file(path[:-5] + ".ecx") == ref["ecx"],
                  f"volume {vid} .ecx differs")
        holders[vid] = {sid: node for sid, (node, _p) in files.items()}
    return holders, ecc_checked


def rebuild_launches(lost: dict, shard_bytes: dict,
                     budget: int = LIVE_REBUILD_BUDGET) -> int:
    """Launches `ec.rebuild -batch` makes on one card for RS volumes that
    lost the shards `lost[vid]`: one group per lost set; in each, volumes
    go whole, as many to a step as keep their survivors and rebuilt
    shards (rows x the widest) within `budget` bytes, and a volume that
    does not fit alone goes in column steps of budget // rows bytes,
    whole MiB (at least one)."""
    groups: dict = {}
    for vid in sorted(lost):
        groups.setdefault(tuple(lost[vid]), []).append(vid)
    n = 0
    for missing, group in groups.items():
        rows = 10 + len(missing)
        sizes = [shard_bytes[vid] for vid in group]
        i = 0
        while i < len(sizes):
            if sizes[i] * rows > budget and sizes[i] > MIB:
                n += column_steps(sizes[i], rows, budget)
                i += 1
                continue
            j, widest = i + 1, sizes[i]
            while j < len(sizes) and (j - i + 1) * rows * max(
                    widest, sizes[j]) <= budget:
                widest = max(widest, sizes[j])
                j += 1
            n += 1
            i = j
    return n


def fill_collection(murl: str, collection: str, blob, sizes, mark: float,
                    count: int) -> tuple[dict, dict, list, float]:
    """Upload needles (`sizes` yields (offset, size) into `blob`) to
    `collection` through WeedClient from LIVE_WRITERS threads until
    `count` of its volumes hold `mark` bytes each: ({fid: (offset,
    size)}, {vid: bytes}, the `count` volumes that passed, the wall)."""
    from seaweedfs_tpu_torch.cluster.client import WeedClient
    client = WeedClient(murl)
    fids: dict = {}  # fid -> (offset, size)
    per_vid: dict = {}
    lock = threading.Lock()
    stop = threading.Event()
    errors: list = []

    def writer():
        while not stop.is_set():
            with lock:
                off, size = next(sizes)
            try:
                fid = client.upload_data(bytes(blob[off:off + size]),
                                         collection=collection)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                stop.set()
                return
            vid = int(fid.split(",")[0])
            with lock:
                fids[fid] = (off, size)
                per_vid[vid] = per_vid.get(vid, 0) + size
                full = [v for v, n in per_vid.items() if n >= mark]
                if len(full) >= count:
                    stop.set()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=writer) for _ in range(LIVE_WRITERS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, f"uploads failed: {errors[:3]}")
    wall = time.perf_counter() - t0
    vids = sorted(v for v, n in per_vid.items() if n >= mark)[:count]
    check(len(vids) == count, f"volumes filled: {per_vid}")
    return fids, per_vid, vids, wall


def read_every_needle(masters: list[str], fids: dict, blob,
                      workers: int, lat: list | None = None) -> float:
    """Download every fid of `fids` ({fid: (offset, size)} into `blob`)
    through WeedClient from `workers` threads; fail on any error or
    differing byte.  Returns the wall; each download's seconds go to
    `lat` when given."""
    from seaweedfs_tpu_torch.cluster.client import WeedClient
    it = iter(sorted(fids.items()))
    lock = threading.Lock()
    errors: list = []

    def read_back():
        c = WeedClient(masters)
        while True:
            with lock:
                nxt = next(it, None)
            if nxt is None:
                return
            fid, (off, size) = nxt
            try:
                t0 = time.perf_counter()
                ok = c.download(fid) == blob[off:off + size]
                if lat is not None:
                    lat.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{fid}: {e!r}")
                return
            if not ok:
                errors.append(f"{fid}: bytes differ")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=read_back) for _ in range(workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, f"read-back failed: {errors[:3]}")
    return time.perf_counter() - t0


def phase_live_cluster(torch, dev, args) -> dict:
    """Phase 10: the port's master, LIVE_NODES volume servers and shell
    as `python -m seaweedfs_tpu_torch` processes on the card's host: write
    three volumes of one collection to LIVE_FULL_PERCENT of the limit,
    ec.encode one per volume (K2 in its holder) and two -batch (K2 with a
    volume axis here), kill -9 a holder, degraded reads (K1 in the volume
    servers), ec.rebuild -batch (K2 here), read everything back.  Every
    shard and .ecc entry is held against write_ec_files of a copy of its
    sealed .dat on `dev`, every launch counted: here by the wrappers, in
    the volume servers through /cluster/device, and reconciled with what
    each step must launch."""
    from seaweedfs_tpu_torch.cluster import rpc
    from seaweedfs_tpu_torch.cluster.client import WeedClient
    from seaweedfs_tpu_torch.core import types as t
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.stats import roofline

    t_phase = time.perf_counter()
    limit_mb = args.live_mib
    limit = limit_mb * MIB
    work = os.path.join(REPO, "_smoke_work", "live")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dev_flag = f"-device={dev.type}"
    procs: list = []
    env = None
    out: dict = {"reduced": {"volume_size_limit_mb": [30000, limit_mb],
                             "hosts": [LIVE_NODES, 1]},
                 "walls_s": {}, "gb_s": {}, "launches": {},
                 "device_busy_share": {}}
    try:
        mport = rpc.free_port()
        murl = f"http://127.0.0.1:{mport}"
        master = port_process(
            ["master", f"-port={mport}", f"-mdir={work}/master",
             f"-volumeSizeLimitMB={limit_mb}",
             f"-defaultReplication={LIVE_REPLICATION}"],
            os.path.join(work, "master.log"))
        procs.append(master)
        wait_for(lambda: rpc.call(murl + "/dir/status", timeout=2.0),
                 "the master", procs)
        dirs: dict = {}
        vs_procs: dict = {}
        for i in range(LIVE_NODES):
            port = rpc.free_port()
            node = f"127.0.0.1:{port}"
            dirs[node] = os.path.join(work, f"vs{i}")
            os.makedirs(dirs[node])
            vs_procs[node] = port_process(
                ["volume", dev_flag, f"-port={port}", f"-dir={dirs[node]}",
                 f"-max={LIVE_MAX_VOLUMES}", f"-mserver=127.0.0.1:{mport}",
                 "-dataCenter=dc1",
                 f"-rack=rack{i * LIVE_RACKS // LIVE_NODES}"],
                os.path.join(work, f"vs{i}.log"))
            procs.append(vs_procs[node])
        wait_for(lambda: len(rpc.call_status(
            murl + "/cluster/healthz", timeout=2.0)[1]["nodes"]) == LIVE_NODES,
            f"{LIVE_NODES} volume servers", procs)
        out["startup_s"] = time.perf_counter() - t_phase

        # -- write: three volumes of one collection past the fill mark ----
        rpc.call(f"{murl}/vol/grow?count={LIVE_VOLUMES}"
                 f"&collection={LIVE_COLLECTION}", "POST")
        blob, sizes = live_needles(args.seed, LIVE_BLOB_MIB * MIB)
        fids, per_vid, vids, wall = fill_collection(
            murl, LIVE_COLLECTION, blob, sizes,
            limit * LIVE_FULL_PERCENT / 100, LIVE_VOLUMES)
        written = sum(per_vid.values())
        out["walls_s"]["write"] = wall
        out["gb_s"]["write"] = written / wall / 1e9
        out["needles"] = len(fids)
        out["volumes"] = {str(v): per_vid[v] for v in vids}
        log(f"live: wrote {len(fids)} needles, {written / MIB:.0f} MiB in "
            f"{wall:.2f} s; volumes {vids}")

        # -- seal and copy each volume; the card's single-volume encode ---
        env = CommandEnv(murl, device=dev)
        reference, ref_k = encode_sealed_copies(env, vids, work, dev)
        # K2 on the card (fused CRC), K1 on the CPU (the CRC on the host).
        n_ref = {v: sum(ref_k[v].values()) for v in vids}
        check(all(n_ref.values()), f"reference encodes launched {ref_k}")
        vol_a, vol_b, vol_c = vids
        vs_nodes = list(vs_procs)
        rows0 = node_device_rows(murl, vs_nodes, 0.0, procs)

        # -- ec.encode -volumeId A: a shell process, K2 in the holder -----
        shell_log = os.path.join(work, "shell.log")
        t0 = time.perf_counter()
        shell = port_process(
            ["shell", dev_flag, f"-master=127.0.0.1:{mport}", "lock",
             f"ec.encode -volumeId {vol_a}"], shell_log)
        shell_rss = 0.0
        while shell.poll() is None:  # its RSS, sampled while it runs
            with contextlib.suppress(OSError, RuntimeError):
                shell_rss = max(shell_rss, rss_mib(shell.pid))
            check(time.perf_counter() - t0 < 600, "shell ec.encode hung")
            time.sleep(0.2)
        rc = shell.returncode
        wall = time.perf_counter() - t0
        with open(shell_log) as f:
            shell_out = f.read()
        check(rc == 0 and f"volume {vol_a} -> ec shards" in shell_out,
              f"shell ec.encode exited {rc}: {shell_out[-2000:]}")
        out["walls_s"]["encode_per_volume"] = wall
        out["gb_s"]["encode_per_volume"] = per_vid[vol_a] / wall / 1e9
        out["shell_rss_mib_max_sampled"] = shell_rss
        rows1 = node_device_rows(murl, vs_nodes, time.time(), procs)
        step = rows_delta(rows0, rows1)
        out["launches"]["encode_per_volume"] = {
            "volume_servers": vs_kernel_launches(step)}
        check(set(step) <= {"encode_crc_kernel", "encode_kernel"}
              and vs_kernel_launches(step) == ref_k[vol_a],
              f"per-volume encode rows {step}, expected {ref_k[vol_a]} "
              f"(write_ec_files of the same .dat here)")

        # -- ec.encode -volumeId B,C -batch: K2 with V = 2 here -----------
        run_command(env, "lock")
        reset_counts()
        rows_here = device_counts(roofline.LEDGER.heartbeat_view())
        t0 = time.perf_counter()
        msg = run_command(env, f"ec.encode -volumeId {vol_b},{vol_c} -batch "
                               f"-maxBatchMB {LIVE_BATCH_MB}")
        wall = time.perf_counter() - t0
        here = read_counts()
        rows_here2 = device_counts(roofline.LEDGER.heartbeat_view())
        for vid in (vol_b, vol_c):
            check(f"volume {vid} -> ec shards" in msg, f"batch encode: {msg}")
        out["walls_s"]["encode_batch"] = wall
        out["gb_s"]["encode_batch"] = \
            (per_vid[vol_b] + per_vid[vol_c]) / wall / 1e9
        # One step per chunk of the longer volume, V = 2 while both last.
        n_steps = sum(c["launches"] for c in here.values())
        n_axis = sum(c["volume_axis_launches"] for c in here.values())
        check(n_steps == max(n_ref[vol_b], n_ref[vol_c])
              and n_axis == min(n_ref[vol_b], n_ref[vol_c]),
              f"batched encode launches {here}, expected "
              f"{max(n_ref[vol_b], n_ref[vol_c])} with "
              f"{min(n_ref[vol_b], n_ref[vol_c])} at V = 2")
        check(rows_here2.get("batch_encode", 0)
              - rows_here.get("batch_encode", 0) == n_steps,
              "batch_encode ledger rows != launches")
        rows2 = node_device_rows(murl, vs_nodes, time.time(), procs)
        step = rows_delta(rows1, rows2)
        check(not step, f"volume servers launched during -batch: {step}")
        out["launches"]["encode_batch"] = {
            "shell": {"rs_bitmatrix": here["rs_bitmatrix"]["launches"],
                      "rs_bitmatrix_crc":
                          here["rs_bitmatrix_crc"]["launches"],
                      "volume_axis": n_axis},
            "volume_servers": vs_kernel_launches(step)}

        # -- every shard and .ecc entry against the card's encode ---------
        holders, ecc_checked = check_encoded_shards(
            env, dirs, reference, ecc_required=(vol_b, vol_c))
        out["shards_checked"] = 14 * len(vids)
        out["ecc_entries_checked"] = ecc_checked

        # -- kill -9 a holder of every volume ------------------------------
        def held(node):
            return {v: sorted(s for s, n in holders[v].items() if n == node)
                    for v in vids}
        victim = next((n for n in vs_nodes
                       if all(1 <= len(s) <= 3 for s in held(n).values())),
                      None)
        check(victim is not None, f"no node holds 1-3 shards of each volume: "
              f"{ {n: held(n) for n in vs_nodes} }")
        lost = held(victim)
        out["killed"] = {"node": victim, "shards": {str(v): s
                                                    for v, s in lost.items()}}
        lost_sha = {(v, s): reference[v]["shards"][s]
                    for v, ss in lost.items() for s in ss}
        mem = {victim: rss_mib(vs_procs[victim].pid)}
        t_kill = time.time()
        rows_kill = node_device_rows(murl, vs_nodes, t_kill, procs)
        vs_procs[victim].kill()
        vs_procs[victim].wait(30)
        procs.remove(vs_procs[victim])
        live = [n for n in vs_nodes if n != victim]

        # -- degraded reads of a seeded sample through the client ---------
        rng = np.random.default_rng(args.seed + 10)
        in_vols = sorted(f for f in fids if int(f.split(",")[0]) in vids)
        sample = [in_vols[i] for i in rng.choice(len(in_vols), LIVE_READS,
                                                 replace=False)]
        evs = {v: EcVolume(reference[v]["base"], vid=v, device=dev)
               for v in vids}
        expect_k1 = 0
        for fid in sample:
            vid, key, _cookie = t.parse_file_id(fid)
            ev = evs[vid]
            _o, _s, intervals = ev.locate_needle(key)
            expect_k1 += sum(
                iv.to_shard_id_and_offset(ev.large_block_size,
                                          ev.small_block_size)[0]
                in lost[vid] for iv in intervals)
        for ev in evs.values():
            ev.close()
        lat = []
        reader = WeedClient(murl)
        for fid in sample:
            off, size = fids[fid]
            t0 = time.perf_counter()
            data = reader.download(fid)
            lat.append(time.perf_counter() - t0)
            check(data == blob[off:off + size], f"degraded read {fid} wrong")
        out["degraded_read_ms"] = {"p50": pct_ms(lat, 50),
                                   "p99": pct_ms(lat, 99),
                                   "reads": len(lat),
                                   "intervals_reconstructed": expect_k1}
        out["walls_s"]["degraded_reads"] = sum(lat)
        rows3 = node_device_rows(murl, live, time.time(), procs)
        step = rows_delta({n: rows_kill[n] for n in live}, rows3)
        out["launches"]["degraded_reads"] = {
            "volume_servers": vs_kernel_launches(step)}
        check(step == ({"reconstruct_kernel": expect_k1} if expect_k1
                       else {}),
              f"degraded reads launched {step}, the layout needs "
              f"{expect_k1} K1 10->1")
        check(expect_k1 > 0, "no sampled read crossed a lost shard")

        # -- ec.rebuild -batch once the master has dropped the node -------
        wait_for(lambda: victim not in {
            n["url"] for n in env.data_nodes()}, "the dead-node sweep",
            procs, timeout=120.0)
        flows0 = {n: inbound_flows(n) for n in live}
        reset_counts()
        rows_here = device_counts(roofline.LEDGER.heartbeat_view())
        t0 = time.perf_counter()
        msg = run_command(env, f"ec.rebuild -batch -maxBatchMB "
                               f"{LIVE_REBUILD_BUDGET >> 20}")
        wall = time.perf_counter() - t0
        here = read_counts()
        rows_here2 = device_counts(roofline.LEDGER.heartbeat_view())
        for vid in vids:
            check(f"volume {vid}: rebuilt shards {lost[vid]}" in msg,
                  f"rebuild: {msg}")
        out["walls_s"]["rebuild_batch"] = wall
        rebuilt_bytes = sum(os.path.getsize(f"{reference[v]['base']}.ec00")
                            * len(lost[v]) for v in vids)
        out["gb_s"]["rebuild_batch"] = rebuilt_bytes / wall / 1e9
        n_steps = sum(c["launches"] for c in here.values())
        want = rebuild_launches(lost, {
            v: os.path.getsize(f"{reference[v]['base']}.ec00") for v in vids},
            LIVE_REBUILD_BUDGET)
        check(n_steps == want, f"rebuild launches {here}, expected {want}")
        check(rows_here2.get("batch_reconstruct", 0)
              - rows_here.get("batch_reconstruct", 0) == n_steps,
              "batch_reconstruct ledger rows != launches")
        placed = {}
        for vid in vids:
            files = shard_files({n: dirs[n] for n in live}, vid)
            check(sorted(files) == list(range(14)),
                  f"volume {vid} after rebuild: {sorted(files)}")
            for sid in lost[vid]:
                check(sha256_file(files[sid][1]) == lost_sha[(vid, sid)],
                      f"rebuilt shard {vid}.{sid} differs from its original")
                placed[(vid, sid)] = files[sid][0]
        # Each split volume's rebuilt shards arrive in as many pieces
        # as it had column steps, read from the targets' own flow rows.
        out["rebuild_pieces"] = rebuild_pieces(
            lost, {v: os.path.getsize(f"{reference[v]['base']}.ec00")
                   for v in vids}, placed, flows0,
            {n: inbound_flows(n) for n in live}, LIVE_REBUILD_BUDGET)
        log(f"live: rebuild pieces per target "
            f"{json.dumps(out['rebuild_pieces'])}")
        rows4 = node_device_rows(murl, live, time.time(), procs)
        step = rows_delta(rows3, rows4)
        out["launches"]["rebuild_batch"] = {
            "shell": {"rs_bitmatrix": here["rs_bitmatrix"]["launches"],
                      "rs_bitmatrix_crc":
                          here["rs_bitmatrix_crc"]["launches"]},
            "volume_servers": vs_kernel_launches(step)}

        # -- every needle back, byte for byte -----------------------------
        wall = read_every_needle([murl], fids, blob, LIVE_WRITERS)
        out["walls_s"]["read_back"] = wall
        out["gb_s"]["read_back"] = written / wall / 1e9
        rows5 = node_device_rows(murl, live, time.time(), procs)
        out["launches"]["read_back"] = {
            "volume_servers": vs_kernel_launches(rows_delta(rows4, rows5))}

        # -- every process's memory, then the totals ----------------------
        mem["master"] = rss_mib(master.pid)
        for n in live:
            mem[n] = rss_mib(vs_procs[n].pid)
        mem["chip_smoke"] = rss_mib(os.getpid())
        out["rss_mib"] = mem
        totals = {"rs_bitmatrix": 0, "rs_bitmatrix_crc": 0}
        for s in out["launches"].values():
            for side in s.values():
                for k in totals:
                    totals[k] += side.get(k, 0)
        out["launch_totals"] = totals
        check(all(totals.values()), f"phase 10 launches {totals}")

        out["lrc"] = lrc_pass(dev, args, env, murl, mport,
                              {n: dirs[n] for n in live}, procs, work)
    finally:
        if env is not None:
            env.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"live cluster: {json.dumps(out['walls_s'])}")
    return out


def node_steps(before: dict, after: dict) -> dict:
    """Per volume server that launched anything between two
    node_device_rows(..., geometry_counts) reads, its launches per kernel
    and instantiation."""
    out = {}
    for node in after:
        step = rows_delta({node: before.get(node, {})},
                          {node: after[node]})
        if step:
            out[node] = by_instantiation(step)
    return out


def lrc_pass(dev, args, env, murl: str, mport: int, dirs: dict, procs,
             work: str) -> dict:
    """Phase 10's LRC(10,2,2) pass, in the master and surviving volume
    servers (`dirs`: node -> directory) after the RS steps, with launch
    windows of its own: the reference's acceptance flow
    (tests/test_codecs.py test_cluster_lrc_acceptance) at phase 10's
    limit.  One volume of LRC_COLLECTION filled past LIVE_FULL_PERCENT
    of LRC_FILL_MIB; `lock; ec.encode -volumeId V -codec lrc` through a
    shell process (K2 10->4 in the holder), every shard, .ecx and .ecc
    entry held against
    write_ec_files(codec="lrc") of its sealed copy; then each loss of
    LRC_LOSSES: the shards deleted on their holders, reads through the
    client (every needle after the first loss, LIVE_READS after the
    second; K1 in the volume servers for each interval on a lost shard,
    5->1 from its local group where the group can solve it), `ec.rebuild
    -volumeId V -batch` here, every rebuilt shard and .ecc entry equal
    to the original's.  The single-shard rebuild must read 5 shards,
    exactly 5 x the shard size in SeaweedFS_ec_repair_read_bytes_total
    {codec="lrc"}, and say so."""
    from seaweedfs_tpu_torch.cluster import rpc
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.shell import run_command
    from seaweedfs_tpu_torch.stats.metrics import ec_repair_read_bytes_total

    t_pass = time.perf_counter()
    live = list(dirs)
    out: dict = {"reduced": {"volume_size_limit_mb": [30000, args.live_mib]},
                 "walls_s": {}, "gb_s": {}, "degraded_read_ms": {},
                 "launches": {}, "repair_read_bytes": {}}
    # The encoding shell process starts now and is held once imported
    # (HELD_SHELL), so that its start overlaps the writes.
    trigger = os.path.join(work, "shell_lrc.go")
    shell_log = os.path.join(work, "shell_lrc.log")
    shell = port_process(
        [trigger, "shell", f"-device={dev.type}",
         f"-master=127.0.0.1:{mport}"], shell_log,
        port_launch(dev, HELD_SHELL))
    evs: dict = {}
    try:
        # -- 1. one volume of a collection of its own past the fill mark --
        rpc.call(f"{murl}/vol/grow?count=1&collection={LRC_COLLECTION}",
                 "POST")
        blob, sizes = live_needles(args.seed + LRC_SEED,
                                   LIVE_BLOB_MIB * MIB)
        fill_mib = min(args.live_mib, LRC_FILL_MIB)
        if fill_mib < args.live_mib:
            out["reduced"]["lrc_volume_mib"] = [args.live_mib, fill_mib]
        fids, per_vid, (vid,), wall = fill_collection(
            murl, LRC_COLLECTION, blob, sizes,
            fill_mib * MIB * LIVE_FULL_PERCENT / 100, 1)
        fids = {f: v for f, v in fids.items()
                if int(f.split(",")[0]) == vid}
        out["walls_s"]["write"] = wall
        out["gb_s"]["write"] = sum(per_vid.values()) / wall / 1e9
        out["volume"] = {"id": vid, "bytes": per_vid[vid],
                         "needles": len(fids)}

        # -- 2. ec.encode -codec lrc in a shell process: K2 in the holder -
        reference, ref_k = encode_sealed_copies(env, [vid], work, dev,
                                                codec="lrc")
        ref = reference[vid]
        rows0 = node_device_rows(murl, live, 0.0, procs,
                                 geometry_counts)
        # The admin lock is the shell process's while it encodes.
        run_command(env, "unlock")
        wait_for(lambda: os.path.exists(trigger + ".ready"),
                 "the shell process's imports", procs + [shell])
        with open(trigger + ".tmp", "w") as f:
            f.write(f"lock\nec.encode -volumeId {vid} -codec lrc\n")
        t0 = time.perf_counter()
        os.replace(trigger + ".tmp", trigger)
        try:
            rc = shell.wait(600)
        except subprocess.TimeoutExpired:
            shell.kill()
            shell.wait()
            check(False, "shell ec.encode -codec lrc hung")
        wall = time.perf_counter() - t0
        with open(shell_log) as f:
            shell_out = f.read()
        check(rc == 0 and f"volume {vid} -> ec shards" in shell_out,
              f"shell ec.encode -codec lrc exited {rc}: "
              f"{shell_out[-2000:]}")
        # From the held shell's release: its imports ran beside the writes.
        out["walls_s"]["encode"] = wall
        out["gb_s"]["encode"] = per_vid[vid] / wall / 1e9
        lookup = rpc.call(f"{murl}/dir/lookup?volumeId={vid}")
        check(lookup.get("ecCodec") == "lrc"
              and env.ec_codec(vid) == "lrc",
              f"volume {vid}'s codec: the master's lookup says "
              f"{lookup.get('ecCodec')!r}, the shell {env.ec_codec(vid)!r}")
        rows1 = node_device_rows(murl, live, time.time(), procs,
                                 geometry_counts)
        nodes = node_steps(rows0, rows1)
        step = by_instantiation(rows_delta(rows0, rows1))
        out["launches"]["encode"] = {"volume_servers": nodes,
                                     "write_ec_files_here": ref_k[vid]}
        check({k: sum(v.values()) for k, v in step.items()} == ref_k[vid]
              and len(nodes) == 1,
              f"LRC encode launched {nodes}, expected {ref_k[vid]} in the "
              f"holder (write_ec_files of the same .dat here)")
        _holders, ecc_checked = check_encoded_shards(env, dirs, reference)
        run_command(env, "lock")
        out["shards_checked"] = 14
        out["ecc_entries_checked"] = ecc_checked

        # -- 3-5. each loss: delete, read through the client, rebuild -----
        evs = {vid: EcVolume(ref["base"], vid=vid, device=dev)}
        shard_bytes = os.path.getsize(ref["base"] + ".ec00")
        rng = np.random.default_rng(args.seed + LRC_SEED)
        earlier: list = []
        rows_a = rows1
        for i, lost in enumerate(LRC_LOSSES):
            name = "lost_" + "_".join(map(str, lost))
            locs = env.ec_shard_locations(vid)
            for sid in lost:
                for url in locs[sid]:
                    rpc.call_json(f"http://{url}/admin/ec/delete_shards",
                                  "POST", {"volume": vid, "shards": [sid]})
            wait_for(lambda: not set(lost)
                     & set(env.ec_shard_locations(vid)),
                     f"the master to drop shards {lost}", procs)
            if i == 0:
                read = dict(fids)
            elif i == 1:
                ordered = sorted(fids)
                n_reads = min(LIVE_READS, len(ordered))
                if n_reads < LIVE_READS:
                    out["reduced"]["lrc_reads_after_second_loss"] = \
                        [LIVE_READS, n_reads]
                read = {ordered[j]: fids[ordered[j]] for j in
                        rng.choice(len(ordered), n_reads, replace=False)}
            else:
                read = {}
            if read:
                lat: list = []
                wall = read_every_needle([murl], read, blob, LIVE_WRITERS,
                                         lat)
                out["walls_s"][f"read_{name}"] = wall
                out["gb_s"][f"read_{name}"] = \
                    sum(size for _o, size in read.values()) / wall / 1e9
                out["degraded_read_ms"][name] = {
                    "p50": pct_ms(lat, 50), "p99": pct_ms(lat, 99),
                    "reads": len(lat)}
                # The window opens where the last one closed: the last
                # rebuild ran here, so the volume servers launch only
                # for these reads.
                rows_b = node_device_rows(murl, live, time.time(), procs,
                                          geometry_counts)
                nodes = node_steps(rows_a, rows_b)
                recorded = set(rows_delta(rows_a, rows_b))
                rows_a = rows_b
                k1 = sum(sum(n["rs_bitmatrix"].values())
                         for n in nodes.values())
                # Each lost interval read is rebuilt at least once; a
                # reader whose cached shard map predates the last rebuild
                # may rebuild an interval of an earlier loss too.
                need = lost_intervals(evs, {vid: list(lost)}, read)
                need_all = lost_intervals(evs, {vid: list(lost) + earlier},
                                          read)
                out["launches"][f"read_{name}"] = {
                    "volume_servers": nodes, "lost_intervals_read": need,
                    "lost_intervals_with_earlier_losses": need_all}
                check(all(k.startswith("reconstruct_kernel ")
                          for k in recorded),
                      f"reads after losing {lost} recorded {recorded}")
                check(need <= k1 <= need_all and need > 0,
                      f"reads after losing {lost}: {k1} K1 in the volume "
                      f"servers for {need} lost intervals read "
                      f"({need_all} with the earlier losses)")
                if i == 0:
                    local = sum(n["rs_bitmatrix"].get("generic<=16", 0)
                                for n in nodes.values())
                    out["k1_generic16_in_volume_servers"] = local
                    check(local > 0, "K1 generic<=16 (the local 5->1 "
                                     f"solve) never launched: {nodes}")
            reset_counts()
            before = ec_repair_read_bytes_total.value(codec="lrc")
            t0 = time.perf_counter()
            msg = run_command(env, f"ec.rebuild -volumeId {vid} -batch")
            wall = time.perf_counter() - t0
            here = read_counts()
            got = ec_repair_read_bytes_total.value(codec="lrc") - before
            check(f"volume {vid}: rebuilt shards {list(lost)}" in msg,
                  f"ec.rebuild after losing {lost}: {msg}")
            out["walls_s"][f"rebuild_{name}"] = wall
            out["gb_s"][f"rebuild_{name}"] = \
                shard_bytes * len(lost) / wall / 1e9
            out["repair_read_bytes"][name] = got
            n_steps = sum(c["launches"] for c in here.values())
            check(n_steps == 1, f"ec.rebuild of one volume launched {here}")
            wait_for(lambda: sorted(env.ec_shard_locations(vid))
                     == list(range(14)), "the master to list 14 shards",
                     procs)
            files = shard_files(dirs, vid)
            check(sorted(files) == list(range(14)),
                  f"volume {vid} after the rebuild: {sorted(files)}")
            for sid in lost:
                path = files[sid][1]
                check(sha256_file(path) == ref["shards"][sid],
                      f"rebuilt shard {vid}.{sid} differs from its original")
                check(ecc_entries(path[:-5] + ".ecc").get(sid)
                      == ref["ecc"][sid],
                      f"rebuilt shard {vid}.{sid}: .ecc entry differs")
            out["launches"][f"rebuild_{name}"] = {
                "shell": {k: c["by_instantiation"] for k, c in here.items()}}
            if len(lost) == 1:
                check("read 5 shards vs 10 for RS" in msg,
                      f"single-shard rebuild: {msg}")
                check(got == 5 * shard_bytes,
                      f"single-shard rebuild read {got} bytes, not 5 x "
                      f"{shard_bytes}")
            earlier += list(lost)
    finally:
        for ev in evs.values():
            ev.close()
        if shell.poll() is None:
            shell.kill()
            shell.wait()
    totals = {"rs_bitmatrix": 0, "rs_bitmatrix_crc": 0}
    for s in out["launches"].values():
        sides = list(s.get("volume_servers", {}).values())
        sides += [s["shell"]] if "shell" in s else []
        for side in sides:
            for k in totals:
                totals[k] += sum(side.get(k, {}).values())
    out["launch_totals"] = totals
    out["wall_s"] = time.perf_counter() - t_pass
    log(f"live cluster, LRC: {json.dumps(out['walls_s'])}")
    return out


def busy_share(timings: dict, walls: dict, steps: dict) -> dict:
    """Device busy share per step: launches x the kernel table's ms at
    the step's shape (an upper bound where the step's shapes are
    smaller) over the step's wall.  `steps` maps a step to (kernel,
    launches, shape): the shape names a row of the kernel's table by
    its prefix, None its headline shape."""
    def ms(kernel, shape):
        rows = timings[kernel]
        return rows["ms"] if shape is None else next(
            v["ms"] for k, v in rows.items() if k.startswith(shape))
    return {step: n * ms(kernel, shape) / 1e3 / walls[step]
            for step, (kernel, n, shape) in steps.items()}


# -- phase 11: an HA cluster, its mirror and the autopilot on the card -------


# A `weed` command held until a file appears: its first argument names
# the file, the rest are the command line.  Once its imports are done it
# creates that name + ".ready".
HELD = (
    "import os, time\n"
    "import seaweedfs_tpu_torch.command\n"
    "open(sys.argv[1] + '.ready', 'w').close()\n"
    "while not os.path.exists(sys.argv[1]):\n"
    "    time.sleep(0.01)\n"
    "del sys.argv[1]\n")


# A `weed shell` held as HELD holds a command, with the shell's modules
# (and torch) imported; the file that releases it holds the shell
# commands to run, one per line.
HELD_SHELL = (
    "import os, time\n"
    "import seaweedfs_tpu_torch.shell\n"
    "open(sys.argv[1] + '.ready', 'w').close()\n"
    "while not os.path.exists(sys.argv[1]):\n"
    "    time.sleep(0.01)\n"
    "sys.argv += open(sys.argv[1]).read().splitlines()\n"
    "del sys.argv[1]\n")


# A thread in each master that wakes every 10 ms and prints, with the
# wall clock, each wake-up later than STALL_S: how long the process's
# Python threads (raft's appends, the beats' handlers, the sweep) could
# not run, for want of the interpreter lock or of a core.
STALL_S = 0.2
STALL_MONITOR = (
    "import threading, time\n"
    "def _stall_monitor():\n"
    "    prev = time.monotonic()\n"
    "    while True:\n"
    "        time.sleep(0.01)\n"
    "        now = time.monotonic()\n"
    f"        if now - prev - 0.01 > {STALL_S}:\n"
    "            print(f'STALL {time.time():.3f} {now - prev - 0.01:.3f}',\n"
    "                  flush=True)\n"
    "        prev = now\n"
    "threading.Thread(target=_stall_monitor, daemon=True).start()\n")


def master_stalls(logs: dict, origin: float) -> dict:
    """{master url: [[wall clock - `origin` s, stall s], ...]} from the
    STALL lines of each master's log (`logs`: url -> path); a stall
    ends at its time."""
    out = {}
    for url, path in logs.items():
        with open(path, errors="replace") as f:
            rows = [line.split()[1:3] for line in f
                    if line.startswith("STALL ")]
        out[url] = [[round(float(t) - origin, 3), float(s)]
                    for t, s in rows]
    return out


def port_launch(dev, before_run: str = "") -> str:
    """The launch snippet of phase 11's processes: MASTER_LAUNCH with
    `before_run` (such as HELD) ahead of the run, and, when the phase
    rehearses on the CPU, a CPU default for the batch mesh, which the
    leader's repair daemon builds with make_mesh() (every visible card,
    raising without one)."""
    if dev.type != "cuda":
        before_run = (
            "import torch\n"
            "from seaweedfs_tpu_torch.parallel import cluster_rebuild as _cr\n"
            "_mk = _cr.make_mesh\n"
            "_cr.make_mesh = lambda devices=None: _mk(\n"
            "    devices or [torch.device('cpu')])\n") + before_run
    return MASTER_LAUNCH.replace("runpy.run_module",
                                 before_run + "runpy.run_module", 1)


def master_roles(urls: list[str]) -> dict:
    """{master url: /cluster/status} of every master that answers."""
    from seaweedfs_tpu_torch.cluster import rpc
    out = {}
    for u in urls:
        with contextlib.suppress(OSError, rpc.RpcError):
            out[u] = rpc.call(u + "/cluster/status", timeout=2.0)
    return out


def the_leader(urls: list[str]) -> str | None:
    """The one master of `urls` that says it leads, else None."""
    roles = master_roles(urls)
    leaders = [u for u, st in roles.items() if st.get("is_leader")]
    return leaders[0] if len(leaders) == 1 else None


def run_port(args: list[str], log_path: str, launch: str, procs,
             timeout: float = 600.0,
             stall: float | None = None) -> tuple[str, float, float]:
    """A short-lived `python -m seaweedfs_tpu_torch` process (shell,
    backup, fix, export, benchmark) run to its end: its output, wall
    and RSS sampled while it runs.  Fails on a non-zero exit.  With
    `stall`, a process still running after that many seconds has its
    and every cluster process's stacks printed once (`dump_stacks`)."""
    t0 = time.perf_counter()
    p = port_process(args, log_path, launch)
    rss = 0.0
    try:
        while p.poll() is None:
            with contextlib.suppress(OSError, RuntimeError):
                rss = max(rss, rss_mib(p.pid))
            for q in procs:
                check(q.poll() is None, f"{args[0]}: a cluster process "
                                        f"exited ({q.args[3:6]})")
            check(time.perf_counter() - t0 < timeout,
                  f"{' '.join(args[:3])} hung")
            if stall is not None and time.perf_counter() - t0 > stall:
                dump_stacks([p, *procs],
                            f"{args[0]} still running after {stall} s")
                stall = None
            time.sleep(0.1)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    check(p.returncode == 0,
          f"{' '.join(args[:3])} exited {p.returncode}: {text[-2000:]}")
    return text, wall, rss


def needle_set(dat_path: str) -> dict:
    """{needle id: (cookie, size, crc)} of the live needles of a .dat,
    in append order (the newest record per id wins, a tombstone erases)."""
    from seaweedfs_tpu_torch.storage.volume_scanner import scan_volume_file
    live: dict = {}
    for n, _off, _total in scan_volume_file(dat_path):
        if n.size <= 0:
            live.pop(n.id, None)
        else:
            live[n.id] = (n.cookie, n.size, n.checksum)
    return live


def served_needles(directory: str, vid: int) -> dict:
    """{needle id: (cookie, size, crc)} of what a backup copy serves:
    the copy mounted as a volume, every needle its .idx names read."""
    from seaweedfs_tpu_torch.storage.volume import Volume
    v = Volume(directory, "", vid, create=False, use_worker=False)
    try:
        keys: list = []
        v.nm.ascending_visit(lambda e: keys.append(e.key)
                             if e.size > 0 else None)
        out = {}
        for k in keys:
            n = v.read_needle(k)
            out[k] = (n.cookie, n.size, n.checksum)
        return out
    finally:
        v.close()


def first_difference(a: str, b: str) -> int | None:
    """The first byte offset where two files differ (the shorter one's
    length if one is a prefix of the other), None if they are equal."""
    block = 1 << 20
    with open(a, "rb") as fa, open(b, "rb") as fb:
        off = 0
        while True:
            x, y = fa.read(block), fb.read(block)
            if x != y:
                n = min(len(x), len(y))
                i = next((i for i in range(n) if x[i] != y[i]), n)
                return off + i
            if not x:
                return None
            off += len(x)


def crc_map(murl: str, fids, workers: int = 8) -> dict:
    """`volume.fsck -crc -json`'s node-address-free `volumes` map (vid ->
    fid -> sorted distinct replica CRCs) for the file ids written, from
    the same HEAD X-Needle-Checksum on every replica the master names."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.shell.command_volume import VolumeFsck
    env = CommandEnv(murl, device="cpu")
    try:
        locs = {v: env.volume_locations(v)
                for v in {int(f.split(",")[0]) for f in fids}}
    finally:
        env.close()

    def one(fid):
        vid = int(fid.split(",")[0])
        return vid, fid, sorted({VolumeFsck._head_checksum(u, fid)
                                 for u in locs[vid]})

    vols: dict = {}
    with ThreadPoolExecutor(workers) as pool:
        for vid, fid, crcs in pool.map(one, sorted(fids)):
            vols.setdefault(str(vid), {})[fid] = crcs
    return {v: dict(sorted(f.items())) for v, f in sorted(vols.items())}


def ecc_union(dirs: dict, vid: int) -> dict:
    """{shard id: entry} over every `.ecc` of `vid` in `dirs`; a shard
    with two different entries fails."""
    import glob
    out: dict = {}
    for d in dirs.values():
        for path in glob.glob(os.path.join(d, f"*{vid}.ecc")):
            if os.path.basename(path)[:-4].split("_")[-1] != str(vid):
                continue
            for sid, entry_ in ecc_entries(path).items():
                check(out.get(sid, entry_) == entry_,
                      f"volume {vid} shard {sid}: two .ecc entries")
                out[sid] = entry_
    return out


def hash_shards(files: dict) -> dict:
    """{shard id: sha256} of shard_files()' paths, hashed in threads."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        got = pool.map(lambda kv: (kv[0], sha256_file(kv[1][1])),
                       files.items())
        return dict(got)


def bench_report(text: str) -> dict:
    """`weed benchmark`'s write and read blocks as numbers."""
    out: dict = {}
    title = None
    for line in text.splitlines():
        if line.startswith("--- "):
            title = "write" if line[4:].startswith("write") else "read"
            out[title] = {}
        elif title and line.startswith("requests"):
            parts = line.split()
            out[title]["requests"] = int(parts[1])
            out[title]["errors"] = int(parts[3].rstrip(")"))
        elif title and line.startswith("throughput"):
            out[title]["req_per_s"] = float(line.split()[1])
        elif title and line.startswith("latency ms"):
            w = line.split()
            out[title]["latency_ms"] = {w[i]: float(w[i + 1])
                                        for i in range(2, len(w) - 1, 2)}
    return out


def phase_ha_cluster(torch, dev, args) -> dict:
    """Phase 11: a primary of three raft masters (-peers, -repair) and
    HA_NODES volume servers mirroring into a standby cluster, every role
    a `python -m seaweedfs_tpu_torch` process on the card's host.  The
    raft leader is killed while a collection's volume fills; `weed
    backup` copies it (full, then incremental) and `weed fix`/`export`
    read the copy; the standby converges to the same CRC map; both
    clusters `ec.encode` the volume (K2 in each holder); a holder is
    killed, 300 degraded reads run (K1 in the survivors) and the new
    leader's repair daemon rebuilds the lost shards (K2 in the leader);
    every needle reads back; the shell's cluster verbs run on the
    leader, and `weed benchmark` against it.  The output carries the
    raft term after each step that asks for /cluster/device, each
    master's stalls (STALL_MONITOR) and, after the repair, what each
    master says of the volume (`ha_diagnosis`, which a failed read or
    repair poll prints)."""
    from seaweedfs_tpu_torch.cluster import resilience, rpc
    from seaweedfs_tpu_torch.cluster.client import WeedClient
    from seaweedfs_tpu_torch.core import types as t
    from seaweedfs_tpu_torch.ec.encoder import (write_ec_files,
                                                write_sorted_file_from_idx)
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    t_phase = time.perf_counter()
    limit_mb = args.ha_mib
    limit = limit_mb * MIB
    work = os.path.join(REPO, "_smoke_work", "ha")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launch = port_launch(dev)
    dev_flag = f"-device={dev.type}"
    procs: list = []
    extras: list = []  # processes that end on their own
    envs: list = []
    # The filler is a change to the layout, not a cut of scale: the
    # failover's client errors count the writers' 406s while no slot is
    # free, and depend on it.
    out: dict = {"reduced": {"volume_size_limit_mb": [30000, limit_mb],
                             "hosts": [HA_MASTERS + HA_NODES + 1
                                       + HA_STANDBY_NODES, 1],
                             "benchmark_n": [1048576, HA_BENCH_N],
                             "free_slots_during_write": [
                                 HA_NODES * HA_MAX_VOLUMES - 1, 0]},
                 "walls_s": {}, "gb_s": {}, "launches": {}, "rss_mib": {}}

    def start(args_, name):
        p = port_process(args_, os.path.join(work, f"{name}.log"), launch)
        procs.append(p)
        return p

    def env_for(murl):
        e = CommandEnv(murl, device=dev)
        envs.append(e)
        return e

    try:
        # -- the standby: one master and two volume servers ---------------
        sport = rpc.free_port()
        surl = f"http://127.0.0.1:{sport}"
        sb_master = start(["master", f"-port={sport}",
                           f"-mdir={work}/standby",
                           f"-volumeSizeLimitMB={limit_mb}",
                           f"-defaultReplication={HA_REPLICATION}"],
                          "standby")
        sb_dirs: dict = {}
        sb_procs: dict = {}
        for i in range(HA_STANDBY_NODES):
            port = rpc.free_port()
            node = f"127.0.0.1:{port}"
            sb_dirs[node] = os.path.join(work, f"sb{i}")
            os.makedirs(sb_dirs[node])
            sb_procs[node] = start(
                ["volume", dev_flag, f"-port={port}", f"-dir={sb_dirs[node]}",
                 f"-max={HA_MAX_VOLUMES}", f"-mserver=127.0.0.1:{sport}"],
                f"sb{i}")
        # -- the primary: three raft masters, HA_NODES volume servers -----
        mports = [rpc.free_port() for _ in range(HA_MASTERS)]
        murls = [f"http://127.0.0.1:{p}" for p in mports]
        peers = ",".join(f"127.0.0.1:{p}" for p in mports)
        m_procs: dict = {}
        m_launch = port_launch(dev, STALL_MONITOR)
        for i, port in enumerate(mports):
            m_procs[murls[i]] = p = port_process(
                ["master", f"-port={port}", f"-mdir={work}/m{i}",
                 f"-peers={peers}", f"-volumeSizeLimitMB={limit_mb}",
                 f"-defaultReplication={HA_REPLICATION}", "-repair",
                 f"-repair.delay={HA_REPAIR_DELAY_S}"],
                os.path.join(work, f"m{i}.log"), m_launch)
            procs.append(p)
        m_logs = {u: p.log_path for u, p in m_procs.items()}
        dirs: dict = {}
        vs_procs: dict = {}
        for i in range(HA_NODES):
            port = rpc.free_port()
            node = f"127.0.0.1:{port}"
            dirs[node] = os.path.join(work, f"vs{i}")
            os.makedirs(dirs[node])
            vs_procs[node] = start(
                ["volume", dev_flag, f"-port={port}", f"-dir={dirs[node]}",
                 f"-max={HA_MAX_VOLUMES}", "-dataCenter=dc1",
                 f"-rack=rack{i * HA_RACKS // HA_NODES}",
                 f"-mserver={peers}", f"-replicate.peer=127.0.0.1:{sport}"],
                f"vs{i}")
        leader = wait_for(lambda: the_leader(murls), "a raft leader", procs)
        term_start = master_roles([leader])[leader]["raft"]["term"]
        wait_for(lambda: len(rpc.call_status(
            leader + "/cluster/healthz", timeout=2.0)[1]["nodes"])
            == HA_NODES, f"{HA_NODES} volume servers at the leader", procs)
        wait_for(lambda: len(rpc.call_status(
            surl + "/cluster/healthz", timeout=2.0)[1]["nodes"])
            == HA_STANDBY_NODES, "the standby's volume servers", procs)
        out["startup_s"] = time.perf_counter() - t_phase
        vs_nodes = list(vs_procs)
        sb_nodes = list(sb_procs)

        # -- write with a leader kill ---------------------------------------
        rpc.call(f"{leader}/vol/grow?count=1&collection={HA_COLLECTION}",
                 "POST")
        client = WeedClient(list(murls))
        probe = client.assign(collection=HA_COLLECTION)
        vid = int(probe["fid"].split(",")[0])
        holder = probe["url"]
        # The shipper enables a volume's change log on its next tick: no
        # write may land before it (it would have nothing to ship).
        wait_for(lambda: str(vid) in (rpc.call(
            f"http://{holder}/debug/replication", timeout=2.0).get("rlog")
            or {}), "the volume's change log", procs)
        # Every other slot holds an empty volume of another collection
        # while the volume fills: a leader elected before the volume
        # servers' next beats knows no volume of the collection (as
        # upstream's does), and with no slot free it cannot grow one
        # elsewhere, so the writers wait out the failover (406, retried)
        # and every write lands in the one volume.
        slots = HA_NODES * HA_MAX_VOLUMES - 1
        filled = rpc.call(f"{leader}/vol/grow?count={slots}"
                          f"&collection={HA_FILLER}", "POST")["count"]
        check(filled == slots, f"filled {filled} of {slots} free slots")
        rows0 = node_device_rows(leader, vs_nodes, 0.0, procs)
        # The highest raft term after each step that asks the leader for
        # /cluster/device (its first loads the master's device stack): a
        # term that moves there is an election the step caused.
        terms = {"startup": term_start}

        def term_now(step: str) -> None:
            terms[step] = max(st["raft"]["term"]
                              for st in master_roles(murls).values())
        term_now("first_device_rows")
        blob, sizes = live_needles(args.seed + 11, LIVE_BLOB_MIB * MIB)
        fids: dict = {}  # fid -> (offset, size)
        lock = threading.Lock()
        stop = threading.Event()
        target = [0]  # bytes acked into `vid`
        failures: list = []
        client_errors: list = []
        retries0 = sum(resilience.rpc_retries_total.value(reason=r)
                       for r in ("connect", "shed", "status", "io"))

        def writer():
            while not stop.is_set():
                with lock:
                    off, size = next(sizes)
                deadline = time.monotonic() + 120
                while True:
                    try:
                        fid = client.upload_data(bytes(blob[off:off + size]),
                                                 collection=HA_COLLECTION)
                        break
                    except Exception as e:  # noqa: BLE001 — retried
                        client_errors.append(repr(e))
                        if stop.is_set():
                            return  # never acked: nothing to keep
                        if time.monotonic() > deadline:
                            failures.append(repr(e))
                            stop.set()
                            return
                        time.sleep(0.05)
                with lock:
                    if fid in fids:
                        failures.append(f"file id {fid} issued twice")
                        stop.set()
                        return
                    fids[fid] = (off, size)
                    if int(fid.split(",")[0]) == vid:
                        target[0] += size

        # `weed backup` comes up first and waits for the write to reach
        # the backup mark: a process takes seconds to come up, and the
        # writes last only a few.
        bdir = os.path.join(work, "backup")
        trigger = os.path.join(work, "backup.go")
        backup_log = os.path.join(work, "backup_full.log")
        backup_full = port_process(
            [trigger, "backup", f"-master={leader}", f"-volumeId={vid}",
             f"-dir={bdir}"], backup_log, port_launch(dev, HELD))
        extras.append(backup_full)
        wait_for(lambda: os.path.exists(trigger + ".ready"),
                 "the backup process", procs + extras)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=writer) for _ in range(HA_WRITERS)]
        for th in threads:
            th.start()
        try:
            wait_for(lambda: stop.is_set() or target[0]
                     >= limit * HA_BACKUP_PERCENT / 100,
                     "the write to reach the backup mark", procs, timeout=600)
            # A leader elected under the write load answers lookups only
            # after the volume servers' next beats: start the backup
            # once its master answers the volume's.
            wait_for(lambda: rpc.call_status(
                f"{leader}/dir/lookup?volumeId={vid}", timeout=2.0)[0]
                == 200, "a lookup of the volume", procs)
            with open(trigger, "w"):
                pass
            # Its lookup is done once it fetches the .idx: only then may
            # the master it asked die.
            wait_for(lambda: os.path.exists(os.path.join(bdir, f"{vid}.idx"))
                     or backup_full.poll() is not None,
                     "the full backup's start", procs)
            wait_for(lambda: stop.is_set() or target[0]
                     >= limit * HA_KILL_PERCENT / 100,
                     "the write to reach the kill mark", procs, timeout=600)
            # The leader of the newest term: a leadership change under
            # the write load leaves a deposed leader believing it leads
            # until it hears the newer term.
            claims = [(st["raft"]["term"], u)
                      for u, st in master_roles(murls).items()
                      if st.get("is_leader")]
            check(claims, "no master claims to lead at the kill mark")
            term_at_kill, old_leader = max(claims)
            t_kill = time.perf_counter()
            out["rss_mib"][f"master {old_leader} (killed leader)"] = \
                rss_mib(m_procs[old_leader].pid)
            m_procs[old_leader].kill()
            m_procs[old_leader].wait(30)
            procs.remove(m_procs[old_leader])
            survivors = [u for u in murls if u != old_leader]
            leader = wait_for(lambda: the_leader(survivors),
                              "a new raft leader", procs, timeout=60)
            out["new_leader_s"] = time.perf_counter() - t_kill
            terms.update(at_kill=term_at_kill, new_leader=master_roles(
                [leader])[leader]["raft"]["term"])
            out["raft_terms"] = terms
            log(f"ha: leader {old_leader} killed; {leader} leads after "
                f"{out['new_leader_s']:.3f} s")
            wait_for(lambda: stop.is_set() or target[0]
                     >= limit * HA_FULL_PERCENT / 100,
                     "the write to fill the volume", procs, timeout=600)
        finally:
            stop.set()
            for th in threads:
                th.join()
        t_last_write = time.perf_counter()
        wall = t_last_write - t0

        # The mirror drains while the backups run: time it from here.
        def drained():
            pending = 0
            for n in vs_nodes:
                doc = rpc.call(f"http://{n}/debug/replication", timeout=5.0)
                pending += sum(st["pending"]
                               for st in (doc.get("rlog") or {}).values())
            return pending == 0

        converged: list = []

        def watch_drain():
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline:
                try:
                    if drained():
                        converged.append(time.perf_counter() - t_last_write)
                        return
                except (OSError, rpc.RpcError):
                    pass
                except Exception as e:  # noqa: BLE001 — reported below
                    converged.append(repr(e))
                    return
                time.sleep(0.05)

        drain_watch = threading.Thread(target=watch_drain, daemon=True)
        drain_watch.start()
        check(not failures, f"writes failed past their deadline: "
                            f"{failures[:3]}")
        retries = sum(resilience.rpc_retries_total.value(reason=r)
                      for r in ("connect", "shed", "status", "io")) - retries0
        keys = [t.parse_file_id(f)[1:] for f in fids]
        check(len(set(keys)) == len(keys), "a needle key was issued twice")
        written = sum(s for _o, s in fids.values())
        out["walls_s"]["write"] = wall
        out["gb_s"]["write"] = written / wall / 1e9
        out["write"] = {"needles": len(fids), "bytes": written,
                        "volume": vid, "volume_bytes": target[0],
                        "volumes": len({f.split(",")[0] for f in fids}),
                        "client_errors_retried": len(client_errors),
                        "client_rpc_retries": retries,
                        "acked_lost": None, "fids_unique": True}
        log(f"ha: wrote {len(fids)} needles, {written / MIB:.0f} MiB in "
            f"{wall:.2f} s; {len(client_errors)} client errors retried, "
            f"{retries:.0f} rpc retries")

        # The new leader learns each node's volumes from its next full
        # beat after the failover; then the slots are freed.
        wait_for(lambda: len(rpc.call_status(
            leader + "/cluster/healthz", timeout=2.0)[1]["nodes"])
            == HA_NODES and rpc.call_status(
            f"{leader}/dir/lookup?volumeId={vid}", timeout=2.0)[0] == 200,
            "every volume server at the new leader", procs)
        freed = rpc.call(f"{leader}/col/delete?collection={HA_FILLER}",
                         "POST")["deleted_replicas"]
        check(freed == filled, f"freed {freed} of {filled} filler volumes")

        # -- weed backup: full (taken during the writes), incremental ----
        backup_full.wait(600)
        with open(backup_log) as f:
            text = f.read()
        check(backup_full.returncode == 0 and "full backup" in text,
              f"full backup exited {backup_full.returncode}: "
              f"{text[-2000:]}")
        full_bytes = os.path.getsize(os.path.join(bdir, f"{vid}.dat"))
        backup_argv = ["backup", f"-master={leader}", f"-volumeId={vid}",
                       f"-dir={bdir}"]
        text, wall, _rss = run_port(backup_argv, os.path.join(
            work, "backup_incr.log"), launch, procs)
        check("incremental backup" in text, f"incremental backup: {text}")
        out["walls_s"]["backup_incremental"] = wall
        out["backup"] = {"full_dat_bytes": full_bytes,
                         "incremental": text.strip().splitlines()[-1]}
        # The primary's volume as it stands after the last write.
        base = os.path.join(work, "ref", f"{HA_COLLECTION}_{vid}")
        os.makedirs(os.path.dirname(base))
        for ext in (".dat", ".idx"):
            rpc.call_to_file(f"http://{holder}/admin/volume_file?"
                             f"volume={vid}&ext={ext}", base + ext)
        primary_set = needle_set(base + ".dat")
        want_ids = {t.parse_file_id(f)[1] for f in fids
                    if int(f.split(",")[0]) == vid}
        check(set(primary_set) == want_ids,
              "the primary's needles are not the acked writes")
        # Records appended between the full copy's .idx and .dat are
        # served only after `fix` (a reference fault, ROADMAP queue 3).
        served = served_needles(bdir, vid)
        check(all(primary_set.get(k) == v for k, v in served.items()),
              "the backup's index serves a needle the primary lacks")
        text, wall, _rss = run_port(
            ["fix", f"-dir={bdir}", f"-volumeId={vid}"],
            os.path.join(work, "fix.log"), launch, procs)
        out["walls_s"]["fix"] = wall
        out["backup"]["fix"] = text.strip().splitlines()[-1]
        fixed = served_needles(bdir, vid)
        text, wall, _rss = run_port(
            ["export", f"-dir={bdir}", f"-volumeId={vid}"],
            os.path.join(work, "export.log"), launch, procs)
        out["walls_s"]["export"] = wall
        listed = sum(1 for ln in text.splitlines() if "\toffset=" in ln)
        scanned = needle_set(os.path.join(bdir, f"{vid}.dat"))
        out["backup"].update({"needles": len(fixed),
                              "equal_to_primary": fixed == primary_set,
                              "served_before_fix": len(served),
                              "export_listed": listed})
        check(fixed == primary_set,
              f"after fix the backup serves {len(fixed)} needles, "
              f"{len(set(primary_set) - set(fixed))} of the primary's "
              f"{len(primary_set)} missing or different")
        check(scanned == primary_set and listed == len(scanned),
              f"export listed {listed} and a scan found {len(scanned)} "
              f"of the primary's {len(primary_set)} needles")

        # -- the mirror converges -----------------------------------------
        drain_watch.join(600)
        check(converged and isinstance(converged[0], float),
              f"the shippers never drained: {converged}")
        out["mirror_converged_s"] = converged[0]
        env = env_for(leader)
        status = wait_for(lambda: (lambda s: s if "CAUGHT UP" in s
                                   else None)(run_command(
                                       env, "cluster.mirror.status")),
                          "cluster.mirror.status CAUGHT UP", procs)
        out["mirror_status_head"] = status.splitlines()[0]
        vid_fids = sorted(f for f in fids if int(f.split(",")[0]) == vid)
        t0 = time.perf_counter()
        pr_map = crc_map(leader, vid_fids)
        sb_map = crc_map(surl, vid_fids)
        check(pr_map == sb_map, "the standby's CRC map differs from the "
                                "primary's")
        check(all(len(c) == 1 and c[0] for c in pr_map[str(vid)].values()),
              "a needle without one CRC")
        out["walls_s"]["crc_maps"] = time.perf_counter() - t0
        out["crc_map_needles"] = len(pr_map[str(vid)])
        sb_holder = env_for(surl).volume_locations(vid)
        check(len(sb_holder) == 1, f"standby holders of {vid}: {sb_holder}")
        sb_holder = sb_holder[0]
        sb_dat = os.path.join(sb_dirs[sb_holder], f"{HA_COLLECTION}_{vid}.dat")
        pr_dat = os.path.join(dirs[holder], f"{HA_COLLECTION}_{vid}.dat")
        diff = first_difference(pr_dat, sb_dat)
        out["dat_identical"] = diff is None
        if diff is not None:
            out["dat_first_difference"] = {
                "offset": diff, "primary_bytes": os.path.getsize(pr_dat),
                "standby_bytes": os.path.getsize(sb_dat)}
        log(f"ha: mirror converged {out['mirror_converged_s']:.2f} s after "
            f"the last write; .dat identical: {diff is None}")

        # -- the card's encode of the same .dat here -----------------------
        write_sorted_file_from_idx(base)
        reset_counts()
        write_ec_files(base, device=dev)
        ref_counts = read_counts()
        ref_k = {k: c["launches"] for k, c in ref_counts.items()}
        check(ref_k["rs_bitmatrix_crc"] > 0, f"reference encode {ref_k}")
        ref_sha = {s: sha256_file(f"{base}.ec{s:02d}") for s in range(14)}
        ref_ecc = ecc_entries(base + ".ecc")
        shard_size = os.path.getsize(base + ".ec00")
        for path in [base + ".dat"] + [f"{base}.ec{s:02d}"
                                       for s in range(1, 14)]:
            os.remove(path)

        # -- ec.encode on both clusters: K2 in each holder -----------------
        encodes = {}
        for side, murl, nodes, ddirs in (("primary", leader, vs_nodes, dirs),
                                         ("standby", surl, sb_nodes,
                                          sb_dirs)):
            before = node_device_rows(murl, nodes, time.time(), procs)
            if side == "primary":
                term_now("before_encode")
                idle = rows_delta(rows0, before)
                check(not idle, f"volume servers launched during the write,"
                                f" backup or mirror: {idle}")
            text, wall, rss = run_port(
                ["shell", dev_flag, f"-master={murl.split('//')[1]}", "lock",
                 f"ec.encode -volumeId {vid}"],
                os.path.join(work, f"encode_{side}.log"), launch, procs)
            check(f"volume {vid} -> ec shards" in text,
                  f"{side} ec.encode: {text[-2000:]}")
            after = node_device_rows(murl, nodes, time.time(), procs)
            step = rows_delta(before, after)
            check(set(step) <= {"encode_crc_kernel", "encode_kernel"}
                  and vs_kernel_launches(step) == ref_k,
                  f"{side} ec.encode rows {step}, expected {ref_k} "
                  f"(write_ec_files of the same .dat here)")
            files = shard_files(ddirs, vid)
            check(sorted(files) == list(range(14)),
                  f"{side} volume {vid} shards: {sorted(files)}")
            sha = hash_shards(files)
            ecc = ecc_union(ddirs, vid)
            check(all(ecc[s] == ref_ecc[s] for s in ecc),
                  f"{side}: an .ecc entry differs from the card's encode")
            encodes[side] = {"sha": sha, "ecc": ecc, "files": files}
            out["walls_s"][f"encode_{side}"] = wall
            out["gb_s"][f"encode_{side}"] = target[0] / wall / 1e9
            out["launches"][f"encode_{side}"] = {
                "volume_servers": vs_kernel_launches(step)}
            out["rss_mib"][f"shell encode {side} (sampled)"] = rss
        pr_sha, sb_sha = encodes["primary"]["sha"], encodes["standby"]["sha"]
        out["shards_identical_across_clusters"] = pr_sha == sb_sha
        out["shards_equal_to_card_encode"] = {
            side: encodes[side]["sha"] == ref_sha for side in encodes}
        # A shard copied by the per-volume flow has no .ecc entry until
        # its first scrub, and the two clusters copy different shards.
        pr_ecc, sb_ecc = encodes["primary"]["ecc"], encodes["standby"]["ecc"]
        out["ecc_entries"] = {
            "primary": len(pr_ecc), "standby": len(sb_ecc),
            "equal_where_both": all(pr_ecc[s] == sb_ecc[s]
                                    for s in set(pr_ecc) & set(sb_ecc))}
        check(pr_sha == ref_sha, "the primary's shards differ from the "
                                 "card's encode of its .dat")
        check((pr_sha == sb_sha) == (diff is None),
              "shards and .dat disagree on whether the clusters differ")
        log(f"ha: shards identical across clusters: {pr_sha == sb_sha}")

        # -- a holder dies: degraded reads, the autopilot's repair --------
        holders = {s: n for s, (n, _p) in encodes["primary"]["files"].items()}
        counts = {n: sorted(s for s, h in holders.items() if h == n)
                  for n in vs_nodes}
        # Placement 000 keeps one copy: a node holding another volume
        # with acked writes is not one to lose.
        env = env_for(leader)
        others = {int(f.split(",")[0]) for f in fids} - {vid}
        busy = {u for v in others for u in env.volume_locations(v)}
        candidates = [n for n in vs_nodes
                      if 1 <= len(counts[n]) <= 4 and n not in busy]
        check(candidates, f"no node holds 1-4 shards of {vid} and no other "
                          f"written volume: {counts}, {sorted(busy)}")
        victim = max(candidates, key=lambda n: len(counts[n]))
        lost = counts[victim]
        out["killed_node"] = {"node": victim, "shards": lost}
        # A locating copy: the .ecx, .vif and one shard's size.
        loc_base = os.path.join(work, "locate", f"{HA_COLLECTION}_{vid}")
        os.makedirs(os.path.dirname(loc_base))
        some = encodes["primary"]["files"][lost[0]][1][:-5]
        for ext in (".ecx", ".vif"):
            shutil.copyfile(some + ext, loc_base + ext)
        os.symlink(encodes["primary"]["files"][0][1], loc_base + ".ec00")
        out["repair_status_before"] = run_command(env, "cluster.repair status")
        live = [n for n in vs_nodes if n != victim]
        rows_kill = node_device_rows(leader, vs_nodes, time.time(), procs)
        leader_rows0 = leader_device_rows(leader)
        term_now("holder_kill")
        out["rss_mib"][f"volume {victim} (killed)"] = \
            rss_mib(vs_procs[victim].pid)
        # The leader's memory across its repair: it runs the batched
        # rebuild in its own process, whose rebuilt pieces go out as
        # each column step drains.
        leader_pid = m_procs[leader].pid
        leader_rss = {"before_mib": rss_mib(leader_pid)}
        leader_rss["peak_mib"] = leader_rss["before_mib"]
        t_kill, wall_kill = time.perf_counter(), time.time()
        terms_kill = {u: st["raft"]["term"]
                      for u, st in master_roles(survivors).items()}
        vs_procs[victim].kill()
        vs_procs[victim].wait(30)
        procs.remove(vs_procs[victim])
        rng = np.random.default_rng(args.seed + 12)
        sample = [vid_fids[i] for i in rng.choice(
            len(vid_fids), min(HA_READS, len(vid_fids)), replace=False)]
        ev = EcVolume(loc_base, vid=vid, device=dev)
        expect_k1 = 0
        for fid in sample:
            _o, _s, intervals = ev.locate_needle(t.parse_file_id(fid)[1])
            expect_k1 += sum(iv.to_shard_id_and_offset(
                ev.large_block_size, ev.small_block_size)[0] in lost
                for iv in intervals)
        ev.close()
        reader = WeedClient(survivors)
        lat = []
        for i, fid in enumerate(sample):
            off, size = fids[fid]
            t0 = time.perf_counter()
            try:
                data = reader.download(fid)
            except rpc.RpcError as e:
                raise RuntimeError(
                    f"degraded read {i} ({fid}) "
                    f"{time.perf_counter() - t_kill:.2f} s after the "
                    f"kill: {e}; masters: "
                    f"{ha_diagnosis(survivors, vid, t_kill, wall_kill)}; "
                    f"stalls: {master_stalls(m_logs, wall_kill)}"
                ) from None
            lat.append(time.perf_counter() - t0)
            check(data == blob[off:off + size], f"degraded read {fid} wrong")
        out["degraded_read_ms"] = {"p50": pct_ms(lat, 50),
                                   "p99": pct_ms(lat, 99), "reads": len(lat),
                                   "intervals_reconstructed": expect_k1}
        out["walls_s"]["degraded_reads"] = sum(lat)
        rows_reads = node_device_rows(leader, live, time.time(), procs)
        step = rows_delta({n: rows_kill[n] for n in live}, rows_reads)
        check(rows_delta(leader_rows0, leader_device_rows(leader)) == {},
              "the repair launched before the degraded reads ended")
        term_now("after_degraded_reads")
        check(step == ({"reconstruct_kernel": expect_k1} if expect_k1
                       else {}),
              f"degraded reads launched {step}, the layout needs "
              f"{expect_k1} K1 10->1")
        check(expect_k1 > 0, "no sampled read crossed a lost shard")
        out["launches"]["degraded_reads"] = {
            "volume_servers": vs_kernel_launches(step)}

        def repaired():
            leader_rss["peak_mib"] = max(leader_rss["peak_mib"],
                                         rss_mib(leader_pid))
            try:
                locs = env.ec_shard_locations(vid)
            except rpc.RpcError as e:
                raise RuntimeError(
                    f"repair poll {time.perf_counter() - t_kill:.2f} s "
                    f"after the kill: {e}; masters: "
                    f"{ha_diagnosis(survivors, vid, t_kill, wall_kill)}; "
                    f"stalls: {master_stalls(m_logs, wall_kill)}"
                ) from None
            return sorted(s for s, us in locs.items()
                          if any(u in live for u in us)) == list(range(14))
        wait_for(repaired, "the autopilot's EC rebuild", procs, timeout=600)
        out["repair_s_from_kill"] = time.perf_counter() - t_kill
        leader_rss["after_mib"] = rss_mib(leader_pid)
        out["leader_rss_across_repair"] = leader_rss
        log(f"ha: the leader's RSS across its repair {json.dumps(leader_rss)}")
        # The control plane across the repair, failed or not: a moved
        # term or a live node's heartbeat.lost is the 404's window.
        out["masters_after_repair"] = {
            "terms_at_kill": terms_kill,
            **ha_diagnosis(survivors, vid, t_kill, wall_kill)}
        # Each master's stalls over the phase, in s from the kill.
        out["master_stalls"] = master_stalls(m_logs, wall_kill)
        out["repair_status_after"] = run_command(env, "cluster.repair status")
        files = shard_files({n: dirs[n] for n in live}, vid)
        check(sorted(files) == list(range(14)),
              f"volume {vid} after the repair: {sorted(files)}")
        for sid in lost:
            check(sha256_file(files[sid][1]) == ref_sha[sid],
                  f"rebuilt shard {vid}.{sid} differs from its original")
        step = rows_delta(leader_rows0, leader_device_rows(leader))
        term_now("after_repair")
        want = rebuild_launches({vid: lost}, {vid: shard_size})
        check(set(step) <= {"batch_reconstruct"}
              and step.get("batch_reconstruct", 0) == want,
              f"the leader's repair launched {step}, expected {want} "
              f"batched K2 rebuild steps")
        rows_repair = node_device_rows(leader, live, time.time(), procs)
        check(not rows_delta(rows_reads, rows_repair),
              "volume servers launched during the repair")
        out["launches"]["repair"] = {"leader_master": {
            "rs_bitmatrix": 0, "rs_bitmatrix_crc": want}}
        log(f"ha: repaired {lost} {out['repair_s_from_kill']:.2f} s "
            f"after the kill")

        # -- every needle back, byte for byte -----------------------------
        wall = read_every_needle(survivors, fids, blob, HA_WRITERS)
        out["write"]["acked_lost"] = 0
        out["walls_s"]["read_back"] = wall
        out["gb_s"]["read_back"] = written / wall / 1e9
        rows_back = node_device_rows(leader, live, time.time(), procs)
        out["launches"]["read_back"] = {
            "volume_servers": vs_kernel_launches(rows_delta(rows_repair,
                                                            rows_back))}

        # -- the shell's cluster verbs on the leader ----------------------
        verbs = {}
        for line in ("cluster.check", "cluster.roofline", "cluster.flows",
                     "events.ls"):
            t0 = time.perf_counter()
            text = run_command(env, line)
            verbs[line] = {"s": time.perf_counter() - t0,
                           "lines": len(text.splitlines()),
                           "head": text.splitlines()[0] if text else ""}
            check(text.strip(), f"{line} printed nothing")
            if line == "cluster.roofline":
                check(f"peaks[{dev.type}" in text,
                      f"cluster.roofline peaks are not the card's: {text}")
                # Rows ride each live node's beats: the encoding holder's
                # K2 rows go with it if it was the node killed.
                keys = ["reconstruct_kernel"] + (
                    ["encode_crc_kernel"] if holder != victim else [])
                for key in keys:
                    check(key in text, f"cluster.roofline lacks {key}")
        out["shell_verbs"] = verbs

        # -- weed benchmark against the leader ----------------------------
        text, wall, rss = run_port(
            ["benchmark", f"-master={leader.split('//')[1]}",
             f"-n={HA_BENCH_N}", f"-size={HA_BENCH_SIZE}",
             f"-c={HA_BENCH_C}"], os.path.join(work, "benchmark.log"),
            launch, procs, timeout=900)
        bench = bench_report(text)
        for side in ("write", "read"):
            check(bench.get(side, {}).get("requests") == HA_BENCH_N
                  and bench[side]["errors"] == 0,
                  f"benchmark {side}: {bench.get(side)}")
        out["benchmark"] = bench
        out["walls_s"]["benchmark"] = wall
        out["rss_mib"]["benchmark (sampled)"] = rss

        # -- every process's memory, then the totals ----------------------
        for u, p in m_procs.items():
            if p.poll() is None:
                out["rss_mib"][f"master {u}"] = rss_mib(p.pid)
        out["rss_mib"][f"master {surl} (standby)"] = rss_mib(sb_master.pid)
        for n in live:
            out["rss_mib"][f"volume {n}"] = rss_mib(vs_procs[n].pid)
        for n in sb_nodes:
            out["rss_mib"][f"volume {n} (standby)"] = rss_mib(sb_procs[n].pid)
        out["rss_mib"]["chip_smoke"] = rss_mib(os.getpid())
        totals = {"rs_bitmatrix": 0, "rs_bitmatrix_crc": 0}
        for s in out["launches"].values():
            for side in s.values():
                for k in totals:
                    totals[k] += side.get(k, 0)
        out["launch_totals"] = totals
        check(out["launches"]["encode_primary"]["volume_servers"][
            "rs_bitmatrix_crc"] > 0 and out["launches"]["encode_standby"][
            "volume_servers"]["rs_bitmatrix_crc"] > 0,
            "K2 did not launch in both clusters' holders")
        check(totals["rs_bitmatrix"] > 0, "K1 did not launch")
    finally:
        for e in envs:
            e.close()
        for p in procs + extras:
            if p.poll() is None:
                p.terminate()
        for p in procs + extras:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"ha cluster: {json.dumps(out['walls_s'])}")
    return out


def lookup_summary(answer: tuple) -> list:
    """A /dir/lookup answer in short: [status, {shard: holders}] for an
    EC volume, else [status, the body]."""
    status, doc = answer
    shards = doc.get("ecShards") if isinstance(doc, dict) else None
    if shards is None:
        return [status, doc]
    return [status, {s: [loc["url"] for loc in locs]
                     for s, locs in sorted(shards.items(),
                                           key=lambda kv: int(kv[0]))}]


def ha_diagnosis(murls: list[str], vid: int, t_kill: float,
                 wall_kill: float) -> dict:
    """What each master says of itself and of volume `vid` (for a
    failure's message): raft role and term, its /dir/lookup, its
    heartbeat.lost events since the kill (`wall_kill`, time.time())
    with their age_seconds and its elections (leader.elect) with their
    terms; the leader's EC shard row for `vid` (each node of its
    /vol/list with the shards it holds); the seconds since the kill
    (`t_kill`, time.perf_counter())."""
    from seaweedfs_tpu_torch.cluster import rpc
    from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
    out: dict = {"s_since_kill": round(time.perf_counter() - t_kill, 3)}
    for u in murls:
        try:
            st = rpc.call(u + "/cluster/status", timeout=5.0)
            lost = rpc.call(f"{u}/cluster/events?type=heartbeat.lost"
                            f"&since={wall_kill}", timeout=5.0)
            won = rpc.call(f"{u}/cluster/events?type=leader.elect",
                           timeout=5.0)
            out[u] = {"is_leader": st.get("is_leader"),
                      "leader": st.get("leader"),
                      "term": st.get("raft", {}).get("term"),
                      "lookup": lookup_summary(rpc.call_status(
                          f"{u}/dir/lookup?volumeId={vid}", timeout=5.0)),
                      "heartbeat_lost": [
                          {"node": e.get("node"),
                           "s_after_kill": round(e["ts"] - wall_kill, 3),
                           "age_seconds": e["attrs"].get("age_seconds")}
                          for e in lost["events"]],
                      "elected_s_after_kill": [
                          [round(e["ts"] - wall_kill, 3),
                           e["attrs"].get("term")] for e in won["events"]]}
            if st.get("is_leader"):
                topo = rpc.call(u + "/vol/list", timeout=5.0)["topology"]
                out["leader_ec_row"] = {
                    n["url"]: ShardBits(e["shard_bits"]).shard_ids()
                    for dc in topo["data_centers"] for r in dc["racks"]
                    for n in r["nodes"] for e in n["ec_shards"]
                    if e["id"] == vid}
                out["leader_nodes"] = sorted(
                    n["url"] for dc in topo["data_centers"]
                    for r in dc["racks"] for n in r["nodes"])
        except Exception as e:  # noqa: BLE001 — a diagnosis, best effort
            out[u] = repr(e)
    return out


def ha_runs(torch, dev, args, smi: str) -> int:
    """Phase 11 alone, `args.ha_runs` times in a row: per run its wall,
    whether it passed (else the failure's message, with its diagnosis),
    the seconds to repair and the masters' terms and heartbeat.lost
    events across the repair.  Exits 1 if any run failed."""
    failed = 0
    for i in range(args.ha_runs):
        t0 = time.perf_counter()
        row: dict = {"run": i}
        try:
            with hooks("armed"):
                ha = phase_ha_cluster(torch, dev, args)
            row.update(ok=True, repair_s_from_kill=ha["repair_s_from_kill"],
                       degraded_read_ms=ha["degraded_read_ms"],
                       raft_terms=ha["raft_terms"],
                       master_stalls=ha["master_stalls"],
                       masters_after_repair=ha["masters_after_repair"])
        except Exception as e:  # noqa: BLE001 — counted, then reported
            failed += 1
            row.update(ok=False, error=f"{type(e).__name__}: {e}"[-6000:])
        row["wall_s"] = time.perf_counter() - t0
        print(json.dumps({"ha_run": row}), flush=True)
    print(smi)
    print(json.dumps({"ha_runs": args.ha_runs, "passed":
                      args.ha_runs - failed}))
    return 1 if failed else 0


# The wire measurement (--wire-mib): one volume through `ec.encode
# -batch` and `ec.rebuild -batch` in a live cluster, in turns of two
# checkouts of this repository.
WIRE_NODES = 5
WIRE_LOST = (1, 3, 9, 12)
WIRE_BATCH_MB = 256  # ec.rebuild's -maxBatchMB default
WIRE_SAMPLE_S = 0.05
# A `weed shell` whose memory is read around its command: torch, the
# card's context, the shell's modules and the batch mesh come up first,
# then it prints its RSS (WIRE_BASE, kB).
WIRE_SHELL = (
    "import seaweedfs_tpu_torch.shell\n"
    "from seaweedfs_tpu_torch.parallel import cluster_rebuild\n"
    "cluster_rebuild.make_mesh()\n"
    "with open('/proc/self/status') as _f:\n"
    "    print('WIRE_BASE', next(int(x.split()[1]) for x in _f\n"
    "                            if x.startswith('VmRSS:')), flush=True)\n")


def wire_command(dev, tree: str, mport: int, command: str, log_path: str,
                 servers: dict, procs) -> dict:
    """One shell command of the wire measurement, in a WIRE_SHELL
    process of `tree`: its wall, the shell's RSS growth over its command
    (its largest RSS less its RSS once set up) and each volume server's
    (over its RSS at the start), sampled every WIRE_SAMPLE_S, and each
    server's `ec.scatter` requests and bytes in (`servers`: node ->
    pid)."""
    flows0 = {n: inbound_flows(n) for n in servers}
    base = {n: rss_mib(pid) for n, pid in servers.items()}
    peak = dict(base)
    warm = "import torch\ntorch.zeros(1, device='cuda')\n" \
        if dev.type == "cuda" else ""
    p = port_process([
        "shell", f"-device={dev.type}", f"-master=127.0.0.1:{mport}",
        "lock", command], log_path, port_launch(dev, warm + WIRE_SHELL),
        tree)
    shell_peak = 0.0
    t0 = time.perf_counter()
    try:
        while p.poll() is None:
            for n, pid in servers.items():
                peak[n] = max(peak[n], rss_mib(pid))
            with contextlib.suppress(OSError, RuntimeError):
                shell_peak = max(shell_peak, rss_mib(p.pid))
            for q in procs:
                check(q.poll() is None, f"{command}: a cluster process "
                                        f"exited ({q.args[3:6]})")
            check(time.perf_counter() - t0 < 1800, f"{command} hung")
            time.sleep(WIRE_SAMPLE_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    check(p.returncode == 0, f"{command} exited {p.returncode}: "
                             f"{text[-2000:]}")
    m = re.search(r"^WIRE_BASE (\d+)$", text, re.M)
    check(m is not None, f"{command}: no WIRE_BASE line: {text[-2000:]}")
    pieces = {}
    for n in servers:
        b, k = flows_delta(flows0[n], inbound_flows(n)).get(
            "ec.scatter", [0, 0])
        if k:
            pieces[n] = {"requests": k, "bytes": b}
    return {"wall_s": wall,
            "shell_rss_growth_mib": shell_peak - int(m.group(1)) / 1024,
            "target_rss_growth_mib": {n: peak[n] - base[n]
                                      for n in servers},
            "max_target_rss_growth_mib": max(peak[n] - base[n]
                                             for n in servers),
            "ec_scatter_in": pieces, "output": text[-600:]}


def wire_turn(dev, tree: str, src: str, work: str) -> dict:
    """One turn of the wire measurement on `tree`'s package: a master
    and WIRE_NODES volume servers (the first holding volume 1, a hard
    link of `src`'s .dat and a copy of its .idx, from its start),
    `ec.encode -volumeId 1 -batch`, WIRE_LOST deleted on their holders,
    `ec.rebuild -volumeId 1 -batch`; every rebuilt shard's block CRCs
    must equal the encode's `.ecc` entries of it."""
    from seaweedfs_tpu_torch.cluster import rpc
    from seaweedfs_tpu_torch.ec.integrity import file_block_crcs
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs: list = []
    out: dict = {}
    try:
        mport = rpc.free_port()
        murl = f"http://127.0.0.1:{mport}"
        master = port_process(
            ["master", f"-port={mport}", f"-mdir={work}/master",
             f"-volumeSizeLimitMB={CLUSTER_SIZE_LIMIT_MB}",
             "-defaultReplication=000"],
            os.path.join(work, "master.log"), tree=tree)
        procs.append(master)
        wait_for(lambda: rpc.call(murl + "/dir/status", timeout=2.0),
                 "the master", procs)
        dirs, servers = {}, {}
        for i in range(WIRE_NODES):
            port = rpc.free_port()
            node = f"127.0.0.1:{port}"
            dirs[node] = os.path.join(work, f"vs{i}")
            os.makedirs(dirs[node])
            if i == 0:
                os.link(src + ".dat", os.path.join(dirs[node], "1.dat"))
                shutil.copyfile(src + ".idx",
                                os.path.join(dirs[node], "1.idx"))
            p = port_process(
                ["volume", f"-device={dev.type}", f"-port={port}",
                 f"-dir={dirs[node]}", "-max=7",
                 f"-mserver=127.0.0.1:{mport}", f"-rack=rack{i % 2}"],
                os.path.join(work, f"vs{i}.log"), tree=tree)
            procs.append(p)
            servers[node] = p.pid
        wait_for(lambda: len(rpc.call_status(
            murl + "/cluster/healthz", timeout=2.0)[1]["nodes"])
            == WIRE_NODES and rpc.call(
                murl + "/dir/lookup?volumeId=1", timeout=2.0).get(
                "locations"), "the volume servers and volume 1", procs)
        out["encode"] = wire_command(
            dev, tree, mport, "ec.encode -volumeId 1 -batch",
            os.path.join(work, "encode.log"), servers, procs)
        files = shard_files(dirs, 1)
        check(sorted(files) == list(range(14)),
              f"shards after ec.encode: {sorted(files)}")
        shard = os.path.getsize(files[0][1])
        crcs = {sid: ecc_entries(path[:-5] + ".ecc")[sid]
                for sid, (_n, path) in files.items()}
        for sid in WIRE_LOST:
            rpc.call_json(f"http://{files[sid][0]}/admin/ec/delete_shards",
                          payload={"volume": 1, "shards": [sid]})
        wait_for(lambda: not {str(s) for s in WIRE_LOST} & set(rpc.call(
            murl + "/dir/lookup?volumeId=1", timeout=2.0).get(
            "ecShards", {})), "the master to drop the lost shards", procs)
        out["rebuild"] = wire_command(
            dev, tree, mport,
            f"ec.rebuild -volumeId 1 -batch -maxBatchMB {WIRE_BATCH_MB}",
            os.path.join(work, "rebuild.log"), servers, procs)
        files = shard_files(dirs, 1)
        check(sorted(files) == list(range(14)),
              f"shards after ec.rebuild: {sorted(files)}")
        for sid in WIRE_LOST:
            check([f"{c:08x}" for c in file_block_crcs(files[sid][1])]
                  == crcs[sid], f"rebuilt shard {sid} differs from the "
                                "encode's block CRCs")
        out["shard_bytes"] = shard
        out["disk_used_gib"] = shutil.disk_usage(work).used / 2 ** 30
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


def wire_turns(torch, dev, args, smi: str) -> int:
    """The wire measurement: one volume of --wire-mib MiB (written here
    by write_volume) through `ec.encode -batch` and `ec.rebuild -batch`
    in a live cluster, in turns of the checkout at --wire-parent and of
    this one (parent, change, change, parent); one {"wire_turn": ...}
    line per turn (wall, the shell's and the largest target's RSS
    growth, the pieces each target took)."""
    work = os.path.join(REPO, "_smoke_work", "wire")
    shutil.rmtree(work, ignore_errors=True)
    src = os.path.join(work, "src", "1")
    os.makedirs(os.path.dirname(src))
    t0 = time.perf_counter()
    write_volume(src, args.wire_mib * MIB, args.seed + 140)
    log(f"wire: a {args.wire_mib} MiB volume in "
        f"{time.perf_counter() - t0:.1f} s")
    trees = {"parent": os.path.abspath(args.wire_parent), "change": REPO}
    try:
        for i, name in enumerate(("parent", "change", "change", "parent")):
            row = {"turn": i, "tree": name, "mib": args.wire_mib}
            row.update(wire_turn(dev, trees[name], src,
                                 os.path.join(work, f"turn{i}")))
            print(json.dumps({"wire_turn": row}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(smi)
    return 0


def gateway_runs(torch, dev, args, smi: str) -> int:
    """Phase 13 alone, `args.gateway_runs` times in a row: per run its
    wall, whether it passed (else the failure's message), each read
    pass's launches, lost intervals and wire rows, the calls per process
    that met a closed connection or timed out, and the walls of
    `filer.copy` and `volume.fsck`.  Exits 1 if any run failed."""
    failed = 0
    for i in range(args.gateway_runs):
        t0 = time.perf_counter()
        row: dict = {"run": i, "small_div": args.gateway_small_div}
        try:
            with hooks("armed"):
                gw = phase_gateway_cluster(torch, dev, args)
            row.update(ok=True, launches=gw["launches"],
                       rpc_fails=gw["rpc_fails"],
                       filer_copy_s=gw["walls_s"]["filer_copy"],
                       fsck_s=gw["walls_s"]["fsck"])
        except Exception as e:  # noqa: BLE001 — counted, then reported
            failed += 1
            row.update(ok=False, error=f"{type(e).__name__}: {e}"[-6000:])
        row["wall_s"] = time.perf_counter() - t0
        print(json.dumps({"gateway_run": row}), flush=True)
    print(smi)
    print(json.dumps({"gateway_runs": args.gateway_runs, "passed":
                      args.gateway_runs - failed}))
    return 1 if failed else 0


def leader_device_rows(murl: str) -> dict:
    """The leader master's own ledger rows (its process runs the repair
    daemon's batched rebuilds), as /cluster/device folds them in under
    its own URL: {its url: {catalog key: count}}, as rows_delta reads
    them."""
    from seaweedfs_tpu_torch.cluster import rpc
    doc = rpc.call(murl + "/cluster/device", timeout=120.0)
    node = doc["nodes"].get(doc["leader"])
    return {doc["leader"]: device_counts(node) if node else {}}



# -- phase 12: a filer-fronted EC cluster on the card ------------------------


def filer_namespace(seed: int, limit_mb: int) -> dict:
    """The seeded namespace of phase 12, {path: (offset, size)} into one
    random blob: FILER_LARGE_PER_LIMIT x the volume limit of large files
    (log-uniform FILER_LARGE_RANGE, capped at a quarter of the limit),
    FILER_SMALL small ones per 1024 MiB of limit (log-uniform
    FILER_SMALL_RANGE), spread over the leaf directories of a tree
    FILER_DIRS wide at each of its three levels."""
    rng = np.random.default_rng(seed + 12)
    blob_bytes = FILER_BLOB_MIB * MIB
    a, b, c = FILER_DIRS
    leaves = [f"/a{i}/b{j}/c{k}" for i in range(a) for j in range(b)
              for k in range(c)]
    lo, hi = FILER_LARGE_RANGE
    hi = min(hi, limit_mb * MIB // 4)
    large: dict = {}
    total, i = 0, 0
    while total < FILER_LARGE_PER_LIMIT * limit_mb * MIB:
        size = int(math.exp(rng.uniform(math.log(lo), math.log(hi))))
        d = leaves[int(rng.integers(len(leaves)))]
        large[f"{d}/L{i:05d}.bin"] = (int(rng.integers(blob_bytes - size)),
                                      size)
        total += size
        i += 1
    small: dict = {}
    lo, hi = FILER_SMALL_RANGE
    for j in range(max(FILER_SMALL * limit_mb // 1024, 200)):
        size = int(math.exp(rng.uniform(math.log(lo), math.log(hi))))
        d = leaves[int(rng.integers(len(leaves)))]
        small[f"{d}/s{j:05d}.bin"] = (int(rng.integers(blob_bytes - size)),
                                      size)
    return {"blob": memoryview(rng.bytes(blob_bytes)), "large": large,
            "small": small, "leaves": leaves}


def pool_run(items, work, workers: int) -> tuple[float, list]:
    """work(item) over `items` from `workers` threads; returns the wall
    and every item's latency in s.  Fails on the first error."""
    it = iter(items)
    lock = threading.Lock()
    errors: list = []
    lat: list = []

    def run():
        while not errors:
            with lock:
                item = next(it, None)
            if item is None:
                return
            t0 = time.perf_counter()
            try:
                work(item)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{item!r:.200}: {e!r:.300}")
                return
            lat.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run) for _ in range(workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, f"{len(errors)} failed: {errors[:3]}")
    return time.perf_counter() - t0, lat


def filer_listing(env, expected: dict) -> None:
    """`fs.ls` of every directory of `expected` ({dir: names}, a
    directory's name ending in /) must list exactly those names (the
    root at least them)."""
    from seaweedfs_tpu_torch.shell import run_command
    for d, names in sorted(expected.items()):
        got = set(filter(None, run_command(env, f"fs.ls {d}").split("\n")))
        check(got >= names if d == "/" else got == names,
              f"fs.ls {d}: {len(got)} names, {len(got ^ names)} differ "
              f"from what was written")


def lost_intervals(evs: dict, lost: dict, fids) -> int:
    """K1 10->1 launches a whole read of each chunk of `fids` needs:
    the intervals of its needle on a lost shard (evs: vid -> EcVolume of
    the reference copy, lost: vid -> shard ids)."""
    from seaweedfs_tpu_torch.core import types as t
    n = 0
    for fid in fids:
        vid, key, _cookie = t.parse_file_id(fid)
        if vid not in evs:
            continue
        ev = evs[vid]
        _o, _s, intervals = ev.locate_needle(key)
        n += sum(iv.to_shard_id_and_offset(ev.large_block_size,
                                           ev.small_block_size)[0]
                 in lost.get(vid, ()) for iv in intervals)
    return n


def phase_filer_cluster(torch, dev, args) -> dict:
    """Phase 12: the port's filer in front of a live EC cluster on the
    card's host, every role a `python -m seaweedfs_tpu_torch` process:
    write a seeded namespace through the filer's HTTP API, list it, kill
    -9 and restart the filer, ec.encode in the holders (K2), kill -9 a
    holder, read every file and 300 ranges through the filer (K1 in the
    survivors), volume.fsck through CommandEnv.filer(), ec.rebuild, read
    everything again, fs.rm -r a directory and fsck once its deletes
    land.  Every shard and .ecc entry is held against write_ec_files of
    a copy of its sealed .dat on `dev`; every launch is counted per
    process through /cluster/device and reconciled with the intervals
    the reads needed."""
    from seaweedfs_tpu_torch.cluster import rpc
    from seaweedfs_tpu_torch.core import types as t
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.shell.command_volume import VolumeFsck

    t_phase = time.perf_counter()
    limit_mb = args.filer_mib
    limit = limit_mb * MIB
    work = os.path.join(REPO, "_smoke_work", "filer")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dev_flag = f"-device={dev.type}"
    procs: list = []
    env = None
    evs: dict = {}
    out: dict = {"reduced": {"volume_size_limit_mb": [30000, limit_mb],
                             "hosts": [FILER_NODES + 2, 1],
                             "small_files_per_1024_mib": [20000,
                                                          FILER_SMALL],
                             "read_after_rebuild": "not run since phase 13 "
                                                   "joined (time)",
                             "fsck_after_rm": "not run since phase 13 "
                                              "joined (time); the orphan "
                                              "wait holds the deletes"},
                 "walls_s": {}, "gb_s": {}, "launches": {}}
    try:
        mport, fport = rpc.free_port(), rpc.free_port()
        murl = f"http://127.0.0.1:{mport}"
        furl = f"http://127.0.0.1:{fport}"
        master = port_process(
            ["master", f"-port={mport}", f"-mdir={work}/master",
             f"-volumeSizeLimitMB={limit_mb}",
             f"-defaultReplication={FILER_REPLICATION}"],
            os.path.join(work, "master.log"))
        procs.append(master)
        wait_for(lambda: rpc.call(murl + "/dir/status", timeout=2.0),
                 "the master", procs)
        dirs: dict = {}
        vs_procs: dict = {}
        for i in range(FILER_NODES):
            port = rpc.free_port()
            node = f"127.0.0.1:{port}"
            dirs[node] = os.path.join(work, f"vs{i}")
            os.makedirs(dirs[node])
            vs_procs[node] = port_process(
                ["volume", dev_flag, f"-port={port}", f"-dir={dirs[node]}",
                 f"-max={FILER_MAX_VOLUMES}", f"-mserver=127.0.0.1:{mport}",
                 "-dataCenter=dc1",
                 f"-rack=rack{i * FILER_RACKS // FILER_NODES}"],
                os.path.join(work, f"vs{i}.log"))
            procs.append(vs_procs[node])
        filer_args = ["filer", f"-port={fport}",
                      f"-master=127.0.0.1:{mport}",
                      f"-dir={work}/filer",
                      f"-collection={FILER_COLLECTION}"]
        filer = port_process(filer_args, os.path.join(work, "filer.log"))
        procs.append(filer)
        wait_for(lambda: len(rpc.call_status(
            murl + "/cluster/healthz", timeout=2.0)[1]["nodes"])
            == FILER_NODES, f"{FILER_NODES} volume servers", procs)
        wait_for(lambda: rpc.call(furl + "/", timeout=2.0), "the filer",
                 procs)
        out["startup_s"] = time.perf_counter() - t_phase
        with open(os.path.join(work, "filer.log")) as f:
            text = f.read()
        # Off without grpcio/protobuf (the card's host), else serving.
        out["filer_grpc"] = "off" if "gRPC plane disabled" in text \
            else "on" if "filer gRPC" in text else None
        check(out["filer_grpc"] is not None,
              "the filer did not log its gRPC plane's state")

        # -- 1. write the namespace from 8 threads ------------------------
        rpc.call(f"{murl}/vol/grow?count={FILER_PREGROW}"
                 f"&collection={FILER_COLLECTION}", "POST")
        ns = filer_namespace(args.seed, limit_mb)
        blob = ns["blob"]
        files = {**ns["large"], **ns["small"]}
        acked: dict = {}  # path -> sha256 of what the filer acknowledged

        def put(path):
            off, size = files[path]
            data = bytes(blob[off:off + size])
            rpc.call(furl + path, "POST", data, timeout=600.0)
            acked[path] = hashlib.sha256(data).hexdigest()

        large_bytes = sum(s for _o, s in ns["large"].values())
        wall, _lat = pool_run(sorted(ns["large"]), put, FILER_WRITERS)
        out["walls_s"]["write_large"] = wall
        out["gb_s"]["write_large"] = large_bytes / wall / 1e9
        wall, lat = pool_run(sorted(ns["small"]), put, FILER_WRITERS)
        out["walls_s"]["write_small"] = wall
        out["small_creates_per_s"] = len(ns["small"]) / wall
        out["small_create_ms"] = {"p50": pct_ms(lat, 50),
                                  "p99": pct_ms(lat, 99)}
        written = sum(s for _o, s in files.values())
        check(len(acked) == len(files), "a write went unacknowledged")
        out["namespace"] = {"large_files": len(ns["large"]),
                            "large_bytes": large_bytes,
                            "small_files": len(ns["small"]),
                            "bytes": written,
                            "directories": len(ns["leaves"])}
        log(f"filer: wrote {len(files)} files, {written / MIB:.0f} MiB "
            f"(large {out['gb_s']['write_large']:.3f} GB/s, small "
            f"{out['small_creates_per_s']:.0f} creates/s)")

        # -- 2. list it ----------------------------------------------------
        expected: dict = {"/": set()}
        for path in files:
            parts = path.split("/")[1:]
            for k in range(len(parts)):
                parent = "/" + "/".join(parts[:k])
                name = parts[k] + ("/" if k < len(parts) - 1 else "")
                expected.setdefault(parent, set()).add(name)
        env = CommandEnv(murl, filer_url=furl, device=dev)
        t0 = time.perf_counter()
        filer_listing(env, expected)
        du = run_command(env, "fs.du /")
        out["walls_s"]["listing"] = time.perf_counter() - t0
        check(du.startswith(f"{written} bytes, {len(files)} files, "),
              f"fs.du /: {du!r}, written {written} bytes in {len(files)} "
              f"files")
        out["fs_du"] = du
        log(f"filer: listed in {out['walls_s']['listing']:.1f} s")

        # -- 3. kill -9 the filer, restart it on the same -dir ------------
        out["rss_mib"] = {"filer_after_write": rss_mib(filer.pid)}
        filer.kill()
        filer.wait(30)
        procs.remove(filer)
        t0 = time.perf_counter()
        filer = port_process(filer_args,
                             os.path.join(work, "filer-restart.log"))
        procs.append(filer)
        wait_for(lambda: rpc.call(furl + "/a0/", timeout=2.0),
                 "the restarted filer", procs)
        out["walls_s"]["filer_restart"] = time.perf_counter() - t0
        chunks: dict = {}  # path -> [(file id, offset, size)]

        def meta(path):
            doc = rpc.call(f"{furl}{path}?metadata=true", timeout=60.0)
            chunks[path] = sorted(((c["file_id"], c["offset"], c["size"])
                                   for c in doc["chunks"]),
                                  key=lambda c: c[1])
            check(sum(s for _f, _o, s in chunks[path]) == files[path][1],
                  f"{path}: chunks cover {chunks[path]}")

        wall, _lat = pool_run(sorted(files), meta, FILER_WRITERS)
        filer_listing(env, expected)
        out["walls_s"]["entries_after_restart"] = wall
        n_chunks = sum(len(c) for c in chunks.values())
        check(max(len(c) for c in chunks.values()) > 1,
              "no file was cut into several chunks")
        rng = np.random.default_rng(args.seed + 13)
        sample = [sorted(files)[i] for i in rng.choice(
            len(files), min(FILER_SAMPLE, len(files)), replace=False)]

        def read_equal(path):
            data = bytes(rpc.call(furl + path, timeout=600.0))
            check(hashlib.sha256(data).hexdigest() == acked[path],
                  f"{path}: read back differs from what was acknowledged")

        wall, _lat = pool_run(sample, read_equal, FILER_WRITERS)
        out["walls_s"]["sample_after_restart"] = wall
        out["after_restart"] = {"entries": len(chunks), "chunks": n_chunks,
                                "sampled_reads": len(sample)}
        log(f"filer: restarted in {out['walls_s']['filer_restart']:.1f} s, "
            f"{len(chunks)} entries, {n_chunks} chunks")

        # -- 4. lock; ec.encode the volumes that hold the namespace -------
        vs_nodes = list(vs_procs)
        rows0 = node_device_rows(murl, vs_nodes, time.time(), procs)
        vids = sorted({t.parse_file_id(f)[0] for c in chunks.values()
                       for f, _o, _s in c})
        reference, ref_k = encode_sealed_copies(env, vids, work, dev)
        dat_bytes = {v: reference[v]["dat_bytes"] for v in vids}
        full = [v for v in vids
                if dat_bytes[v] >= limit * FILER_FULL_PERCENT / 100]
        check(len(full) >= 1, f"no volume filled: {dat_bytes}")
        out["volumes"] = {"encoded": vids, "full": full,
                          "dat_bytes": {str(v): n
                                        for v, n in dat_bytes.items()}}
        want_k2 = sum(k.get("rs_bitmatrix_crc", 0) for k in ref_k.values())
        want_k1 = sum(k.get("rs_bitmatrix", 0) for k in ref_k.values())
        check(want_k2 + want_k1 > 0, f"reference encodes launched {ref_k}")
        shell_out, wall, shell_rss = run_port(
            ["shell", dev_flag, f"-master=127.0.0.1:{mport}", "lock",
             "ec.encode -volumeId " + ",".join(map(str, vids))],
            os.path.join(work, "shell-encode.log"), MASTER_LAUNCH, procs)
        for vid in vids:
            check(f"volume {vid} -> ec shards" in shell_out,
                  f"shell ec.encode: {shell_out[-2000:]}")
        out["walls_s"]["encode"] = wall
        out["gb_s"]["encode"] = sum(dat_bytes.values()) / wall / 1e9
        out["rss_mib"]["shell_max_sampled"] = shell_rss
        rows1 = node_device_rows(murl, vs_nodes, time.time(), procs)
        step = rows_delta(rows0, rows1)
        got = vs_kernel_launches(step)
        out["launches"]["encode"] = {"volume_servers": got}
        check(set(step) <= {"encode_crc_kernel", "encode_kernel"}
              and got == {"rs_bitmatrix": want_k1,
                          "rs_bitmatrix_crc": want_k2},
              f"encode rows {step}, expected K2 {want_k2} and K1 {want_k1} "
              f"(write_ec_files of the same .dat here)")
        holders, ecc_checked = check_encoded_shards(env, dirs, reference)
        out["shards_checked"] = 14 * len(vids)
        out["ecc_entries_checked"] = ecc_checked
        log(f"filer: encoded {vids} (full {full}) in {wall:.1f} s, "
            f"{want_k2} K2 in the holders")

        # -- 5. kill -9 the holder of the most shards of a volume ---------
        def held(node):
            return {v: sorted(s for s, n in holders[v].items() if n == node)
                    for v in vids}
        victim = max(vs_nodes, key=lambda n: (
            max(len(s) for s in held(n).values()),
            sum(len(s) for s in held(n).values())))
        lost = {v: s for v, s in held(victim).items() if s}
        out["killed"] = {"node": victim,
                         "shards": {str(v): s for v, s in lost.items()},
                         "most_of_one_volume": max(map(len, lost.values()))}
        lost_sha = {(v, s): reference[v]["shards"][s]
                    for v, ss in lost.items() for s in ss}
        out["rss_mib"]["killed_volume_server"] = rss_mib(
            vs_procs[victim].pid)
        rows_kill = node_device_rows(murl, vs_nodes, time.time(), procs)
        vs_procs[victim].kill()
        vs_procs[victim].wait(30)
        procs.remove(vs_procs[victim])
        live = [n for n in vs_nodes if n != victim]
        evs = {v: EcVolume(reference[v]["base"], vid=v, device=dev)
               for v in vids}

        def cache_doc():
            return rpc.call(furl + "/debug/cache?fids=1", timeout=60.0)

        # -- 6. every file through the filer: the first read after the kill
        before = cache_doc()
        resident = {fid for fid, _n in before["resident"]}
        all_fids = [f for c in chunks.values() for f, _o, _s in c]
        need = lost_intervals(evs, lost, all_fids)
        need_hits = lost_intervals(evs, lost, [f for f in all_fids
                                               if f in resident])
        wall, lat = pool_run(sorted(files), read_equal, FILER_WRITERS)
        after = cache_doc()
        rows2 = node_device_rows(murl, live, time.time(), procs)
        step = rows_delta({n: rows_kill[n] for n in live}, rows2)
        k1 = vs_kernel_launches(step)
        out["walls_s"]["degraded_read_all"] = wall
        out["gb_s"]["degraded_read_all"] = written / wall / 1e9
        out["degraded_read_ms"] = {"p50": pct_ms(lat, 50),
                                   "p99": pct_ms(lat, 99), "reads": len(lat)}
        hits = {"hit_bytes": after["chunk_cache"]["hit_bytes"]
                - before["chunk_cache"]["hit_bytes"],
                "resident_chunks_before": len(resident),
                "lost_intervals_of_resident_chunks": need_hits}
        out["launches"]["degraded_read_all"] = {
            "volume_servers": k1, "lost_intervals_read": need,
            "chunk_cache": hits}
        check(set(step) <= {"reconstruct_kernel"}
              and need - need_hits <= k1["rs_bitmatrix"] <= need,
              f"degraded reads launched {step}; the layout needs {need} "
              f"K1 10->1, {need_hits} of them on chunks the cache held")
        check(k1["rs_bitmatrix"] > 0, "no read crossed a lost shard")
        log(f"filer: read all after the kill in "
            f"{out['walls_s']['degraded_read_all']:.1f} s, {k1} launches, "
            f"{need} lost intervals")

        # 300 ranges across chunk boundaries of multi-chunk files.
        multi = sorted(p for p, c in chunks.items() if len(c) > 1)
        rng = np.random.default_rng(args.seed + 14)
        ranges = []
        for _ in range(FILER_RANGES):
            path = multi[int(rng.integers(len(multi)))]
            cut = chunks[path][1 + int(rng.integers(len(chunks[path]) - 1))][1]
            lo_ = max(0, cut - int(rng.integers(1, 256 << 10)))
            hi_ = min(files[path][1], cut + int(rng.integers(1, 256 << 10))) - 1
            ranges.append((path, lo_, hi_))
        # Every chunk each range touches, once per range: a chunk the
        # cache has evicted since an earlier range is fetched again.
        range_fids = [f for path, lo_, hi_ in ranges
                      for f, o, s in chunks[path] if o <= hi_ and o + s > lo_]

        def read_range(item):
            path, lo_, hi_ = item
            off, _size = files[path]
            status, body = rpc.call_status(
                furl + path, headers={"Range": f"bytes={lo_}-{hi_}"},
                timeout=600.0)
            check(status == 206 and bytes(body)
                  == bytes(blob[off + lo_:off + hi_ + 1]),
                  f"range {lo_}-{hi_} of {path}: status {status}")

        before = cache_doc()
        wall, lat = pool_run(ranges, read_range, FILER_WRITERS)
        after = cache_doc()
        rows3 = node_device_rows(murl, live, time.time(), procs)
        step = rows_delta(rows2, rows3)
        k1 = vs_kernel_launches(step)
        need = lost_intervals(evs, lost, range_fids)
        out["range_read_ms"] = {"p50": pct_ms(lat, 50), "p99": pct_ms(lat, 99),
                                "reads": len(lat)}
        out["launches"]["range_reads"] = {
            "volume_servers": k1,
            "lost_intervals_of_chunks_touched_per_range": need,
            "chunk_cache": {"hit_bytes": after["chunk_cache"]["hit_bytes"]
                            - before["chunk_cache"]["hit_bytes"]}}
        check(set(step) <= {"reconstruct_kernel"}
              and k1["rs_bitmatrix"] <= need,
              f"range reads launched {step}; the chunks they touch hold "
              f"{need} lost intervals, counted once per range")

        # -- 7. volume.fsck through CommandEnv.filer() --------------------
        t0 = time.perf_counter()
        fsck = run_command(env, "volume.fsck -orphans")
        out["walls_s"]["fsck"] = time.perf_counter() - t0
        out["fsck"] = fsck
        check(fsck == f"checked {n_chunks} chunks, 0 missing, 0 orphans",
              f"volume.fsck: {fsck[:2000]}")
        rows4 = node_device_rows(murl, live, time.time(), procs)
        out["launches"]["fsck"] = {
            "volume_servers": vs_kernel_launches(rows_delta(rows3, rows4))}
        log(f"filer: fsck in {out['walls_s']['fsck']:.1f} s: {fsck}")

        # -- 8. ec.rebuild once the master has dropped the node, read all --
        wait_for(lambda: victim not in {
            n["url"] for n in env.data_nodes()}, "the dead-node sweep",
            procs, timeout=120.0)
        run_command(env, "lock")
        t0 = time.perf_counter()
        msg = run_command(env, "ec.rebuild")
        out["walls_s"]["rebuild"] = time.perf_counter() - t0
        run_command(env, "unlock")
        for vid, ss in lost.items():
            files_ = shard_files({n: dirs[n] for n in live}, vid)
            check(sorted(files_) == list(range(14)),
                  f"volume {vid} after rebuild: {sorted(files_)}; {msg}")
            for sid in ss:
                check(sha256_file(files_[sid][1]) == lost_sha[(vid, sid)],
                      f"rebuilt shard {vid}.{sid} differs from its original")
        rows5 = node_device_rows(murl, live, time.time(), procs)
        out["launches"]["rebuild"] = {
            "volume_servers": vs_kernel_launches(rows_delta(rows4, rows5))}
        log(f"filer: rebuilt in {out['walls_s']['rebuild']:.1f} s")

        # -- 9. fs.rm -r one directory; fsck once its deletes land -------
        gone = [p for p in files if p.startswith(FILER_RM_DIR + "/")]
        check(gone, f"nothing under {FILER_RM_DIR}")
        t0 = time.perf_counter()
        check(run_command(env, f"fs.rm -r {FILER_RM_DIR}")
              == f"removed {FILER_RM_DIR}", f"fs.rm -r {FILER_RM_DIR}")
        keep = {}
        for path, c in chunks.items():
            if path not in gone:
                for fid, _o, _s in c:
                    vid, key, _cookie = t.parse_file_id(fid)
                    keep.setdefault(vid, set()).add(key)

        def orphans() -> dict:
            return {v: len(keys - keep.get(v, set())) for v, keys in
                    VolumeFsck._live_keys(env).items()
                    if keys - keep.get(v, set())}
        try:
            wait_for(lambda: not orphans(), f"the deletes under "
                     f"{FILER_RM_DIR}", procs, timeout=120.0)
        except RuntimeError as e:
            raise RuntimeError(f"{e}: live needles no chunk names, by "
                               f"volume: {orphans()}") from None
        out["walls_s"]["rm_until_deletes_landed"] = time.perf_counter() - t0
        kept = n_chunks - sum(len(chunks[p]) for p in gone)
        out["removed"] = {"dir": FILER_RM_DIR, "files": len(gone),
                          "chunks": n_chunks - kept}

        # -- every process's memory, then the totals ----------------------
        out["rss_mib"]["filer"] = rss_mib(filer.pid)
        out["rss_mib"]["master"] = rss_mib(master.pid)
        for n in live:
            out["rss_mib"][n] = rss_mib(vs_procs[n].pid)
        out["rss_mib"]["chip_smoke"] = rss_mib(os.getpid())
        totals = {"rs_bitmatrix": 0, "rs_bitmatrix_crc": 0}
        for s in out["launches"].values():
            for k in totals:
                totals[k] += s["volume_servers"].get(k, 0)
        out["launch_totals"] = totals
        check(all(totals.values()), f"phase 12 launches {totals}")
    finally:
        for ev in evs.values():
            ev.close()
        if env is not None:
            env.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"filer cluster: {json.dumps(out['walls_s'])}")
    return out


# -- phase 13: a gateway-fronted EC cluster on the card ----------------------


def s3_identities_doc() -> dict:
    """Upstream's s3.json shape (weed s3 -config): one admin identity and
    one that may only read and list."""
    return {"identities": [
        {"name": "admin",
         "credentials": [{"accessKey": GW_ADMIN[0], "secretKey": GW_ADMIN[1]}],
         "actions": ["Admin", "Read", "Write", "List", "Tagging"]},
        {"name": "reader",
         "credentials": [{"accessKey": GW_READER[0],
                          "secretKey": GW_READER[1]}],
         "actions": ["Read", "List"]}]}


def aws_chunked(body, signed: dict, secret: str,
                chunk: int = GW_AWS_CHUNK) -> bytes:
    """`body` framed as the aws-chunked stream an SDK sends under
    STREAMING-AWS4-HMAC-SHA256-PAYLOAD: 64 KiB chunks, each with its
    signature chained from the request's seed signature, then the empty
    terminating chunk."""
    import hmac

    from seaweedfs_tpu_torch.s3api.sigv4 import derive_signing_key
    auth = signed["Authorization"]
    prev = auth.rsplit("Signature=", 1)[1]
    scope = auth.split("Credential=", 1)[1].split(",", 1)[0].split("/", 1)[1]
    date, region, service, _term = scope.split("/")
    key = derive_signing_key(secret, date, region, service)
    empty = hashlib.sha256(b"").hexdigest()
    mv = memoryview(body)
    out = bytearray()
    for off in list(range(0, len(mv), chunk)) + [len(mv)]:
        piece = mv[off:off + chunk] if off < len(mv) else b""
        sts = "\n".join(("AWS4-HMAC-SHA256-PAYLOAD", signed["x-amz-date"],
                         scope, prev, empty,
                         hashlib.sha256(piece).hexdigest()))
        prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        out += f"{len(piece):x};chunk-signature={prev}\r\n".encode()
        out += piece
        out += b"\r\n"
    return bytes(out)


class S3Client:
    """A SigV4 client of the port's S3 gateway: header auth as SDKs
    send it, with aws-chunked bodies for object and part uploads."""

    def __init__(self, url: str, access_key: str, secret_key: str):
        self.url, self.ak, self.sk = url, access_key, secret_key

    def call(self, method: str, path: str, query: str = "",
             body: bytes = b"", headers: dict | None = None,
             streaming: bool = False):
        from seaweedfs_tpu_torch.cluster import rpc
        from seaweedfs_tpu_torch.s3api.sigv4 import sign_request
        url = self.url + urllib.parse.quote(path) + (
            f"?{query}" if query else "")
        hdrs = dict(headers or {})
        if streaming:
            hdrs["Content-Encoding"] = "aws-chunked"
            hdrs["x-amz-decoded-content-length"] = str(len(body))
            signed = sign_request(
                method, url, hdrs, b"", self.ak, self.sk,
                payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
            body = aws_chunked(body, signed, self.sk)
        else:
            signed = sign_request(method, url, hdrs, body, self.ak, self.sk)
        signed.pop("Host")  # the rpc layer sends the same Host line
        return rpc.call_status(url, method, body or None, timeout=600.0,
                               headers=signed)


def s3_event_records(data: bytes) -> bytes:
    """The Records payload of an AWS event stream (S3 Select's answer),
    every frame's prelude and message CRC checked."""
    import struct
    import zlib
    out = bytearray()
    pos = 0
    while pos < len(data):
        total, hlen = struct.unpack_from(">II", data, pos)
        check(struct.unpack_from(">I", data, pos + 8)[0]
              == zlib.crc32(data[pos:pos + 8]), "event-stream prelude CRC")
        check(struct.unpack_from(">I", data, pos + total - 4)[0]
              == zlib.crc32(data[pos:pos + total - 4]),
              "event-stream message CRC")
        raw = data[pos + 12:pos + 12 + hlen]
        etype, hp = None, 0
        while hp < len(raw):
            nlen = raw[hp]
            name = raw[hp + 1:hp + 1 + nlen].decode()
            vlen = struct.unpack_from(">H", raw, hp + 2 + nlen)[0]
            if name == ":event-type":
                etype = raw[hp + 4 + nlen:hp + 4 + nlen + vlen].decode()
            hp += 4 + nlen + vlen
        if etype == "Records":
            out += data[pos + 12 + hlen:pos + total - 4]
        pos += total
    return bytes(out)


def csv_object(rng, target: int) -> bytes:
    """A seeded CSV of just under `target` bytes: a header and rows of
    id, name, score (0..999) and a padding field."""
    rows = ["id,name,score,note"]
    size = len(rows[0]) + 1
    i = 0
    while True:
        row = (f"{i},user{int(rng.integers(1 << 20))},"
               f"{int(rng.integers(1000))},{'x' * int(rng.integers(8, 64))}")
        if size + len(row) + 1 > target:
            break
        rows.append(row)
        size += len(row) + 1
        i += 1
    return ("\n".join(rows) + "\n").encode()


def plain_select(data: bytes, floor: int) -> bytes:
    """GW_SELECT over one CSV object by Python's csv module: the rows
    whose score is above `floor`, projected to id and score, as the
    engine's JSON lines."""
    import csv
    import io
    rows = csv.DictReader(io.StringIO(data.decode()))
    return b"".join(
        json.dumps({"id": r["id"], "score": r["score"]},
                   separators=(",", ":")).encode() + b"\n"
        for r in rows if float(r["score"]) > floor)


def gateway_data(seed: int, limit_mb: int, small_div: int = 1) -> dict:
    """The seeded data of phase 13, scaled by the volume limit over
    1024 MiB: S3 objects (large log-uniform GW_LARGE_RANGE, multipart
    uploads in GW_PART_MIB parts, small ones, CSV objects), WebDAV files
    two levels deep, the messages' count, the WFS file and the local
    tree filer.copy uploads.  Payloads are slices of one random blob.
    `small_div` divides the small objects and the messages."""
    rng = np.random.default_rng(seed + 130)
    scale = limit_mb / 1024
    blob_bytes = GW_BLOB_MIB * MIB
    blob = memoryview(rng.bytes(blob_bytes))

    def logu(lo, hi):
        return int(math.exp(rng.uniform(math.log(lo), math.log(hi))))

    def sized(n):
        return int(rng.integers(blob_bytes - n)), n
    large: dict = {}
    total, i = 0, 0
    lo, hi = GW_LARGE_RANGE
    hi = min(hi, limit_mb * MIB // 8)
    while total < GW_LARGE_MIB * MIB * scale:
        size = logu(lo, hi)
        large[f"large/{i % 16:02d}/obj{i:05d}.bin"] = sized(size)
        total += size
        i += 1
    part = max(int(GW_PART_MIB * MIB * scale), 5 << 20) \
        if scale >= 1 else max(int(GW_PART_MIB * MIB * scale), 256 << 10)
    multipart = {f"multi/mp{j}.bin": [sized(part) for _ in range(
        GW_MULTIPART_MIB // GW_PART_MIB)] for j in range(GW_MULTIPARTS)}
    lo, hi = GW_SMALL_RANGE
    small = {f"small/{j % 64:02d}/s{j:05d}.bin": sized(logu(lo, hi))
             for j in range(max(int(GW_SMALL * scale) // small_div, 100))}
    csv_size = min(GW_CSV_MIB * MIB, max(int(GW_CSV_MIB * MIB * scale),
                                         256 << 10)) - 4096
    csvs = {f"csv/c{j:02d}.csv": csv_object(rng, csv_size)
            for j in range(max(int(GW_CSVS * scale), 2))}
    dav: dict = {}
    total, i = 0, 0
    lo, hi = GW_DAV_RANGE
    dirs = [f"/dav/d{a}/e{b}" for a in range(GW_DAV_DIRS[0])
            for b in range(GW_DAV_DIRS[1])]
    while total < GW_DAV_MIB * MIB * scale:
        size = logu(lo, hi)
        dav[f"{dirs[i % len(dirs)]}/f{i:04d}.bin"] = sized(size)
        total += size
        i += 1
    lo, hi = GW_COPY_RANGE
    copy = {f"t{j % 8}/f{j:03d}.bin": sized(logu(lo, hi))
            for j in range(GW_COPY_FILES)}
    wfs_size = max(int(GW_WFS_MIB * MIB * scale), 4 * GW_WFS_WRITE)
    wfs_blocks = list(range(wfs_size // GW_WFS_WRITE))
    rng.shuffle(wfs_blocks)
    return {"blob": blob, "large": large, "multipart": multipart,
            "small": small, "csv": csvs, "dav": dav, "dav_dirs": dirs,
            "copy": copy,
            "messages": max(int(GW_MESSAGES * scale) // small_div, 500),
            "wfs_size": wfs_size, "wfs_order": wfs_blocks,
            "wfs_base": int(rng.integers(blob_bytes - wfs_size))}


def webdav_names(durl: str, path: str) -> set:
    """PROPFIND Depth: 1 of a WebDAV collection: its members' names
    (a collection's ending in /)."""
    import xml.etree.ElementTree as ET

    from seaweedfs_tpu_torch.cluster import rpc
    status, body = rpc.call_status(durl + path + "/", "PROPFIND",
                                   headers={"Depth": "1"}, timeout=60.0)
    check(status == 207, f"PROPFIND {path}: {status}")
    out = set()
    for r in ET.fromstring(bytes(body)).iter("{DAV:}response"):
        href = urllib.parse.unquote(r.find("{DAV:}href").text)
        if href.rstrip("/") == path.rstrip("/"):
            continue
        name = href.rstrip("/").rsplit("/", 1)[1]
        out.add(name + ("/" if href.endswith("/") else ""))
    return out


def namespace_keys(proxy) -> dict:
    """{volume id: needle ids} the chunks of every entry of the filer's
    namespace name (volume.fsck's walk: every directory from /, each
    file's metadata on GW_WRITERS threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch.core import types as t
    files, stack = [], ["/"]
    while stack:
        d = stack.pop()
        for e in proxy.list_all(d):
            (stack if e["is_directory"] else files).append(e["FullPath"])
    with ThreadPoolExecutor(GW_WRITERS) as pool:
        metas = list(pool.map(proxy.meta, files))
    out: dict = {}
    for meta in metas:
        for c in (meta or {}).get("chunks", []):
            vid, key, _cookie = t.parse_file_id(c["file_id"])
            out.setdefault(vid, set()).add(key)
    return out


def _x4_rank(rank: int, world: int, port: int, dev_type: str, seed: int,
             width: int, out_dir: str) -> None:
    """One rank of phase 13's X4 step, in a gloo group on localhost: it
    makes the seeded survivors itself, encodes them and takes
    batched_reconstruct's answer on its device (the single-device
    reference), then runs each X4 function once; its wall, this rank's
    K1 launches inside it and whether its column block equals the
    reference's go to <out_dir>/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from seaweedfs_tpu_torch.ops.coder_cuda import apply_bitmatrix
    from seaweedfs_tpu_torch.parallel import sharded_codec as sc
    dev = torch.device(dev_type, 0) if dev_type == "cuda" \
        else torch.device("cpu")
    rng = np.random.default_rng(seed + 140)
    data = torch.from_numpy(rng.integers(0, 256, (X4_VOLUMES, 10, width),
                                         dtype=np.uint8)).to(dev)
    shards = torch.cat([data, sc.batched_encode(data, device=dev)], dim=1)
    present = tuple(s for s in range(14) if s not in X4_LOST)
    stacked = shards[:, list(present[:10])].contiguous()
    want = sc.batched_reconstruct(stacked, present, X4_LOST, device=dev)
    report = {"reference_equals_shards": bool(torch.equal(
        want, shards[:, list(X4_LOST)]))}
    chunk = width // world
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        for name in ("all_to_all_reconstruct", "ring_reconstruct"):
            n0 = apply_bitmatrix.launches
            dist.barrier()
            t0 = time.perf_counter()
            local = getattr(sc, name)(stacked, present, X4_LOST, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
            report[name] = {
                "wall_s": time.perf_counter() - t0,
                "k1_launches": apply_bitmatrix.launches - n0,
                "equal": bool(torch.equal(
                    local, want[:, :, rank * chunk:(rank + 1) * chunk]))}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def phase_x4(torch, dev, seed: int, width: int, work: str) -> dict:
    """X4 on one card: X4_RANKS gloo ranks (NCCL refuses two ranks on one
    device) run all_to_all_reconstruct and ring_reconstruct on seeded
    (X4_VOLUMES, 10, width) survivors of X4_LOST lost shards, each
    rank's K1 on `dev` and the exchange through host tensors; every
    rank's column block must be byte-equal to batched_reconstruct of the
    same survivors on `dev`, and launch one K1 per function on the
    card."""
    import torch.multiprocessing as mp

    from seaweedfs_tpu_torch.cluster import rpc
    out_dir = os.path.join(work, "x4")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(_x4_rank, args=(X4_RANKS, rpc.free_port(), dev.type, seed,
                             width, out_dir), nprocs=X4_RANKS, join=True)
    reports = []
    for r in range(X4_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    out = {"ranks": X4_RANKS, "backend": "gloo",
           "shape": [X4_VOLUMES, 10, width], "lost": list(X4_LOST),
           "spawn_and_run_s": time.perf_counter() - t0,
           "wall_s": {}, "k1_launches": {}}
    check(all(r["reference_equals_shards"] for r in reports),
          "batched_reconstruct differs from the encoded shards")
    for name in ("all_to_all_reconstruct", "ring_reconstruct"):
        check(all(r[name]["equal"] for r in reports),
              f"X4 {name} differs from batched_reconstruct")
        out["wall_s"][name] = max(r[name]["wall_s"] for r in reports)
        launches = [r[name]["k1_launches"] for r in reports]
        out["k1_launches"][name] = launches
        if dev.type == "cuda":
            check(launches == [1] * X4_RANKS,
                  f"X4 {name}: K1 launches per rank {launches}")
    return out


def phase_gateway_cluster(torch, dev, args) -> dict:
    """Phase 13: S3, WebDAV and the message broker in front of a filer
    and a live EC cluster on the card's host, every role a `python -m
    seaweedfs_tpu_torch` process, plus the mount's WFS in this process
    and `filer.copy`/`filer.replicate` processes: write seeded data
    through each gateway, list it, query a CSV needle, ec.encode in the
    holders (K2), kill -9 a holder, read everything back through every
    gateway (K1 in the survivors, counted per pass and reconciled with
    the lost intervals read and the filer's cache hits), ec.rebuild,
    volume.fsck -orphans, then X4 on the card."""
    from seaweedfs_tpu_torch.cluster import rpc
    from seaweedfs_tpu_torch.core import types as t
    from seaweedfs_tpu_torch.ec.volume import EcVolume
    from seaweedfs_tpu_torch.filer.client import FilerProxy
    from seaweedfs_tpu_torch.messaging import MessagingClient
    from seaweedfs_tpu_torch.mount.vfs import WFS
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.storage import chunk_cache

    t_phase = time.perf_counter()
    launch = gateway_launch()
    watch_rpc(rpc, RPC_FAILS.append)
    fails_before = len(RPC_FAILS)
    limit_mb = args.gateway_mib
    limit = limit_mb * MIB
    work = os.path.join(REPO, "_smoke_work", "gateway")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dev_flag = f"-device={dev.type}"
    procs: list = []
    env = None
    wfs = None
    evs: dict = {}
    out: dict = {"reduced": {"volume_size_limit_mb": [30000, limit_mb],
                             "hosts": [GW_NODES + 5, 1],
                             "broker_messages": [100000, GW_MESSAGES],
                             "x4": "gloo over 2 ranks on one card (NCCL "
                                   "refuses two ranks on one device); the "
                                   "exchange through host tensors"},
                 "walls_s": {}, "gb_s": {}, "launches": {}, "rss_mib": {}}
    try:
        ports = {r: rpc.free_port() for r in
                 ("master", "filer", "s3", "webdav", "broker")}
        murl, furl, s3url, durl, burl = (
            f"http://127.0.0.1:{ports[r]}" for r in
            ("master", "filer", "s3", "webdav", "broker"))
        master = port_process(
            ["master", f"-port={ports['master']}", f"-mdir={work}/master",
             f"-volumeSizeLimitMB={limit_mb}",
             f"-defaultReplication={GW_REPLICATION}"],
            os.path.join(work, "master.log"), launch)
        procs.append(master)
        wait_for(lambda: rpc.call(murl + "/dir/status", timeout=2.0),
                 "the master", procs)
        dirs: dict = {}
        vs_procs: dict = {}
        for i in range(GW_NODES):
            port = rpc.free_port()
            node = f"127.0.0.1:{port}"
            dirs[node] = os.path.join(work, f"vs{i}")
            os.makedirs(dirs[node])
            vs_procs[node] = port_process(
                ["volume", dev_flag, f"-port={port}", f"-dir={dirs[node]}",
                 f"-max={GW_MAX_VOLUMES}",
                 f"-mserver=127.0.0.1:{ports['master']}", "-dataCenter=dc1",
                 f"-rack=rack{i * GW_RACKS // GW_NODES}"],
                os.path.join(work, f"vs{i}.log"), launch)
            procs.append(vs_procs[node])
        filer = port_process(
            ["filer", f"-port={ports['filer']}",
             f"-master=127.0.0.1:{ports['master']}", f"-dir={work}/filer",
             f"-collection={GW_COLLECTION}"],
            os.path.join(work, "filer.log"), launch)
        procs.append(filer)
        wait_for(lambda: len(rpc.call_status(
            murl + "/cluster/healthz", timeout=2.0)[1]["nodes"])
            == GW_NODES, f"{GW_NODES} volume servers", procs)
        wait_for(lambda: rpc.call(furl + "/", timeout=2.0), "the filer",
                 procs)
        # The volume the first writes fill, grown before any writer
        # (the broker's registration is the first) asks for one; then
        # the gateways, once the filer they front serves.
        rpc.call(f"{murl}/vol/grow?count={GW_PREGROW}"
                 f"&collection={GW_COLLECTION}", "POST")
        with open(os.path.join(work, "s3.json"), "w") as f:
            json.dump(s3_identities_doc(), f)
        gw_args = {
            "s3": ["s3", f"-port={ports['s3']}",
                   f"-filer=127.0.0.1:{ports['filer']}",
                   f"-config={work}/s3.json"],
            "webdav": ["webdav", f"-port={ports['webdav']}",
                       f"-filer=127.0.0.1:{ports['filer']}"],
            "broker": ["msg.broker", f"-port={ports['broker']}",
                       f"-filer=127.0.0.1:{ports['filer']}"]}
        gw = {r: port_process(a, os.path.join(work, f"{r}.log"), launch)
              for r, a in gw_args.items()}
        procs.extend(gw.values())
        wait_for(lambda: rpc.call_status(s3url + "/", timeout=2.0)[0]
                 and rpc.call_status(durl + "/", "OPTIONS",
                                     timeout=2.0)[0] == 200
                 and rpc.call(burl + "/status", timeout=2.0),
                 "the gateways", procs)
        out["startup_s"] = time.perf_counter() - t_phase
        admin = S3Client(s3url, *GW_ADMIN)
        reader = S3Client(s3url, *GW_READER)
        proxy = FilerProxy(furl)
        vs_nodes = list(vs_procs)
        rows: dict = {}  # each volume server's ledger rows at the last step
        steps_rows: dict = {}

        def step_rows(name, nodes):
            """K1/K2 launches in the volume servers since the last step,
            from a beat after this one."""
            nonlocal rows
            now = node_device_rows(murl, nodes, time.time(), procs)
            steps_rows[name] = rows_delta({n: rows[n] for n in nodes}, now)
            rows = {**rows, **now}
            return vs_kernel_launches(steps_rows[name])

        # -- 1. write: S3, WebDAV, the broker, the WFS file, filer.copy --
        small_div = getattr(args, "gateway_small_div", 1)
        if small_div > 1:
            out["reduced"]["small_objects_and_messages_divided_by"] = \
                small_div
        data = gateway_data(args.seed, limit_mb, small_div)
        blob = data["blob"]
        acked: dict = {}  # filer path -> sha256 of what was acknowledged
        check(admin.call("PUT", f"/{GW_BUCKET}")[0] == 200,
              "create bucket")
        objects = {**{k: bytes(blob[o:o + s]) for k, (o, s) in
                      data["large"].items()}}

        def s3_put(item):
            key, body = item
            status, resp = admin.call("PUT", f"/{GW_BUCKET}/{key}",
                                      body=body, streaming=True)
            check(status == 200, f"PUT {key}: {status} {resp!r:.200}")
            acked[f"/buckets/{GW_BUCKET}/{key}"] = \
                hashlib.sha256(body).hexdigest()

        large_bytes = sum(len(b) for b in objects.values())
        wall, lat = pool_run(sorted(objects.items()), s3_put, GW_WRITERS)
        out["walls_s"]["s3_put_large"] = wall
        out["gb_s"]["s3_put_large"] = large_bytes / wall / 1e9
        out["s3_put_large_ms"] = {"p50": pct_ms(lat, 50),
                                  "p99": pct_ms(lat, 99)}

        def multipart(item):
            key, parts = item
            status, resp = admin.call("POST", f"/{GW_BUCKET}/{key}",
                                      "uploads")
            check(status == 200, f"initiate {key}: {status}")
            upload = re.search(rb"<UploadId>([^<]+)</UploadId>",
                               bytes(resp)).group(1).decode()
            body = b""
            xml = ["<CompleteMultipartUpload>"]
            for n, (o, s) in enumerate(parts, 1):
                piece = bytes(blob[o:o + s])
                status, _r = admin.call(
                    "PUT", f"/{GW_BUCKET}/{key}",
                    f"partNumber={n}&uploadId={upload}", piece,
                    streaming=True)
                check(status == 200, f"part {n} of {key}: {status}")
                xml.append(f"<Part><PartNumber>{n}</PartNumber><ETag>"
                           f"\"{hashlib.md5(piece).hexdigest()}\"</ETag>"
                           "</Part>")
                body += piece
            xml.append("</CompleteMultipartUpload>")
            status, resp = admin.call("POST", f"/{GW_BUCKET}/{key}",
                                      f"uploadId={upload}",
                                      "".join(xml).encode())
            check(status == 200 and b"CompleteMultipartUploadResult"
                  in bytes(resp), f"complete {key}: {status}")
            objects[key] = body
            acked[f"/buckets/{GW_BUCKET}/{key}"] = \
                hashlib.sha256(body).hexdigest()

        mp_bytes = sum(s for parts in data["multipart"].values()
                       for _o, s in parts)
        wall, _lat = pool_run(sorted(data["multipart"].items()), multipart,
                              GW_MULTIPARTS)
        out["walls_s"]["s3_multipart"] = wall
        out["gb_s"]["s3_multipart"] = mp_bytes / wall / 1e9
        small = {k: bytes(blob[o:o + s]) for k, (o, s) in
                 data["small"].items()}
        objects.update(small)
        wall, lat = pool_run(sorted(small.items()), s3_put, GW_WRITERS)
        out["walls_s"]["s3_put_small"] = wall
        out["s3_small_puts_per_s"] = len(small) / wall
        out["s3_put_small_ms"] = {"p50": pct_ms(lat, 50),
                                  "p99": pct_ms(lat, 99)}
        objects.update(data["csv"])
        wall, _lat = pool_run(sorted(data["csv"].items()), s3_put,
                              GW_WRITERS)
        out["walls_s"]["s3_put_csv"] = wall
        s3_bytes = sum(len(b) for b in objects.values())
        log(f"gateway: {len(objects)} S3 objects, {s3_bytes / MIB:.0f} MiB "
            f"(large {out['gb_s']['s3_put_large']:.3f} GB/s, multipart "
            f"{out['gb_s']['s3_multipart']:.3f}, small "
            f"{out['s3_small_puts_per_s']:.0f} /s)")

        # WebDAV: MKCOL the tree, PUT the files.
        dav_dirs = sorted({"/dav"} | {d.rsplit("/", 1)[0]
                                      for d in data["dav_dirs"]}
                          | set(data["dav_dirs"]))
        for d in dav_dirs:
            check(rpc.call_status(durl + d, "MKCOL", timeout=60.0)[0] == 201,
                  f"MKCOL {d}")
        dav_bytes = sum(s for _o, s in data["dav"].values())

        def dav_put(path):
            o, s = data["dav"][path]
            body = bytes(blob[o:o + s])
            status, _r = rpc.call_status(durl + path, "PUT", body,
                                         timeout=600.0)
            check(status in (200, 201, 204), f"WebDAV PUT {path}: {status}")
            acked[path] = hashlib.sha256(body).hexdigest()

        wall, _lat = pool_run(sorted(data["dav"]), dav_put, GW_WRITERS)
        out["walls_s"]["webdav_put"] = wall
        out["gb_s"]["webdav_put"] = dav_bytes / wall / 1e9

        # The broker: a 4-partition topic, 1 KiB messages from 8 threads.
        client = MessagingClient(burl)
        client.configure_topic(GW_NS, GW_TOPIC,
                               partition_count=GW_PARTITIONS)
        published: dict = {p: [] for p in range(GW_PARTITIONS)}
        plock = threading.Lock()

        def publish(i):
            o = (i * 7919) % (blob.nbytes - GW_MESSAGE_BYTES)
            value = bytes(blob[o:o + GW_MESSAGE_BYTES])
            ack = MessagingClient(burl).publish(GW_NS, GW_TOPIC, value,
                                                key=f"k{i}")
            with plock:
                published[ack["partition"]].append(
                    (ack["ts_ns"], f"k{i}",
                     hashlib.sha256(value).hexdigest()))

        wall, _lat = pool_run(range(data["messages"]), publish, GW_WRITERS)
        out["walls_s"]["broker_publish"] = wall
        out["broker_publish_per_s"] = data["messages"] / wall

        # The mount's WFS in this process: one file in 1 MiB writes at
        # random offsets.
        wfs = WFS(furl, collection=GW_COLLECTION)
        wfs.start()
        wfs.mkdir("/mnt")
        fh = wfs.create("/mnt/wfs.bin")
        base = data["wfs_base"]
        t0 = time.perf_counter()
        for b in data["wfs_order"]:
            off = b * GW_WFS_WRITE
            wfs.write(fh, bytes(blob[base + off:base + off + GW_WFS_WRITE]),
                      off)
        wfs.flush(fh)
        wfs.release(fh)
        out["walls_s"]["wfs_write"] = time.perf_counter() - t0
        wfs_body = bytes(blob[base:base + data["wfs_size"]])
        acked["/mnt/wfs.bin"] = hashlib.sha256(wfs_body).hexdigest()
        wfs.stop()
        wfs = None

        # filer.copy of a seeded local tree, as a process.
        src = os.path.join(work, "copy_src", "tree")
        for rel, (o, s) in data["copy"].items():
            os.makedirs(os.path.dirname(os.path.join(src, rel)),
                        exist_ok=True)
            with open(os.path.join(src, rel), "wb") as f:
                f.write(blob[o:o + s])
        text, wall, _rss = run_port(
            ["filer.copy", f"-filer=127.0.0.1:{ports['filer']}", src,
             "/copied/"], os.path.join(work, "filer-copy.log"),
            launch, procs, stall=30.0)
        check(f"copied {len(data['copy'])} files" in text,
              f"filer.copy: {text[-500:]}")
        out["walls_s"]["filer_copy"] = wall
        for rel, (o, s) in data["copy"].items():
            acked[f"/copied/tree/{rel}"] = hashlib.sha256(
                blob[o:o + s]).hexdigest()
        out["written"] = {
            "s3_objects": len(objects), "s3_bytes": s3_bytes,
            "multipart_uploads": len(data["multipart"]),
            "webdav_files": len(data["dav"]), "webdav_bytes": dav_bytes,
            "messages": data["messages"], "wfs_bytes": data["wfs_size"],
            "copied_files": len(data["copy"])}
        log(f"gateway: wrote {json.dumps(out['written'])}")

        # -- 2. listings and the read-only identity -----------------------
        import xml.etree.ElementTree as ET
        ns3 = "{http://s3.amazonaws.com/doc/2006-03-01/}"
        t0 = time.perf_counter()
        listed: dict = {}
        token, pages = "", 0
        while True:
            q = "list-type=2&max-keys=1000" + (
                f"&continuation-token={urllib.parse.quote(token)}"
                if token else "")
            status, body = admin.call("GET", f"/{GW_BUCKET}", q)
            check(status == 200, f"ListObjectsV2: {status}")
            root = ET.fromstring(bytes(body))
            pages += 1
            for c in root.iter(f"{ns3}Contents"):
                listed[c.find(f"{ns3}Key").text] = \
                    int(c.find(f"{ns3}Size").text)
            if root.find(f"{ns3}IsTruncated").text != "true":
                break
            token = root.find(f"{ns3}NextContinuationToken").text
        out["walls_s"]["list_objects_v2"] = time.perf_counter() - t0
        check(listed == {k: len(b) for k, b in objects.items()},
              f"ListObjectsV2: {len(listed)} keys, "
              f"{len(set(listed) ^ set(objects))} differ from the writes")
        out["list_objects_v2"] = {"keys": len(listed), "pages": pages}
        expected: dict = {}
        for path in [*data["dav"], *(d + "/" for d in dav_dirs)]:
            parts = path.rstrip("/").split("/")[1:]
            for k in range(1, len(parts)):
                parent = "/" + "/".join(parts[:k])
                expected.setdefault(parent, set()).add(parts[k] + (
                    "/" if k < len(parts) - 1 or path.endswith("/")
                    else ""))
        t0 = time.perf_counter()
        for d, names in sorted(expected.items()):
            got = webdav_names(durl, d)
            check(got == names, f"PROPFIND {d}: {len(got ^ names)} names "
                                f"differ from the writes")
        out["walls_s"]["propfind"] = time.perf_counter() - t0
        status, _r = reader.call("PUT", f"/{GW_BUCKET}/denied.bin",
                                 body=b"no", streaming=True)
        check(status == 403, f"read-only PUT answered {status}")
        small_key = sorted(small)[0]
        status, body = reader.call("GET", f"/{GW_BUCKET}/{small_key}")
        check(status == 200 and bytes(body) == small[small_key],
              f"read-only GET: {status}")
        out["readonly_put_status"] = 403

        # -- 3. flush the broker; the volume Query RPC on a CSV needle ----
        def stop_broker() -> None:
            """SIGTERM the broker (it flushes its partition tails to the
            filer and removes its registration), then wait until the
            filer's background pump (one tick a second, in order) has
            deleted the registration's last chunk: every earlier delete
            of its rewrites has landed by then, before a volume is
            sealed for the encode or fsck counts orphans."""
            registration = (f"/topics/.system/brokers/"
                            f"{urllib.parse.urlsplit(burl).netloc}")
            fids = [c["file_id"] for c in
                    (proxy.meta(registration) or {}).get("chunks", [])]
            gw["broker"].terminate()
            check(gw["broker"].wait(60) == 0,
                  "the broker did not stop cleanly")
            procs.remove(gw["broker"])

            def gone():
                for fid in fids:
                    vid_ = t.parse_file_id(fid)[0]
                    url = rpc.call(f"{murl}/dir/lookup?volumeId={vid_}")[
                        "locations"][0]["url"]
                    if rpc.call_status(f"http://{url}/{fid}",
                                       timeout=10.0)[0] != 404:
                        return False
                return True
            wait_for(gone, "the delete of the broker's registration", procs)

        stop_broker()
        path = f"/buckets/{GW_BUCKET}/csv/c00.csv"
        meta = proxy.meta(path)
        check(len(meta["chunks"]) == 1, f"{path}: {len(meta['chunks'])} "
                                        "chunks")
        fid = meta["chunks"][0]["file_id"]
        vid = t.parse_file_id(fid)[0]
        holder = rpc.call(f"{murl}/dir/lookup?volumeId={vid}")[
            "locations"][0]["url"]
        t0 = time.perf_counter()
        got = rpc.call(f"http://{holder}/query", "POST", json.dumps({
            "fid": fid, "query": GW_SELECT, "input_format": "csv",
            "csv_header": True}).encode(), timeout=120.0)
        out["walls_s"]["volume_query"] = time.perf_counter() - t0
        want = plain_select(data["csv"]["csv/c00.csv"], GW_SELECT_FLOOR)
        check(bytes(got) == want, "volume Query differs from the plain "
                                  "evaluation of the same SELECT")
        out["volume_query"] = {"fid": fid, "rows": want.count(b"\n")}

        # -- every entry's chunks, the volumes that hold them ------------
        spans: dict = {}  # path -> its chunks' (file id, offset, size)

        def meta_of(path):
            doc = proxy.meta(path)
            check(doc is not None, f"{path}: no entry")
            spans[path] = sorted(((c["file_id"], c["offset"], c["size"])
                                  for c in doc["chunks"]),
                                 key=lambda c: c[1])

        seg_paths = []
        for p in range(GW_PARTITIONS):
            d = f"/topics/{GW_NS}/{GW_TOPIC}/{p:04d}"
            seg_paths += [f"{d}/{e['name']}" for e in proxy.list_all(d)
                          if e["name"].endswith(".seg")]
        pool_run(sorted(acked) + seg_paths, meta_of, GW_WRITERS)
        chunks = {p: [f for f, _o, _s in c] for p, c in spans.items()}
        named = namespace_keys(proxy)
        vids = sorted(named)

        # -- 4. lock; ec.encode (K2 in the holders) -----------------------
        env = CommandEnv(murl, filer_url=furl, device=dev)
        reference, ref_k = encode_sealed_copies(env, vids, work, dev)
        dat_bytes = {v: reference[v]["dat_bytes"] for v in vids}
        full = [v for v in vids
                if dat_bytes[v] >= limit * GW_FULL_PERCENT / 100]
        check(len(full) >= 1, f"no volume filled: {dat_bytes}")
        out["volumes"] = {"encoded": vids, "full": full,
                          "dat_bytes": {str(v): n
                                        for v, n in dat_bytes.items()}}
        want_k2 = sum(k.get("rs_bitmatrix_crc", 0) for k in ref_k.values())
        want_k1 = sum(k.get("rs_bitmatrix", 0) for k in ref_k.values())
        rows = node_device_rows(murl, vs_nodes, time.time(), procs)
        shell_out, wall, _rss = run_port(
            ["shell", dev_flag, f"-master=127.0.0.1:{ports['master']}",
             "lock", "ec.encode -volumeId " + ",".join(map(str, vids))],
            os.path.join(work, "shell-encode.log"), launch, procs)
        for v in vids:
            check(f"volume {v} -> ec shards" in shell_out,
                  f"shell ec.encode: {shell_out[-2000:]}")
        out["walls_s"]["encode"] = wall
        out["gb_s"]["encode"] = sum(dat_bytes.values()) / wall / 1e9
        got = step_rows("encode", vs_nodes)
        out["launches"]["encode"] = {"volume_servers": got}
        check(set(steps_rows["encode"]) <= {"encode_crc_kernel",
                                            "encode_kernel"}
              and got == {"rs_bitmatrix": want_k1,
                          "rs_bitmatrix_crc": want_k2},
              f"encode rows {steps_rows['encode']}, expected K2 {want_k2} "
              f"and K1 {want_k1} (write_ec_files of the same .dat here)")
        check(want_k2 > 0, "the holders' encode launched no K2")
        holders, ecc_checked = check_encoded_shards(env, dirs, reference)
        out["shards_checked"] = 14 * len(vids)
        out["ecc_entries_checked"] = ecc_checked
        log(f"gateway: encoded {vids} (full {full}) in {wall:.1f} s, "
            f"{want_k2} K2 in the holders")

        # -- 5. kill -9 a holder of 3 or more shards of a volume ----------
        def held(node):
            return {v: sorted(s for s, n in holders[v].items() if n == node)
                    for v in vids}
        victim = max(vs_nodes, key=lambda n: (
            max(len(s) for s in held(n).values()),
            sum(len(s) for s in held(n).values())))
        lost = {v: s for v, s in held(victim).items() if s}
        check(max(map(len, lost.values())) >= 3,
              f"no holder has 3 shards of a volume: {lost}")
        out["killed"] = {"node": victim,
                         "shards": {str(v): s for v, s in lost.items()}}
        lost_sha = {(v, s): reference[v]["shards"][s]
                    for v, ss in lost.items() for s in ss}
        vs_procs[victim].kill()
        vs_procs[victim].wait(30)
        procs.remove(vs_procs[victim])
        live = [n for n in vs_nodes if n != victim]
        evs = {v: EcVolume(reference[v]["base"], vid=v, device=dev)
               for v in vids}
        # New writes (the broker's registration) must not land on the
        # dead node's volumes: wait for the master's sweep first.
        wait_for(lambda: victim not in {
            n["url"] for n in env.data_nodes()}, "the dead-node sweep",
            procs, timeout=120.0)

        def cache_doc():
            return rpc.call(furl + "/debug/cache?fids=1", timeout=60.0)

        filer_node = furl.split("//")[1]

        def wire_snapshot():
            """Requests in by purpose, of the filer and of the survivors
            together, and the survivors' answers by status class."""
            vs_in: dict = {}
            vs_ans: dict = {}
            for n in live:
                for p, (b, k) in inbound_flows(n).items():
                    row = vs_in.setdefault(p, [0, 0])
                    row[0] += b
                    row[1] += k
                for c, k in answer_classes(n, "volumeServer").items():
                    vs_ans[c] = vs_ans.get(c, 0) + k
            return {"volume_in": vs_in, "volume_answers": vs_ans,
                    "filer_in": inbound_flows(filer_node)}

        def wire_delta(a, b):
            return {"volume_in": flows_delta(a["volume_in"], b["volume_in"]),
                    "volume_answers": {
                        c: k - a["volume_answers"].get(c, 0)
                        for c, k in b["volume_answers"].items()
                        if k != a["volume_answers"].get(c, 0)},
                    "filer_in": flows_delta(a["filer_in"], b["filer_in"])}

        def degraded_pass(name, fids, items, work_fn):
            """One gateway's read pass after the kill: K1 in the
            survivors from a beat after it, reconciled with the lost
            intervals of the chunks it reads (and of the GETs the
            survivors took beyond those reads), less those the filer's
            chunk cache held before it."""
            before = cache_doc()
            resident = {f for f, _n in before["resident"]}
            need = lost_intervals(evs, lost, fids)
            need_hits = lost_intervals(evs, lost,
                                       [f for f in fids if f in resident])
            # Each lost interval of a chunk the cache did not hold is
            # rebuilt at least once; a chunk read twice in the pass may
            # be a hit the second time.
            need_first = lost_intervals(evs, lost, set(fids) - resident)
            wire0 = wire_snapshot()
            wall, lat = pool_run(items, work_fn, GW_WRITERS)
            after = cache_doc()
            wire = wire_delta(wire0, wire_snapshot())
            wire.update(chunk_reads=len(fids), chunks_read=len(set(fids)),
                        chunks_uncached=len(set(fids) - resident))
            k1 = step_rows(name, live)
            hits = {"hit_bytes": after["chunk_cache"]["hit_bytes"]
                    - before["chunk_cache"]["hit_bytes"],
                    "resident_chunks_before": len(resident & set(fids)),
                    "lost_intervals_of_resident_chunks": need_hits}
            out["launches"][name] = {"volume_servers": k1,
                                     "lost_intervals_read": need,
                                     "lost_intervals_uncached": need_first,
                                     "chunk_cache": hits, "wire": wire}
            out["walls_s"][name] = wall
            check(set(steps_rows[name]) <= {"reconstruct_kernel"},
                  f"{name}: rows {steps_rows[name]}")
            # A chunk the survivors were asked for more often than the
            # pass reads it (a repeated or retried GET: the broker's tail
            # reads ask for their segments' chunks again, 44 GETs for 16
            # chunk reads at the halved data on an H100) is rebuilt
            # again: count that work, at most the most lost intervals a
            # chunk of the pass holds per repeated GET.
            repeats = max(0, wire["volume_in"].get("proxy", [0, 0])[1]
                          - len(fids))
            most = max((lost_intervals(evs, lost, [f]) for f in set(fids)),
                       default=0)
            wire.update(repeated_gets=repeats,
                        most_lost_intervals_per_chunk=most)
            lo_ok = k1["rs_bitmatrix"] >= need_first
            hi_ok = k1["rs_bitmatrix"] <= need + repeats * most
            check(lo_ok and hi_ok,
                  f"{name}: {k1['rs_bitmatrix']} K1 in the survivors; the "
                  f"chunks read hold {need} lost intervals, {need_first} "
                  f"on chunks the cache did not hold, {repeats} repeated "
                  f"GETs of at most {most}; wire {wire}")
            check(need_first == 0 or k1["rs_bitmatrix"] > 0,
                  f"{name}: no K1 for {need_first} lost intervals of "
                  f"chunks the cache did not hold")
            return wall, lat

        # -- 6. read everything back through every gateway ----------------
        def s3_fids(keys):
            return [f for k in keys
                    for f in chunks[f"/buckets/{GW_BUCKET}/{k}"]]

        # S3 Select over each CSV object (reads through the filer).
        def select(key):
            req = ("<SelectObjectContentRequest><Expression>"
                   f"{GW_SELECT.replace('>', '&gt;')}</Expression>"
                   "<ExpressionType>SQL</ExpressionType>"
                   "<InputSerialization><CSV><FileHeaderInfo>USE"
                   "</FileHeaderInfo></CSV></InputSerialization>"
                   "<OutputSerialization><JSON/></OutputSerialization>"
                   "</SelectObjectContentRequest>").encode()
            status, body = admin.call("POST", f"/{GW_BUCKET}/{key}",
                                      "select&select-type=2", req)
            check(status == 200, f"Select {key}: {status}")
            check(s3_event_records(bytes(body)) == plain_select(
                data["csv"][key], GW_SELECT_FLOOR),
                f"Select {key} differs from the plain evaluation")

        csv_keys = sorted(data["csv"])
        wall, _lat = degraded_pass("s3_select", s3_fids(csv_keys), csv_keys,
                                   select)
        out["select_mb_s"] = sum(len(data["csv"][k]) for k in csv_keys) \
            / wall / 1e6

        # 300 ranges across chunk boundaries of multi-chunk objects,
        # before the whole objects: their chunks' first reads.
        keys = sorted(objects)
        multi = sorted(k for k in keys
                       if len(spans[f"/buckets/{GW_BUCKET}/{k}"]) > 1)
        rng = np.random.default_rng(args.seed + 131)
        ranges = []
        for _ in range(GW_RANGES):
            k = multi[int(rng.integers(len(multi)))]
            cs = spans[f"/buckets/{GW_BUCKET}/{k}"]
            cut = cs[1 + int(rng.integers(len(cs) - 1))][1]
            lo_ = max(0, cut - int(rng.integers(1, 256 << 10)))
            hi_ = min(len(objects[k]),
                      cut + int(rng.integers(1, 256 << 10))) - 1
            # Every chunk the range touches, once per range.
            ranges.append((k, lo_, hi_, [f for f, o, s in cs
                                         if o <= hi_ and o + s > lo_]))

        def s3_range(item):
            k, lo_, hi_, _f = item
            status, body = admin.call("GET", f"/{GW_BUCKET}/{k}",
                                      headers={"Range": f"bytes={lo_}-{hi_}"})
            check(status == 206 and bytes(body) == objects[k][lo_:hi_ + 1],
                  f"range {lo_}-{hi_} of {k}: {status}")

        wall, lat = degraded_pass(
            "s3_ranges", [f for r in ranges for f in r[3]], ranges, s3_range)
        out["s3_range_ms"] = {"p50": pct_ms(lat, 50), "p99": pct_ms(lat, 99),
                              "reads": len(lat)}

        def s3_get(key):
            status, body = admin.call("GET", f"/{GW_BUCKET}/{key}")
            check(status == 200 and hashlib.sha256(bytes(body)).hexdigest()
                  == acked[f"/buckets/{GW_BUCKET}/{key}"],
                  f"GET {key}: {status}, bytes differ from the write")

        wall, lat = degraded_pass("s3_get_all", s3_fids(keys), keys, s3_get)
        out["gb_s"]["s3_get_all"] = s3_bytes / wall / 1e9
        out["degraded_s3_get_ms"] = {"p50": pct_ms(lat, 50),
                                     "p99": pct_ms(lat, 99),
                                     "reads": len(lat)}

        def dav_get(path):
            status, body = rpc.call_status(durl + path, timeout=600.0)
            check(status == 200 and hashlib.sha256(bytes(body)).hexdigest()
                  == acked[path], f"WebDAV GET {path}: {status}")

        dav_paths = sorted(data["dav"])
        wall, _lat = degraded_pass(
            "webdav_get_all", [f for p in dav_paths for f in chunks[p]],
            dav_paths, dav_get)
        out["gb_s"]["webdav_get_all"] = dav_bytes / wall / 1e9

        # The broker again (its tails were flushed to the filer): every
        # message from offset 0 of every partition, in order.
        # On a new port: the first one may be some connection's
        # ephemeral port by now.
        ports["broker"] = rpc.free_port()
        burl = f"http://127.0.0.1:{ports['broker']}"
        gw["broker"] = port_process(
            ["msg.broker", f"-port={ports['broker']}",
             f"-filer=127.0.0.1:{ports['filer']}"],
            os.path.join(work, "broker2.log"), launch)
        procs.append(gw["broker"])
        wait_for(lambda: rpc.call(burl + "/status", timeout=2.0),
                 "the restarted broker", procs)
        consumed: dict = {}

        def consume(p):
            c = MessagingClient(burl)
            since, got = 0, []
            while True:
                page = c.fetch(GW_NS, GW_TOPIC, p, since_ns=since)
                if not page["messages"]:
                    break
                got += [(m["ts_ns"], m["key"],
                         hashlib.sha256(m["value"]).hexdigest())
                        for m in page["messages"]]
                since = page["messages"][-1]["ts_ns"]
            consumed[p] = got

        seg_fids = [f for p in seg_paths for f in chunks[p]]
        wall, _lat = degraded_pass("broker_consume", seg_fids,
                                   range(GW_PARTITIONS), consume)
        for p in range(GW_PARTITIONS):
            check(consumed[p] == sorted(published[p]),
                  f"partition {p}: {len(consumed[p])} messages read, "
                  f"{len(published[p])} published, or out of order")
        out["broker_consume_per_s"] = data["messages"] / wall

        # The mount: a fresh WFS (empty meta cache) reads the file whole
        # through its own chunk streamer (this process's chunk cache
        # emptied first).
        chunk_cache.CACHE.reset()

        def wfs_read(path):
            m = WFS(furl, collection=GW_COLLECTION)
            m.start()
            try:
                fh = m.open(path)
                body = m.read(fh, data["wfs_size"], 0)
                m.release(fh)
            finally:
                m.stop()
            check(hashlib.sha256(body).hexdigest() == acked[path],
                  "the WFS file reads back differently")

        degraded_pass("wfs_read", chunks["/mnt/wfs.bin"], ["/mnt/wfs.bin"],
                      wfs_read)

        # filer.replicate -once of the copied tree into a local sink.
        sink = os.path.join(work, "sink")
        copy_paths = sorted(p for p in acked if p.startswith("/copied/"))

        def replicate(_):
            text, _w, _r = run_port(
                ["filer.replicate", f"-filer=127.0.0.1:{ports['filer']}",
                 "-source.dir=/copied", f"-sink=local://{sink}", "-once"],
                os.path.join(work, "filer-replicate.log"), launch,
                procs)
            for p in copy_paths:
                local = os.path.join(sink, p[len("/copied/"):])
                check(os.path.exists(local)
                      and sha256_file(local) == acked[p],
                      f"replicated {p} differs or is missing")

        wall, _lat = degraded_pass(
            "filer_replicate", [f for p in copy_paths for f in chunks[p]],
            [0], replicate)
        out["replicate_s"] = wall

        # -- 7. stop the broker; ec.rebuild; volume.fsck -orphans ---------
        out["rss_mib"].update({r: rss_mib(p.pid) for r, p in gw.items()})
        out["rss_mib"]["filer"] = rss_mib(filer.pid)
        stop_broker()
        run_command(env, "lock")
        t0 = time.perf_counter()
        msg = run_command(env, "ec.rebuild")
        out["walls_s"]["rebuild"] = time.perf_counter() - t0
        run_command(env, "unlock")
        for v, ss in lost.items():
            files_ = shard_files({n: dirs[n] for n in live}, v)
            check(sorted(files_) == list(range(14)),
                  f"volume {v} after rebuild: {sorted(files_)}; {msg}")
            for sid in ss:
                check(sha256_file(files_[sid][1]) == lost_sha[(v, sid)],
                      f"rebuilt shard {v}.{sid} differs from its original")
        out["launches"]["rebuild"] = {
            "volume_servers": step_rows("rebuild", live)}
        t0 = time.perf_counter()
        fsck = run_command(env, "volume.fsck -orphans")
        out["walls_s"]["fsck"] = time.perf_counter() - t0
        out["fsck"] = fsck
        check(fsck.endswith(", 0 missing, 0 orphans"),
              f"volume.fsck: {fsck[:2000]}")

        # -- 8. X4 on the card --------------------------------------------
        out["x4"] = phase_x4(torch, dev, args.seed,
                             max(X4_MIB * MIB * limit_mb // 1024, 1 << 20),
                             work)
        out["rss_mib"]["chip_smoke"] = rss_mib(os.getpid())
        totals = {"rs_bitmatrix": 0, "rs_bitmatrix_crc": 0}
        for s in out["launches"].values():
            for k in totals:
                totals[k] += s["volume_servers"].get(k, 0)
        totals["rs_bitmatrix"] += sum(
            sum(v) for v in out["x4"]["k1_launches"].values())
        out["launch_totals"] = totals
        check(all(totals.values()), f"phase 13 launches {totals}")
        # Each process's calls that met a closed connection or timed
        # out, counted from the `RPC-FAIL` lines.
        out["rpc_fails"] = {"chip_smoke": len(RPC_FAILS) - fails_before,
                            **{name: len(lines) for name, lines in
                               rpc_fail_lines(work).items()}}
    except BaseException:
        log(f"phase 13 failed with {mem_available() / 2 ** 30:.1f} GiB of "
            f"memory available; the calls that met a closed connection "
            f"or timed out, by process:")
        for line in RPC_FAILS[fails_before:]:
            log(f"chip_smoke: {line}")
        for name, lines in rpc_fail_lines(work).items():
            for line in lines:
                log(f"{name}: {line}")
        dump_stacks(procs, "phase 13 failed")
        log("its processes' logs:")
        log_tails(work)
        raise
    finally:
        for ev in evs.values():
            ev.close()
        if wfs is not None:
            wfs.stop()
        if env is not None:
            env.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"gateway cluster: {json.dumps(out['walls_s'])}")
    return out


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
    (2, 10, ceil(512 MiB / 10) MiB) and phase 4's column step (1, 10,
    18 MiB) with the decode matrix of shards 1/3/9/12, and LRC's local
    repair 5 -> 1 (K1 at 1 MiB, K2 at one 26 MiB LRC shard).  Each
    kernel's timing keeps the queue filled;
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
    # Phase 4's batched rebuild of its volume: one column step of 10
    # survivors and 4 rebuilt rows under the default budget.
    step_mib = MAIN_BATCH_BYTES // (10 + len(REBUILD_LOST)) // MIB
    g = torch.Generator(device=dev).manual_seed(args.seed + 3)

    def rand(shape, count):
        return [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                              generator=g) for _ in range(count)]

    cases = (  # (key, masks, inputs, k_out, reps, plain reps)
        ("at_batch_4x10x4mib", par, rand((4, 10, KERNEL_N), 2), 4, 200, 2),
        ("at_rebuild_2x10x%dmib" % shard_mib, dec,
         rand((2, 10, shard_mib * MIB), 2), 4, 50, 1),
        ("at_column_step_1x10x%dmib" % step_mib, dec,
         rand((1, 10, step_mib * MIB), 3), 4, 50, 1),
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
    if name in ("rs_rebuild", "main_batch_rebuild"):
        s = main_shard if name == "main_batch_rebuild" else rs_shards
        return "batch_reconstruct", {
            "batch_gather": 10 * s, "batch_scatter": 4 * s,
            "batch_rebuild_device": stacked("batch_reconstruct", 10, 4)}, \
            {"rs": 10 * s}
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
        # A window of more launches than the ring keeps holds its last.
        check(len(rows) == min(w["launches"], roofline._RING_MAX),
              f"{name}: ring holds {len(rows)} of the window's "
              f"{w['launches']} rows")
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
    ap.add_argument("--main-mib", type=int, default=MAIN_MIB,
                    help="phase 4's volume, MiB")
    ap.add_argument("--dat-mib", type=int, default=1024,
                    help="phase 8's volume, MiB")
    ap.add_argument("--batch-div", type=int, default=1,
                    help="divide the batched path's volume sizes by this")
    ap.add_argument("--live-mib", type=int, default=LIVE_LIMIT_MB,
                    help="the live cluster's volume size limit, MiB")
    ap.add_argument("--ha-mib", type=int, default=HA_LIMIT_MB,
                    help="the HA cluster's volume size limit, MiB")
    ap.add_argument("--filer-mib", type=int, default=FILER_LIMIT_MB,
                    help="the filer cluster's volume size limit, MiB")
    ap.add_argument("--gateway-mib", type=int, default=GW_LIMIT_MB,
                    help="the gateway cluster's volume size limit, MiB")
    ap.add_argument("--ha-runs", type=int, default=0,
                    help="only build, probe and run phase 11 this many "
                         "times, one {\"ha_run\": ...} line each")
    ap.add_argument("--gateway-runs", type=int, default=0,
                    help="only build, probe and run phase 13 this many "
                         "times, one {\"gateway_run\": ...} line each")
    ap.add_argument("--gateway-small-div", type=int, default=1,
                    help="divide phase 13's small S3 objects and messages "
                         "by this")
    ap.add_argument("--wire-mib", type=int, default=0,
                    help="only build, probe and run the wire measurement "
                         "on a volume of this many MiB, one "
                         "{\"wire_turn\": ...} line per turn")
    ap.add_argument("--wire-parent", default="",
                    help="the other checkout the wire measurement turns "
                         "with")
    ap.add_argument("--main-only", action="store_true",
                    help="only build, probe and run phase 4, one "
                         "{\"main_path\": ...} line")
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
    if args.ha_runs:
        return ha_runs(torch, dev, args, smi)
    if args.gateway_runs:
        return gateway_runs(torch, dev, args, smi)
    if args.wire_mib:
        return wire_turns(torch, dev, args, smi)
    if args.main_only:
        with hooks("armed"):
            main_path = phase_main_path(torch, dev, args)
        main_path.pop("obs")
        print(json.dumps({"main_path": main_path}))
        print(smi)
        return 0

    phase_walls: dict = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_walls[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_walls[name]:.1f} s")
        return out

    kern = timed("3_kernels", phase_kernels, torch, dev, args.seed)
    with hooks("armed"):
        main_path = timed("4_main", phase_main_path, torch, dev, args)
        batch = timed("6_batch", phase_batch, torch, dev, args)
        storage = timed("8_storage", phase_storage, torch, dev, args)
        cluster = timed("9_cluster", phase_cluster, torch, dev, args)
        live = timed("10_live", phase_live_cluster, torch, dev, args)
        ha = timed("11_ha", phase_ha_cluster, torch, dev, args)
        filer = timed("12_filer", phase_filer_cluster, torch, dev, args)
        gateway = timed("13_gateway", phase_gateway_cluster, torch, dev,
                        args)
    t0 = time.perf_counter()
    timings = phase_timings(torch, dev, kern, args.seed)
    for name, rows in batch_timings(torch, dev, kern, args).items():
        timings[name].update(rows)
    phase_walls["5_timings"] = time.perf_counter() - t0
    batch["single_volume_encode_gb_s"] = main_path["encode_gb_s"]
    # Device busy share: launches x kernel ms at the step's shape (the
    # encode's (4, 10, 4 MiB) and the rebuild's largest step, both upper
    # bounds for the smaller steps) over the step's wall.
    k2 = timings["rs_bitmatrix_crc"]
    rebuild_key = next(k for k in k2 if k.startswith("at_rebuild"))
    column_key = next(k for k in k2 if k.startswith("at_column_step"))
    main_path["batch_rebuild"]["device_busy_share"] = \
        main_path["batch_rebuild"]["steps"] * k2[column_key]["ms"] / 1e3 \
        / main_path["walls_s"]["batch_rebuild"]
    for step, ms in (("rs_encode", k2["at_batch_4x10x4mib"]["ms"]),
                     ("rs_rebuild", k2[rebuild_key]["ms"])):
        n = batch[step]["launches"]["rs_bitmatrix_crc"]["launches"]
        batch[step]["device_busy_share"] = \
            n * ms / 1e3 / batch[step]["wall_s"]
    # The same for the storage path's, phase 10's and phase 11's kernel
    # steps, at their shapes: K2 10->4 and K1 10->4 at 4 MiB, K1 10->1 at
    # 1 MiB, K2's rebuild step.  The volume axis costs V times one
    # volume, so a V = 2 encode step counts twice.
    k1, k2 = "rs_bitmatrix", "rs_bitmatrix_crc"
    at = storage["launches"]
    storage["device_busy_share"] = busy_share(timings, storage["walls_s"], {
        "storage_generate": (k2, at["storage_generate"][k2]["launches"], None),
        "storage_ec_scrub": (k1, at["storage_ec_scrub"][k1]["launches"],
                             "at_10_to_1_1mib"),
        "storage_rebuild": (k1, at["storage_rebuild"][k1]["launches"], None)})
    at = live["launches"]
    shell = at["encode_batch"]["shell"]
    live["device_busy_share"] = busy_share(timings, live["walls_s"], {
        "encode_per_volume": (
            k2, at["encode_per_volume"]["volume_servers"][k2], None),
        "encode_batch": (k2, shell[k2] + shell["volume_axis"], None),
        "degraded_reads": (k1, at["degraded_reads"]["volume_servers"][k1],
                           "at_10_to_1_1mib"),
        "rebuild_batch": (k2, at["rebuild_batch"]["shell"][k2],
                          "at_rebuild")})
    at = ha["launches"]
    ha["device_busy_share"] = busy_share(
        timings, {**ha["walls_s"], "repair": ha["repair_s_from_kill"]}, {
            "encode_primary": (
                k2, at["encode_primary"]["volume_servers"][k2], None),
            "encode_standby": (
                k2, at["encode_standby"]["volume_servers"][k2], None),
            "degraded_reads": (k1, at["degraded_reads"]["volume_servers"][k1],
                               "at_10_to_1_1mib"),
            "repair": (k2, at["repair"]["leader_master"][k2], "at_rebuild")})
    at = filer["launches"]
    filer["device_busy_share"] = busy_share(timings, filer["walls_s"], {
        "encode": (k2, at["encode"]["volume_servers"][k2], None),
        "degraded_read_all": (
            k1, at["degraded_read_all"]["volume_servers"][k1],
            "at_10_to_1_1mib")})

    at = gateway["launches"]
    gateway["device_busy_share"] = busy_share(timings, gateway["walls_s"], {
        "encode": (k2, at["encode"]["volume_servers"][k2], None),
        **{step: (k1, at[step]["volume_servers"][k1], "at_10_to_1_1mib")
           for step in GW_PASSES}})

    kernels = [
        {"name": "rs_bitmatrix", "route": "cuda",
         "source": "seaweedfs_tpu_torch/csrc/rs_bitmatrix.cu",
         "replaces": "seaweedfs_tpu/ops/coder_pallas.py:104",
         "launches": main_path["launches"]["rs_bitmatrix"] + sum(
             batch[s]["launches"]["rs_bitmatrix"]["launches"]
             for s in PHASE6_STEPS) + sum(
             storage["launches"][s]["rs_bitmatrix"]["launches"]
             for s in STORAGE_STEPS)
         + cluster["window_launches"]["rs_bitmatrix"]
         + live["launch_totals"]["rs_bitmatrix"]
         + live["lrc"]["launch_totals"]["rs_bitmatrix"]
         + ha["launch_totals"]["rs_bitmatrix"]
         + filer["launch_totals"]["rs_bitmatrix"]
         + gateway["launch_totals"]["rs_bitmatrix"],
         "max_abs_err": kern["k1_err"], **timings["rs_bitmatrix"]},
        {"name": "rs_bitmatrix_crc", "route": "cuda",
         "source": "seaweedfs_tpu_torch/csrc/rs_bitmatrix_crc.cu",
         "replaces": "seaweedfs_tpu/ops/coder_pallas.py:200",
         "launches": main_path["launches"]["rs_bitmatrix_crc"] + sum(
             batch[s]["launches"]["rs_bitmatrix_crc"]["launches"]
             for s in PHASE6_STEPS) + sum(
             storage["launches"][s]["rs_bitmatrix_crc"]["launches"]
             for s in STORAGE_STEPS)
         + cluster["window_launches"]["rs_bitmatrix_crc"]
         + live["launch_totals"]["rs_bitmatrix_crc"]
         + live["lrc"]["launch_totals"]["rs_bitmatrix_crc"]
         + ha["launch_totals"]["rs_bitmatrix_crc"]
         + filer["launch_totals"]["rs_bitmatrix_crc"]
         + gateway["launch_totals"]["rs_bitmatrix_crc"],
         "max_abs_err": kern["k2_err"], **timings["rs_bitmatrix_crc"]},
    ]
    obs = phase_observability(torch, probe, main_path, batch, storage, timings)
    obs["ledger_vs_phase5"]["k1_10_to_4_4mib"]["alone_ms"] = \
        isolated_launch_ms(torch, dev, kern)
    print(json.dumps({"main_path": main_path}))
    print(json.dumps({"batch_path": batch}))
    print(json.dumps({"storage_path": storage}))
    print(json.dumps({"observability": obs}))
    print(json.dumps({"control_plane": cluster}))
    print(json.dumps({"live_cluster": live}))
    print(json.dumps({"ha_cluster": ha}))
    print(json.dumps({"filer_cluster": filer}))
    print(json.dumps({"gateway_cluster": gateway}))
    print(json.dumps({"phase_walls_s": phase_walls}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
