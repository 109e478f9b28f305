"""Batched EC rebuild of many volumes under a byte budget per device step.

Port of seaweedfs_tpu/parallel/cluster_rebuild.py.  Its device half is
`rebuild_group` (the reference's `_rebuild_group_inner`), with the
survivors' size, their gather and the placement of rebuilt shards
passed in as functions:

- ``shard_size(vid) -> int``: the length of each survivor shard;
- ``fetch_rows(vid, used, span) -> rows``: the `used` survivor shards
  of one volume, in that order, whole (`span` None) or their bytes
  ``[lo, hi)`` (bytes or uint8 arrays);
- ``place(vid, missing, lo, shards, last, crcs) -> suffix``: store the
  rebuilt bytes from offset `lo` of each shard (uint8 arrays, in
  `missing` order); `last` marks the volume's last piece, which alone
  carries the `.ecc` block CRCs of the whole shards (one list per shard
  from the device, or None when the CRCs were not fused) and whose
  returned text (or None) ends the volume's report line.

Its network half is `batch_rebuild`, the shell's `ec.rebuild -batch`:
`plan_rebuilds` groups the cluster's degraded EC volumes by (codec,
survivors, missing), `_fetch_shard` gathers survivors (whole, or a
range) from their holders over HTTP with failover and deadlines, and
`_scatter_volume` pushes the rebuilt shards (their device `.ecc`
fragments first) to balanced targets (`_TargetPicker`) and mounts them:
a volume that fits in one step whole, a split one piece by piece as
each column step drains (`receive_shard`'s `offset=`/`size=`).

Every volume of a group shares a codec and lost the same shards, so one
decode matrix covers the group.  Every step stacks at most
`max_batch_bytes` of survivor input plus rebuilt output and is one K2
launch (fused CRC) or K1 launch per device: volumes that fit go whole,
as many to a step as fit, on the "vol" axis; a volume that does not fit
alone goes in column steps, each a multiple of the `.ecc` block times
the mesh's "col" axis wide (the last may be ragged), so its fused CRCs
still fold into whole blocks.  The reference gathers such a volume whole
into one step (~62 GB of host memory for a 30 000 MiB volume that lost
4 shards); the bytes written are the same.  `batch_rebuild_files` is
the local implementation: it plans the groups from the shard files
beside each base, reads survivor shard files (a range at a time) and
writes rebuilt shards at their offsets and, after a volume's last step,
their `.ecc` entries.

The stages report as the JAX package's do: `batch_gather`,
`batch_rebuild_device` and `batch_scatter` (the placement) in the
`SeaweedFS_ec_stage_*` histograms, the gathered survivor bytes in
`SeaweedFS_ec_repair_read_bytes_total`, one `batch_reconstruct` roofline
row per step with its kernel time, the recorder in the ledger's
occupancy docs while `roofline.ARMED`, and an `ec.repair.local` event
per volume when every lost shard was repaired inside its locality group.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..cluster import rpc
from ..codecs import Codec, get_codec
from ..ec import SMALL_BLOCK_SIZE, to_ext
from ..ec.integrity import ShardChecksums, ecc_lock, file_block_crcs
from ..ec.shard_bits import ShardBits
from ..ec.volume_info import ec_codec_name
from ..events import emit as emit_event
from ..fault import registry as _fault
from ..ops.crc_fold import fused_crc_enabled
from ..stats import flows as _flows
from ..stats import roofline as _roofline
from ..stats.metrics import (ec_repair_read_bytes_total,
                             observe_batch_stage, stage_attrs)
from ..trace import root_span
from ..utils import env_float as _env_float
from . import mesh as _mesh
from .mesh import Mesh
from .sharded_codec import reconstruct_step, record_fenced_batch
from .stream_pipeline import PipelineRecorder, run_pipeline

# Column padding granularity without fused CRC (see cluster_encode).
_COL_ALIGN = 2048


# Shard-fetch budgets: each holder attempt gets a bounded slice of a
# total per-shard deadline, so one dead holder costs one attempt
# timeout, never a hang that stalls the whole batch.
FETCH_ATTEMPT_TIMEOUT = _env_float(
    "SEAWEEDFS_TPU_EC_FETCH_TIMEOUT", 30.0)
FETCH_TOTAL_DEADLINE = _env_float(
    "SEAWEEDFS_TPU_EC_FETCH_DEADLINE", 180.0)


def make_mesh(devices=None) -> Mesh:
    """Default batch mesh: volumes data-parallel on "vol", byte columns
    on "col" (2 when the device count is even).  `devices` defaults to
    every visible card (raising without one)."""
    devices = list(devices) if devices is not None \
        else _mesh.make_mesh().device_list()
    n = len(devices)
    return _mesh.make_mesh(devices=devices,
                           vol_axis=n // 2 if n % 2 == 0 else n)


def _pad_to(n: int, align: int) -> int:
    return -(-n // align) * align


@dataclass
class RebuildPlan:
    """Volumes grouped by (codec, survivor signature): every volume in
    a group shares a codec and lost the same shards, so one decode
    matrix (and one launch per sub-batch) covers the whole group."""

    groups: dict[tuple[str, tuple[int, ...], tuple[int, ...]],
                 list[tuple[int, dict[int, list[str]]]]] = \
        field(default_factory=dict)
    skipped: list[tuple[int, str]] = field(default_factory=list)


def plan_rebuilds(env, vids=None) -> RebuildPlan:
    """Group rebuildable EC volumes by (codec, present, missing).
    Codec ids come from the /vol/list payload (heartbeats put "codec" on
    every ec_shards entry), with env.ec_codec(vid) as the per-volume
    fallback; a volume whose codec cannot be determined is skipped,
    never guessed — decoding LRC shards with RS matrices would scatter
    silently corrupt bytes cluster-wide."""
    plan = RebuildPlan()
    codecs: dict[int, str] = {}
    try:
        nodes = env.data_nodes()
    except Exception:  # noqa: BLE001 — fall back to per-vid lookups
        nodes = []
    for n in nodes:
        for e in n.get("ec_shards", []):
            if e.get("codec"):
                codecs[e["id"]] = e["codec"]
    if vids is None:
        vids = sorted({e["id"] for n in nodes for e in n["ec_shards"]})
    for vid in vids:
        name = codecs.get(vid)
        if name is None:
            getter = getattr(env, "ec_codec", None)
            if getter is None:  # duck-typed env predating codecs: rs
                name = "rs"
            else:
                try:
                    name = getter(vid) or "rs"
                except Exception as e:  # noqa: BLE001 — master hiccup
                    plan.skipped.append(
                        (vid, f"cannot determine codec: "
                              f"{type(e).__name__}: {e}"))
                    continue
        try:
            codec = get_codec(name)
        except ValueError:
            plan.skipped.append((vid, f"unknown codec {name!r}"))
            continue
        locs = env.ec_shard_locations(vid)
        present = tuple(sorted(locs))
        missing = tuple(s for s in range(codec.total_shards)
                        if s not in locs)
        if not missing:
            continue
        try:
            codec.repair_plan(present, list(missing))
        except ValueError:
            plan.skipped.append(
                (vid, f"only {len(present)} shards survive "
                      f"({codec.name}: unrecoverable pattern)"))
            continue
        plan.groups.setdefault((codec.name, present, missing),
                               []).append((vid, locs))
    return plan


def plan_repair_reads(codec: Codec, present, missing) -> dict:
    """Repair-bandwidth plan for one volume: per-missing-shard minimal
    read sets (local group first, global fallback) plus the
    planned-vs-RS accounting — RS(k) reads data_shards survivors once to
    rebuild everything, so the saving is union-of-planned-reads vs
    data_shards."""
    plans = codec.repair_plan(tuple(present), list(missing))
    union: set[int] = set()
    for p in plans:
        union.update(p.reads)
    return {
        "codec": codec.name,
        "reads": {p.sid: list(p.reads) for p in plans},
        "union_reads": sorted(union),
        "planned_read_shards": len(union),
        "rs_read_shards": codec.data_shards,
        "local_repairs": sum(1 for p in plans if p.local),
    }


def _steps(sizes: list[int], rows: int, unit: int, max_batch_bytes: int):
    """The device steps of one group, in volume order: (indices into
    `sizes`, None) for whole volumes, as many to a step as keep rows x
    the widest at most `max_batch_bytes`; (one index, (lo, hi)) for
    each column step of a volume that does not fit alone, `unit`-aligned
    and at most `max_batch_bytes` of rows (at least one `unit`)."""
    i = 0
    while i < len(sizes):
        if sizes[i] * rows > max_batch_bytes and sizes[i] > unit:
            cols = max(unit, max_batch_bytes // rows // unit * unit)
            for lo in range(0, sizes[i], cols):
                yield [i], (lo, min(sizes[i], lo + cols))
            i += 1
            continue
        j, widest = i + 1, sizes[i]
        while j < len(sizes) and (j - i + 1) * rows * max(
                widest, sizes[j]) <= max_batch_bytes:
            widest = max(widest, sizes[j])
            j += 1
        yield list(range(i, j)), None
        i = j


def rebuild_group(codec: Codec, present, missing, vids, shard_size,
                  fetch_rows, place, mesh: Mesh,
                  max_batch_bytes: int = 1 << 28,
                  depth: int | None = None,
                  recorder: PipelineRecorder | None = None,
                  stages: dict | None = None, progress=None) -> list[str]:
    """Streamed rebuild of one survivor-signature group: the producer
    gathers and stacks the next step while the device decodes the
    current one and the drain thread places the completed pieces.  Each
    step holds at most `max_batch_bytes` of survivor input plus rebuilt
    output (see the module docstring), but never less than one volume
    of up to one column unit.  `recorder` collects the stage spans;
    without one, a bounded recorder is made while `roofline.ARMED`, and
    armed, it is folded into `roofline.LEDGER.note_pipeline` as
    "rebuild".  `stages` collects the batch_* stage seconds and bytes.
    Returns one line per volume, each also handed to `progress`."""
    from .cluster_encode import (device_streams, mesh_on_cuda,
                                 pipeline_depth, side_streams)
    present, missing = tuple(present), tuple(missing)
    report = plan_repair_reads(codec, present, missing)
    all_local = bool(report["local_repairs"]) and \
        report["local_repairs"] == len(missing)
    # The codec's planned read set, not "first data_shards survivors":
    # an in-group LRC loss gathers 5 shards per volume instead of 10.
    _mat, used = codec.decode_matrix(present, missing)
    vids = list(vids)
    vol_axis = mesh.shape["vol"]
    col_axis = mesh.shape["col"]
    on_cuda = mesh_on_cuda(mesh)
    fused = fused_crc_enabled(mesh.device_list()[0])
    block = SMALL_BLOCK_SIZE
    align = block * col_axis if fused \
        else _pad_to(_COL_ALIGN, col_axis * 8)
    depth = pipeline_depth(depth)
    streams = side_streams(mesh)
    rec = recorder
    if rec is None and _roofline.ARMED:
        rec = PipelineRecorder(maxlen=1024)
    if stages is None:
        stages = {}
    out: list[str] = []
    saved = f" ({codec.name}: read {len(used)} shards vs " \
            f"{codec.data_shards} for RS)" \
        if len(used) < codec.data_shards else ""
    sizes = [int(shard_size(vid)) for vid in vids]
    # A split volume's device CRCs, gathered step by step.
    crc_acc: dict[int, list[list[int]]] = {}

    def produce():
        steps = _steps(sizes, len(used) + len(missing), block * col_axis,
                       max_batch_bytes)
        for bi, (idx, span) in enumerate(steps):
            t_gather = time.perf_counter()
            chunk = [vids[k] for k in idx]
            widths = [sizes[k] for k in idx] if span is None \
                else [span[1] - span[0]]
            fetched = [fetch_rows(vid, used, span) for vid in chunk]
            for vid, rows, width in zip(chunk, fetched, widths):
                for row in rows:
                    if len(row) != width:
                        raise ValueError(
                            f"volume {vid}: survivor shards disagree "
                            f"on size ({len(row)} vs {width})")
            gathered = sum(widths) * len(used)
            ec_repair_read_bytes_total.inc(gathered, codec=codec.name)
            n_pad = _pad_to(max(widths), align)
            v_pad = _pad_to(len(chunk), vol_axis)
            stacked = torch.zeros((v_pad, len(used), n_pad),
                                  dtype=torch.uint8, pin_memory=on_cuda)
            view = stacked.numpy()
            for v, rows in enumerate(fetched):
                for r, row in enumerate(rows):
                    view[v, r, :len(row)] = np.frombuffer(row, np.uint8)
            # Stacked: the gathered rows go now, not when the next
            # step's gather replaces them.
            del fetched, rows, row
            t_gend = time.perf_counter()
            observe_batch_stage(stages, "batch_gather", t_gend - t_gather,
                                gathered)
            if rec is not None:
                rec.note_span("stack", bi, t_gather, t_gend)
            yield stacked, idx, span, widths, bi

    def dispatch(item):
        stacked, idx, span, widths, bi = item
        t_d0 = time.perf_counter()
        # Device CRCs of the rebuilt rows ride along when every shard of
        # the step covers whole `.ecc` blocks (shard files are 1 MiB
        # block padded by construction; column steps start on a block).
        use_crc = fused and all(sizes[k] % block == 0 for k in idx)
        with device_streams(streams):
            step = reconstruct_step(stacked, present, missing, mesh, codec,
                                    use_crc)
            step.start_host_copy(on_cuda)
        t_d1 = time.perf_counter()
        if rec is not None:
            rec.note_span("dispatch", bi, t_d0, t_d1)
        return step, use_crc, idx, span, widths, stacked.nbytes, bi, t_d1

    def drain(handle):
        step, use_crc, idx, span, widths, nbytes, bi, t_d1 = handle
        t_dev = time.perf_counter()
        step.wait()
        rebuilt = step.host_out()
        crcs = step.host_crcs() if use_crc else None
        t_fence = time.perf_counter()
        observe_batch_stage(stages, "batch_rebuild_device", t_fence - t_dev,
                            nbytes)
        if rec is not None:
            rec.note_span("device", bi, t_d1, t_fence)
        if _roofline.ARMED:
            seconds = step.kernel_seconds()
            if seconds is not None:
                record_fenced_batch(
                    "batch_reconstruct", codec.name,
                    out_rows=int(rebuilt.shape[1]), in_rows=len(used),
                    n=int(rebuilt.shape[2]), batch=int(rebuilt.shape[0]),
                    crc=crcs is not None, seconds=seconds,
                    measured_bytes=int(nbytes) + rebuilt.nbytes,
                    device=mesh.device_list()[0])
        t_scatter = time.perf_counter()
        scattered = 0
        lo = 0 if span is None else span[0]
        for v, k in enumerate(idx):
            vid, width = vids[k], widths[v]
            last = lo + width == sizes[k]
            shards = [rebuilt[v, m, :width] for m in range(len(missing))]
            step_crcs = None
            if crcs is not None:
                nb = width // block
                step_crcs = [[int(c) for c in crcs[v, m, :nb]]
                             for m in range(len(missing))]
                if span is not None:  # a split volume's, step by step
                    acc = crc_acc.setdefault(k, [[] for _ in missing])
                    for m, c in enumerate(step_crcs):
                        acc[m] += c
                    step_crcs = crc_acc.pop(k) if last else None
            scattered += width * len(missing)
            placed = place(vid, missing, lo, shards, last, step_crcs)
            if not last:
                continue
            if all_local:
                emit_event("ec.repair.local", vid=vid, codec=codec.name,
                           shard=list(missing), reads=len(used),
                           bytes=sizes[k] * len(used))
            out.append(f"volume {vid}: rebuilt shards {list(missing)}"
                       + (placed or "") + saved)
            if progress:
                progress(out[-1])
        t_send = time.perf_counter()
        observe_batch_stage(stages, "batch_scatter", t_send - t_scatter,
                            scattered)
        if rec is not None:
            rec.note_span("drain", bi, t_scatter, t_send)

    run_pipeline(produce(), dispatch, drain, depth=depth, recorder=rec)
    if rec is not None and _roofline.ARMED:
        _roofline.LEDGER.note_pipeline("rebuild", rec)
    return out


def _read_rows(base: str, used, span) -> list:
    if span is None:
        return [np.fromfile(base + to_ext(sid), dtype=np.uint8)
                for sid in used]
    lo, hi = span
    rows = []
    for sid in used:
        with open(base + to_ext(sid), "rb") as f:
            rows.append(os.pread(f.fileno(), hi - lo, lo))
    return rows


def _write_rebuilt(base: str, missing, lo: int, shards, last: bool,
                   crcs) -> None:
    """Write each rebuilt piece at its offset (a shard's first piece
    creates the file); after the last, set the shards' `.ecc`
    entries."""
    for m, sid in enumerate(missing):
        with open(base + to_ext(sid), "wb" if lo == 0 else "r+b") as f:
            f.seek(lo)
            f.write(np.ascontiguousarray(shards[m]))
    if not last:
        return
    # Load-modify-save of the shared sidecar, under its lock.
    with ecc_lock(base):
        ecc = ShardChecksums.load(base)
        for m, sid in enumerate(missing):
            ecc.set_shard(sid, crcs[m] if crcs is not None
                          else file_block_crcs(base + to_ext(sid)))
        ecc.save()


def batch_rebuild_files(bases, mesh: Mesh | None = None,
                        max_batch_bytes: int = 1 << 28,
                        depth: int | None = None,
                        recorder: PipelineRecorder | None = None
                        ) -> list[str]:
    """Rebuild the missing shard files of the local EC volumes `bases`
    (paths without extension) in batched device steps of at most
    `max_batch_bytes` each, and their `.ecc` entries.  Each volume's
    codec comes from its `.vif`; volumes are grouped by (codec,
    surviving shards, missing shards).  The mesh defaults to every
    visible card (raising without one); a mesh of CPU devices runs the
    kernels' plain versions.  Returns one line per volume, skipped ones
    included."""
    if mesh is None:
        mesh = make_mesh()
    groups: dict[tuple, list[str]] = {}
    messages: list[str] = []
    for base in bases:
        codec = get_codec(ec_codec_name(base))
        present = tuple(s for s in range(codec.total_shards)
                        if os.path.exists(base + to_ext(s)))
        missing = tuple(s for s in range(codec.total_shards)
                        if s not in present)
        if not missing:
            continue
        try:
            codec.repair_plan(present, list(missing))
        except ValueError:
            messages.append(f"volume {base}: SKIPPED — only {len(present)} "
                            f"shards survive ({codec.name}: unrecoverable "
                            "pattern); cannot rebuild")
            continue
        groups.setdefault((codec.name, present, missing), []).append(base)
    for (name, present, missing), group in sorted(groups.items()):
        messages += rebuild_group(
            get_codec(name), present, missing, group,
            lambda base, sid=present[0]: os.path.getsize(base + to_ext(sid)),
            _read_rows, _write_rebuilt, mesh, max_batch_bytes, depth,
            recorder)
    return messages


# -- the network half: ec.rebuild -batch over the cluster --------------------

def _fetch_shard(holders: list[str], vid: int, sid: int,
                 attempt_timeout: float | None = None,
                 total_deadline: float | None = None,
                 span: tuple[int, int] | None = None) -> bytes:
    """Fetch one whole shard, or its bytes [lo, hi) of `span`, failing
    over across every holder of it (store_ec.go:264-320 walks all
    sourceDataNodes) with a second round for transient errors.  Every
    attempt runs under `attempt_timeout`, all of them together under
    `total_deadline`: a dead holder costs one bounded attempt, and a
    shard with only dead holders fails the batch within the deadline
    instead of hanging it.  A range past the shard's end comes back
    short (empty past it)."""
    attempt_timeout = attempt_timeout or FETCH_ATTEMPT_TIMEOUT
    total_deadline = total_deadline or FETCH_TOTAL_DEADLINE
    deadline = time.monotonic() + total_deadline
    errors: list[str] = []
    permanent: set[str] = set()
    for attempt in range(2):
        for url in holders:
            if url in permanent:
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                errors.append(f"deadline {total_deadline:g}s exhausted")
                raise rpc.RpcError(
                    502, f"shard {vid}.{sid} unreachable within "
                         f"deadline: " + "; ".join(errors[:6]))
            try:
                if _fault.ARMED:
                    _fault.hit("ec.fetch_shard", holder=url, vid=vid,
                               shard=sid)
                what = f"shard_file?volume={vid}&shard={sid}" \
                    if span is None else \
                    f"shard_read?volume={vid}&shard={sid}" \
                    f"&offset={span[0]}&size={span[1] - span[0]}"
                data = rpc.call(
                    f"http://{url}/admin/ec/{what}",
                    timeout=min(attempt_timeout, remaining),
                    headers={**rpc.PRIORITY_LOW,
                             **_flows.tag("ec.gather")})
                if not isinstance(data, (bytes, bytearray)):
                    raise rpc.RpcError(
                        410, f"shard {vid}.{sid}: non-binary reply")
                return bytes(data)
            except rpc.RpcError as e:
                # A definitive 4xx (the holder lacks the shard) will not
                # change on a retry; a 429 admission shed means "later".
                if (400 <= e.status < 500 or e.status == 410) \
                        and e.status != 429:
                    permanent.add(url)
                errors.append(f"{url} (try {attempt + 1}): {e}")
            except Exception as e:  # noqa: BLE001 — transient: next
                errors.append(
                    f"{url} (try {attempt + 1}): {type(e).__name__}: {e}")
    raise rpc.RpcError(
        502, f"shard {vid}.{sid} unreachable on any holder: "
             + "; ".join(errors[:6]))


def _shard_size(holders: list[str], vid: int, sid: int) -> int:
    """A shard's length, from one-byte ranged reads: the smallest whole
    `.ecc` block count past its end by doubling, then bisection, then
    (for a ragged shard, which the batched encoders never write) the
    byte within its last block.  A shard of S MiB costs about
    2 log2(S) reads."""
    def has(offset: int) -> bool:
        return bool(_fetch_shard(holders, vid, sid, span=(offset,
                                                          offset + 1)))
    if not has(0):
        return 0
    block = SMALL_BLOCK_SIZE
    hi = 1
    while has(hi * block):
        hi *= 2
    lo = hi // 2  # blocks: lo * block < size <= hi * block
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if has(mid * block):
            lo = mid
        else:
            hi = mid
    if has(hi * block - 1):
        return hi * block
    first, last = lo * block, hi * block - 1  # has(first), not has(last)
    while last - first > 1:
        mid = (first + last) // 2
        if has(mid):
            first = mid
        else:
            last = mid
    return last


class _TargetPicker:
    """Free-slot balanced placement for rebuilt shards, preferring nodes
    that hold nothing of the volume (maximises survivors on node loss —
    the same objective as balancedEcDistribution)."""

    def __init__(self, env):
        self.free: dict[str, int] = {}
        for n in env.data_nodes():
            held = sum(ShardBits(e["shard_bits"]).shard_id_count()
                       for e in n["ec_shards"])
            free = n["max_volume_count"] * 10 - len(n["volumes"]) * 10 \
                - held
            self.free[n["url"]] = max(free, 0)

    def pick(self, holders: set[str]) -> str:
        if not self.free:
            raise rpc.RpcError(503, "no data nodes for rebuilt shards")
        fresh = {u: f for u, f in self.free.items() if u not in holders}
        pool = fresh if any(f > 0 for f in fresh.values()) else self.free
        url = max(pool, key=lambda u: pool[u])
        self.free[url] -= 1
        return url


def batch_rebuild(env, vids=None, mesh: Mesh | None = None,
                  max_batch_bytes: int = 1 << 28, workers: int = 16,
                  progress=None, depth: int | None = None) -> list[str]:
    """Rebuild every missing EC shard across the cluster in batched
    device steps.  Returns one line per volume.  `depth` overrides the
    stream-pipeline depth (0 = serialized).  The mesh defaults to every
    visible card (raising without one).

    env: duck-typed cluster view (shell CommandEnv): ec_shard_locations,
    data_nodes, vs_call."""
    plan = plan_rebuilds(env, vids)
    messages = [f"volume {vid}: SKIPPED — {why}; cannot rebuild"
                for vid, why in plan.skipped]
    if not plan.groups:
        return messages
    if mesh is None:
        mesh = make_mesh()
    picker = _TargetPicker(env)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    try:
        for (codec_name, present, missing), entries in \
                sorted(plan.groups.items()):
            messages += _rebuild_group(
                env, mesh, pool, picker, get_codec(codec_name),
                present, missing, entries, max_batch_bytes, progress,
                depth)
    finally:
        # A failed group must not leave queued fetches or pushes running.
        pool.shutdown(wait=False, cancel_futures=True)
    return messages


def _rebuild_group(env, mesh, pool, picker, codec, present, missing,
                   entries, max_batch_bytes, progress,
                   depth: int | None = None) -> list[str]:
    """One (codec, survivor-signature) group over the wire — journaled
    as ec.rebuild.start/finish with per-stage byte/second attrs and the
    planner's planned-vs-RS read accounting, under a root span."""
    vids = [vid for vid, _locs in entries]
    locs_of = dict(entries)
    report = plan_repair_reads(codec, present, missing)
    with root_span("ec.batch_rebuild", "ec", volumes=len(vids),
                   missing=list(missing), codec=codec.name):
        emit_event("ec.rebuild.start", volumes=vids, batch=True,
                   missing=list(missing), codec=codec.name,
                   planned_read_shards=report["planned_read_shards"],
                   rs_read_shards=report["rs_read_shards"])
        t0 = time.perf_counter()
        stages: dict[str, list[float]] = {}

        sizes = {}

        def shard_size(vid):
            sid = present[0]
            sizes[vid] = _shard_size(locs_of[vid][sid], vid, sid)
            return sizes[vid]

        def fetch_rows(vid, used, span):
            return _fetch_rows(pool, vid, locs_of[vid], used, span)

        # Each volume's targets, picked at its first piece.
        targets: dict[int, list[tuple[int, str]]] = {}

        def place(vid, missing, lo, shards, last, crcs):
            # A volume that fits in one step is pushed whole; a split
            # one goes piece by piece at its offsets as each column step
            # drains, so the host holds one step's output, not the
            # volume's.
            if lo == 0:
                targets[vid] = _pick_targets(picker, locs_of[vid], missing)
            placed = _scatter_volume(
                env, pool, vid, locs_of[vid], targets[vid],
                [memoryview(np.ascontiguousarray(s)) for s in shards],
                shard_crcs=crcs,
                piece=None if lo == 0 and last else (lo, sizes[vid]),
                last=last)
            if not last:
                return None
            del targets[vid]
            return " -> " + ", ".join(f"{s}@{u}" for s, u in placed)

        try:
            out = rebuild_group(codec, present, missing, vids, shard_size,
                                fetch_rows, place, mesh, max_batch_bytes,
                                depth, stages=stages, progress=progress)
        except Exception as e:
            emit_event("ec.rebuild.finish", severity="error",
                       volumes=vids, batch=True, missing=list(missing),
                       codec=codec.name,
                       seconds=round(time.perf_counter() - t0, 6),
                       error=f"{type(e).__name__}: {e}",
                       **stage_attrs(stages))
            raise
        emit_event("ec.rebuild.finish", volumes=vids, batch=True,
                   missing=list(missing), codec=codec.name,
                   planned_read_shards=report["planned_read_shards"],
                   rs_read_shards=report["rs_read_shards"],
                   seconds=round(time.perf_counter() - t0, 6),
                   **stage_attrs(stages))
        return out


def _fetch_rows(pool, vid, locs, used, span=None) -> list[bytes]:
    """Fetch the `used` survivor shards of one volume (whole, or their
    bytes [lo, hi) of `span`) in parallel, each failing over across its
    holders (store_ec.go:322-376)."""
    futs = [pool.submit(_fetch_shard, locs[sid], vid, sid, span=span)
            for sid in used]
    return [f.result() for f in futs]


def _push_shard(vid: int, sid: int, payload, target: str,
                sources: list[str], ecc_push=None,
                piece: tuple[int, int] | None = None) -> None:
    """Push one rebuilt shard, or with `piece` = (offset, shard size)
    its bytes at that offset; the target pulls the .ecx index from a
    source holder once the shard is complete, so fail over across
    sources — a stale entry in the location map must not sink the
    scatter."""
    if ecc_push is not None:
        # The target's device `.ecc` entries land before the push that
        # completes a shard, once per target, inside this worker
        # (_EccOncePush).
        ecc_push.ensure(target)
    errors: list[str] = []
    for src in sources:
        try:
            if _fault.ARMED:
                _fault.hit("ec.scatter", target=target, vid=vid,
                           shard=sid, **({"offset": piece[0]} if piece
                                         else {}))
            rpc.call(
                f"http://{target}/admin/ec/receive_shard?volume={vid}"
                f"&shard={sid}&ecx_source={src}"
                + (f"&offset={piece[0]}&size={piece[1]}" if piece else ""),
                "POST", payload, 600.0,
                headers={**rpc.PRIORITY_LOW,
                         **_flows.tag("ec.scatter")})
            return
        except rpc.RpcError as e:
            # The target answered: its ecx pull from this source may be
            # what failed, and another source can fix that.
            errors.append(f"via {src}: {e}")
        except Exception as e:
            # The target is unreachable: no other source helps, and
            # resending the payload per source would multiply the wait.
            raise rpc.RpcError(
                502, f"cannot place rebuilt shard {vid}.{sid}: target "
                     f"{target} unreachable: {type(e).__name__}: {e}"
            ) from None
    raise rpc.RpcError(
        502, f"cannot place rebuilt shard {vid}.{sid} on {target}: "
             + "; ".join(errors[:4]))


def _pick_targets(picker, locs, missing) -> list[tuple[int, str]]:
    """A balanced target for each lost shard of one volume."""
    holders = {u for urls in locs.values() for u in urls}
    return [(sid, picker.pick(holders)) for sid in missing]


def _scatter_volume(env, pool, vid, locs, placed, shards: list,
                    shard_crcs=None, piece: tuple[int, int] | None = None,
                    last: bool = True) -> list[tuple[int, str]]:
    """Push rebuilt shards to their targets `placed` in parallel, each
    pulling the .ecx index alongside: the whole shards, or with `piece`
    = (lo, shard size) one column step's bytes [lo, lo + width) of
    each.  The shards are mounted after the `last` push.  With
    `shard_crcs` (the device's per-block CRC32-C of each rebuilt shard,
    known at the last push) the target gets its `.ecc` entries first,
    so receive_shard skips its CPU pass over the shard.  A failed piece
    fails the volume: a retry of the rebuild starts each shard again at
    offset 0."""
    sources = sorted({u for urls in locs.values() for u in urls})
    pusher = None
    if shard_crcs is not None:
        from .cluster_encode import _ecc_push_plan
        pusher = _ecc_push_plan(
            vid, ((target, sid, crcs)
                  for (sid, target), crcs in zip(placed, shard_crcs)))
    futs = [pool.submit(_push_shard, vid, sid, payload, target,
                        sources, pusher, piece)
            for (sid, target), payload in zip(placed, shards)]
    for f in futs:
        f.result()
    if last:
        for _sid, target in placed:
            env.vs_call(target, "/admin/ec/mount", {"volume": vid})
    return placed
