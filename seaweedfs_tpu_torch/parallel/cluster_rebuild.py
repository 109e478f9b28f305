"""Batched EC rebuild of many volumes: whole shard files per device step.

Port of the device half of seaweedfs_tpu/parallel/cluster_rebuild.py:
`plan_repair_reads`, `_pad_to`, and `_rebuild_group_inner` as
`rebuild_group`, with the survivor gather and the placement of rebuilt
shards passed in as functions:

- ``fetch_rows(vid, used) -> rows``: the `used` survivor shards of one
  volume, in that order (bytes or uint8 arrays of one length);
- ``place(vid, missing, shards, crcs)``: store the rebuilt shards (uint8
  arrays, in `missing` order) and their `.ecc` block CRCs (one list per
  shard from the device, or None when the CRCs were not fused).

Every volume of a group shares a codec and lost the same shards, so one
decode matrix covers the group; volumes are stacked on the "vol" axis in
sub-batches of at most `max_batch_bytes` and each sub-batch is one K2
launch (fused CRC) or K1 launch per device.  `batch_rebuild_files` is
the local implementation: it plans the groups from the shard files
beside each base, reads survivor shard files and writes rebuilt shards
and their `.ecc` entries.  Fetching survivors from their holders and
scattering the rebuilt shards plug into `rebuild_group` in the cluster
layer.

The stages report as the JAX package's do: `batch_gather`,
`batch_rebuild_device` and `batch_scatter` (the placement) in the
`SeaweedFS_ec_stage_*` histograms, the gathered survivor bytes in
`SeaweedFS_ec_repair_read_bytes_total`, one `batch_reconstruct` roofline
row per step with its kernel time, the recorder in the ledger's
occupancy docs while `roofline.ARMED`, and an `ec.repair.local` event
per volume when every lost shard was repaired inside its locality group.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..codecs import Codec, get_codec
from ..ec import SMALL_BLOCK_SIZE, to_ext
from ..ec.integrity import ShardChecksums, ecc_lock, file_block_crcs
from ..ec.volume_info import ec_codec_name
from ..events import emit as emit_event
from ..ops.crc_fold import fused_crc_enabled
from ..stats import roofline as _roofline
from ..stats.metrics import ec_repair_read_bytes_total, observe_batch_stage
from .mesh import Mesh, make_mesh
from .sharded_codec import reconstruct_step, record_fenced_batch
from .stream_pipeline import PipelineRecorder, run_pipeline

# Column padding granularity without fused CRC (see cluster_encode).
_COL_ALIGN = 2048


def _pad_to(n: int, align: int) -> int:
    return -(-n // align) * align


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


def rebuild_group(codec: Codec, present, missing, vids, fetch_rows, place,
                  mesh: Mesh, max_batch_bytes: int = 1 << 28,
                  depth: int | None = None,
                  recorder: PipelineRecorder | None = None) -> list[str]:
    """Streamed rebuild of one survivor-signature group: the producer
    gathers and stacks the next sub-batch while the device decodes the
    current one and the drain thread places the completed shards.
    `recorder` collects the stage spans; without one, a bounded recorder
    is made while `roofline.ARMED`, and armed, it is folded into
    `roofline.LEDGER.note_pipeline` as "rebuild".  Returns one line per
    volume."""
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
    stages: dict = {}
    out: list[str] = []
    saved = f" ({codec.name}: read {len(used)} shards vs " \
            f"{codec.data_shards} for RS)" \
        if len(used) < codec.data_shards else ""

    def produce():
        i = 0
        bi = 0
        while i < len(vids):
            # The first volume's shard size bounds the sub-batch.
            t_gather = time.perf_counter()
            rows0 = fetch_rows(vids[i], used)
            per_vol = len(rows0[0]) * (len(used) + len(missing))
            chunk_v = max(1, min(len(vids) - i,
                                 int(max_batch_bytes // max(per_vol, 1))))
            chunk = vids[i:i + chunk_v]
            fetched = [rows0] + [fetch_rows(vid, used) for vid in chunk[1:]]
            gathered = sum(len(row) for rows in fetched for row in rows)
            ec_repair_read_bytes_total.inc(gathered, codec=codec.name)
            sizes = [len(rows[0]) for rows in fetched]
            n_pad = _pad_to(max(sizes), align)
            v_pad = _pad_to(len(chunk), vol_axis)
            stacked = torch.zeros((v_pad, len(used), n_pad),
                                  dtype=torch.uint8, pin_memory=on_cuda)
            view = stacked.numpy()
            for v, rows in enumerate(fetched):
                for r, row in enumerate(rows):
                    if len(row) != sizes[v]:
                        raise ValueError(
                            f"volume {chunk[v]}: survivor shards disagree "
                            f"on size ({len(row)} vs {sizes[v]})")
                    view[v, r, :len(row)] = np.frombuffer(row, np.uint8)
            t_gend = time.perf_counter()
            observe_batch_stage(stages, "batch_gather", t_gend - t_gather,
                                gathered)
            if rec is not None:
                rec.note_span("stack", bi, t_gather, t_gend)
            yield stacked, chunk, sizes, bi
            bi += 1
            i += chunk_v

    def dispatch(item):
        stacked, chunk, sizes, bi = item
        t_d0 = time.perf_counter()
        # Device CRCs of the rebuilt rows ride along when every shard of
        # the sub-batch covers whole `.ecc` blocks (shard files are 1 MiB
        # block padded by construction).
        use_crc = fused and all(s % block == 0 for s in sizes)
        with device_streams(streams):
            step = reconstruct_step(stacked, present, missing, mesh, codec,
                                    use_crc)
            step.start_host_copy(on_cuda)
        t_d1 = time.perf_counter()
        if rec is not None:
            rec.note_span("dispatch", bi, t_d0, t_d1)
        return step, use_crc, chunk, sizes, stacked.nbytes, bi, t_d1

    def drain(handle):
        step, use_crc, chunk, sizes, nbytes, bi, t_d1 = handle
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
        for v, vid in enumerate(chunk):
            shards = [rebuilt[v, m, :sizes[v]] for m in range(len(missing))]
            shard_crcs = None
            if crcs is not None:
                nb = sizes[v] // block
                shard_crcs = [[int(c) for c in crcs[v, m, :nb]]
                              for m in range(len(missing))]
            scattered += sizes[v] * len(missing)
            place(vid, missing, shards, shard_crcs)
            if all_local:
                emit_event("ec.repair.local", vid=vid, codec=codec.name,
                           shard=list(missing), reads=len(used),
                           bytes=sizes[v] * len(used))
            out.append(f"volume {vid}: rebuilt shards {list(missing)}"
                       + saved)
        t_send = time.perf_counter()
        observe_batch_stage(stages, "batch_scatter", t_send - t_scatter,
                            scattered)
        if rec is not None:
            rec.note_span("drain", bi, t_scatter, t_send)

    run_pipeline(produce(), dispatch, drain, depth=depth, recorder=rec)
    if rec is not None and _roofline.ARMED:
        _roofline.LEDGER.note_pipeline("rebuild", rec)
    return out


def _read_rows(base: str, used) -> list[np.ndarray]:
    return [np.fromfile(base + to_ext(sid), dtype=np.uint8) for sid in used]


def _write_rebuilt(base: str, missing, shards, crcs) -> None:
    for m, sid in enumerate(missing):
        with open(base + to_ext(sid), "wb") as f:
            f.write(np.ascontiguousarray(shards[m]))
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
    (paths without extension) in batched device steps, and their `.ecc`
    entries.  Each volume's codec comes from its `.vif`; volumes are
    grouped by (codec, surviving shards, missing shards).  The mesh
    defaults to every visible card (raising without one); a mesh of CPU
    devices runs the kernels' plain versions.  Returns one line per
    volume, skipped ones included."""
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
        messages += rebuild_group(get_codec(name), present, missing, group,
                                  _read_rows, _write_rebuilt, mesh,
                                  max_batch_bytes, depth, recorder)
    return messages
