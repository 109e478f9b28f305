"""Batched EC encode of many volumes: one device step per stripe chunk
of every volume in a group.

Port of seaweedfs_tpu/parallel/cluster_encode.py.  Steps 2-3 of the
reference's `_encode_batch_group_inner` are `encode_volume_files`:
stream-encode local `.dat` files with stripe chunks of many volumes
stacked on the "vol" axis, write their shards, then `.ecx` and `.vif`,
and return each volume's device-computed `.ecc` CRCs.  Two entry points
wrap it:

- `batch_encode_files`, the local one: it groups volumes under
  `max_batch_bytes` and writes the `.ecc` sidecars beside the shards;
- `batch_encode`, the shell's `ec.encode -batch`: it freezes every
  replica, pulls each `.dat`/`.idx` from a holder (`_fetch_volume`),
  encodes, then scatters the shards under a byte budget to a balanced
  placement, each holder's device `.ecc` fragment first
  (`_ecc_push_plan`), a shard larger than a piece in pieces at its
  offsets (`_scatter_shard`), mounts them and deletes the originals.

The data path is streamed (stream_pipeline.py): a prefetch thread stacks
the next chunk batch into a reusable host buffer — pinned, when the
mesh's devices are CUDA, so the host-to-device copy is asynchronous —
while the caller's thread copies it in, launches K2 (fused `.ecc` CRC)
or K1, and copies the results out on a CUDA stream of its own, and a
drain thread waits for that step's event and appends the shard files.
Each volume's chunk sequence is the local encoder's `_chunk_reader`, so
every shard, `.ecx`, `.vif` and `.ecc` is byte-identical to
`write_ec_files`.

The stages report as the JAX package's do: `batch_stack`,
`batch_encode_device` and `batch_write` in the `SeaweedFS_ec_stage_*`
histograms (host clock), one `batch_encode` roofline row per step with
the step's kernel time, and, while `roofline.ARMED`, the run's
`PipelineRecorder` folded into the ledger's occupancy docs.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ..cluster import rpc
from ..codecs import get_codec
from ..ec import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext
from ..ec.encoder import (DEFAULT_CHUNK, _chunk_reader,
                          write_sorted_file_from_idx)
from ..ec.integrity import ShardChecksums, ecc_lock, file_block_crcs
from ..ec.volume_info import update_volume_info
from ..events import emit as emit_event
from ..fault import registry as _fault
from ..ops.crc_fold import fused_crc_enabled
from ..stats import flows as _flows
from ..stats import roofline as _roofline
from ..stats.metrics import observe_batch_stage, stage_attrs
from ..trace import root_span
from .cluster_rebuild import _pad_to, make_mesh
from .mesh import Mesh
from .sharded_codec import encode_step, record_fenced_batch
from .stream_pipeline import PipelineRecorder, run_pipeline

# Column padding granularity without fused CRC: a multiple of K1's
# 16-byte width unit that divides over any col axis <= 16, and few
# distinct step widths.
_COL_ALIGN = 2048


def pipeline_depth(depth: int | None = None) -> int:
    """Chunks in flight between prefetch and drain (0 = the serialized
    loop); SEAWEEDFS_TPU_EC_PIPELINE_DEPTH, as for seaweedfs_tpu, else 2."""
    if depth is not None:
        return depth
    return int(os.environ.get("SEAWEEDFS_TPU_EC_PIPELINE_DEPTH", "2"))


def mesh_on_cuda(mesh: Mesh) -> bool:
    return any(d.type == "cuda" for d in mesh.device_list())


@contextlib.contextmanager
def device_streams(streams: dict):
    """Make each CUDA stream in `streams` (device -> stream) current for
    its device."""
    with contextlib.ExitStack() as stack:
        for s in streams.values():
            stack.enter_context(torch.cuda.stream(s))
        yield


def side_streams(mesh: Mesh) -> dict:
    """One CUDA stream per CUDA device of the mesh, for a pipeline's
    copies and launches."""
    return {d: torch.cuda.Stream(d) for d in dict.fromkeys(
        mesh.device_list()) if d.type == "cuda"}


class _BufferPool:
    """Reusable host staging buffers for the stacked chunk batches.

    The pipeline recycles a buffer only after its chunk's device step
    has been waited for (drain), so at most `slots` stacked batches
    exist.  With `pin` the buffers are page-locked, so the host-to-device
    copy of a step is asynchronous; pinning needs a CUDA build."""

    def __init__(self, slots: int, nbytes: int, pin: bool,
                 cancel: threading.Event | None = None):
        self._free: list[torch.Tensor] = []
        self._slots = slots
        self._nbytes = nbytes
        self._pin = pin
        self._cond = threading.Condition()
        self._made = 0
        # Shared with the stream pipeline: if the drain stage dies, no
        # release() is ever coming — a producer blocked here must
        # observe the cancellation instead of deadlocking the join.
        self._cancel = cancel

    def acquire(self) -> torch.Tensor:
        """A flat uint8 buffer of `nbytes`; a step views its first bytes
        as a contiguous (V, rows, width) batch.  Recycled buffers keep
        their stale bytes: the producer writes or zeroes every byte of
        the view it stacks into."""
        with self._cond:
            while not self._free and self._made >= self._slots:
                if self._cancel is not None and self._cancel.is_set():
                    raise RuntimeError("encode pipeline cancelled")
                self._cond.wait(0.2)
            if self._free:
                return self._free.pop()
            self._made += 1
        return torch.empty(self._nbytes, dtype=torch.uint8,
                           pin_memory=self._pin)

    def release(self, buf: torch.Tensor) -> None:
        with self._cond:
            self._free.append(buf)
            self._cond.notify()


class _ShardWriter:
    """Appends stripe chunks to the codec's local shard files of one
    volume in arrival order — the same order `write_ec_files` writes
    them."""

    def __init__(self, base: str, total_shards: int):
        self.files = [open(base + to_ext(i), "wb")
                      for i in range(total_shards)]

    def write(self, data: np.ndarray, parity: np.ndarray) -> None:
        for i in range(DATA_SHARDS):
            self.files[i].write(np.ascontiguousarray(data[i]))
        for p in range(parity.shape[0]):
            self.files[DATA_SHARDS + p].write(np.ascontiguousarray(parity[p]))

    def finish(self) -> None:
        for f in self.files:
            f.close()


def _check_chunk_size(chunk_size: int) -> None:
    if not SMALL_BLOCK_SIZE <= chunk_size <= LARGE_BLOCK_SIZE:
        raise ValueError(
            f"chunk_size {chunk_size} must be within "
            f"[{SMALL_BLOCK_SIZE}, {LARGE_BLOCK_SIZE}]")
    if LARGE_BLOCK_SIZE % chunk_size != 0:
        raise ValueError(
            f"chunk_size {chunk_size} must divide the large block "
            f"size {LARGE_BLOCK_SIZE}")


def batch_encode_files(bases, mesh: Mesh | None = None,
                       max_batch_bytes: int = 1 << 28,
                       chunk_size: int = DEFAULT_CHUNK, codec=None,
                       depth: int | None = None,
                       recorder: PipelineRecorder | None = None
                       ) -> list[str]:
    """EC-encode the local volumes `bases` (paths without extension,
    each with its `.dat` and `.idx`) in batched device steps, writing
    every volume's `.ec00`-`.ec13`, `.ecx`, `.vif` and `.ecc`.  Volumes
    are grouped in order until a group holds `max_batch_bytes` of
    `.dat`.  The mesh defaults to every visible card (raising without
    one); a mesh of CPU devices runs the kernels' plain versions.
    Returns one line per volume."""
    _check_chunk_size(chunk_size)
    codec = get_codec(codec)
    depth = pipeline_depth(depth)
    if mesh is None:
        mesh = make_mesh()
    bases = list(bases)
    sizes = [os.path.getsize(b + ".dat") for b in bases]
    out: list[str] = []
    i = 0
    while i < len(bases):
        group, total = [], 0
        while i < len(bases) and (not group or total < max_batch_bytes):
            group.append(bases[i])
            total += sizes[i]
            i += 1
        crcs = encode_volume_files(group, mesh, chunk_size, codec, depth,
                                   recorder)
        for v, base in enumerate(group):
            with ecc_lock(base):
                ecc = ShardChecksums(base)
                for sid in range(codec.total_shards):
                    ecc.set_shard(sid, crcs[v][sid] if crcs is not None
                                  else file_block_crcs(base + to_ext(sid)))
                ecc.save()
            out.append(f"volume {base} -> {codec.total_shards} ec shards "
                       f"({codec.name}, {len(group)} volumes per step)")
    return out


def encode_volume_files(bases, mesh: Mesh, chunk_size: int, codec,
                        depth: int,
                        recorder: PipelineRecorder | None = None,
                        stages: dict | None = None,
                        vif_version: bool = False
                        ) -> list[list[list[int]]] | None:
    """Stream-encode the local `.dat` files `bases` in one group: write
    every volume's shard files, `.ecx` and `.vif` (with the needle
    version of the `.dat` when `vif_version`, as the cluster scatter
    ships it).  Returns each volume's per-shard `.ecc` block CRCs from
    the device (fused CRC), or None when the CRCs were not fused (the
    caller then checksums the shard files).  `recorder` collects the
    stack, dispatch, device and drain spans; without one, a bounded
    recorder is made while `roofline.ARMED`.  Armed, the recorder is
    folded into `roofline.LEDGER.note_pipeline` as "encode".  `stages`
    collects the batch_* stage seconds and bytes."""
    vol_axis = mesh.shape["vol"]
    col_axis = mesh.shape["col"]
    on_cuda = mesh_on_cuda(mesh)
    # Fused device CRCs need every stacked width to cover whole `.ecc`
    # blocks per mesh column; `_chunk_reader` widths are always 1 MiB
    # multiples when chunk_size is.
    fused = fused_crc_enabled(mesh.device_list()[0]) \
        and chunk_size % SMALL_BLOCK_SIZE == 0
    align = SMALL_BLOCK_SIZE * col_axis if fused \
        else _pad_to(_COL_ALIGN, col_axis * 8)
    writers = [_ShardWriter(b, codec.total_shards) for b in bases]
    vol_crcs: list[list[list[int]]] = \
        [[[] for _ in range(codec.total_shards)] for _ in bases]
    dats = [open(b + ".dat", "rb") for b in bases]
    n_cap = _pad_to(max(SMALL_BLOCK_SIZE,
                        min(chunk_size, LARGE_BLOCK_SIZE)), align)
    v_cap = _pad_to(len(bases), vol_axis)
    cancel = threading.Event()
    buffers = _BufferPool(max(2, depth + 1), v_cap * DATA_SHARDS * n_cap,
                          on_cuda, cancel=cancel)
    streams = side_streams(mesh)
    rec = recorder
    if rec is None and _roofline.ARMED:
        rec = PipelineRecorder(maxlen=1024)
    if stages is None:
        stages = {}
    try:
        iters = [
            _chunk_reader(d, os.path.getsize(b + ".dat"),
                          LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, chunk_size)
            for d, b in zip(dats, bases)]

        def produce():
            active = list(range(len(iters)))
            bi = 0
            while active:
                t_stack = time.perf_counter()
                chunks, produced = [], []
                for v in active:
                    try:
                        chunks.append(next(iters[v]))
                        produced.append(v)
                    except StopIteration:
                        pass
                if not chunks:
                    break
                widths = [c.shape[1] for c in chunks]
                n_pad = _pad_to(max(widths), align)
                v_pad = _pad_to(len(chunks), vol_axis)
                # Backpressure wait (drain has not recycled a buffer yet)
                # is pipeline idle time, not stacking work.
                t_wait0 = time.perf_counter()
                buf = buffers.acquire()
                t_wait1 = time.perf_counter()
                t_wait = t_wait1 - t_wait0
                stacked = buf[:v_pad * DATA_SHARDS * n_pad].view(
                    v_pad, DATA_SHARDS, n_pad)
                view = stacked.numpy()
                for j, c in enumerate(chunks):
                    view[j, :, :c.shape[1]] = c
                    view[j, :, c.shape[1]:] = 0
                view[len(chunks):] = 0
                t_end = time.perf_counter()
                observe_batch_stage(stages, "batch_stack",
                                    t_end - t_stack - t_wait,
                                    sum(widths) * DATA_SHARDS)
                if rec is not None:
                    rec.note_span("stack", bi, t_stack, t_wait0)
                    rec.note_span("stack", bi, t_wait1, t_end)
                yield buf, stacked, produced, widths, bi
                bi += 1
                active = produced

        def dispatch(item):
            buf, stacked, active, widths, bi = item
            t_d0 = time.perf_counter()
            with device_streams(streams):
                step = encode_step(stacked, mesh, codec, fused)
                step.start_host_copy(on_cuda)
            t_d1 = time.perf_counter()
            if rec is not None:
                rec.note_span("dispatch", bi, t_d0, t_d1)
            return buf, stacked, step, active, widths, bi, t_d1

        def drain(handle):
            buf, stacked, step, active, widths, bi, t_d1 = handle
            # The exposed device + copy wait: with the pipeline
            # overlapping, its per-batch sum exceeds its share of the wall.
            t_dev = time.perf_counter()
            step.wait()
            parity = step.host_out()
            crcs = step.host_crcs() if fused else None
            t_fence = time.perf_counter()
            observe_batch_stage(stages, "batch_encode_device",
                                t_fence - t_dev, stacked.nbytes)
            if rec is not None:
                # Device busy is seen only as [dispatch end, event done]:
                # it includes queueing, an upper bound on kernel time.
                rec.note_span("device", bi, t_d1, t_fence)
            if _roofline.ARMED:
                seconds = step.kernel_seconds()
                if seconds is not None:
                    record_fenced_batch(
                        "batch_encode", codec.name,
                        out_rows=int(parity.shape[1]),
                        in_rows=DATA_SHARDS, n=int(parity.shape[2]),
                        batch=int(parity.shape[0]), crc=crcs is not None,
                        seconds=seconds,
                        measured_bytes=int(stacked.nbytes) + parity.nbytes,
                        device=mesh.device_list()[0])
            t_wr = time.perf_counter()
            written = 0
            data = stacked.numpy()
            for j, v in enumerate(active):
                w = widths[j]
                writers[v].write(data[j, :, :w], parity[j, :, :w])
                written += w * (DATA_SHARDS + parity.shape[1])
                if crcs is not None:
                    nb = w // SMALL_BLOCK_SIZE
                    for sid in range(codec.total_shards):
                        vol_crcs[v][sid].extend(
                            int(c) for c in crcs[j, sid, :nb])
            t_wr1 = time.perf_counter()
            observe_batch_stage(stages, "batch_write", t_wr1 - t_wr, written)
            if rec is not None:
                rec.note_span("drain", bi, t_fence, t_wr1)
            buffers.release(buf)

        run_pipeline(produce(), dispatch, drain, depth=depth,
                     cancel=cancel, recorder=rec)
        if rec is not None and _roofline.ARMED:
            _roofline.LEDGER.note_pipeline("encode", rec)
    finally:
        for d in dats:
            d.close()
        for w in writers:
            w.finish()

    # .ecx from the .idx (WriteSortedFileFromIdx) and the .vif codec id,
    # as write_ec_files records them.
    for base in bases:
        write_sorted_file_from_idx(base)
        if vif_version:
            with open(base + ".dat", "rb") as f:
                version = f.read(1)[0]
            update_volume_info(base, version=version, codec=codec.name)
        else:
            update_volume_info(base, codec=codec.name)
    return vol_crcs if fused else None


# -- the network half: ec.encode -batch over the cluster ---------------------

def scatter_budget_bytes() -> int:
    """Cap on concurrent in-flight shard payload bytes during scatter —
    a batch of large volumes must not hold every shard file in memory at
    once (shards are read inside the budgeted workers, not up front)."""
    return int(os.environ.get("SEAWEEDFS_TPU_EC_SCATTER_BUDGET",
                              str(256 << 20)))


def scatter_piece_bytes(budget: int) -> int:
    """Width of one pushed piece of a shard larger than it: a quarter
    of the scatter budget in whole `.ecc` blocks (at least one), so
    four pushes fit in flight at once."""
    return max(SMALL_BLOCK_SIZE,
               budget // 4 // SMALL_BLOCK_SIZE * SMALL_BLOCK_SIZE)


class _ByteBudget:
    """Blocking byte-count semaphore; a request larger than the cap is
    clamped so it can always proceed alone (`_scatter_shard` never asks
    for more than one piece)."""

    def __init__(self, cap: int):
        self.cap = max(1, cap)
        self._used = 0
        self._cond = threading.Condition()

    def acquire(self, nbytes: int) -> int:
        take = min(nbytes, self.cap)
        with self._cond:
            while self._used + take > self.cap:
                self._cond.wait()
            self._used += take
        return take

    def release(self, taken: int) -> None:
        with self._cond:
            self._used -= taken
            self._cond.notify_all()


def batch_encode(env, vids, mesh: Mesh | None = None,
                 max_batch_bytes: int = 1 << 28, workers: int = 8,
                 chunk_size: int = DEFAULT_CHUNK, progress=None,
                 codec=None, depth: int | None = None) -> list[str]:
    """EC-encode `vids` across the cluster in batched device steps.
    Returns one line per volume.  `codec` selects the erasure codec
    ("rs" default / "lrc"); the generator matrix, shard count and the
    `.vif` codec id pushed to every holder derive from it.  `depth`
    overrides the stream-pipeline depth (0 = serialized).  The mesh
    defaults to every visible card (raising without one).

    env: duck-typed cluster view (shell CommandEnv): volume_locations,
    data_nodes, vs_call."""
    # Refused before any replica is frozen.
    _check_chunk_size(chunk_size)
    codec = get_codec(codec)
    depth = pipeline_depth(depth)
    if mesh is None:
        mesh = make_mesh()
    # One size map per call, not a topology rescan per volume.
    sizes: dict[int, int] = {}
    for n in env.data_nodes():
        for v in n["volumes"]:
            sizes.setdefault(v["id"], int(v["size"]))
    targets: list[tuple[int, list[str]]] = []
    messages: list[str] = []
    for vid in vids:
        try:
            locs = env.volume_locations(vid)
        except rpc.RpcError as e:
            if e.status != 404:
                raise
            locs = []
        if not locs:
            messages.append(f"volume {vid}: SKIPPED — no locations")
            continue
        targets.append((vid, locs))
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    try:
        i = 0
        while i < len(targets):
            batch, total = [], 0
            while i < len(targets) and (not batch
                                        or total < max_batch_bytes):
                batch.append(targets[i])
                total += sizes.get(targets[i][0], 0)
                i += 1
            messages += _encode_batch_group(env, mesh, pool, batch,
                                            chunk_size, progress,
                                            codec, depth)
    finally:
        # Queued fetch/scatter work of a failed batch must not keep
        # running after the exception has unwound to the caller.
        pool.shutdown(wait=False, cancel_futures=True)
    return messages


def _fetch_volume(tmpdir: str, vid: int, locs: list[str]) -> str:
    """Pull one frozen volume's .dat/.idx to local temp files, failing
    over across replicas.  Returns the local base path."""
    base = os.path.join(tmpdir, str(vid))
    errors = []
    for url in locs:
        try:
            if _fault.ARMED:
                _fault.hit("ec.fetch_shard", holder=url, vid=vid)
            _h = {**rpc.PRIORITY_LOW, **_flows.tag("ec.gather")}
            rpc.call_to_file(
                f"http://{url}/admin/volume_file?volume={vid}&ext=.idx",
                base + ".idx", headers=_h)
            rpc.call_to_file(
                f"http://{url}/admin/volume_file?volume={vid}&ext=.dat",
                base + ".dat", headers=_h)
            return base
        except Exception as e:  # noqa: BLE001 — next replica
            errors.append(f"{url}: {type(e).__name__}: {e}")
    raise rpc.RpcError(
        502, f"volume {vid}: cannot fetch .dat/.idx: "
             + "; ".join(errors[:4]))


def _encode_batch_group(env, mesh, pool, batch, chunk_size,
                        progress, codec, depth) -> list[str]:
    """Fetch, encode, scatter one sub-batch of volumes — journaled as
    ec.encode.start/finish with per-stage byte/second attrs, under a
    root span."""
    vids = [vid for vid, _locs in batch]
    with root_span("ec.batch_encode", "ec", volumes=len(vids),
                   codec=codec.name):
        emit_event("ec.encode.start", volumes=vids, batch=True,
                   codec=codec.name)
        t0 = time.perf_counter()
        stages: dict[str, list[float]] = {}
        try:
            out = _encode_batch_group_inner(env, mesh, pool, batch,
                                            chunk_size, progress,
                                            stages, codec, depth)
        except Exception as e:
            emit_event("ec.encode.finish", severity="error",
                       volumes=vids, batch=True, codec=codec.name,
                       seconds=round(time.perf_counter() - t0, 6),
                       error=f"{type(e).__name__}: {e}",
                       **stage_attrs(stages))
            raise
        emit_event("ec.encode.finish", volumes=vids, batch=True,
                   codec=codec.name, pipeline_depth=depth,
                   seconds=round(time.perf_counter() - t0, 6),
                   **stage_attrs(stages))
        return out


def _encode_batch_group_inner(env, mesh, pool, batch, chunk_size,
                              progress, stages, codec, depth) -> list[str]:
    """Fetch, stream-encode, scatter one sub-batch of volumes."""
    from ..shell.command_ec import balanced_distribution, collect_ec_nodes
    out: list[str] = []
    with tempfile.TemporaryDirectory(prefix="ec_batch_encode_") as tmp:
        # 1. Freeze every replica, then pull .dat/.idx in parallel.
        for vid, locs in batch:
            for url in locs:
                env.vs_call(url, "/admin/readonly",
                            {"volume": vid, "readonly": True})
        t_fetch = time.perf_counter()
        bases = list(pool.map(lambda t: _fetch_volume(tmp, *t), batch))
        observe_batch_stage(
            stages, "batch_fetch", time.perf_counter() - t_fetch,
            sum(os.path.getsize(b + ".dat") for b in bases))

        # 2-3. Stream-encode the group, then .ecx and a .vif with the
        # needle version and codec id: every shard holder must know
        # which generator matrix made its shards.
        vol_crcs = encode_volume_files(bases, mesh, chunk_size, codec,
                                       depth, stages=stages,
                                       vif_version=True)

        # 4. Scatter: balanced placement; push the device-computed
        # `.ecc` fragment first (so receive_shard skips its CPU CRC pass
        # over the pushed bytes), then shards under the byte budget,
        # then .ecx/.vif, mount, delete the originals
        # (command_ec_encode.go flow).
        budget = _ByteBudget(scatter_budget_bytes())
        for b_idx, ((vid, locs), base) in enumerate(zip(batch, bases)):
            plan = balanced_distribution(collect_ec_nodes(env),
                                         n_shards=codec.total_shards)
            t_scatter = time.perf_counter()
            pusher = _ecc_push_plan(
                vid, ((url, sid, vol_crcs[b_idx][sid])
                      for url, sids in plan.items()
                      for sid in sids)) if vol_crcs is not None else None
            futs = []
            for url, shard_ids in plan.items():
                for sid in shard_ids:
                    futs.append(pool.submit(
                        _scatter_shard, url, vid, sid,
                        base + to_ext(sid), budget, pusher))
            scattered = sum(f.result() for f in futs)
            observe_batch_stage(stages, "batch_scatter",
                                time.perf_counter() - t_scatter, scattered)
            with open(base + ".ecx", "rb") as f:
                ecx = f.read()
            with open(base + ".vif", "rb") as f:
                vif = f.read()
            for url in plan:
                _h = {**rpc.PRIORITY_LOW, **_flows.tag("ec.scatter")}
                rpc.call(f"http://{url}/admin/ec/receive_file?"
                         f"volume={vid}&ext=.ecx", "POST", ecx, 600.0,
                         headers=_h)
                rpc.call(f"http://{url}/admin/ec/receive_file?"
                         f"volume={vid}&ext=.vif", "POST", vif, 600.0,
                         headers=_h)
                env.vs_call(url, "/admin/ec/mount", {"volume": vid})
            for url in locs:
                env.vs_call(url, "/admin/delete_volume", {"volume": vid})
            line = (f"volume {vid} -> ec shards on {len(plan)} "
                    "servers: "
                    + ", ".join(f"{u}:{s}"
                                for u, s in sorted(plan.items())))
            out.append(line)
            if progress:
                progress(line)
    return out


class _EccOncePush:
    """Once-per-holder push of the kernel-computed `.ecc` fragment, run
    lazily inside the scatter workers: the first shard worker bound for
    a holder ships that holder's fragment under its lock, so the entries
    land before any shard body and receive_shard can skip its CPU pass,
    while workers for other holders proceed in parallel.  The fragments
    are best effort: a holder that missed its fragment fingerprints the
    pushed bodies itself."""

    def __init__(self, vid: int, docs: dict[str, dict]):
        self._vid = vid
        self._docs = docs
        self._locks = {u: threading.Lock() for u in docs}

    def ensure(self, url: str) -> None:
        lock = self._locks.get(url)
        if lock is None:
            return
        with lock:
            doc = self._docs.pop(url, None)
            if doc is None:
                return  # already shipped (or the attempt failed)
            try:
                rpc.call(
                    f"http://{url}/admin/ec/receive_ecc?"
                    f"volume={self._vid}", "POST",
                    json.dumps(doc).encode(), 60.0,
                    headers={**rpc.PRIORITY_LOW,
                             **_flows.tag("ec.scatter")})
            except (rpc.RpcError, OSError):
                # Best effort: the holder recomputes from the body.
                pass


def _ecc_push_plan(vid: int, entries) -> _EccOncePush:
    """Per-holder `.ecc` fragments from `(holder_url, sid, crcs)`
    triples — the one place the fragment wire format (block key,
    8-hex-digit CRCs) is written, shared by encode and rebuild
    scatter."""
    docs: dict[str, dict] = {}
    for url, sid, crcs in entries:
        doc = docs.setdefault(
            url, {"block": SMALL_BLOCK_SIZE, "shards": {}})
        doc["shards"][str(sid)] = [f"{c:08x}" for c in crcs]
    return _EccOncePush(vid, docs)


def _scatter_shard(url: str, vid: int, sid: int, path: str,
                   budget: _ByteBudget,
                   ecc_push: _EccOncePush | None = None) -> int:
    """Push one encoded shard to its placement target: whole when it
    fits in one piece (`scatter_piece_bytes`), else piece by piece in
    order at its offsets (`receive_shard`'s `offset=`/`size=`).  Each
    piece is read here, inside the budgeted worker, and `budget` caps
    the total bytes in flight, a shard larger than the cap included.
    The fragment goes first, before budget is taken: workers queued on
    a slow holder's fragment lock must wait empty-handed."""
    if ecc_push is not None:
        ecc_push.ensure(url)
    size = os.path.getsize(path)
    width = scatter_piece_bytes(budget.cap)
    with open(path, "rb") as f:
        for lo in range(0, max(size, 1), width):
            n = min(width, size - lo)
            taken = budget.acquire(n)
            try:
                payload = os.pread(f.fileno(), n, lo)
                whole = n == size
                if _fault.ARMED:
                    _fault.hit("ec.scatter", target=url, vid=vid,
                               shard=sid, **({} if whole
                                             else {"offset": lo}))
                piece = "" if whole else f"&offset={lo}&size={size}"
                rpc.call(f"http://{url}/admin/ec/receive_shard?"
                         f"volume={vid}&shard={sid}{piece}", "POST",
                         payload, 600.0,
                         headers={**rpc.PRIORITY_LOW,
                                  **_flows.tag("ec.scatter")})
            finally:
                budget.release(taken)
    return size
