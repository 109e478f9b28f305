"""Batched EC encode of many volumes: one device step per stripe chunk
of every volume in a group.

Port of the network-free half of seaweedfs_tpu/parallel/cluster_encode.py:
`pipeline_depth`, `_BufferPool`, `_ShardWriter`, and steps 2-3 of
`_encode_batch_group_inner` as `encode_volume_files`: stream-encode local
`.dat` files with stripe chunks of many volumes stacked on the "vol" axis,
write their shards, then `.ecx` and `.vif`, and return each volume's
device-computed `.ecc` CRCs.  `batch_encode_files` is its local entry
point: it groups volumes under `max_batch_bytes` as `batch_encode` does
and writes the `.ecc` sidecars where the cluster path would push them to
the shard holders.  Fetching `.dat`/`.idx` from volume servers and scattering
the shards wrap `encode_volume_files` in the cluster layer.

The data path is streamed (stream_pipeline.py): a prefetch thread stacks
the next chunk batch into a reusable host buffer — pinned, when the
mesh's devices are CUDA, so the host-to-device copy is asynchronous —
while the caller's thread copies it in, launches K2 (fused `.ecc` CRC)
or K1, and copies the results out on a CUDA stream of its own, and a
drain thread waits for that step's event and appends the shard files.
Each volume's chunk sequence is the local encoder's `_chunk_reader`, so
every shard, `.ecx`, `.vif` and `.ecc` is byte-identical to
`write_ec_files`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch

from ..codecs import get_codec
from ..ec import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext
from ..ec.encoder import (DEFAULT_CHUNK, _chunk_reader,
                          write_sorted_file_from_idx)
from ..ec.integrity import ShardChecksums, ecc_lock, file_block_crcs
from ..ec.volume_info import update_volume_info
from ..ops.crc_fold import fused_crc_enabled
from .cluster_rebuild import _pad_to
from .mesh import Mesh, make_mesh
from .sharded_codec import encode_step
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
                        recorder: PipelineRecorder | None = None
                        ) -> list[list[list[int]]] | None:
    """Stream-encode the local `.dat` files `bases` in one group: write
    every volume's shard files, `.ecx` and `.vif`.  Returns each volume's
    per-shard `.ecc` block CRCs from the device (fused CRC), or None when
    the CRCs were not fused (the caller then checksums the shard files).
    `recorder` collects the stack, dispatch, device and drain spans."""
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
                stacked = buf[:v_pad * DATA_SHARDS * n_pad].view(
                    v_pad, DATA_SHARDS, n_pad)
                view = stacked.numpy()
                for j, c in enumerate(chunks):
                    view[j, :, :c.shape[1]] = c
                    view[j, :, c.shape[1]:] = 0
                view[len(chunks):] = 0
                t_end = time.perf_counter()
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
            step.wait()
            parity = step.host_out()
            crcs = step.host_crcs() if fused else None
            t_fence = time.perf_counter()
            if rec is not None:
                # Device busy is seen only as [dispatch end, event done]:
                # it includes queueing, an upper bound on kernel time.
                rec.note_span("device", bi, t_d1, t_fence)
            data = stacked.numpy()
            for j, v in enumerate(active):
                w = widths[j]
                writers[v].write(data[j, :, :w], parity[j, :, :w])
                if crcs is not None:
                    nb = w // SMALL_BLOCK_SIZE
                    for sid in range(codec.total_shards):
                        vol_crcs[v][sid].extend(
                            int(c) for c in crcs[j, sid, :nb])
            if rec is not None:
                rec.note_span("drain", bi, t_fence, time.perf_counter())
            buffers.release(buf)

        run_pipeline(produce(), dispatch, drain, depth=depth,
                     cancel=cancel, recorder=rec)
    finally:
        for d in dats:
            d.close()
        for w in writers:
            w.finish()

    # .ecx from the .idx (WriteSortedFileFromIdx) and the .vif codec id,
    # as write_ec_files records them.
    for base in bases:
        write_sorted_file_from_idx(base)
        update_volume_info(base, codec=codec.name)
    return vol_crcs if fused else None
