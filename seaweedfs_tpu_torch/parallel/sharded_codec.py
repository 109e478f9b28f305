"""Batched multi-volume erasure coding: V volumes in one kernel launch.

Port of seaweedfs_tpu/parallel/sharded_codec.py's batched steps (X3):

- `batched_encode`: (V, k, N) -> (V, p, N) parity for V volumes at once;
- `batched_encode_with_crc`: the same plus the actual crc32c of every
  `.ecc` block of every data and parity row, (V, k + p, N // BLOCK);
- `batched_reconstruct`: (V, len(used), N) survivor stacks -> (V, W, N)
  rebuilt shards for V volumes that lost the same shards;
- `batched_reconstruct_with_crc`: the same plus the block CRCs of every
  rebuilt row, (V, W, N // BLOCK).

Where the JAX package vmaps a bit-matrix matmul over the volumes, these
launch the port's kernels once per step and device with a volume axis:
K1 (`coder_cuda.apply_bitmatrix`) without CRC, K2
(`coder_cuda.apply_bitmatrix_crc`) with it.  K2 emits position-shifted
tile partials; the CRC variants copy those off the card (1/1024 of the
bytes) and fold them on the host with
`crc_fold.block_crcs_from_partials_batched`.  A reconstruct with CRC
runs K2 with the decode masks and keeps only the output rows' partials
(the survivor rows' CRC work is a known extra cost).

Without a mesh the step runs on `device` (default the card, raising
without one; ``device="cpu"`` runs the kernels' plain versions).  With a
`mesh.Mesh`, volumes split over "vol" and byte columns over "col", one
launch per device, and no bytes move between devices; results are then
`mesh.MeshArray`s.  The plain entry points return device tensors
without a synchronize, as `CudaCoder` does; the CRC variants wait for
the partials only.  `encode_step` and `reconstruct_step` expose the
device half for the stream pipeline, which copies the results to pinned
host memory on its own CUDA stream and waits for an event instead.

While `roofline.ARMED`, each launch of a step is bracketed by a
`roofline.KernelTimer` (a CUDA event pair on the launching stream);
`Step.kernel_seconds` reads them once `Step.wait` has seen the step's
copies done, and the pipelines of `cluster_encode`/`cluster_rebuild`
hand that to `record_fenced_batch`.

The multi-card reconstructions (X4) run one process per card over
`torch.distributed` (NCCL between cards, gloo on the CPU or between ranks
that share a card): every rank of the group calls
`all_to_all_reconstruct` or `ring_reconstruct` with the same arguments,
holds the shard rows `mesh.shard_row_block` gives it, and gets back its
column block of the output, (V, W, N/D) for D ranks (rank order is
column order, as the JAX package's result is sharded).  Each rank's
local solve is one K1 launch (`coder_cuda.apply_bitmatrix`), or its
plain version for a CPU tensor.  Over gloo a card's tensors cross
through host copies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import crc_fold
from ..ops.coder_cuda import (BLOCK_N, apply_bitmatrix, apply_bitmatrix_crc,
                              pack_bitmatrix, pack_crc_tables, plane_major)
from ..ops.erasure import resolve_device
from ..stats import roofline as _roofline
from .mesh import Mesh, MeshArray, shard_row_block, volume_blocks

# K1 on a card takes widths in multiples of 16 bytes: a block of another
# width is zero-padded for the launch and cut back after.
_K1_ALIGN = 16


def mm_name() -> str:
    """Roofline dtype label of the batch paths: the kernels mix bits
    with packed-mask AND/XOR, read against the int8 roof."""
    return "int8"


def record_fenced_batch(kernel: str, codec_name: str, *,
                        out_rows: int, in_rows: int, n: int,
                        batch: int, crc: bool, seconds: float,
                        measured_bytes: int | None = None,
                        node: str = "", device=None) -> None:
    """Roofline record for a batched kernel invocation.  The batch entry
    points return without waiting for the device (waiting inside
    dispatch would serialise the stream pipeline), so the caller
    invokes this from its drain site with `Step.kernel_seconds()`, read
    after `Step.wait`.  Callers gate on `roofline.ARMED` themselves so
    the disarmed cost stays one flag read."""
    try:
        _roofline.LEDGER.record(
            kernel, codec_name, mm_name(), out_rows=out_rows,
            in_rows=in_rows, n=n, batch=batch, crc=crc,
            seconds=seconds, measured_bytes=measured_bytes, node=node,
            device=device)
    except Exception:  # noqa: BLE001 — accounting never breaks encode
        pass


def _codec_of(data_shards: int, parity_shards: int, matrix_kind: str,
              codec):
    """An explicit codec wins, else ad-hoc RS from the shard counts."""
    from ..codecs import get_codec, rs_codec
    if codec is None:
        return rs_codec(data_shards, parity_shards, matrix_kind)
    return get_codec(codec)


def _check_mesh_divisible(mesh: Mesh, v: int, n: int) -> None:
    if v % mesh.shape["vol"]:
        raise ValueError(
            f"batch of {v} volumes must divide over vol axis "
            f"{mesh.shape['vol']}")
    if n % mesh.shape["col"]:
        raise ValueError(
            f"byte width {n} must divide over col axis "
            f"{mesh.shape['col']}")


def _check_crc_width(mesh: Mesh | None, n: int) -> None:
    block = crc_fold.BLOCK
    cols = mesh.shape["col"] if mesh is not None else 1
    if n % (block * cols):
        raise ValueError(
            f"byte width {n} must be a multiple of the .ecc block "
            f"{block} x col axis {cols}")


def _host_masks(bmat: np.ndarray, rows: int, cols: int) -> torch.Tensor:
    return torch.from_numpy(pack_bitmatrix(plane_major(
        np.asarray(bmat), rows, cols)))


@functools.lru_cache(maxsize=64)
def _parity_masks(codec) -> torch.Tensor:
    return _host_masks(codec.parity_bitmatrix(), codec.parity_shards,
                       codec.data_shards)


@functools.lru_cache(maxsize=256)
def _decode_masks(codec, present: tuple[int, ...], wanted: tuple[int, ...]
                  ) -> tuple[torch.Tensor, tuple[int, ...]]:
    bmat, used = codec.decode_bitmatrix(present, wanted)
    return _host_masks(bmat, len(wanted), len(used)), tuple(used)


@functools.lru_cache(maxsize=None)
def _crc_consts(device: torch.device) -> tuple[torch.Tensor, ...]:
    """K2's CRC tables on `device`, uploaded once and waited for, so a
    step on any stream of the device may read them."""
    consts = tuple(torch.from_numpy(a).to(device)
                   for a in pack_crc_tables(crc_fold.tables(BLOCK_N)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return consts


def _as_batch(x) -> torch.Tensor:
    """(V, R, N) uint8 tensor of a numpy array or tensor (no copy when
    it already is one)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    elif x.dtype != torch.uint8:
        x = x.to(torch.uint8)
    if x.dim() != 3:
        raise ValueError(f"expected a (volumes, rows, width) batch, got "
                         f"shape {tuple(x.shape)}")
    return x


class Step:
    """The device half of one batched call: each device's output block
    (and K2 partials), launched and not waited for."""

    def __init__(self, mesh: Mesh | None, shape: tuple[int, int, int]):
        self.mesh = mesh
        self.shape = shape
        # (vi, ci, device, volume slice, column slice, out, partials)
        self.parts: list[tuple] = []
        self._host = None
        self._events: list = []
        # One roofline.KernelTimer per launch while the ledger is armed.
        self.timers: list = []

    def array(self):
        """The output: a tensor on the device, or a MeshArray."""
        if self.mesh is None:
            return self.parts[0][5]
        return MeshArray(self.mesh, {(p[0], p[1]): p[5] for p in self.parts},
                         self.shape)

    def _fold(self, partials_of) -> np.ndarray:
        v, _r, n = self.shape
        rows = self.parts[0][6].shape[1]
        out = np.empty((v, rows, n // crc_fold.BLOCK), dtype=np.uint32)
        for _vi, _ci, _dev, vs, cs, _out, _parts in self.parts:
            width = cs.stop - cs.start
            b0 = cs.start // crc_fold.BLOCK
            out[vs, :, b0:b0 + width // crc_fold.BLOCK] = \
                crc_fold.block_crcs_from_partials_batched(
                    partials_of(vs, cs, _parts), width, BLOCK_N)
        return out

    def crcs(self) -> np.ndarray:
        """(V, rows, N // BLOCK) uint32 block CRCs: copies the partials
        to the host (waiting for them) and folds them."""
        return self._fold(lambda _vs, _cs, p: p.cpu().numpy())

    # -- asynchronous copy-out, for the stream pipeline ---------------------

    def start_host_copy(self, pin: bool) -> None:
        """Copy every output (and partials) block into host tensors
        (pinned when `pin`) on each device's current stream, and record
        an event there.  `wait()` then makes them readable."""
        v, r, n = self.shape
        out = torch.empty((v, r, n), dtype=torch.uint8, pin_memory=pin)
        parts = None
        if self.parts[0][6] is not None:
            prow = self.parts[0][6].shape[1]
            parts = torch.empty((v, prow, n // BLOCK_N), dtype=torch.int32,
                                pin_memory=pin)
        for _vi, _ci, dev, vs, cs, o, p in self.parts:
            out[vs, :, cs].copy_(o, non_blocking=pin)
            if parts is not None:
                parts[vs, :, cs.start // BLOCK_N:cs.stop // BLOCK_N].copy_(
                    p, non_blocking=pin)
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self._events.append(ev)
        self._host = (out, parts)

    def wait(self) -> None:
        """Block until start_host_copy's copies are done: the events of
        this step only, never the whole device."""
        for ev in self._events:
            ev.synchronize()

    def kernel_seconds(self) -> float | None:
        """The step's kernel time, the longest of its launches (they run
        on their devices side by side): device time on a card, host time
        of the plain versions on the CPU.  After `wait` the launches'
        end events have completed; None when the step was not timed or a
        launch is still running."""
        secs = [t.seconds() for t in self.timers]
        if not secs or None in secs:
            return None
        return max(secs)

    def host_out(self) -> np.ndarray:
        return self._host[0].numpy()

    def host_crcs(self) -> np.ndarray:
        parts = self._host[1]
        return self._fold(lambda vs, cs, _p: parts[
            vs, :, cs.start // BLOCK_N:cs.stop // BLOCK_N].numpy())


def _step(x, mesh: Mesh | None, device, masks: torch.Tensor, crc: bool,
          keep_from: int = 0) -> Step:
    """Launch K1 (or K2 when `crc`) once per device on its block of the
    (V, R, N) batch x.  Partials rows before `keep_from` are dropped."""
    x = _as_batch(x)
    v, _r, n = x.shape
    out_rows = masks.shape[0] // 8
    if mesh is None:
        blocks = [(0, 0, resolve_device(device), slice(0, v), slice(0, n))]
    else:
        _check_mesh_divisible(mesh, v, n)
        blocks = volume_blocks(mesh, v, n)
    step = Step(mesh, (v, out_rows, n))
    for vi, ci, dev, vs, cs in blocks:
        blk = x[vs, :, cs]
        if blk.device != dev:
            blk = blk.contiguous().to(dev, non_blocking=True)
        blk = blk.contiguous()
        width = blk.shape[2]
        partials = None
        timer = _roofline.KernelTimer(dev) if _roofline.ARMED else None
        if crc:
            out, partials = apply_bitmatrix_crc(masks, blk, *_crc_consts(dev),
                                                timer=timer)
            partials = partials[:, keep_from:]
        elif dev.type == "cuda" and width % _K1_ALIGN:
            padded = torch.zeros((*blk.shape[:2], -(-width // _K1_ALIGN)
                                  * _K1_ALIGN), dtype=torch.uint8, device=dev)
            padded[:, :, :width] = blk
            out = apply_bitmatrix(masks, padded, timer=timer)[:, :, :width]
        else:
            out = apply_bitmatrix(masks, blk, timer=timer)
        if timer is not None:
            step.timers.append(timer)
        step.parts.append((vi, ci, dev, vs, cs, out, partials))
    return step


def encode_step(data, mesh: Mesh | None, codec, crc: bool,
                device="cuda") -> Step:
    """The device half of batched_encode[_with_crc]."""
    if crc:
        _check_crc_width(mesh, _as_batch(data).shape[2])
    return _step(data, mesh, device, _parity_masks(codec), crc)


def reconstruct_step(stacked, present, wanted, mesh: Mesh | None, codec,
                     crc: bool, device="cuda") -> Step:
    """The device half of batched_reconstruct[_with_crc]."""
    masks, used = _decode_masks(codec, tuple(present), tuple(wanted))
    stacked = _as_batch(stacked)
    if stacked.shape[1] != len(used):
        raise ValueError(
            f"stacked must carry the {len(used)} used survivor rows "
            f"({[int(u) for u in used]}), got {stacked.shape[1]}")
    if crc:
        _check_crc_width(mesh, stacked.shape[2])
    return _step(stacked, mesh, device, masks, crc, keep_from=len(used))


def batched_encode(data, mesh: Mesh | None = None,
                   data_shards: int = 10, parity_shards: int = 4,
                   matrix_kind: str = "vandermonde", codec=None,
                   device="cuda"):
    """(V, data_shards, N) uint8 -> (V, parity_shards, N) parity.

    One K1 launch per device: volumes over the mesh's "vol" axis, byte
    columns over "col" (parity is columnwise for every codec, so no
    bytes move between devices).  `codec` swaps the generator matrix
    (e.g. "lrc"); the kernel is the same."""
    cd = _codec_of(data_shards, parity_shards, matrix_kind, codec)
    return encode_step(data, mesh, cd, False, device).array()


def batched_encode_with_crc(data, mesh: Mesh | None = None, codec=None,
                            device="cuda"):
    """batched_encode plus the crc32c of every `.ecc` block of EVERY
    shard row (data rows first, then parity), from one K2 launch per
    device.

    data: (V, k, N) uint8 with N a multiple of the `.ecc` block (1 MiB)
    times the mesh col axis — zero-padded tail blocks yield the crc of a
    zero block, to be sliced off by true width.  Returns (parity
    (V, p, N) uint8 on the device, crcs (V, k+p, N // BLOCK) uint32 on
    the host)."""
    cd = _codec_of(10, 4, "vandermonde", codec)
    step = encode_step(data, mesh, cd, True, device)
    return step.array(), step.crcs()


def batched_reconstruct(stacked, present: tuple[int, ...],
                        wanted: tuple[int, ...],
                        mesh: Mesh | None = None,
                        data_shards: int = 10, parity_shards: int = 4,
                        matrix_kind: str = "vandermonde", codec=None,
                        device="cuda"):
    """Rebuild `wanted` shards for V volumes that all lost the same shards.

    stacked: (V, len(used), N) — the codec's `used` survivor rows
    (codec.decode_matrix(present, wanted)[1], stacked in that order) for
    each volume; for RS the first data_shards survivors by id, for LRC
    the planned minimal read set (5 rows for an in-group loss).  Returns
    (V, len(wanted), N) from one K1 launch per device."""
    cd = _codec_of(data_shards, parity_shards, matrix_kind, codec)
    return reconstruct_step(stacked, present, wanted, mesh, cd, False,
                            device).array()


def batched_reconstruct_with_crc(stacked, present: tuple[int, ...],
                                 wanted: tuple[int, ...],
                                 mesh: Mesh | None = None, codec=None,
                                 device="cuda"):
    """batched_reconstruct plus the crc32c of every `.ecc` block of every
    REBUILT row, from one K2 launch per device with the decode masks.
    Returns (rebuilt (V, W, N) uint8 on the device, crcs (V, W,
    N // BLOCK) uint32 on the host).  N must be a multiple of the `.ecc`
    block times the mesh col axis."""
    cd = _codec_of(10, 4, "vandermonde", codec)
    step = reconstruct_step(stacked, present, wanted, mesh, cd, True, device)
    return step.array(), step.crcs()


# -- X4: shard-major reconstruction across ranks ------------------------------

def _shard_major_prep(stacked, present, wanted, group, data_shards,
                      parity_shards, matrix_kind, device):
    """Shared prologue of the shard-major reconstructions: the decode
    bit matrix in plane-major order (8W, 8K), the survivors validated as
    the JAX package validates them, and this rank's shard rows on
    `device`.  Returns (pm, block, rank, ranks, chunk)."""
    import torch.distributed as dist

    from ..ops import rs_bitmatrix
    total = data_shards + parity_shards
    bmat, _used = rs_bitmatrix.decode_bitmatrix(
        data_shards, total, tuple(present), tuple(wanted), matrix_kind)
    pm = plane_major(np.asarray(bmat), len(wanted), data_shards)
    n_axis = dist.get_world_size(group)
    if data_shards % n_axis != 0:
        raise ValueError(
            f"data_shards {data_shards} must divide over mesh col axis "
            f"{n_axis}")
    stacked = _as_batch(stacked)
    _v, s, n = stacked.shape
    if s != data_shards:
        raise ValueError(
            f"stacked must carry the {data_shards} used survivor rows, "
            f"got {s}")
    if n % n_axis != 0:
        raise ValueError(f"byte length {n} must divide over {n_axis}")
    rank = dist.get_rank(group)
    dev = resolve_device(device)
    block = shard_row_block(stacked, rank, n_axis).contiguous().to(dev)
    return pm, block, rank, n_axis, n // n_axis


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """`t` as the group's backend carries it: gloo moves host tensors."""
    import torch.distributed as dist
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.contiguous()


def _all_to_all(got: list, parts: list, group) -> None:
    """got[j] <- rank j's parts[this rank], for every rank j: the
    all-to-all as send/recv pairs, which NCCL and gloo both run (gloo
    lacks alltoall in some torch builds)."""
    import torch.distributed as dist
    me = dist.get_rank(group)
    got[me].copy_(parts[me])
    ops = []
    for j in range(dist.get_world_size(group)):
        if j == me:
            continue
        peer = dist.get_global_rank(group, j) if group is not None else j
        ops.append(dist.P2POp(dist.isend, parts[j], peer, group))
        ops.append(dist.P2POp(dist.irecv, got[j], peer, group))
    for r in dist.batch_isend_irecv(ops):
        r.wait()


def _solve(masks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One K1 launch (or its plain version) of packed `masks` over the
    (V, k, n) batch x on its device."""
    return _step(x, None, x.device, masks, False).array()


def all_to_all_reconstruct(stacked, present: tuple[int, ...],
                           wanted: tuple[int, ...], group=None,
                           data_shards: int = 10, parity_shards: int = 4,
                           matrix_kind: str = "vandermonde",
                           device="cuda") -> torch.Tensor:
    """Reconstruction when the survivors live shard-major on the ranks.

    stacked: the (V, data_shards, N) survivor stack; this rank keeps the
    whole shard rows `shard_row_block` gives it.  One `all_to_all` swaps
    shard rows for column blocks (every rank sends each other rank its
    rows' slice of that rank's columns), then each rank solves its column
    block locally with the full decode matrix.  Returns this rank's
    (V, W, N/D) column block, on `device`."""
    import torch.distributed as dist
    pm, block, _rank, ranks, chunk = _shard_major_prep(
        stacked, present, wanted, group, data_shards, parity_shards,
        matrix_kind, device)
    parts = [_wire(block[:, :, j * chunk:(j + 1) * chunk], group)
             for j in range(ranks)]
    got = [torch.empty_like(parts[0]) for _ in range(ranks)]
    _all_to_all(got, parts, group)
    gathered = torch.cat(got, dim=1).to(block.device)  # (V, K, chunk)
    masks = torch.from_numpy(pack_bitmatrix(pm))
    return _solve(masks, gathered)


def ring_reconstruct(stacked, present: tuple[int, ...],
                     wanted: tuple[int, ...], group=None,
                     data_shards: int = 10, parity_shards: int = 4,
                     matrix_kind: str = "vandermonde",
                     device="cuda") -> torch.Tensor:
    """Ring reduce-scatter of partial GF(2) products.

    Same input layout as `all_to_all_reconstruct`, but each rank
    multiplies only its own shard rows by its slice of the plane-major
    decode matrix (the columns of those rows); GF(2) linearity makes the
    output the XOR of the ranks' partials.  The partials ride the ring:
    D-1 send/recv hops, each XORed into the next rank's chunk, until
    rank d holds the reduced column chunk d.  Returns this rank's
    (V, W, N/D) chunk, on `device`."""
    import torch.distributed as dist
    pm, block, d, ranks, chunk = _shard_major_prep(
        stacked, present, wanted, group, data_shards, parity_shards,
        matrix_kind, device)
    w = len(wanted)
    rows_local = data_shards // ranks
    # Plane-major columns are b*K + s (bit b of input shard s): reshaped
    # (8W, 8, K), this rank's rows are one slice of the last axis.
    pm_local = pm.reshape(8 * w, 8, data_shards)[
        :, :, d * rows_local:(d + 1) * rows_local].reshape(
            8 * w, 8 * rows_local)
    partial = _solve(torch.from_numpy(pack_bitmatrix(pm_local)), block)

    def take(idx: int) -> torch.Tensor:
        return partial[:, :, idx * chunk:(idx + 1) * chunk]

    nxt = dist.get_global_rank(group, (d + 1) % ranks) \
        if group is not None else (d + 1) % ranks
    prv = dist.get_global_rank(group, (d - 1) % ranks) \
        if group is not None else (d - 1) % ranks
    # The accumulator made on rank d targets chunk d-1; after D-1 hops it
    # lands there having taken every rank's partial once.
    acc = take((d - 1) % ranks)
    for t in range(1, ranks):
        out = _wire(acc, group)
        inc = torch.empty_like(out)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, nxt, group),
            dist.P2POp(dist.irecv, inc, prv, group)])
        for r in reqs:
            r.wait()
        acc = torch.bitwise_xor(inc.to(partial.device),
                                take((d - t - 1) % ranks))
    return acc
