"""EC encode / rebuild: `.dat` -> `.ec00`-`.ec13`, `.idx` -> `.ecx`.

Behavioral port of weed/storage/erasure_coding/ec_encoder.go with the
byte crunching routed through the ErasureCoder (the CUDA kernels, or
the numpy oracle).  Two deviations from the Go encoder's mechanics keep
outputs byte-identical:

- Go streams 10 x 256KB buffers per encoder call (encodeDataOneBatch);
  here much larger contiguous chunks per shard row are read and the
  whole (10, chunk) matrix goes to one kernel launch — same bytes,
  ~chunk/256KB fewer launches;
- rebuild ignores the block layout entirely: byte column p across shard
  files is one RS codeword, so reconstruction is a flat column-parallel
  bit-matrix product over any chunk size.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from contextlib import contextmanager

import numpy as np

from . import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext
from .integrity import BlockCrcAccumulator, ShardChecksums, ecc_lock
from .volume_info import ec_codec_name, update_volume_info
from ..codecs import get_codec
from ..fault import registry as _fault
from ..ops.crc_fold import FusedCrcAccumulator, fused_crc_enabled
from ..ops.erasure import ErasureCoder, host_array, new_coder
from ..stats.metrics import (ec_repair_read_bytes_total, ec_stage,
                             profiler_range, stage_attrs)
from ..storage.needle_map import MemDb
from ..trace import root_span
from ..trace import span as trace_span

# Per-shard contiguous bytes handed to one coder call. Must divide
# LARGE_BLOCK_SIZE and be a multiple of SMALL_BLOCK_SIZE.
DEFAULT_CHUNK = 4 * 1024 * 1024
# Coder calls in flight in write_ec_files' pipeline; its stripe ring
# holds two buffers more (the one being filled, the one being handed on).
PIPELINE_DEPTH = 2


@contextmanager
def _span(name: str, root: bool = False, **attrs):
    """A trace span and a profiler range of one name: the span joins the
    request's trace (a `root` opens one outside any), the range puts it
    on a profiler trace's clock."""
    opened = root_span(name, "ec", **attrs) if root \
        else trace_span(name, **attrs)
    with opened as sp, profiler_range(name):
        yield sp


def write_sorted_file_from_idx(base_file_name: str,
                               ext: str = ".ecx") -> None:
    """Generate the sorted `.ecx` from the `.idx` (WriteSortedFileFromIdx),
    spanned as `ec.encode.ecx` and timed as the stage `encode_index`."""
    idx_bytes = os.path.getsize(base_file_name + ".idx")
    with _span("ec.encode.ecx", root=True, bytes=idx_bytes), \
            ec_stage("encode_index", idx_bytes):
        with open(base_file_name + ".idx", "rb") as f:
            db = MemDb.from_idx(f)
        with open(base_file_name + ext, "wb") as out:
            out.write(db.to_sorted_bytes())


def _shard_write(f, sid: int, buf, accs) -> None:
    """One shard-file write of any buffer (bytes, or a row of a stripe
    or parity array, written as it is): feed the integrity accumulator
    with the TRUE bytes first, then write — possibly through the
    volume.corrupt bit-rot injector, which corrupts a copy and never
    the caller's buffer — so the recorded `.ecc` checksums describe what
    the encoder intended and any on-disk divergence is detectable."""
    if accs is not None:
        accs[sid].feed(buf)
    if _fault.ARMED and len(buf):
        try:
            _fault.hit("volume.corrupt", shard=sid)
        except _fault.FaultInjected:
            b = bytearray(buf)
            b[0] ^= 0xFF
            buf = bytes(b)
    f.write(buf)


def write_ec_files(base_file_name: str, coder: ErasureCoder | None = None,
                   large_block_size: int = LARGE_BLOCK_SIZE,
                   small_block_size: int = SMALL_BLOCK_SIZE,
                   chunk_size: int = DEFAULT_CHUNK,
                   codec=None, device="cuda") -> None:
    """Generate the shard files from the .dat (WriteEcFiles), plus the
    `.ecc` per-block checksum sidecar and the `.vif` codec id.  Without
    a `coder`, one is built on `device` (raises when that names CUDA and
    no card is present).

    Spanned as `ec.encode`, with the children `ec.encode.shards` (the
    pipeline; its stages' totals as attributes) and `ec.encode.sidecars`;
    every chunk's stages go to the EC stage histograms (`encode_ring_wait`,
    `encode_read`, `encode_read_wait`, `encode_submit`, `encode_write`,
    `encode_fetch`, `encode_write_drain`; the sidecars as
    `encode_index`)."""
    with _span("ec.encode", root=True) as root:
        if coder is None:
            coder = new_coder(codec=codec, device=device)
        cd = getattr(coder, "codec", None) or get_codec("rs")
        if codec is not None and get_codec(codec).name != cd.name:
            raise ValueError(
                f"coder carries codec {cd.name!r} but "
                f"{get_codec(codec).name!r} was requested")
        if cd.data_shards != DATA_SHARDS:
            # The shard-file block layout (locate.py) row-stripes over
            # exactly DATA_SHARDS columns.
            raise ValueError(
                f"codec {cd.name!r}: data shards must be {DATA_SHARDS} "
                "for the weed shard layout")
        dat_size = os.path.getsize(base_file_name + ".dat")
        root.set(bytes=dat_size)
        # Fused path: the coder emits every shard's per-block CRC32-C
        # beside the parity (ops/crc_fold.py) — no CPU pass over the
        # shard bytes.  Requires the DEFAULT block geometry: only then
        # are `_chunk_reader` widths 1MB-block multiples (except the
        # final tail), which keeps the kernel partials block-aligned.
        fused = (fused_crc_enabled(getattr(coder, "device", None))
                 and getattr(coder, "fused_crc_ok", False)
                 and chunk_size % SMALL_BLOCK_SIZE == 0
                 and small_block_size == SMALL_BLOCK_SIZE
                 and large_block_size % SMALL_BLOCK_SIZE == 0)
        accs = None if fused \
            else [BlockCrcAccumulator() for _ in range(cd.total_shards)]
        stages: dict = {}
        ring = _StripeRing(PIPELINE_DEPTH + 2, DATA_SHARDS * _widest(
            large_block_size, small_block_size, chunk_size), stages)
        with _span("ec.encode.shards") as shards:
            outputs = [open(base_file_name + to_ext(i), "wb")
                       for i in range(cd.total_shards)]
            try:
                with open(base_file_name + ".dat", "rb") as dat:
                    chunks = _chunk_reader(dat, dat_size, large_block_size,
                                           small_block_size, chunk_size,
                                           stages, ring.take)
                    crc_map = _pipelined_encode(chunks, coder, outputs,
                                                ring, accs=accs,
                                                stages=stages)
            finally:
                for f in outputs:
                    f.close()
            shards.set(**stage_attrs(stages))
        with _span("ec.encode.sidecars"), ec_stage("encode_index"):
            # The codec id travels in the .vif like the needle version.
            update_volume_info(base_file_name, codec=cd.name)
            with ecc_lock(base_file_name):
                ecc = ShardChecksums(base_file_name)
                for sid in range(cd.total_shards):
                    ecc.set_shard(sid, crc_map[sid] if crc_map is not None
                                  else accs[sid].finalize())
                ecc.save()


def _stripes(dat_size: int, large: int, small: int, chunk_size: int):
    """Each stripe chunk's width and its reads, in shard-file order:
    (data shard, column, bytes, `.dat` offset) per read."""
    remaining = dat_size
    processed = 0
    # Large-block rows while more than one full large row remains
    # (strictly greater, like the Go encodeDatFile loop).
    chunk = min(chunk_size, large)
    if large % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide block size {large}")
    while remaining > large * DATA_SHARDS:
        for b in range(0, large, chunk):
            yield chunk, [(i, 0, chunk, processed + i * large + b)
                          for i in range(DATA_SHARDS)]
        remaining -= large * DATA_SHARDS
        processed += large * DATA_SHARDS
    # Small-block rows, many per coder call: rows are column-independent,
    # so K consecutive rows stack into one (10, K*small) call — same
    # bytes, K fewer launches; each shard's blocks from consecutive rows
    # are consecutive in its shard file.
    rows_per_call = max(1, chunk_size // small)
    row_bytes = small * DATA_SHARDS
    while remaining > 0:
        nrows = min(rows_per_call, -(-remaining // row_bytes))
        yield nrows * small, [(i, r * small, small,
                               processed + r * row_bytes + i * small)
                              for r in range(nrows)
                              for i in range(DATA_SHARDS)]
        remaining -= row_bytes * nrows
        processed += row_bytes * nrows


def _widest(large: int, small: int, chunk_size: int) -> int:
    """The widest chunk `_stripes` can yield."""
    return max(min(chunk_size, large), max(1, chunk_size // small) * small)


def _read_into(fd: int, row, offset: int) -> None:
    """Fill `row` (a contiguous slice of a stripe buffer) from the
    `.dat` at `offset`, in place; zero what lies past the file's end."""
    done, n = 0, len(row)
    while done < n:
        got = os.preadv(fd, [row[done:]], offset + done)
        if got <= 0:
            break
        done += got
    if done < n:
        row[done:] = 0


def _chunk_reader(dat, dat_size: int, large: int, small: int,
                  chunk_size: int, stages: dict | None = None, take=None):
    """Yield (DATA_SHARDS, n) uint8 stripe chunks in shard-file order,
    each chunk's reads timed as the stage `encode_read`.  Each chunk is
    a fresh array the caller may keep; with `take`, a (DATA_SHARDS, n)
    view of the front of the flat buffer `take()` hands out, filled in
    place (a `_StripeRing`'s)."""
    fd = dat.fileno()
    for width, reads in _stripes(dat_size, large, small, chunk_size):
        flat = np.empty(DATA_SHARDS * width, dtype=np.uint8) \
            if take is None else take()
        data = flat[:DATA_SHARDS * width].reshape(DATA_SHARDS, width)
        with ec_stage("encode_read", data.nbytes, stages):
            for i, col, n, offset in reads:
                _read_into(fd, data[i, col:col + n], offset)
        yield data


class _StripeRing:
    """The host stripe buffers of one write_ec_files call: at most
    `count` flat uint8 buffers of `nbytes`, each made when first needed.
    The read-ahead takes a free one (the wait timed as the stage
    `encode_ring_wait`) and fills it in place; the coder uploads from it
    in place; the shard writer writes its rows in place, then gives it
    back.  A slow writer so stalls the read-ahead, and the read-ahead the
    main thread: the ring alone bounds the memory."""

    def __init__(self, count: int, nbytes: int, stages: dict):
        self.made = 0
        self._count = count
        self._nbytes = nbytes
        self._stages = stages
        self._free: "queue.SimpleQueue" = queue.SimpleQueue()
        # Buffers taken and not yet given back, oldest first: the writer
        # writes chunks in the order the read-ahead filled them.
        self._taken: "collections.deque" = collections.deque()
        self._closed = threading.Event()

    def take(self) -> np.ndarray:
        with ec_stage("encode_ring_wait", 0, self._stages):
            buf = self._wait()
        self._taken.append(buf)
        return buf

    def _wait(self) -> np.ndarray:
        try:
            return self._free.get_nowait()
        except queue.Empty:
            pass
        if self.made < self._count:
            self.made += 1
            return np.empty(self._nbytes, dtype=np.uint8)
        while not self._closed.is_set():
            try:
                return self._free.get(timeout=0.2)
            except queue.Empty:
                continue
        raise RuntimeError("ec encode cancelled while the read-ahead "
                           "waited for a stripe buffer")

    def give(self) -> None:
        """Give back the oldest buffer taken: its chunk's upload has
        returned, its tail is copied and its data rows are written."""
        self._free.put(self._taken.popleft())

    def close(self) -> None:
        self._closed.set()


def _pipelined_encode(chunks, coder: ErasureCoder, outputs,
                      ring: _StripeRing, depth: int = PIPELINE_DEPTH,
                      accs=None, stages=None):
    """Pipelined encode over three threads:

      read-ahead:  fill chunk k+1          (overlaps everything)
      main:        launch encode(k)        (async on the card)
                   hand chunk k's data rows to the writer
                   bring over parity of k-depth+1, hand it to the writer
      writer:      write every shard file, in chunk order per file

    The CUDA coder returns device tensors without a synchronize, so up
    to `depth` encodes are in flight while the next chunk is read.  Only
    the main thread touches the device; the read-ahead only reads the
    file, and the writer owns every shard-file write.  Nothing is copied
    to be written: the writer writes the chunk's rows and the parity's
    as they are.  The chunks are `ring`'s buffers, and each goes back to
    it once the writer has written its data rows (the upload returned
    and the ragged tail was copied before the hand-off).

    When ``accs is None`` the coder must support fused CRC
    (`encode_with_crc`): its second output is every shard's `.ecc` tile
    partials and this function returns the per-shard CRC lists
    (crc_fold.FusedCrcAccumulator folds them, with the CPU path for a
    ragged tail chunk).  With byte accumulators passed, the writer feeds
    them and None is returned.

    A failure on any thread cancels the others and is raised here;
    nothing is written after it, and every thread has ended on return.

    The stages, timed into `stages` (see stats.metrics.ec_stage): on the
    main thread, never nested, `encode_read_wait` (the wait for the
    next chunk), `encode_submit` (the coder call: the upload and the
    launch), `encode_fetch` (the parity, and the CRC partials, brought
    to the host) and `encode_write_drain` (the wait for the writer at
    the end); on the writer, `encode_write` (each hand-off's writes and,
    unfused, the CPU CRC feed); on the read-ahead, `encode_ring_wait`
    and `encode_read` (see `_StripeRing`, `_chunk_reader`)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    # Unbounded, but bounded by the pipeline: every data hand-off holds
    # a chunk, and at most one parity hand-off follows each.
    writes: "queue.SimpleQueue" = queue.SimpleQueue()
    cancelled = threading.Event()
    error: list[BaseException] = []

    def fail(e: BaseException) -> None:
        error.append(e)
        cancelled.set()
        ring.close()

    def read_loop() -> None:
        try:
            for data in chunks:
                # Bounded puts with a cancel check: if the main thread
                # dies while this thread is blocked on a full queue, a
                # plain q.put would deadlock the final join.
                delivered = False
                while not cancelled.is_set():
                    try:
                        q.put(data, timeout=0.2)
                        delivered = True
                        break
                    except queue.Full:
                        continue
                if not delivered:
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            fail(e)
        finally:
            # The end-of-stream sentinel must actually arrive; same
            # bounded-put-with-cancel as the data path.
            while not cancelled.is_set():
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def write_loop() -> None:
        try:
            while True:
                item = writes.get()
                if item is None or cancelled.is_set():
                    return
                first, rows, written = item
                with ec_stage("encode_write", rows.nbytes, stages):
                    for j in range(len(rows)):
                        if cancelled.is_set():
                            return
                        _shard_write(outputs[first + j], first + j,
                                     rows[j], accs)
                if written is not None:
                    written()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            fail(e)

    def next_chunk():
        while True:
            try:
                return q.get(timeout=0.2)
            except queue.Empty:
                if error:
                    raise error[0]

    reader = threading.Thread(target=read_loop, daemon=True,
                              name="ec-read-ahead")
    writer = threading.Thread(target=write_loop, daemon=True,
                              name="ec-shard-writer")
    reader.start()
    writer.start()
    inflight: "collections.deque" = collections.deque()

    data_shards = coder.data_shards
    parity_shards = coder.parity_shards
    fused = accs is None
    faccs = None
    block = SMALL_BLOCK_SIZE
    if fused:
        faccs = [FusedCrcAccumulator(coder.block_n)
                 for _ in range(data_shards + parity_shards)]

    def flush_one() -> None:
        if not fused:
            handle = inflight.popleft()
            with ec_stage("encode_fetch", parity_shards * handle.shape[1],
                          stages):
                parity = host_array(handle)
            writes.put((data_shards, parity, None))
            return
        handle, crc_handle, width, data_tail = inflight.popleft()
        with ec_stage("encode_fetch", parity_shards * width, stages):
            parity = host_array(handle)
            crc_np = host_array(crc_handle).view(np.uint32)
        full = width // block * block
        for i in range(data_shards):
            faccs[i].feed_tiles(crc_np[i], full)
            if width > full:
                faccs[i].feed_bytes(data_tail[i])
        for p in range(parity_shards):
            sid = data_shards + p
            faccs[sid].feed_tiles(crc_np[sid], full)
            if width > full:
                faccs[sid].feed_bytes(parity[p, full:width])
        writes.put((data_shards, parity, None))

    try:
        while True:
            if error:
                raise error[0]
            with ec_stage("encode_read_wait", 0, stages):
                data = next_chunk()
            if data is None:
                break
            # Launch first: the kernel runs while the data shards are
            # written and the next chunk is read.
            width = data.shape[1]
            if fused:
                with ec_stage("encode_submit", data.nbytes, stages):
                    handle, crc_handle = coder.encode_with_crc(data)
                full = width // block * block
                # Ragged tail (non-block-multiple chunk): keep the tail
                # bytes for the CPU fold in flush_one.
                tail = data[:, full:].copy() if width > full else None
                inflight.append((handle, crc_handle, width, tail))
            else:
                with ec_stage("encode_submit", data.nbytes, stages):
                    inflight.append(coder.encode(data))
            writes.put((0, data, ring.give))
            if len(inflight) >= depth:
                flush_one()
        while inflight:
            flush_one()
        writes.put(None)
        with ec_stage("encode_write_drain", 0, stages):
            writer.join()
    finally:
        cancelled.set()
        ring.close()
        writes.put(None)
        while True:  # unblock a reader stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        reader.join()
        writer.join()
    if error:
        raise error[0]
    if fused:
        return {sid: faccs[sid].finalize()
                for sid in range(data_shards + parity_shards)}
    return None


def rebuild_ec_files(base_file_name: str,
                     coder: ErasureCoder | None = None,
                     chunk_size: int = DEFAULT_CHUNK,
                     device="cuda") -> list[int]:
    """Recreate missing .ec?? files from survivors (RebuildEcFiles).

    Returns the list of generated shard ids.  Layout-agnostic: operates
    on flat shard-file columns.  The codec comes from the `.vif` sidecar
    and only the codec's planned read set is read from disk.  Without a
    `coder`, one is built on `device`.
    """
    if coder is None:
        coder = new_coder(codec=ec_codec_name(base_file_name), device=device)
    cd = getattr(coder, "codec", None) or get_codec("rs")
    present: dict[int, str] = {}
    missing: list[int] = []
    for sid in range(cd.total_shards):
        path = base_file_name + to_ext(sid)
        if os.path.exists(path):
            present[sid] = path
        else:
            missing.append(sid)
    if not missing:
        return []
    try:
        plan = cd.repair_plan(tuple(present), missing)
    except ValueError as e:
        raise ValueError(
            f"too few shards to rebuild: {len(present)} survive "
            f"({cd.name}): {e}") from None
    needed = sorted({sid for p in plan for sid in p.reads})

    shard_size = os.path.getsize(next(iter(present.values())))
    for sid, path in present.items():
        if os.path.getsize(path) != shard_size:
            raise ValueError(f"ec shard size mismatch on {path}")

    ins = {sid: open(present[sid], "rb") for sid in needed}
    outs = {sid: open(base_file_name + to_ext(sid), "wb") for sid in missing}
    accs = {sid: BlockCrcAccumulator() for sid in missing}
    try:
        for off in range(0, shard_size, chunk_size):
            take = min(chunk_size, shard_size - off)
            have = {}
            for sid, f in ins.items():
                buf = os.pread(f.fileno(), take, off)
                if len(buf) != take:
                    raise ValueError(f"short read on shard {sid}")
                have[sid] = np.frombuffer(buf, dtype=np.uint8)
            ec_repair_read_bytes_total.inc(take * len(have),
                                           codec=cd.name)
            rec = coder.reconstruct(have, wanted=missing)
            for sid in missing:
                _shard_write(outs[sid], sid,
                             host_array(rec[sid]).tobytes(), accs)
    finally:
        for f in ins.values():
            f.close()
        for f in outs.values():
            f.close()
    # Load-modify-save of the shared sidecar: serialize with the other
    # writers or concurrent savers lose each other's entries.
    with ecc_lock(base_file_name):
        ecc = ShardChecksums.load(base_file_name)
        for sid in missing:
            ecc.set_shard(sid, accs[sid].finalize())
        ecc.save()
    return missing
