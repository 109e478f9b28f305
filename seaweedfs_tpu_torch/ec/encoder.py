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

import numpy as np

from . import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext
from .integrity import BlockCrcAccumulator, ShardChecksums, ecc_lock
from .volume_info import ec_codec_name, update_volume_info
from ..codecs import get_codec
from ..ops.crc_fold import FusedCrcAccumulator, fused_crc_enabled
from ..ops.erasure import ErasureCoder, host_array, new_coder
from ..storage.needle_map import MemDb

# Per-shard contiguous bytes handed to one coder call. Must divide
# LARGE_BLOCK_SIZE and be a multiple of SMALL_BLOCK_SIZE.
DEFAULT_CHUNK = 4 * 1024 * 1024


def write_sorted_file_from_idx(base_file_name: str,
                               ext: str = ".ecx") -> None:
    """Generate the sorted `.ecx` from the `.idx` (WriteSortedFileFromIdx)."""
    with open(base_file_name + ".idx", "rb") as f:
        db = MemDb.from_idx(f)
    with open(base_file_name + ext, "wb") as out:
        out.write(db.to_sorted_bytes())


def _shard_write(f, sid: int, buf: bytes, accs) -> None:
    """One shard-file write, feeding the integrity accumulator first so
    the recorded `.ecc` checksums describe the intended bytes."""
    if accs is not None:
        accs[sid].feed(buf)
    f.write(buf)


def write_ec_files(base_file_name: str, coder: ErasureCoder | None = None,
                   large_block_size: int = LARGE_BLOCK_SIZE,
                   small_block_size: int = SMALL_BLOCK_SIZE,
                   chunk_size: int = DEFAULT_CHUNK,
                   codec=None, device="cuda") -> None:
    """Generate the shard files from the .dat (WriteEcFiles), plus the
    `.ecc` per-block checksum sidecar and the `.vif` codec id.  Without
    a `coder`, one is built on `device` (raises when that names CUDA and
    no card is present)."""
    if coder is None:
        coder = new_coder(codec=codec, device=device)
    cd = getattr(coder, "codec", None) or get_codec("rs")
    if codec is not None and get_codec(codec).name != cd.name:
        raise ValueError(
            f"coder carries codec {cd.name!r} but {get_codec(codec).name!r} "
            "was requested")
    if cd.data_shards != DATA_SHARDS:
        # The shard-file block layout (locate.py) row-stripes over
        # exactly DATA_SHARDS columns.
        raise ValueError(
            f"codec {cd.name!r}: data shards must be {DATA_SHARDS} for "
            "the weed shard layout")
    dat_size = os.path.getsize(base_file_name + ".dat")
    # Fused path: the coder emits every shard's per-block CRC32-C beside
    # the parity (ops/crc_fold.py) — no CPU pass over the shard bytes.
    # Requires the DEFAULT block geometry: only then are `_chunk_reader`
    # widths 1MB-block multiples (except the final tail), which keeps
    # the kernel partials block-aligned.
    fused = (fused_crc_enabled(getattr(coder, "device", None))
             and getattr(coder, "fused_crc_ok", False)
             and chunk_size % SMALL_BLOCK_SIZE == 0
             and small_block_size == SMALL_BLOCK_SIZE
             and large_block_size % SMALL_BLOCK_SIZE == 0)
    accs = None if fused \
        else [BlockCrcAccumulator() for _ in range(cd.total_shards)]
    outputs = [open(base_file_name + to_ext(i), "wb")
               for i in range(cd.total_shards)]
    try:
        with open(base_file_name + ".dat", "rb") as dat:
            chunks = _chunk_reader(dat, dat_size, large_block_size,
                                   small_block_size, chunk_size)
            crc_map = _pipelined_encode(chunks, coder, outputs, accs=accs)
    finally:
        for f in outputs:
            f.close()
    # The codec id travels in the .vif like the needle version.
    update_volume_info(base_file_name, codec=cd.name)
    with ecc_lock(base_file_name):
        ecc = ShardChecksums(base_file_name)
        for sid in range(cd.total_shards):
            ecc.set_shard(sid, crc_map[sid] if crc_map is not None
                          else accs[sid].finalize())
        ecc.save()


def _chunk_reader(dat, dat_size: int, large: int, small: int,
                  chunk_size: int):
    """Yield (DATA_SHARDS, n) uint8 stripe chunks in shard-file order."""
    fd = dat.fileno()
    remaining = dat_size
    processed = 0
    # Large-block rows while more than one full large row remains
    # (strictly greater, like the Go encodeDatFile loop).
    chunk = min(chunk_size, large)
    if large % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide block size {large}")
    while remaining > large * DATA_SHARDS:
        for b in range(0, large, chunk):
            data = np.zeros((DATA_SHARDS, chunk), dtype=np.uint8)
            for i in range(DATA_SHARDS):
                raw = os.pread(fd, chunk, processed + i * large + b)
                if raw:
                    data[i, :len(raw)] = np.frombuffer(raw,
                                                       dtype=np.uint8)
            yield data
        remaining -= large * DATA_SHARDS
        processed += large * DATA_SHARDS
    # Small-block rows, many per coder call: rows are column-independent,
    # so K consecutive rows stack into one (10, K*small) call — same
    # bytes, K fewer launches; each shard's blocks from consecutive rows
    # are consecutive in its shard file.
    rows_per_call = max(1, chunk_size // small)
    while remaining > 0:
        row_bytes = small * DATA_SHARDS
        nrows = min(rows_per_call, -(-remaining // row_bytes))
        data = np.zeros((DATA_SHARDS, nrows * small), dtype=np.uint8)
        for r in range(nrows):
            base = processed + r * row_bytes
            col = r * small
            for i in range(DATA_SHARDS):
                raw = os.pread(fd, small, base + i * small)
                if raw:
                    data[i, col:col + len(raw)] = \
                        np.frombuffer(raw, dtype=np.uint8)
        yield data
        remaining -= row_bytes * nrows
        processed += row_bytes * nrows


def _pipelined_encode(chunks, coder: ErasureCoder, outputs,
                      depth: int = 2, accs=None):
    """Double-buffered encode pipeline:

      reader thread:  pread chunk k+1          (overlaps everything)
      main thread:    launch encode(k)         (async on the card)
                      write data shards of k   (independent of parity)
                      bring over + write parity of k-depth+1

    The CUDA coder returns device tensors without a synchronize, so up
    to `depth` encodes are in flight while the next chunk is read.  Only
    the main thread touches the device; the reader thread only reads
    the file.

    When ``accs is None`` the coder must support fused CRC
    (`encode_with_crc`): its second output is every shard's `.ecc` tile
    partials and this function returns the per-shard CRC lists
    (crc_fold.FusedCrcAccumulator folds them, with the CPU path for a
    ragged tail chunk).  With byte accumulators passed, None is
    returned."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    cancelled = threading.Event()
    error: list[BaseException] = []

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
                    error.append(RuntimeError(
                        "ec encode cancelled with a chunk undelivered"))
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            error.append(e)
        finally:
            # The end-of-stream sentinel must actually arrive; same
            # bounded-put-with-cancel as the data path.
            while not cancelled.is_set():
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue
    t = threading.Thread(target=read_loop, daemon=True,
                         name="ec-read-ahead")
    t.start()
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
            parity = host_array(inflight.popleft())
            for p in range(parity_shards):
                _shard_write(outputs[data_shards + p], data_shards + p,
                             parity[p].tobytes(), accs)
            return
        handle, crc_handle, width, data_tail = inflight.popleft()
        parity = host_array(handle)
        crc_np = host_array(crc_handle).view(np.uint32)
        full = width // block * block
        for i in range(data_shards):
            faccs[i].feed_tiles(crc_np[i], full)
            if width > full:
                faccs[i].feed_bytes(data_tail[i].tobytes())
        for p in range(parity_shards):
            sid = data_shards + p
            faccs[sid].feed_tiles(crc_np[sid], full)
            if width > full:
                faccs[sid].feed_bytes(parity[p, full:width].tobytes())
            _shard_write(outputs[sid], sid, parity[p].tobytes(), None)

    try:
        while True:
            data = q.get()
            if data is None:
                break
            # Launch first: the kernel runs while the data shards are
            # written and the next chunk is read.
            if fused:
                handle, crc_handle = coder.encode_with_crc(data)
                width = data.shape[1]
                full = width // block * block
                # Ragged tail (non-block-multiple chunk): keep the tail
                # bytes for the CPU fold in flush_one.
                tail = data[:, full:].copy() if width > full else None
                inflight.append((handle, crc_handle, width, tail))
            else:
                inflight.append(coder.encode(data))
            for i in range(data_shards):
                _shard_write(outputs[i], i, data[i].tobytes(),
                             None if fused else accs)
            if len(inflight) >= depth:
                flush_one()
        while inflight:
            flush_one()
    finally:
        cancelled.set()
        while True:  # unblock a reader stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join()
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
