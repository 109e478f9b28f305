"""EcVolume: runtime access to an erasure-coded volume's local shards.

Port of the read path in weed/storage/erasure_coding/ec_volume.go and
store_ec.go: binary-search the `.ecx` for the needle, map its byte range to
shard intervals, read each interval from a local shard — and when a shard
is missing, reconstruct exactly that interval from >= 10 surviving shards
(the degraded-read path: one bit-matrix kernel launch per interval).

In the clustered setting the "fetch other shards" step goes over the wire
(cluster layer); here the EcVolume handles whatever shards are local and
exposes the same reconstruction hook.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from . import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext
from ..codecs import get_codec
from ..core import types as t
from ..core.needle import Needle, get_actual_size
from ..ops.erasure import ErasureCoder, host_array, new_coder
from ..stats.metrics import ec_repair_read_bytes_total
from .locate import Interval, locate_data
from .volume_info import ec_codec_name


class NeedleNotFound(Exception):
    pass


class ShardsUnavailable(Exception):
    pass


class EcVolumeShard:
    """One local `.ec??` file."""

    def __init__(self, base_file_name: str, shard_id: int):
        self.shard_id = shard_id
        self.path = base_file_name + to_ext(shard_id)
        self._f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)

    def read_at(self, offset: int, size: int) -> bytes:
        return os.pread(self._f.fileno(), size, offset)

    def close(self) -> None:
        self._f.close()


class EcVolume:
    def __init__(self, base_file_name: str, vid: int = 0,
                 coder: ErasureCoder | None = None,
                 version: int | None = None,
                 large_block_size: int = LARGE_BLOCK_SIZE,
                 small_block_size: int = SMALL_BLOCK_SIZE,
                 codec=None, device="cuda"):
        self.base_file_name = base_file_name
        self.vid = vid
        self.large_block_size = large_block_size
        self.small_block_size = small_block_size
        # The codec rides the .vif sidecar (like the needle version):
        # an explicit coder wins, then an explicit codec name, then
        # whatever the shards were generated with.  Without a coder,
        # one is built on `device` (raises when that names CUDA and no
        # card is present).
        if coder is not None:
            self.coder = coder
            self.codec = getattr(coder, "codec", None) or get_codec("rs")
        else:
            self.codec = get_codec(codec or ec_codec_name(base_file_name))
            self.coder = new_coder(codec=self.codec, device=device)
        self.shards: dict[int, EcVolumeShard] = {}
        self._ecx = open(base_file_name + ".ecx", "r+b")
        self.ecx_size = os.path.getsize(base_file_name + ".ecx")
        self._ecj_lock = threading.Lock()
        self.load_local_shards()
        # Version detection is lazy: a server holding only parity shards
        # can still mount and serve raw shard bytes without knowing it.
        self._version = version

    @property
    def version(self) -> int:
        if self._version is None:
            self._version = self._detect_version()
        return self._version

    def _detect_version(self) -> int:
        """Volume version: .vif sidecar, else shard 0's superblock, else
        reconstruct the superblock bytes from >=10 survivors.

        A wrong version mis-sizes every record, so no silent default.
        """
        from ..core.super_block import SuperBlock
        from .decoder import read_ec_volume_version
        from .volume_info import load_volume_info
        info = load_volume_info(self.base_file_name)
        if info and "version" in info:
            return int(info["version"])
        try:
            return read_ec_volume_version(self.base_file_name)
        except FileNotFoundError:
            pass
        head = self._reconstruct_interval(0, 0, 64)
        return SuperBlock.from_bytes(head).version

    # -- shard registry ----------------------------------------------------

    def load_local_shards(self) -> list[int]:
        found = []
        for sid in range(self.codec.total_shards):
            if sid in self.shards:
                continue
            if os.path.exists(self.base_file_name + to_ext(sid)):
                self.shards[sid] = EcVolumeShard(self.base_file_name, sid)
                found.append(sid)
        return found

    def shard_size(self) -> int:
        if not self.shards:
            return 0
        return next(iter(self.shards.values())).size

    # -- .ecx search --------------------------------------------------------

    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """Binary search the sorted index. Returns (offset, size)."""
        entry, _pos = self._search_ecx(needle_id)
        if entry is None:
            raise NeedleNotFound(f"needle {needle_id:x} not in ecx")
        if t.size_is_deleted(entry.size):
            raise NeedleNotFound(f"needle {needle_id:x} deleted")
        return entry.offset, entry.size

    def _search_ecx(self, needle_id: int):
        lo, hi = 0, self.ecx_size // t.NEEDLE_MAP_ENTRY_SIZE
        fd = self._ecx.fileno()
        while lo < hi:
            mid = (lo + hi) // 2
            buf = os.pread(fd, t.NEEDLE_MAP_ENTRY_SIZE,
                           mid * t.NEEDLE_MAP_ENTRY_SIZE)
            e = t.NeedleMapEntry.from_bytes(buf)
            if e.key == needle_id:
                return e, mid
            if e.key < needle_id:
                lo = mid + 1
            else:
                hi = mid
        return None, -1

    # -- reads ---------------------------------------------------------------

    def locate_needle(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        offset, size = self.find_needle_from_ecx(needle_id)
        total = get_actual_size(size, self.version)
        dat_size = DATA_SHARDS * self.shard_size()
        intervals = locate_data(self.large_block_size, self.small_block_size,
                                dat_size, offset, total)
        return offset, size, intervals

    def read_interval(self, interval: Interval) -> bytes:
        sid, off = interval.to_shard_id_and_offset(self.large_block_size,
                                                   self.small_block_size)
        shard = self.shards.get(sid)
        if shard is not None:
            buf = shard.read_at(off, interval.size)
            if len(buf) == interval.size:
                return buf
        return self._reconstruct_interval(sid, off, interval.size)

    def _reconstruct_interval(self, missing_sid: int, offset: int,
                              size: int) -> bytes:
        """Degraded read: rebuild one shard interval from survivors.

        Go: store_ec.go:322 recoverOneRemoteEcShardInterval — there
        the survivors are fetched over gRPC; locally we use whatever shard
        files exist.  The read set follows the codec's repair plan —
        local group first (5 reads for LRC), global fallback — and a
        shard that comes up short is excluded and the plan re-solved,
        so one truncated file degrades the read cost, never the read.
        """
        excluded: set[int] = set()
        while True:
            usable = tuple(s for s in self.shards
                           if s != missing_sid and s not in excluded)
            try:
                plan = self.codec.repair_plan(usable, [missing_sid])
            except ValueError:
                raise ShardsUnavailable(
                    f"cannot reconstruct shard {missing_sid}: only "
                    f"{len(usable)} survivors") from None
            have: dict[int, np.ndarray] = {}
            for sid in plan[0].reads:
                buf = self.shards[sid].read_at(offset, size)
                if len(buf) != size:
                    excluded.add(sid)
                    break
                have[sid] = np.frombuffer(buf, dtype=np.uint8)
            if len(have) == len(plan[0].reads):
                break
        ec_repair_read_bytes_total.inc(size * len(have),
                                       codec=self.codec.name)
        rec = self.coder.reconstruct(have, wanted=[missing_sid])
        return host_array(rec[missing_sid]).tobytes()

    def read_needle(self, needle_id: int) -> Needle:
        _offset, size, intervals = self.locate_needle(needle_id)
        blob = b"".join(self.read_interval(iv) for iv in intervals)
        return Needle.from_bytes(blob, self.version)

    # -- deletes -------------------------------------------------------------

    def refresh_index(self) -> None:
        """Reopen the .ecx when the file on disk is no longer the one
        open here: a rebuild or a shard copy that brings this holder a
        fresh .ecx replaces the file under the open handle, and a
        tombstone written through the old handle would land in a file
        nobody reads again."""
        path = self.base_file_name + ".ecx"
        if os.fstat(self._ecx.fileno()).st_ino != os.stat(path).st_ino:
            old, self._ecx = self._ecx, open(path, "r+b")
            old.close()

    def delete_needle(self, needle_id: int) -> None:
        """Tombstone the .ecx entry in place + append id to the .ecj."""
        entry, pos = self._search_ecx(needle_id)
        if entry is None:
            return
        size_off = (pos * t.NEEDLE_MAP_ENTRY_SIZE + t.NEEDLE_ID_SIZE +
                    t.OFFSET_SIZE)
        os.pwrite(self._ecx.fileno(),
                  t.size_to_bytes(t.TOMBSTONE_FILE_SIZE), size_off)
        with self._ecj_lock:
            with open(self.base_file_name + ".ecj", "ab") as f:
                f.write(t.put_uint64(needle_id))

    def close(self) -> None:
        self._ecx.close()
        for s in self.shards.values():
            s.close()
        self.shards.clear()
