"""`ec.encode` of a collection, volume by volume, as a volume server's
/admin/ec/generate runs it: seaweedfs_tpu_torch.ec.encoder's
write_sorted_file_from_idx(base), then write_ec_files(base,
device="cuda"), which writes the 14 shards, the `.ecc` and the `.vif`.

Inputs: each volume's `.dat` and `.idx` of needles drawn from the seed,
at a fill of the configuration's list (the seed deals the fills out, so
every seed encodes the same sizes).  The window encodes the volumes in
a seeded order, round and round; before each encode that volume's
shard and `.ecx` files are retired (the shards sampled; all closed) and
fresh ones put at their paths, and after it the `.ecx` and `.ecc` are
read for the judge.  Progress is the `.dat` bytes whose shards were
written: those of ended encodes and, for the current one, k times the
shortest of its 14 shard files (as fstat finds them), at most its
`.dat`."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import memfiles, volumes
from ..driver import MIB, Driver, blocks_differ, volume_bytes
from ..reference import crc32c, index, layout, rs, sidecar

WRITE_COLS = 64 * MIB


def _ext(sid: int) -> str:
    return f".ec{sid:02d}"


class Encode(Driver):
    def __init__(self, cell):
        super().__init__(cell)
        cfg = cell.config
        self.k, self.m = cfg["data_shards"], cfg["parity_shards"]
        self.large, self.block = cfg["large_block_bytes"], \
            cfg["small_block_bytes"]
        n = cfg["volumes"]
        deal = volumes.host_rng(cell.seed, 4).permutation(n)
        self.rooms = [volume_bytes(cfg, int(deal[v])) for v in range(n)]
        self.order = [int(v) for v in volumes.host_rng(
            cell.seed, 5).permutation(n)]
        self.bases = [os.path.join(cell.work, f"v{v + 1}") for v in range(n)]
        self.dat_size = [0] * n
        self.shard = [0] * n
        self.current: int | None = None
        self.last_pass: dict[int, int] = {}
        self.ecc_texts: list[tuple[int, int, str | None]] = []
        self.ecx_blobs: dict[int, bytes] = {}
        self.shard_bytes = 0  # one shard's bytes over the window's encodes

    def host_bytes(self) -> int:
        return sum(r + (self.k + self.m) * (-(-r // self.k) + self.block)
                   for r in self.rooms)

    def setup(self) -> None:
        t0 = time.monotonic()
        params = self.cell.config["needle_payload"]
        for v, base in enumerate(self.bases):
            dat, idx = volumes.make_volume(self.cell.seed, v, self.rooms[v],
                                           params, self.device)
            self.dat_size[v] = dat.numel()
            self.shard[v] = layout.shard_size(dat.numel(), self.k,
                                              self.large, self.block)
            fd = self.ram.make(base + ".dat")
            for lo in range(0, dat.numel(), WRITE_COLS):
                memfiles.write_all(fd, dat[lo:lo + WRITE_COLS].cpu().numpy(),
                                   lo)
            memfiles.write_all(self.ram.make(base + ".idx"), idx, 0)
            for name in [_ext(s) for s in range(self.k + self.m)] + [".ecx"]:
                self.ram.make(base + name)
            with open(base + ".vif", "w") as f:
                json.dump({"version": 3}, f)
            del dat
        t1 = time.monotonic()
        self._encode(self.order[0])
        self.timings = {"inputs_s": t1 - t0, "warm_s": time.monotonic() - t1}

    def _encode(self, v: int) -> None:
        from seaweedfs_tpu_torch.ec.encoder import (write_ec_files,
                                                    write_sorted_file_from_idx)
        write_sorted_file_from_idx(self.bases[v])
        write_ec_files(self.bases[v], device=self.device)

    def control_pass(self) -> None:
        """The reference in the program's place, with ISA-L's Cauchy
        parity instead of RS(10,4)'s: the guarantee it breaks is "every
        shard byte-equal to RS(10,4) over the Go layout"."""
        v = self.current
        base = self.bases[v]
        code = rs.Code(self.k, self.m, self.device, kind="cauchy")
        crc = crc32c.BlockCrc(self.block, self.device)
        memfiles.write_all(self.ram.fds[base + ".ecx"], index.sorted_index(
            memfiles.read_all(self.ram.fds[base + ".idx"])), 0)
        dat_fd = self.ram.fds[base + ".dat"]
        entries = {s: [] for s in range(self.k + self.m)}
        for lo in range(0, self.shard[v], volumes.PIECE_COLS):
            hi = min(self.shard[v], lo + volumes.PIECE_COLS)
            data = torch.from_numpy(layout.data_rows(
                lambda at, n: memfiles.read_at(dat_fd, n, at),
                self.dat_size[v], self.k, self.large, self.block,
                lo, hi)).to(self.device)
            full = torch.cat([data, code.encode(data)])
            for s, c in enumerate(crc(full).cpu().tolist()):
                entries[s] += c
            host = full.cpu().numpy()
            for s, path in self._outputs(v).items():
                memfiles.write_all(self.ram.fds[path], host[s], lo)
        with open(base + ".ecc.tmp", "w") as f:
            f.write(sidecar.dumps(self.block, entries))
        os.replace(base + ".ecc.tmp", base + ".ecc")

    def _outputs(self, v: int) -> dict:
        return {s: self.bases[v] + _ext(s) for s in range(self.k + self.m)}

    def begin(self) -> None:
        v = self.order[self.started % len(self.order)]
        shards = {s: self.ram.renew(p) for s, p in self._outputs(v).items()}
        ecx = {"ecx": self.ram.renew(self.bases[v] + ".ecx")}
        prev = self.last_pass.get(v)
        self.retire(prev, shards, self.block, self.shard[v] // self.block)
        self.retire(None, ecx, self.block, 1)
        self.current = v
        self.started += 1
        self.shard_bytes += self.shard[v]

    def run_pass(self) -> None:
        self._encode(self.current)

    def boundary(self, more: bool) -> None:
        v, p = self.current, self.started - 1
        self.completed += self.dat_size[v]
        try:
            with open(self.bases[v] + ".ecc") as f:
                text = f.read()
        except FileNotFoundError:
            text = None
        self.ecc_texts.append((p, v, text))
        fd = self.ram.fds[self.bases[v] + ".ecx"]
        self.ecx_blobs[p] = memfiles.read_all(fd)
        self.last_pass[v] = p
        self.current = None

    def work(self) -> dict:
        """Each encode of the window runs K2 (10 -> 4) over as many
        columns as its volume's shards have bytes."""
        return {"k2_columns": self.shard_bytes}

    def progress(self) -> dict:
        done = self.completed
        if self.current is not None:
            v = self.current
            cols = min(self.ram.size(p) for p in self._outputs(v).values())
            done += min(self.dat_size[v], self.k * cols)
        return {"encoded_bytes": done}

    def judge(self) -> tuple[dict, int, int]:
        """The last encode of each volume whole (its 14 shards and its
        `.ecx`), the sampled blocks of every other, and every encode's
        `.ecc` against the reference."""
        self.drain_retired()
        code = rs.Code(self.k, self.m, self.device)
        crc = crc32c.BlockCrc(self.block, self.device)
        bad: set[int] = set()
        wrong = {"shard_blocks_wrong": 0, "ecc_entries_wrong": 0,
                 "ecx_entries_wrong": 0}
        for v, last in sorted(self.last_pass.items()):
            passes = [p for p, pv, _ in self.ecc_texts if pv == v]
            dat_fd = self.ram.fds[self.bases[v] + ".dat"]
            size = self.shard[v]
            crcs = np.zeros((self.k + self.m, size // self.block), np.int64)
            for s, path in self._outputs(v).items():
                if self.ram.size(path) != size:
                    wrong["shard_blocks_wrong"] += 1
                    bad.add(last)
            for lo in range(0, size, volumes.PIECE_COLS):
                hi = min(size, lo + volumes.PIECE_COLS)
                data = torch.from_numpy(layout.data_rows(
                    lambda at, n: memfiles.read_at(dat_fd, n, at),
                    self.dat_size[v], self.k, self.large, self.block,
                    lo, hi)).to(self.device)
                full = torch.cat([data, code.encode(data)])
                crcs[:, lo // self.block:hi // self.block] = \
                    crc(full).cpu().numpy()
                want = full.cpu().numpy()
                for s, path in self._outputs(v).items():
                    got = np.frombuffer(memfiles.read_at(
                        self.ram.fds[path], hi - lo, lo), dtype=np.uint8)
                    n = blocks_differ(got, want[s], self.block)
                    wrong["shard_blocks_wrong"] += n
                    if n:
                        bad.add(last)
                    for p in passes:
                        for (key, b), blob in self.samples.get(p, {}).items():
                            at = b * self.block - lo
                            if key == s and 0 <= at < hi - lo and \
                                    blocks_differ(np.frombuffer(
                                        blob, dtype=np.uint8),
                                        want[s, at:at + self.block],
                                        self.block):
                                wrong["shard_blocks_wrong"] += 1
                                bad.add(p)
            want_ecx = index.sorted_index(memfiles.read_all(
                self.ram.fds[self.bases[v] + ".idx"]))
            for p in passes:
                n = _entries_differ(self.ecx_blobs[p], want_ecx)
                wrong["ecx_entries_wrong"] += n
                if n:
                    bad.add(p)
            want_ecc = {s: crcs[s].tolist() for s in range(self.k + self.m)}
            for p, pv, text in self.ecc_texts:
                if pv == v:
                    n = sidecar.entries_wrong(text, self.block, want_ecc)
                    wrong["ecc_entries_wrong"] += n
                    if n:
                        bad.add(p)
        return {k: (n, 0) for k, n in wrong.items()}, self.started, len(bad)


def _entries_differ(got: bytes, want: bytes) -> int:
    """16-byte index entries of `want` that `got` lacks or holds wrong."""
    a = np.frombuffer(got[:len(got) // 16 * 16], dtype=np.uint8).reshape(
        -1, 16)
    b = np.frombuffer(want, dtype=np.uint8).reshape(-1, 16)
    n = min(len(a), len(b))
    return int((a[:n] != b[:n]).any(axis=1).sum()) + abs(len(a) - len(b)) \
        + (len(got) % 16 != 0)


DRIVER = Encode
