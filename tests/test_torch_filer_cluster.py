"""The gate of the filer slice: a filer-fronted EC cluster run by each
package in this process and held byte for byte between them.

Each package brings up a master, four volume servers (volume limit
16 MB) and a filer over them (256 KiB chunks, the default embedded
store for a directory), and writes one namespace made from a seed
through the filer's HTTP API, one file at a time: four large files of
several chunks, 48 small ones, in 8 directories three levels deep.
`fs.ls` of every directory, `fs.du /` and `volume.fsck` run through the
package's own shell.  Then `lock` and `ec.encode -volumeId ...` encode
every volume in its holder, the chunk caches are emptied, and the
volume server holding shard 0 of the first volume is stopped; every
file is read back through the filer (degraded reads of the lost
intervals, K1's plain version in the survivors), the listings and
`volume.fsck` run again.  `random` is seeded alike and the clocks
pinned in both packages (`pin_clocks`), so the two clusters store the
same needles under the same file ids.

Held equal across the packages: the file ids of every chunk, every
listing and `fs.du`, every file's bytes (which must equal what was
written), and each stored shard file of the encoded volumes.  Where a
shard lands is not compared: `ec.encode` spreads shards by the servers'
free slots and addresses, and which server holds which volume is not
the same in two live clusters, so neither are the shards the stopped
server took nor the intervals the reads reconstruct.  In each package
the reads must reconstruct at least one interval (one K1 10->1 each),
and in the port each must be one `reconstruct_kernel` row of the
roofline ledger.  Then, in the port only, its additions on the same
cluster (`_orphans_after_rm`): `volume.fsck -orphans` finds none, and
after `fs.rm -r` of a directory the chunk deletes land on the EC
volumes and it finds none again.  `volume.fsck` is equal before the encode; after it, the two
packages differ by a reference fault the port fixes (ROADMAP queue 3):
the JAX package reports every chunk of an EC volume missing (it finds
no `locations` for the volume), the port probes the shard holders and
reports none missing.
"""

from __future__ import annotations

import glob
import hashlib
import os
import random
import time

import numpy as np
import pytest

from _torch_cluster import (PACKAGES, PORT, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state, mod,
                            pin_clocks, seed_placement)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

SEED = 11
CHUNK = 256 << 10
DIRS = [f"/ns/d{i}/e{i % 3}/f{i % 2}" for i in range(8)]


def _namespace() -> dict[str, bytes]:
    """path -> bytes: 4 large files of 300 KiB - 1.2 MiB (several
    256 KiB chunks) and 48 small ones of 1 - 16 KiB, log-uniform, over
    DIRS."""
    rng = np.random.default_rng(SEED)
    out = {}
    for i in range(52):
        lo, hi = (300 << 10, 1200 << 10) if i < 4 else (1 << 10, 16 << 10)
        size = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        out[f"{DIRS[i % len(DIRS)]}/file{i:02d}.bin"] = \
            rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    return out


def _listings(cluster, env) -> dict:
    dirs = sorted({"/", "/ns"} | {d.rsplit("/", k)[0] for d in DIRS
                                  for k in range(3)})
    out = {d: cluster.run(env, f"fs.ls -l {d}") for d in dirs}
    out["du"] = cluster.run(env, "fs.du /")
    return out


def _k1_rows(pkg: str) -> int:
    table = mod(pkg, "stats.roofline").LEDGER.kernel_table()
    return sum(r["count"] for r in table
               if r["kernel"] == "reconstruct_kernel")


def _count_reconstructs(pkg: str, monkeypatch) -> list:
    """Every shard interval the package's volume servers reconstruct
    (one K1 10->1 each), as (vid, shard, offset, size)."""
    cls = mod(pkg, "cluster.volume_server").VolumeServer
    real = cls._reconstruct_shard_interval
    seen: list = []

    def counted(self, ev, sid, off, size):
        seen.append((ev.vid, sid, off, size))
        return real(self, ev, sid, off, size)
    monkeypatch.setattr(cls, "_reconstruct_shard_interval", counted)
    return seen


def _orphans_after_rm(cluster, env, fs, files) -> None:
    """The port's additions on the same cluster: the filer's resident
    chunk list, `volume.fsck -orphans` (0 before), and after `fs.rm -r`
    of a directory its chunk deletes land on the EC volumes, so fsck
    again finds 0 orphans and the checked chunks drop by the removed
    files'."""
    doc = cluster.rpc.call(fs.url() + "/debug/cache?fids=1")
    assert len(doc["resident"]) == doc["chunk_cache"]["chunks"] > 0
    n = int(cluster.run(env, "volume.fsck -orphans").split()[1])
    assert cluster.run(env, "volume.fsck -orphans") == \
        f"checked {n} chunks, 0 missing, 0 orphans"
    gone = [p for p in files if p.startswith(DIRS[0] + "/")]
    proxy = mod(PORT, "filer.client").FilerProxy(fs.url())
    n_gone = sum(len(proxy.meta(p)["chunks"]) for p in gone)
    assert cluster.run(env, f"fs.rm -r {DIRS[0]}") == f"removed {DIRS[0]}"
    want = f"checked {n - n_gone} chunks, 0 missing, 0 orphans"
    for _ in range(100):
        got = cluster.run(env, "volume.fsck -orphans")
        if got == want:
            break
        time.sleep(0.1)
    assert got == want


def _scenario(pkg: str, root, monkeypatch) -> dict:
    random.seed(SEED)
    seed_placement(monkeypatch, pkg, SEED)
    cluster = LiveCluster(pkg, root / pkg, n=4,
                          master_kw={"volume_size_limit_mb": 16})
    fs = None
    try:
        rpc = cluster.rpc
        fs = mod(pkg, "filer.server").FilerServer(
            cluster.url(), port=0, store_path=str(root / pkg / "filer"),
            chunk_size=CHUNK)
        fs.start()
        files = _namespace()
        for path, data in files.items():
            rpc.call(fs.url() + path, "POST", data)
        env = mod(pkg, "shell").CommandEnv(
            cluster.url(), filer_url=fs.url(),
            **({"device": "cpu"} if pkg == PORT else {}))
        cluster._envs.append(env)
        proxy = mod(pkg, "filer.client").FilerProxy(fs.url())
        fids = {p: [c["file_id"] for c in proxy.meta(p)["chunks"]]
                for p in files}
        assert any(len(f) > 1 for f in fids.values())
        before = {"listings": _listings(cluster, env),
                  "fsck": cluster.run(env, "volume.fsck")}
        assert before["fsck"] == \
            f"checked {sum(map(len, fids.values()))} chunks, 0 missing"

        vids = sorted({int(f.split(",")[0]) for fs_ in fids.values()
                       for f in fs_})
        cluster.run(env, "lock")
        out = cluster.run(env, "ec.encode -volumeId "
                          + ",".join(map(str, vids)))
        for vid in vids:
            assert f"volume {vid} -> ec shards" in out, out
        cluster.freshen()
        shards = {}
        held: dict = {}
        for vs in cluster.servers:
            d = vs.store.locations[0].directory
            for path in sorted(glob.glob(os.path.join(d, "*.ec[0-9][0-9]"))):
                vid, sid = int(os.path.basename(path)[:-5]), int(path[-2:])
                shards[(vid, sid)] = hashlib.sha256(
                    open(path, "rb").read()).hexdigest()
                held.setdefault(vs, {}).setdefault(vid, []).append(sid)
        assert len(shards) == 14 * len(vids)

        # Stop the holder of shard 0 of the first volume (shard 0 holds
        # the first 1 MiB block of every volume's data); empty the chunk
        # caches so every read below goes to the volume servers.
        victim = next(vs for vs in held if 0 in held[vs].get(vids[0], ()))
        victim.stop()
        cluster.freshen()
        mod(pkg, "storage.chunk_cache").CACHE.reset()
        rows = _k1_rows(pkg)
        reconstructed = _count_reconstructs(pkg, monkeypatch)
        read = {p: bytes(rpc.call(fs.url() + p)) for p in files}
        assert read == files
        assert reconstructed and {v for v, *_ in reconstructed} <= set(vids)
        if pkg == PORT:  # the port's ledger: one K1 row per interval
            assert _k1_rows(PORT) - rows == len(reconstructed)
        after = {"listings": _listings(cluster, env),
                 "fsck": cluster.run(env, "volume.fsck")}
        if pkg == PORT:
            _orphans_after_rm(cluster, env, fs, files)
        return {"fids": fids, "before": before, "after": after,
                "shards": shards, "lost": sorted(held[victim].items()),
                "k1": sorted(reconstructed),
                "read": {p: hashlib.sha256(d).hexdigest()
                         for p, d in read.items()}}
    finally:
        if fs is not None:
            fs.stop()
        cluster.stop()


def test_filer_cluster_gate_matches_reference(tmp_path, monkeypatch):
    pin_clocks(monkeypatch)
    ref, port = (_scenario(pkg, tmp_path, monkeypatch) for pkg in PACKAGES)
    n_chunks = sum(map(len, ref["fids"].values()))
    # The reference fault the port fixes: every chunk is on an EC
    # volume now, and only the port's fsck finds its holders.
    assert ref["after"].pop("fsck").startswith(
        f"checked {n_chunks} chunks, {n_chunks} missing")
    assert port["after"].pop("fsck") == \
        f"checked {n_chunks} chunks, 0 missing"
    for key in ("fids", "before", "after", "shards", "read"):
        assert port[key] == ref[key], key
