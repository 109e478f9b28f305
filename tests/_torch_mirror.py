"""Both packages' cross-cluster mirrors side by side, for the port's
disaster-recovery, geo and backup tests (tests/test_torch_dr.py,
_geo.py, _backup.py).

`pkg_ns(pkg)` is one package's namespace of the modules these tests
drive.  `mirror_pair(P, root)` builds the mirror fixture of
tests/test_dr.py (a primary whose master is a single-node raft group
and whose volume server ships to a standby cluster); `geo_pair(P, root)`
the two-region fixture of tests/test_geo.py.  The port's volume
servers run on `device="cpu"`.

`crc_map(P, master_url, fids)` is `volume.fsck -crc -json`'s `volumes`
map (vid -> fid -> sorted distinct replica CRCs, node-address free)
for a known list of file ids: the fsck walks the filer's namespace to
find them, and the filer is not ported yet, so the tests name the ids
they wrote.  Each CRC comes from the same HEAD `X-Needle-Checksum` the
fsck reads.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from _torch_cluster import PORT, device_kw, mod

MODULES = {
    "rpc": "cluster.rpc", "resilience": "cluster.resilience",
    "client": "cluster.client", "master": "cluster.master",
    "volume_server": "cluster.volume_server", "types": "core.types",
    "raft": "cluster.raft", "rlog": "replication.rlog",
    "lease": "replication.lease",
    "shell": "shell", "shell_volume": "shell.command_volume",
    "metrics": "stats.metrics", "promcheck": "stats.promcheck",
    "flows": "stats.flows", "fault": "fault", "quota": "tenancy.quota",
}


def pkg_ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(pkg=pkg, is_port=pkg == PORT,
                           **{k: mod(pkg, v) for k, v in MODULES.items()})


def wait(cond, timeout=20.0, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(msg)
        time.sleep(0.05)


def clean(P) -> None:
    P.fault.disarm_all()
    P.resilience.reset_breakers()


def volume_server(P, master_url, d, **kw):
    return P.volume_server.VolumeServer(master_url, [str(d)], **kw,
                                        **device_kw(P.pkg))


def mirror_pair(P, root):
    """(pr_master, pr_vs, sb_master, sb_vs): the primary's master is a
    single-node raft group with a 50 ms lag SLO; its volume server
    ships to the standby's master every 50 ms."""
    sb_master = P.master.MasterServer(volume_size_limit_mb=16,
                                      meta_dir=str(root / "sbmeta"),
                                      pulse_seconds=60)
    sb_master.start()
    (root / "sb").mkdir()
    sb_vs = volume_server(P, sb_master.url(), root / "sb",
                          max_volume_counts=[200], pulse_seconds=60)
    sb_vs.start()
    pport = P.rpc.free_port()
    pr_master = P.master.MasterServer(
        port=pport, volume_size_limit_mb=16, meta_dir=str(root / "prmeta"),
        pulse_seconds=60, peers=[f"http://127.0.0.1:{pport}"],
        replication_lag_slo=0.05)
    pr_master.start()
    wait(pr_master.is_leader, 20, "single-node raft never elected")
    (root / "pr").mkdir()
    pr_vs = volume_server(P, pr_master.url(), root / "pr",
                          max_volume_counts=[200], pulse_seconds=60,
                          replicate_peer=sb_master.url(),
                          replicate_interval=0.05)
    pr_vs.start()
    return pr_master, pr_vs, sb_master, sb_vs


def geo_pair(P, root):
    """(ma, va, mb, vb): regions A and B, each shipping compressed to
    the other's master, with geo cluster ids, lease tables and read
    steering (50 ms lag SLO, 0.2 s steer cache)."""
    pa = P.rpc.free_port()
    pb = P.rpc.free_port()
    while pb == pa:
        pb = P.rpc.free_port()
    ma = P.master.MasterServer(
        port=pa, volume_size_limit_mb=16, meta_dir=str(root / "ma"),
        pulse_seconds=60, replication_lag_slo=0.05, geo_cluster_id="A",
        geo_vid_stride=2, geo_vid_offset=1, steer_peer=f"127.0.0.1:{pb}",
        steer_reads=True, steer_refresh=0.2)
    ma.start()
    mb = P.master.MasterServer(
        port=pb, volume_size_limit_mb=16, meta_dir=str(root / "mb"),
        pulse_seconds=60, replication_lag_slo=0.05, geo_cluster_id="B",
        geo_vid_stride=2, geo_vid_offset=0, steer_peer=f"127.0.0.1:{pa}",
        steer_reads=True, steer_refresh=0.2)
    mb.start()
    (root / "a").mkdir()
    (root / "b").mkdir()
    va = volume_server(P, ma.url(), root / "a", max_volume_counts=[200],
                       pulse_seconds=60, replicate_peer=mb.url(),
                       replicate_interval=0.05, geo_cluster_id="A",
                       replicate_compress=True)
    va.start()
    vb = volume_server(P, mb.url(), root / "b", max_volume_counts=[200],
                       pulse_seconds=60, replicate_peer=ma.url(),
                       replicate_interval=0.05, geo_cluster_id="B",
                       replicate_compress=True)
    vb.start()
    return ma, va, mb, vb


def stop_all(*servers) -> None:
    for s in servers:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 — already stopped in-test
            pass


def rlog_status(P, vs, vid):
    doc = P.rpc.call(f"http://{vs.url()}/debug/replication")
    return (doc.get("rlog") or {}).get(str(vid))


def wait_shipped(P, vs, vid, timeout=20.0):
    def ok():
        st = rlog_status(P, vs, vid)
        return bool(st) and st["pending"] == 0 and st["last_seq"] > 0
    wait(ok, timeout, f"volume {vid} never fully shipped: "
                      f"{rlog_status(P, vs, vid)}")


def crc_map(P, master_url: str, fids) -> dict:
    """vid -> fid -> sorted distinct replica CRCs over every replica the
    master names, as `volume.fsck -crc -json` reports them."""
    env = P.shell.CommandEnv(master_url, **device_kw(P.pkg))
    head = P.shell_volume.VolumeFsck._head_checksum
    vols: dict[str, dict[str, list[str]]] = {}
    try:
        for fid in fids:
            vid = int(fid.split(",")[0])
            crcs = {head(url, fid) for url in env.volume_locations(vid)}
            vols.setdefault(str(vid), {})[fid] = sorted(crcs)
    finally:
        env.close()
    return {vid: dict(sorted(f.items())) for vid, f in sorted(vols.items())}
