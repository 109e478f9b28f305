"""LRC(10,2,2) state carried across packages.

One package's cluster takes a volume of needles; its sealed `.dat` is
encoded with `write_ec_files(codec="lrc")` by BOTH packages, and the
`.ec00`-`.ec13`, `.ecx`, `.ecc` and `.vif` (which carries the codec id)
must be byte-identical.  The other package's encoding is then served by
this package's volume server: the shards mounted in place of the
volume, shard 0 deleted (a loss inside local group 0), and every needle
read back through the server.  The interval on shard 0 is solved from
its local group: five shards read, one `ec.repair.local` event.  Run
once with the JAX package's files in the port's server and once the
other way round.
"""

from __future__ import annotations

import os
import shutil

import pytest

from _torch_cluster import (PORT, PACKAGES, LiveCluster,  # noqa: F401
                            cluster_deadline, hermetic_port_state, mod)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

SIDECARS = (".ecx", ".ecc", ".vif")


def _encode(pkg: str, dat_dir: str, out_dir: str, vid: int) -> str:
    """`pkg`'s write_ec_files(codec="lrc") of the sealed copy in
    dat_dir, in out_dir; returns the base name there."""
    os.makedirs(out_dir)
    base = os.path.join(out_dir, str(vid))
    for ext in (".dat", ".idx"):
        shutil.copyfile(os.path.join(dat_dir, str(vid) + ext), base + ext)
    enc = mod(pkg, "ec.encoder")
    enc.write_sorted_file_from_idx(base)
    kw = {"device": "cpu"} if pkg == PORT else {
        "coder": mod(pkg, "ops.erasure").new_coder(backend="numpy",
                                                   codec="lrc")}
    enc.write_ec_files(base, codec="lrc", **kw)
    return base


def _files(base: str) -> dict:
    to_ext = mod(PORT, "ec").to_ext
    out = {}
    for ext in [to_ext(s) for s in range(14)] + list(SIDECARS):
        with open(base + ext, "rb") as f:
            out[ext] = f.read()
    return out


@pytest.mark.parametrize("server", PACKAGES, ids=["ref-serves-port",
                                                  "port-serves-ref"])
def test_lrc_files_cross_packages_and_read_degraded(server, tmp_path):
    writer = PACKAGES[1 - PACKAGES.index(server)]
    cluster = LiveCluster(server, tmp_path / "cluster", n=1)
    try:
        rpc = cluster.rpc
        client = cluster.client()
        payloads = {}
        for i in range(40):
            data = bytes((i * 37 + j) % 251 for j in range(700 + 4099 * i))
            payloads[client.upload_data(data)] = data
        vids = {int(f.split(",")[0]) for f in payloads}
        vid = min(vids)
        payloads = {f: d for f, d in payloads.items()
                    if int(f.split(",")[0]) == vid}
        vs = cluster.servers[0]
        sealed = str(tmp_path / "sealed")
        os.makedirs(sealed)
        for ext in (".dat", ".idx"):
            rpc.call_to_file(f"http://{vs.url()}/admin/volume_file?"
                             f"volume={vid}&ext={ext}",
                             os.path.join(sealed, str(vid) + ext))

        # Both packages' LRC encodings of the same .dat, byte for byte.
        bases = {pkg: _encode(pkg, sealed, str(tmp_path / pkg), vid)
                 for pkg in PACKAGES}
        files = {pkg: _files(b) for pkg, b in bases.items()}
        assert files[PORT] == files[PACKAGES[0]]
        assert b"lrc" in files[PORT][".vif"]

        # The other package's files, served here in place of the volume.
        rpc.call_json(f"http://{vs.url()}/admin/delete_volume", "POST",
                      {"volume": vid})
        directory = vs.store.locations[0].directory
        for ext in files[writer]:
            shutil.copyfile(bases[writer] + ext,
                            os.path.join(directory, str(vid) + ext))
        rpc.call_json(f"http://{vs.url()}/admin/ec/mount", "POST",
                      {"volume": vid})
        rpc.call_json(f"http://{vs.url()}/admin/ec/delete_shards", "POST",
                      {"volume": vid, "shards": [0]})
        cluster.freshen()
        env = cluster.env()
        assert env.ec_codec(vid) == "lrc"
        assert sorted(env.ec_shard_locations(vid)) == list(range(1, 14))

        counter = mod(server, "stats.metrics").ec_repair_read_bytes_total
        journal = mod(server, "events").JOURNAL
        before, seq = counter.value(codec="lrc"), journal._seq
        for fid, data in payloads.items():
            assert bytes(rpc.call(f"http://{vs.url()}/{fid}")) == data
        local = [e["attrs"] for e in journal.snapshot(
            type_="ec.repair.local") if e["seq"] > seq]
        assert local and all(e["reads"] == 5 and e["shard"] == 0
                             and e["codec"] == "lrc" for e in local)
        # Every interval solved from group 0 read five shards' bytes.
        gathered = counter.value(codec="lrc") - before
        assert gathered >= sum(e["bytes"] for e in local) > 0
        assert gathered % 5 == 0
    finally:
        cluster.stop()
