"""The port's cluster from its command line, and what it refuses.

`python -m seaweedfs_tpu_torch master`, three `volume -device=cpu`
processes and a `shell -device=cpu` process against them: the shell's
`lock` and per-volume `ec.encode` succeed, the volume's shards spread
over the volume servers and every needle reads back through the EC
path.

Each part of this slice that waits for a later one refuses with
NotImplementedError (or, on the wire, 501) naming that slice, instead of
answering a fake success: the gRPC master transport, the filer behind
`fs.*` and `volume.fsck`, `server -filer/-s3/-webdav` and the /query
route (slice 11).  The volume server's cross-cluster shipper and lease
plane and multi-master raft, which refused here until they were ported,
now start; a `-peers` list that does not name this master is refused as
the reference refuses it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest

from _torch_cluster import (cluster_deadline,  # noqa: F401
                            hermetic_port_state)
from seaweedfs_tpu_torch.cluster import rpc
from seaweedfs_tpu_torch.cluster.client import WeedClient
from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
from seaweedfs_tpu_torch.command import main
from seaweedfs_tpu_torch.shell import CommandEnv, run_command

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(args, log):
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=log,
        stderr=subprocess.STDOUT)


def _wait(pred, what, procs, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        for p in procs:
            assert p.poll() is None, f"{what}: a process exited"
        try:
            if pred():
                return
        except OSError:
            pass
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.2)


def test_cli_cluster_ec_encode(tmp_path):
    mport = rpc.free_port()
    murl = f"http://127.0.0.1:{mport}"
    procs = []
    with open(tmp_path / "cluster.log", "w") as log:
        try:
            procs.append(_spawn(["master", f"-port={mport}",
                                 f"-mdir={tmp_path / 'm'}",
                                 "-volumeSizeLimitMB=16"], log))
            _wait(lambda: rpc.call(murl + "/dir/status", timeout=2.0),
                  "master", procs)
            for i in range(3):
                procs.append(_spawn(
                    ["volume", "-device=cpu", f"-port={rpc.free_port()}",
                     f"-dir={tmp_path / f'v{i}'}", "-max=7",
                     f"-mserver=127.0.0.1:{mport}"], log))
            _wait(lambda: len(rpc.call_status(murl + "/cluster/healthz",
                                              timeout=2.0)[1]["nodes"]) == 3,
                  "three volume servers", procs)
            client = WeedClient(murl)
            fids = {client.upload_data(f"cli-{i}".encode() * 50):
                    f"cli-{i}".encode() * 50 for i in range(12)}
            vid = int(next(iter(fids)).split(",")[0])
            r = subprocess.run(
                [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
                 "-device=cpu", f"-master=127.0.0.1:{mport}", "lock",
                 f"ec.encode -volumeId {vid}"], cwd=REPO,
                env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                text=True, timeout=120)
            assert r.returncode == 0, r.stderr[-2000:]
            assert f"volume {vid} -> ec shards on 3 servers" in r.stdout
            look = rpc.call(f"{murl}/dir/lookup?volumeId={vid}")
            assert sorted(int(s) for s in look["ecShards"]) == \
                list(range(14))
            client.cache.forget(vid)
            for fid, payload in fids.items():
                assert bytes(client.download(fid)) == payload
        finally:
            for p in reversed(procs):
                p.terminate()
            for p in procs:
                p.wait(30)


def test_unported_parts_refuse(tmp_path):
    m = MasterServer(meta_dir=str(tmp_path / "m"), pulse_seconds=60)
    m.start()
    try:
        mirrored = VolumeServer(m.url(), [str(tmp_path / "x")],
                                device="cpu", pulse_seconds=60,
                                replicate_peer="http://127.0.0.1:1",
                                geo_cluster_id="A")
        assert mirrored.shipper is not None and mirrored.leases is not None
        with pytest.raises(NotImplementedError, match="slice 11"):
            WeedClient(m.url(), use_grpc=True)
        vs = VolumeServer(m.url(), [str(tmp_path / "v")], pulse_seconds=60,
                          device="cpu")
        vs.start()
        try:
            fid = WeedClient(m.url()).upload_data(b'{"a": 1}')
            status, doc = rpc.call_status(
                f"http://{vs.url()}/query", "POST",
                b'{"fid": "%s", "query": "select * from s3object"}'
                % fid.encode())
            assert status == 501 and "slice 11" in str(doc)
            env = CommandEnv(m.url(), device="cpu")
            try:
                with pytest.raises(NotImplementedError, match="slice 11"):
                    run_command(env, "volume.fsck")
            finally:
                env.close()
        finally:
            vs.stop()
    finally:
        m.stop()
    with pytest.raises(NotImplementedError, match="slice 11"):
        main(["server", "-filer", f"-dir={tmp_path / 's'}", "-device=cpu"])
    with pytest.raises(ValueError, match="-peers must include"):
        MasterServer(peers=["127.0.0.1:1", "127.0.0.1:2"])
