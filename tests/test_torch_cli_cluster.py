"""The port's cluster from its command line, and what it refuses.

`python -m seaweedfs_tpu_torch master`, three `volume -device=cpu`
processes and a `shell -device=cpu` process against them: the shell's
`lock` and per-volume `ec.encode` succeed, the volume's shards spread
over the volume servers and every needle reads back through the EC
path.

The parts that refused here until they were ported now work: the
volume server's cross-cluster shipper and lease plane, multi-master
raft, the gRPC master transport, `volume.fsck` (which without a filer
answers the reference's ShellError), and since slice 11b the /query
route, `server -s3/-webdav`, the Kafka and Pub/Sub notification queues
and the filer-event replicator.  A `-peers` list that does not name this
master is refused as the reference refuses it.
"""

from __future__ import annotations

import json
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


def test_unported_parts_refuse(tmp_path, monkeypatch):
    from seaweedfs_tpu_torch import replication
    from seaweedfs_tpu_torch.filer.server import FilerServer
    from seaweedfs_tpu_torch.utils import config
    from seaweedfs_tpu_torch.replication.notification import queue_for_spec
    from seaweedfs_tpu_torch.shell import ShellError
    m = MasterServer(meta_dir=str(tmp_path / "m"), pulse_seconds=60)
    m.start()
    try:
        mirrored = VolumeServer(m.url(), [str(tmp_path / "x")],
                                device="cpu", pulse_seconds=60,
                                replicate_peer="http://127.0.0.1:1",
                                geo_cluster_id="A")
        assert mirrored.shipper is not None and mirrored.leases is not None
        grpc_client = WeedClient(m.url(), use_grpc=True)
        assert grpc_client._use_grpc
        grpc_client.close()
        vs = VolumeServer(m.url(), [str(tmp_path / "v")], pulse_seconds=60,
                          device="cpu")
        vs.start()
        try:
            fid = WeedClient(m.url()).upload_data(b'{"a": 1}')
            status, doc = rpc.call_status(
                f"http://{vs.url()}/query", "POST",
                b'{"fid": "%s", "query": "select * from s3object"}'
                % fid.encode())
            assert status == 200
            assert [json.loads(x) for x in bytes(doc).splitlines()] \
                == [{"a": 1}]
            env = CommandEnv(m.url(), device="cpu")
            try:
                with pytest.raises(ShellError, match="no filer configured"):
                    run_command(env, "volume.fsck")
            finally:
                env.close()
        finally:
            vs.stop()
    finally:
        m.stop()
    from seaweedfs_tpu_torch.command import COMMANDS, _load_all
    from seaweedfs_tpu_torch.replication.kafka import KafkaQueue
    from seaweedfs_tpu_torch.replication.notification import AsyncPublisher
    from seaweedfs_tpu_torch.replication.pubsub import PubSubQueue
    _load_all()
    assert "-s3=true" in COMMANDS["server"].usage
    assert "-webdav=true" in COMMANDS["server"].usage
    assert isinstance(queue_for_spec("kafka://127.0.0.1:1/t"), KafkaQueue)
    assert isinstance(queue_for_spec("pubsub://p/t"), PubSubQueue)
    # A filer configured to publish to Kafka starts with the queue
    # behind its async publisher (nothing is sent until an event).
    (tmp_path / "conf").mkdir()
    (tmp_path / "conf" / "notification.toml").write_text(
        '[notification.kafka]\nenabled = true\nhosts = "127.0.0.1:1"\n')
    monkeypatch.setattr(config, "SEARCH_PATHS", [str(tmp_path / "conf")])
    fs = FilerServer("http://127.0.0.1:1", port=0)
    q = fs.filer.notification_queue
    assert isinstance(q, AsyncPublisher) and isinstance(q.inner, KafkaQueue)
    q.close()
    assert replication.Replicator.__name__ == "Replicator"
    with pytest.raises(ValueError, match="-peers must include"):
        MasterServer(peers=["127.0.0.1:1", "127.0.0.1:2"])
