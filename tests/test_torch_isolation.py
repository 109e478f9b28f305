"""The PyTorch port stands alone: it imports neither jax nor
seaweedfs_tpu, and its entry points never fall back to the CPU unasked.

The pytest process has already imported JAX (tests/conftest.py), so the
import check runs in a subprocess with both names blocked.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from seaweedfs_tpu_torch.ops.erasure import new_coder

pytestmark = pytest.mark.torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests in other files must not lose their cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "seaweedfs_tpu_torch")
BANNED = ("jax", "jaxlib", "seaweedfs_tpu")

_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "seaweedfs_tpu"):
    sys.modules[name] = None
import os, pkgutil, importlib, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
import seaweedfs_tpu_torch
for m in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__,
                               "seaweedfs_tpu_torch."):
    importlib.import_module(m.name)
from seaweedfs_tpu_torch.core.needle import Needle
from seaweedfs_tpu_torch.ec.encoder import (rebuild_ec_files, write_ec_files,
                                            write_sorted_file_from_idx)
from seaweedfs_tpu_torch.ec.volume import EcVolume
from seaweedfs_tpu_torch.ops.erasure import host_array, new_coder
from seaweedfs_tpu_torch.storage.dat_writer import DatWriter
rng = np.random.default_rng(0)
coder = new_coder(device="cpu")
data = rng.integers(0, 256, (10, 5000), dtype=np.uint8)
assert host_array(coder.encode(data)).shape == (4, 5000)
with tempfile.TemporaryDirectory() as d:
    base = os.path.join(d, "7")
    payloads = {i: rng.bytes(int(rng.integers(1, 3000))) for i in range(1, 40)}
    with DatWriter(base) as w:
        for i, p in payloads.items():
            w.write_needle(Needle(cookie=i, id=i, data=p))
    write_sorted_file_from_idx(base)
    write_ec_files(base, device="cpu", large_block_size=10000,
                   small_block_size=100, chunk_size=100)
    os.remove(base + ".ec02")
    assert rebuild_ec_files(base, device="cpu") == [2]
    os.remove(base + ".ec05")
    vol = EcVolume(base, device="cpu", large_block_size=10000,
                   small_block_size=100)
    assert all(vol.read_needle(i).data == p for i, p in payloads.items())
    vol.close()
    from seaweedfs_tpu_torch.parallel.cluster_encode import batch_encode_files
    from seaweedfs_tpu_torch.parallel.cluster_rebuild import batch_rebuild_files
    from seaweedfs_tpu_torch.parallel.mesh import make_mesh
    lrc = os.path.join(d, "8")
    with DatWriter(lrc) as w:
        for i, p in payloads.items():
            w.write_needle(Needle(cookie=i, id=i, data=p))
    mesh = make_mesh(devices=[torch.device("cpu")])
    batch_encode_files([lrc], mesh, codec="lrc")
    os.remove(lrc + ".ec03")
    assert "read 5 shards" in batch_rebuild_files([lrc], mesh)[0]
    for backend in ("torch", "numpy"):
        c = new_coder(backend=backend, codec="lrc", device="cpu")
        assert host_array(c.encode(data)).shape == (4, 5000)
    from seaweedfs_tpu_torch.storage.scrub import ScrubDaemon
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.vacuum import vacuum
    store = Store([os.path.join(d, "store")])
    store.add_volume(3, "iso")
    for i, p in payloads.items():
        store.write_needle(3, Needle(cookie=i, id=i, data=p))
    assert store.delete_needle(3, 5) > 0
    vacuum(store.find_volume(3))
    assert ScrubDaemon(store, {}, mbps=0, interval=0).scrub_all(
        repair=True)["corrupt"] == 0
    assert store.read_needle(3, 7, 7).data == payloads[7]
    store.close()
    from seaweedfs_tpu_torch.cluster.rpc import RpcError
    from seaweedfs_tpu_torch.events import JOURNAL, emit
    from seaweedfs_tpu_torch.fault import registry as fault
    from seaweedfs_tpu_torch.stats import roofline
    from seaweedfs_tpu_torch.trace import tracer
    fault.arm("volume.read", "status:503*1")
    try:
        fault.hit("volume.read")
        raise AssertionError("armed fault did not fire")
    except RpcError as e:
        assert e.status == 503
    assert JOURNAL.snapshot(type_="fault.injected")
    emit("ec.repair.local", vid=8, codec="lrc")
    os.environ["SEAWEEDFS_TPU_TRACE"] = "1"
    with tracer.root_span("ec.batch_rebuild", "ec") as root:
        with tracer.span("ec.dat_rebuild"):
            pass
    assert len(tracer.BUFFER.get(root.trace_id)) == 2
    os.environ["SEAWEEDFS_TPU_ROOFLINE_CACHE"] = os.path.join(d, "peaks")
    roofline.PROBE_SIZES["cpu"] = {"m": 32, "membw_bytes": 4096,
                                   "copy_bytes": 4096, "reps": 1}
    assert "error" not in roofline.probe_peaks("cpu")
    n_rows = len(roofline.LEDGER.recent(256))
    new_coder(device="cpu").encode(data)
    assert len(roofline.LEDGER.recent(256)) == n_rows + 1
    assert roofline.LEDGER.recent(1)[0]["achieved"] is not None
    assert roofline.LEDGER.conservation()["ok"]
    assert roofline.LEDGER.pipelines()
    # The cluster slice: master, volume servers, client and shell.
    from seaweedfs_tpu_torch.cluster.client import WeedClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    master = MasterServer(meta_dir=os.path.join(d, "m"), pulse_seconds=60)
    master.start()
    servers = []
    for i in range(3):
        servers.append(VolumeServer(master.url(), [os.path.join(d, f"v{i}")],
                                    pulse_seconds=60, device="cpu"))
        servers[-1].start()
    client = WeedClient(master.url())
    fid = client.upload_data(payloads[1])
    vid = fid.split(",")[0]
    env = CommandEnv(master.url(), device="cpu")
    run_command(env, "lock")
    assert "ec shards" in run_command(env, f"ec.encode -volumeId {vid} -batch")
    for vs in servers:
        vs._send_heartbeat(full=True)
    assert client.download(fid) == payloads[1]
    env.close()
    for vs in servers:
        vs.stop()
    master.stop()
    # This slice: a raft master, a shipping and leasing volume server,
    # the mirror verbs and weed backup.
    import time
    from seaweedfs_tpu_torch.cluster.rpc import call, free_port
    from seaweedfs_tpu_torch.command import COMMANDS, _load_all, parse_flags
    standby = MasterServer(meta_dir=os.path.join(d, "sb"), pulse_seconds=60)
    standby.start()
    sb_vs = VolumeServer(standby.url(), [os.path.join(d, "sbv")],
                         pulse_seconds=60, device="cpu")
    sb_vs.start()
    port = free_port()
    primary = MasterServer(port=port, meta_dir=os.path.join(d, "pr"),
                           pulse_seconds=60,
                           peers=[f"http://127.0.0.1:{port}"])
    primary.start()
    while not primary.is_leader():
        time.sleep(0.05)
    pr_vs = VolumeServer(primary.url(), [os.path.join(d, "prv")],
                         pulse_seconds=60, device="cpu",
                         replicate_peer=standby.url(),
                         replicate_interval=0.05, geo_cluster_id="A")
    pr_vs.start()
    call(f"{primary.url()}/vol/grow?count=1&collection=iso", "POST")
    a = call(f"{primary.url()}/dir/assign?collection=iso")
    vid = int(a["fid"].split(",")[0])
    pr_vs.store.find_volume(vid).enable_rlog()
    call(f"http://{a['url']}/{a['fid']}", "POST", payloads[2])
    deadline = time.monotonic() + 60
    while True:
        st = call(f"http://{pr_vs.url()}/debug/replication")["rlog"]
        if st.get(str(vid), {}).get("pending", 1) == 0:
            break
        assert time.monotonic() < deadline, st
        time.sleep(0.05)
    assert WeedClient(standby.url()).download(a["fid"]) == payloads[2]
    pr_vs._send_heartbeat(full=True)
    env = CommandEnv(primary.url(), device="cpu")
    assert "peer(s):" in run_command(env, "cluster.mirror.status")
    assert "HEALTHY" in run_command(env, "cluster.check")
    env.close()
    _load_all()
    flags, rest = parse_flags([f"-master={primary.url()}",
                               f"-volumeId={vid}",
                               f"-dir={os.path.join(d, 'backup')}"])
    assert COMMANDS["backup"].run(flags, rest) == 0
    for srv in (pr_vs, primary, sb_vs, standby):
        srv.stop()
    # The filer slice: a filer over a master and a volume server, its
    # client, the shell's fs.* and volume.fsck.
    from seaweedfs_tpu_torch.filer.client import FilerProxy
    from seaweedfs_tpu_torch.filer.server import FilerServer
    master = MasterServer(meta_dir=os.path.join(d, "fm"), pulse_seconds=60)
    master.start()
    fvs = VolumeServer(master.url(), [os.path.join(d, "fv")],
                       pulse_seconds=60, device="cpu")
    fvs.start()
    filer = FilerServer(master.url(), port=0,
                        store_path=os.path.join(d, "filer"))
    filer.start()
    proxy = FilerProxy(filer.url())
    proxy.put("/iso/dir/a.bin", payloads[3])
    assert proxy.get("/iso/dir/a.bin").read() == payloads[3]
    env = CommandEnv(master.url(), filer_url=filer.url(), device="cpu")
    assert "a.bin" in run_command(env, "fs.ls /iso/dir")
    assert "0 missing" in run_command(env, "volume.fsck")
    env.close()
    for srv in (filer, fvs, master):
        srv.stop()
assert not any(sys.modules.get(n) for n in ("jax", "jaxlib", "seaweedfs_tpu"))
print("ISOLATED-OK")
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_runs_with_jax_and_reference_blocked(tmp_path):
    r = _run([sys.executable, "-c", _BLOCKED_RUN], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    assert "ISOLATED-OK" in r.stdout


_BLOCKED_MASTER = r"""
import runpy, sys
for name in ("jax", "jaxlib", "seaweedfs_tpu"):
    sys.modules[name] = None
runpy.run_module("seaweedfs_tpu_torch", run_name="__main__", alter_sys=True)
"""


def test_port_master_entry_point_with_jax_and_reference_blocked(tmp_path):
    """`python -m seaweedfs_tpu_torch master` (runpy, as -m runs it) in a
    process where jax, jaxlib and seaweedfs_tpu cannot be imported
    answers /dir/status and /cluster/healthz, and stops on SIGTERM."""
    import time

    from seaweedfs_tpu_torch.cluster import rpc
    port = rpc.free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(tmp_path / "master.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", _BLOCKED_MASTER, "master",
             f"-port={port}", f"-mdir={tmp_path / 'm'}",
             "-volumeSizeLimitMB=30000", "-defaultReplication=010"],
            cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, (tmp_path / "master.log").read_text()
            try:
                status = rpc.call(url + "/dir/status", timeout=2.0)
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert status["topology"]["volumes"] == 0
        code, health = rpc.call_status(url + "/cluster/healthz")
        assert code == 503 and health["problems"] == ["no live data nodes"]
        assert health["is_leader"]
    finally:
        proc.terminate()
        assert proc.wait(30) == 0
    assert "Traceback" not in (tmp_path / "master.log").read_text()


_NO_GRPC = _BLOCKED_MASTER.replace(
    'for name in ("jax", "jaxlib", "seaweedfs_tpu"):',
    'for name in ("jax", "jaxlib", "seaweedfs_tpu", "grpc", "google.protobuf"):')


def test_port_filer_serves_without_grpc_and_protobuf(tmp_path):
    """`python -m seaweedfs_tpu_torch master|volume|filer` in processes
    where grpc and google.protobuf cannot be imported (as on a host
    without them), beside jax and the JAX package: each logs that its
    gRPC plane is off, and the filer serves a PUT and a GET."""
    import time

    from seaweedfs_tpu_torch.cluster import rpc
    mport, fport = rpc.free_port(), rpc.free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    argv = [["master", f"-port={mport}", f"-mdir={tmp_path / 'm'}",
             "-volumeSizeLimitMB=64"],
            ["volume", "-device=cpu", f"-port={rpc.free_port()}",
             f"-dir={tmp_path / 'v'}", "-max=7", f"-mserver=127.0.0.1:{mport}"],
            ["filer", f"-port={fport}", f"-master=127.0.0.1:{mport}",
             f"-dir={tmp_path / 'f'}"]]
    procs, logs = [], []
    try:
        for i, args in enumerate(argv):
            logs.append(tmp_path / f"{args[0]}.log")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _NO_GRPC, *args],
                    cwd=str(tmp_path), env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        murl, furl = f"http://127.0.0.1:{mport}", f"http://127.0.0.1:{fport}"

        def up():
            code, doc = rpc.call_status(murl + "/cluster/healthz",
                                        timeout=2.0)
            rpc.call(furl + "/", timeout=2.0)
            return len(doc.get("nodes", [])) == 1
        deadline = time.monotonic() + 90
        while True:
            for p, log in zip(procs, logs):
                assert p.poll() is None, log.read_text()[-3000:]
            try:
                if up():
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "cluster did not start"
            time.sleep(0.2)
        payload = os.urandom(300_000)
        rpc.call(furl + "/nogrpc/a.bin", "PUT", payload)
        assert bytes(rpc.call(furl + "/nogrpc/a.bin")) == payload
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(30)
    for log in logs:
        text = log.read_text()
        assert "gRPC plane disabled" in text, text[-3000:]
        assert "Traceback" not in text, text[-3000:]


@pytest.mark.parametrize("command", ["volume", "shell", "server"])
def test_card_entry_points_refuse_without_a_card(command, tmp_path):
    """`python -m seaweedfs_tpu_torch volume|shell|server` without
    -device=cpu exit non-zero with resolve_device's reason on a host
    without a card, before serving or dialing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run([sys.executable, "-c", _BLOCKED_MASTER, command,
              f"-dir={tmp_path / 'v'}", f"-mdir={tmp_path / 'm'}",
              "-mserver=127.0.0.1:1", "-master=127.0.0.1:1", "volume.list"],
             cwd=str(tmp_path))
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert "Traceback" not in r.stderr
    assert not (tmp_path / "v").exists()


def _sources():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                           "kernel_variants.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_imports_jax_or_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, f"{path}: {name}"


def test_new_coder_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_coder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_coder(backend="numpy")
    assert new_coder(backend="numpy", device="cpu").total_shards == 14
    assert new_coder(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    from the repository and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_native_crc_builds_from_source_when_the_committed_library_fails(
        tmp_path, monkeypatch):
    """A committed native/libseaweed_native.so that does not load on this
    host (built elsewhere) is replaced by a g++ build from
    native/seaweed_native.cpp in the port's build directory."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    from seaweedfs_tpu_torch.utils import native

    real_cdll = native.ctypes.CDLL
    committed = os.path.join(native.NATIVE_DIR, "libseaweed_native.so")

    def cdll(path, *a, **kw):
        if os.path.abspath(path) == committed:
            raise OSError("wrong ELF class")
        return real_cdll(path, *a, **kw)

    monkeypatch.setattr(native.ctypes, "CDLL", cdll)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    lib = native.load.__wrapped__()
    assert lib is not None
    assert os.listdir(tmp_path)
    assert native.crc32c_fn(lib)(b"123456789") == 0xE3069283


# The roles that start a gRPC plane, and so log that it is off.
GRPC_ROLES = ("master", "volume", "filer", "msg.broker")


def wait_logged(logs, text: str, timeout: float = 90.0, sleep=None) -> None:
    """Wait until the log of every role in GRPC_ROLES holds `text`.  A
    role logs that its gRPC plane is off just after it starts serving
    HTTP, so a role that answers may not have written the line yet, and
    a role stopped then never writes it."""
    import time
    sleep = sleep or time.sleep
    deadline = time.monotonic() + timeout
    while True:
        short = [log for log in logs if log.stem in GRPC_ROLES
                 and text not in log.read_text()]
        if not short:
            return
        assert time.monotonic() < deadline, short[0].read_text()[-3000:]
        sleep(0.2)


def test_port_gateways_serve_without_grpc_and_protobuf(tmp_path):
    """`python -m seaweedfs_tpu_torch s3` and `msg.broker` (beside a
    master, a volume server and a filer) in processes where grpc,
    google.protobuf, jax and the JAX package cannot be imported: the
    broker logs that its gRPC plane is off, and both serve a request."""
    import json
    import time

    from seaweedfs_tpu_torch.cluster import rpc
    mport, fport, sport, bport = (rpc.free_port() for _ in range(4))
    env = dict(os.environ, PYTHONPATH=REPO)
    argv = [["master", f"-port={mport}", f"-mdir={tmp_path / 'm'}",
             "-volumeSizeLimitMB=64"],
            ["volume", "-device=cpu", f"-port={rpc.free_port()}",
             f"-dir={tmp_path / 'v'}", "-max=7", f"-mserver=127.0.0.1:{mport}"],
            ["filer", f"-port={fport}", f"-master=127.0.0.1:{mport}",
             f"-dir={tmp_path / 'f'}"],
            ["s3", f"-port={sport}", f"-filer=127.0.0.1:{fport}"],
            ["msg.broker", f"-port={bport}", f"-filer=127.0.0.1:{fport}"]]
    procs, logs = [], []
    s3, broker = f"http://127.0.0.1:{sport}", f"http://127.0.0.1:{bport}"

    def wait(up):
        deadline = time.monotonic() + 90
        while True:
            for p, log in zip(procs, logs):
                assert p.poll() is None, log.read_text()[-3000:]
            try:
                if up():
                    return
            except OSError:
                pass
            assert time.monotonic() < deadline, "cluster did not start"
            time.sleep(0.2)

    def cluster_up():
        _code, doc = rpc.call_status(
            f"http://127.0.0.1:{mport}/cluster/healthz", timeout=2.0)
        rpc.call(f"http://127.0.0.1:{fport}/", timeout=2.0)
        return len(doc.get("nodes", [])) == 1

    def gateways_up():
        rpc.call_status(s3 + "/", timeout=2.0)
        rpc.call(broker + "/status", timeout=2.0)
        return True
    try:
        # The gateways start once the filer they front serves.
        for i, args in enumerate(argv):
            if i == 3:
                wait(cluster_up)
            logs.append(tmp_path / f"{args[0]}.log")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _NO_GRPC, *args],
                    cwd=str(tmp_path), env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        wait(gateways_up)
        payload = os.urandom(200_000)
        assert rpc.call_status(s3 + "/nogrpc", "PUT", b"")[0] == 200
        assert rpc.call_status(s3 + "/nogrpc/a.bin", "PUT", payload)[0] \
            == 200
        code, body = rpc.call_status(s3 + "/nogrpc/a.bin")
        assert code == 200 and bytes(body) == payload
        from seaweedfs_tpu_torch.messaging import MessagingClient
        c = MessagingClient(broker)
        c.configure_topic("ns", "t", partition_count=1)
        c.publish("ns", "t", b"hello", key="k")
        msgs = c.fetch("ns", "t", 0)["messages"]
        assert [m["value"] for m in msgs] == [b"hello"]
        assert json.loads(json.dumps(rpc.call(broker + "/status")))
        wait_logged(logs, "gRPC plane disabled")
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(30)
    for log in logs:
        text = log.read_text()
        assert "Traceback" not in text, text[-3000:]
        if log.stem in GRPC_ROLES:
            assert "gRPC plane disabled" in text, text[-3000:]


def test_roles_are_stopped_only_after_logging_the_plane_off():
    """The broker answered its first request before it logged that its
    gRPC plane is off, and the case stopped it there (its log held the
    "serving" line alone).  The wait reads the log until the line comes."""

    class Log:
        stem = "msg.broker"
        reads = 0

        def read_text(self):
            self.reads += 1
            return "message broker serving at http://x:1\n" + (
                "gRPC plane disabled (grpcio missing)\n"
                if self.reads > 2 else "")

    log = Log()
    wait_logged([log], "gRPC plane disabled", sleep=lambda s: None)
    assert log.reads == 3


def test_both_packages_register_the_same_21_commands():
    import importlib
    names = []
    for pkg in ("seaweedfs_tpu", "seaweedfs_tpu_torch"):
        cmd = importlib.import_module(f"{pkg}.command")
        cmd._load_all()
        names.append(sorted(cmd.COMMANDS))
    assert names[0] == names[1]
    assert len(names[1]) == 21


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_stub_names_slice_11b(path):
    """No part of the port still refuses as waiting for slice 11b."""
    with open(path) as f:
        text = f.read()
    assert "11b" not in text, path
