"""The port's test harness itself (`_torch_cluster`, `_torch_twin`): what
keeps one test's state and timing out of another's when the suite runs
on six xdist workers.

- A twin case that fails names the half it failed in.
- Each xdist worker hands out server ports from a slice of its own,
  each once before any port comes again.
- Every test starts with both packages' keep-alive client pools empty,
  so that a server on a port an earlier test used does not meet the
  connections that test's server closed.
- A twin's `server` subprocess, and the X4 ranks' gloo store, get
  ports below the ephemeral range, which no outbound connection takes
  while they start.
- A twin case's halves leave the process's lock histograms as they
  found them, and start with them empty.
- A stopped gRPC plane may refuse a call or cancel it, in either
  package: the twin records either status alike, and any other error
  as it is.
"""

from __future__ import annotations

import re
import subprocess
from concurrent import futures

import grpc

import numpy as np
import pytest

import _torch_cluster
import _torch_x4
import _torch_twin
from _torch_cluster import PACKAGES, PORT, hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile
from test_torch_gateway_twins import TWINS as GATEWAY_TWINS
from test_torch_master_grpc import TWIN as MASTER_GRPC_TWIN
from test_torch_profile_twins import TWINS as PROFILE_TWINS
from test_torch_rpc_pool import Server
from test_torch_s3_conformance import TWIN as S3_TWIN

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("pkg", PACKAGES)
def test_twin_failure_names_its_half(pkg, tmp_path, monkeypatch):
    twin = TwinFile("test_replication_cloud.py")
    run_one = _torch_twin._run_one

    def failing(mod, case, half, *a, **kw):
        if half == pkg:
            raise AssertionError("an assert of the case")
        return run_one(mod, case, half, *a, **kw)

    monkeypatch.setattr(_torch_twin, "_run_one", failing)
    case = "test_azure_sharedkey_put_delete"
    with pytest.raises(AssertionError, match="an assert") as ei:
        twin.run(case, tmp_path)
    assert ei.value.__notes__ == [f"{case}: failed in {_torch_twin.HALF[pkg]}'s half"]


def test_ports_come_from_the_workers_slice_once_each(monkeypatch):
    """Worker gw2 of six draws from the third sixth of 12000-21999 only,
    and 400 draws give 400 ports."""
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw2")
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    monkeypatch.setattr(_torch_cluster, "_unused_ports", [], raising=False)
    ports = [_torch_cluster.grpc_pair_port() for _ in range(400)]
    assert len(set(ports)) == len(ports)
    assert all(15332 <= p < 16998 for p in ports), sorted(ports)[::40]


def test_worker_slices_are_disjoint(monkeypatch):
    """No two workers hand out one server port, and no server port is
    the gRPC plane (port + 10000) of another: a master on 12041 of gw0
    failed to bind its plane on 22041, a server port of gw5."""
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    seen: set = set()
    for i in range(6):
        monkeypatch.setenv("PYTEST_XDIST_WORKER", f"gw{i}")
        ports = set(_torch_cluster.port_slice())
        assert len(ports) == 1666 and not ports & seen
        assert min(ports) >= 12000 and max(ports) + 10000 < 32768
        seen |= ports
    assert not {p + 10000 for p in seen} & seen


@pytest.mark.parametrize("pkg", PACKAGES)
def test_no_idle_connection_outlives_a_test(pkg):
    """A server leaves four idle connections in the client's pool and
    stops; a server of the next test starts on its port.  The harness's
    drop before that test leaves none, and the first call answers."""
    old = Server(pkg, "threads")
    try:
        old.fill_pool()
    finally:
        old.stop()
    key = ("http", old.srv.host, old.srv.port)
    _torch_cluster.drop_idle_connections()
    assert not old.rpc._pool._idle.get(key)
    new = Server(pkg, "threads", port=old.srv.port)
    try:
        assert new.rpc.call(new.url("/ping")) == {"ok": "ping"}
        assert new.calls["ping"] == 1
    finally:
        new.stop()


class _Spawned(Exception):
    """Stands in for the subprocess the case would start."""


@pytest.mark.parametrize("twin,case", [
    (GATEWAY_TWINS["test_cli.py"][0],
     "test_server_full_stack_s3_webdav[json]"),
    (S3_TWIN, "test_anonymous_is_refused")],
    ids=["test_cli", "test_s3_conformance"])
def test_twin_servers_bind_below_the_ephemeral_range(twin, case, tmp_path,
                                                    monkeypatch):
    """The `server` command line each twin case would run: every port
    it names, and the gRPC plane at port + 10000, lies below 32768."""
    argv = []

    def spawn(args, *a, **kw):
        argv.extend(args)
        raise _Spawned

    monkeypatch.setattr(subprocess, "Popen", spawn)
    with pytest.raises(_Spawned):
        twin.run(case, tmp_path)
    ports = [int(p) for p in re.findall(r"port=(\d+)", " ".join(argv))]
    assert len(ports) >= 4 and all(p + 10000 < 32768 for p in ports), argv


def test_x4_ranks_meet_below_the_ephemeral_range(tmp_path, monkeypatch):
    """The port `_torch_x4.run` gives its gloo ranks to meet on comes
    from this worker's slice, below 32768."""
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw4")
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    monkeypatch.setattr(_torch_cluster, "_unused_ports", [], raising=False)
    ports = []

    def spawn(fn, args, nprocs, join):
        ports.append(args[1])
        raise _Spawned

    monkeypatch.setattr(_torch_x4.mp, "spawn", spawn)
    with pytest.raises(_Spawned):
        _torch_x4.run("ring_reconstruct", 2, np.zeros((1, 10, 8), np.uint8),
                      tuple(range(10)), (10,), tmp_path)
    assert ports[0] < 32768
    assert ports[0] in _torch_cluster.port_slice()


def test_twin_leaves_lock_histograms_as_it_found_them(tmp_path):
    """tests/test_attribution.py counts the observations of its own
    lock ("test.uncontended", 5000 acquires) as an absolute value.  Its
    twin's halves run in the same process as the reference's own file
    under --dist loadfile: what the process holds (three more
    observations here, as that file would make) does not reach the
    halves, and the halves' 10 000 do not stay behind for it."""
    from seaweedfs_tpu.stats import contention
    hist = contention.lock_hold_seconds
    held = _torch_twin._zero_histogram(hist)
    try:
        for _ in range(3):
            hist.observe(1e-6, lock="test.uncontended")
        PROFILE_TWINS["test_attribution.py"].run(
            "test_armed_uncontended_fast_path_bounded", tmp_path)
        assert hist.count(lock="test.uncontended") == 3
    finally:
        _torch_twin._restore_histogram(hist, held)


@pytest.mark.parametrize("ending", ["cancelled", "not_grpc"])
def test_stopped_grpc_plane_cancels_or_refuses_alike(ending, tmp_path,
                                                     monkeypatch):
    """The port's half of test_weedclient_grpc_transport meets its
    stopped plane while it still shuts down: the call is cancelled
    (what a loaded host gives either package now and then), where the
    reference's was refused, and the case passes.  A port half whose
    call fails other than by a gRPC status (here an AttributeError, as
    a broken stub would raise) passes its own `pytest.raises(Exception)`
    and still fails the twin."""
    plane = _torch_cluster.mod(PORT, "pb.master_grpc").MasterGrpcServer
    transport = _torch_cluster.mod(PORT, "cluster.client") \
        ._GrpcMasterTransport
    stand_ins = []

    def cancel(request, context):
        context.abort(grpc.StatusCode.CANCELLED, "CANCELLED")

    class Cancelling(grpc.GenericRpcHandler):
        def service(self, details):
            return grpc.unary_unary_rpc_method_handler(cancel)

    def no_stub(*args, **kwargs):
        raise AttributeError("'NoneType' object has no attribute 'Assign'")

    def broken_init(self, master_url: str) -> None:
        dial(self, master_url)
        self._assign = no_stub

    dial = transport.__init__
    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(0).wait()
        if ending == "not_grpc":
            monkeypatch.setattr(transport, "__init__", broken_init)
            return
        server = grpc.server(futures.ThreadPoolExecutor(1))
        server.add_generic_rpc_handlers((Cancelling(),))
        assert server.add_insecure_port(self.addr()) == self.port
        server.start()
        stand_ins.append(server)

    monkeypatch.setattr(plane, "stop", stop)
    try:
        if ending == "cancelled":
            MASTER_GRPC_TWIN.run("test_weedclient_grpc_transport", tmp_path)
            assert len(stand_ins) == 1
        else:
            with pytest.raises(AssertionError, match="records differently"):
                MASTER_GRPC_TWIN.run("test_weedclient_grpc_transport",
                                     tmp_path)
    finally:
        for server in stand_ins:
            server.stop(None)
