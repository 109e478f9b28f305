"""The port's cluster, mirror, trace, fault, profile, lifecycle and
tenant shell verbs held against the JAX package's.

A reference cluster and a port cluster (one master, one volume server,
clocks pinned, `random` seeded alike) are fed the same writes, reads and
tenant traffic; then every verb of shell/command_{cluster,mirror,trace,
fault,profile,lifecycle,tenant}.py runs against each, in the same order.
With each cluster's addresses and directory named alike, a verb whose
output is deterministic must print the same text in both packages.
Verbs that print timings, byte counts of the wire or probed peaks (the
`SHAPED` set) are compared with every number masked, and trace.ls
without the padding of its milliseconds column.  This covers the
port counterparts of tests/test_slo.py::test_debug_hot_and_cluster_hot_shell,
tests/test_lifecycle.py::test_shell_verbs_and_metrics_exposition and
tests/test_tenancy.py::test_shell_tenant_verbs.
"""

from __future__ import annotations

import random
import re

import pytest

from _torch_cluster import (PACKAGES, PORT, LiveCluster,  # noqa: F401
                            hermetic_port_state, mod, pin_clocks)

pytestmark = pytest.mark.torch

# (label, shell line); `{vs0}` names the volume server.  Mutating verbs
# come last.
VERBS = [
    ("events.ls", "events.ls"),
    ("cluster.hot", "cluster.hot -k 5"),
    ("cluster.hot-client", "cluster.hot -k 3 -dimension client"),
    ("cluster.check", "cluster.check"),
    ("cluster.repair", "cluster.repair"),
    ("cluster.repair-status", "cluster.repair status"),
    ("cluster.repair-run", "cluster.repair run"),
    ("filer.shards.ls", "filer.shards.ls"),
    ("filer.shards.move", "filer.shards.move -shard 0 -to http://x:1"),
    ("cluster.mirror.status", "cluster.mirror.status"),
    ("cluster.mirror.pause", "cluster.mirror.pause"),
    ("cluster.mirror.resume", "cluster.mirror.resume"),
    ("cluster.lease.ls", "cluster.lease.ls"),
    ("cluster.lease.move", "cluster.lease.move -volume 1 -to B"),
    ("fault.set", "fault.set volume.read delay:0.001*2"),
    ("fault.ls", "fault.ls"),
    ("trace.ls", "trace.ls"),
    ("cluster.lifecycle", "cluster.lifecycle"),
    ("cluster.lifecycle-run", "cluster.lifecycle run"),
    ("volume.tier.status", "volume.tier.status"),
    ("cluster.tenants", "cluster.tenants"),
    ("tenant.ls", "tenant.ls"),
    ("tenant.quota", "tenant.quota alice"),
    ("cluster.conns", "cluster.conns"),
    ("cluster.flows", "cluster.flows"),
    ("cluster.roofline", "cluster.roofline"),
    ("cluster.profile", "cluster.profile -seconds 0.2"),
    ("cluster.mirror.cutover", "cluster.mirror.cutover -grace 0 -timeout 1"),
    ("cluster.drain", "cluster.drain -node {vs0} -grace 0"),
]
# Outputs carrying connection ages, wire byte counts (HTTP headers hold
# each cluster's port numbers), probed peaks, sampled stacks or trace
# ids and span times: compared with every number masked.  Trace ids
# are masked everywhere, and the profile keeps its summary lines.
SHAPED = {"cluster.conns", "cluster.flows", "cluster.roofline",
          "cluster.profile", "trace.ls", "tenant.ls"}
RULES = "alice max_bytes=1KB\nvictim weight=4 max_bytes=1GB\n"
ENV = {"SEAWEEDFS_TPU_TRACES": "1", "SEAWEEDFS_TPU_FAULTS": "",
       "SEAWEEDFS_TPU_PPROF": "1"}


def _normalise(text: str, cluster, root) -> str:
    master = cluster.url()
    text = text.replace(master, "<master>")
    text = text.replace(master.replace("http://", ""), "<master>")
    for i, vs in enumerate(cluster.servers):
        text = text.replace(vs.url(), f"<vs{i}>")
    text = text.replace(str(root), "<root>")
    return text.replace(cluster.pkg, "<pkg>")


def mask_numbers(text: str, label: str) -> str:
    """Every number of a SHAPED verb's output as "#".  trace.ls first
    loses the padding of its MS column, which right-aligns each trace's
    milliseconds in nine characters: a timing's digits set it."""
    if label == "trace.ls":
        text = re.sub(r" +(\d+\.\d\d)  ", r"  \1  ", text)
    return re.sub(r"\d+(\.\d+)?", "#", text)


def _reset(pkg) -> None:
    """The package's process-global planes that its in-process servers
    fold into verb output (the event journal, the roofline ledger's rows,
    the wire-flow ledger, the tier and chunk caches' contents and
    counters), its armed faults and breakers, as a fresh process has
    them, and its continuous profiler (which SEAWEEDFS_TPU_PPROF=1 starts
    once per process) stopped: tests before and after this file in the
    worker must not see each other's."""
    mod(pkg, "events").JOURNAL.clear()
    mod(pkg, "stats.roofline").LEDGER.reset()
    mod(pkg, "stats.flows").LEDGER.reset()
    mod(pkg, "storage.remote_cache").CACHE.reset()
    mod(pkg, "storage.chunk_cache").CACHE.reset()
    mod(pkg, "fault").disarm_all()
    mod(pkg, "cluster.resilience").reset_breakers()
    pprof = mod(pkg, "utils.pprof")
    if pprof.PROFILER is not None:
        pprof.PROFILER.stop()


def _drive(pkg, root):
    """One package's cluster, fed and then asked every verb."""
    _reset(pkg)
    rules = root / "tenants.txt"
    rules.write_text(RULES)
    cluster = LiveCluster(pkg, root, n=1,
                          master_kw={"tenant_rules": str(rules)},
                          vs_kw={"tenant_rules": str(rules)})
    rpc = cluster.rpc
    out = {}
    try:
        client = cluster.client()
        fids = [client.upload_data(bytes([i]) * (100 + 37 * i))
                for i in range(10)]
        for fid in fids[:3]:
            for _ in range(4):
                client.download(fid)
        hdr = {"X-Weed-Tenant": "alice"}
        for i in range(3):
            a = rpc.call(f"{cluster.url()}/dir/assign", headers=hdr)
            rpc.call(f"http://{a['url']}/{a['fid']}", "POST",
                     b"a" * (200 + i), headers=hdr)
        cluster.freshen()
        env = cluster.env()
        cluster.run(env, "lock")
        for label, line in VERBS:
            line = line.format(vs0=cluster.servers[0].url())
            try:
                text = cluster.run(env, line)
            except Exception as e:  # noqa: BLE001 — the verb's answer
                text = f"raise {type(e).__name__}: {e}"
            text = re.sub(r"[0-9a-f]{16,}", "<id>",
                          _normalise(text, cluster, root))
            if label == "cluster.profile":
                # Sampled stacks differ run to run: keep the summary.
                text = "\n".join(ln for ln in text.splitlines()
                                  if ".py:" not in ln)
            if label == "cluster.flows":
                # Which cells a beat has carried, and so the conservation
                # verdict, depend on when the verb reads: keep the table
                # of purposes.
                text = "\n".join(ln.split()[0] for ln in text.splitlines()
                                  if ln and not ln.startswith(("nodes=",
                                                               "  !!"))
                                  and "<" not in ln and ":" not in ln)
            if label in SHAPED:
                text = mask_numbers(text, label)
            out[label] = text
    finally:
        cluster.stop()
        _reset(pkg)
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Each verb's normalised output, per package."""
    with pytest.MonkeyPatch.context() as mp:
        clock = pin_clocks(mp)
        for k, v in ENV.items():
            mp.setenv(k, v)
        got = {}
        for pkg in PACKAGES:
            random.seed(0)
            clock.now = 1_700_000_000.0
            got[pkg] = _drive(pkg, tmp_path_factory.mktemp(pkg))
    return got


@pytest.mark.parametrize("label", [label for label, _ in VERBS])
def test_verb_output_equal_across_packages(label, outputs):
    ref, port = outputs[PACKAGES[0]][label], outputs[PORT][label]
    assert port == ref
    assert port.strip()


def test_hot_verbs_show_the_skew(outputs):
    """test_slo.py::test_debug_hot_and_cluster_hot_shell's view."""
    text = outputs[PORT]["cluster.hot"]
    assert "volume (read" in text and "needle (read" in text
    assert "127.0.0.1" in text
    text = outputs[PORT]["cluster.hot-client"]
    assert "volume (read" not in text and "client (read" in text


def test_lifecycle_verbs_render_live_state(outputs):
    """test_lifecycle.py::test_shell_verbs_and_metrics_exposition's
    verbs."""
    out = outputs[PORT]
    assert "enabled" in out["cluster.lifecycle"]
    assert "rules" in out["cluster.lifecycle"]
    assert "scan complete" in out["cluster.lifecycle-run"]
    tier = out["volume.tier.status"]
    assert "NODE" in tier and "VOL" in tier and "<vs0>" in tier
    assert "cache @" in tier


def test_tenant_verbs_show_the_tenant(outputs):
    """test_tenancy.py::test_shell_tenant_verbs's verbs."""
    out = outputs[PORT]
    assert "alice" in out["cluster.tenants"] and "RULE" in out[
        "cluster.tenants"]
    assert "alice" in out["tenant.ls"]
    assert "alice" in out["tenant.quota"] and "KB" in out["tenant.quota"]


def test_fault_trace_and_profile_verbs_reach_every_server(outputs):
    out = outputs[PORT]
    assert "volume.read" in out["fault.ls"]
    assert "raise" not in out["trace.ls"]
    assert "raise" not in out["cluster.profile"]
    assert "drain" in out["cluster.drain"].lower()


def test_trace_ls_mask_keeps_no_ms_column_width(monkeypatch):
    """trace.ls right-aligns each trace's milliseconds in a column nine
    wide: a trace of 9.5 ms and one of 10.5 ms print different padding,
    and masked, the same text.  The other SHAPED verbs keep their
    padding."""
    trace = mod(PORT, "shell.command_trace")
    env = type("Env", (), {"debug_servers": lambda self, flags: ["x:1"]})()

    def listing(ms: float) -> str:
        doc = {"traces": [{"trace_id": "ab" * 16, "duration_ms": ms,
                           "spans": 3, "start": 1.0, "root": "GET /",
                           "services": ["master"]}]}
        monkeypatch.setattr(trace, "_fetch", lambda url, qs: doc)
        return trace.TraceLs().do([], env)

    short, long_ = listing(9.5), listing(10.5)
    assert short.replace("  9.50", " 10.50") == long_
    assert mask_numbers(short, "trace.ls") == mask_numbers(long_, "trace.ls")
    assert mask_numbers(short, "cluster.conns") \
        != mask_numbers(long_, "cluster.conns")
