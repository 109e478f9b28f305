"""The port's host planes held against seaweedfs_tpu's: metrics and the
exposition checker, sketches, heavy hitters, the tracer, the event
journal, fault points, metered locks, wire flows, and the hooks the EC
path reports through (the `volume.corrupt` injector, the metered `.ecc`
lock, the `.dat` rebuild span).

Each case feeds the same seeded inputs to both packages and compares
what they return, expose or write.
"""

from __future__ import annotations

import os
import random
import shutil
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.core.needle import Needle as RefNeedle
from seaweedfs_tpu.ec import decoder as ref_decoder
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import integrity as ref_integrity
from seaweedfs_tpu.events import journal as ref_journal
from seaweedfs_tpu.fault import registry as ref_fault
from seaweedfs_tpu.ops.coder_numpy import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu.stats import contention as ref_contention
from seaweedfs_tpu.stats import flows as ref_flows
from seaweedfs_tpu.stats import hotkeys as ref_hotkeys
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.stats import phases as ref_phases
from seaweedfs_tpu.stats import promcheck as ref_promcheck
from seaweedfs_tpu.stats import sketch as ref_sketch
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu.trace import tracer as ref_tracer
from seaweedfs_tpu.utils import rwlock as ref_rwlock
from seaweedfs_tpu_torch.cluster.rpc import RpcError
from seaweedfs_tpu_torch.ec import decoder, encoder, integrity, to_ext
from seaweedfs_tpu_torch.events import journal
from seaweedfs_tpu_torch.fault import registry as fault
from seaweedfs_tpu_torch.ops.erasure import new_coder
from seaweedfs_tpu_torch.stats import (contention, flows, hotkeys, metrics,
                                       phases, promcheck, sketch)
from seaweedfs_tpu_torch.trace import tracer
from seaweedfs_tpu_torch.utils import rwlock

pytestmark = pytest.mark.torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests in other files must not lose their cores.
torch.set_num_threads(1)

LARGE, SMALL = 10000, 100  # the Go test's shrunken block sizes


# -- metrics and the exposition checker -------------------------------------

def _drive_registry(m, seed: int) -> str:
    """The same counter, gauge and histogram calls on a fresh Registry."""
    rng = random.Random(seed)
    reg = m.Registry()
    c = reg.counter("SeaweedFS_t_total", "a counter", ("kind",))
    plain = reg.counter("SeaweedFS_t_plain_total", "no labels")
    g = reg.gauge("SeaweedFS_t_gauge", 'a "gauge"\\with escapes', ("node",))
    reg.gauge("SeaweedFS_t_cb", "callback gauge", (), callback=lambda: 42.5)
    h = reg.histogram("SeaweedFS_t_seconds", "a histogram", ("stage",),
                      buckets=m.EC_STAGE_BUCKETS)
    for _ in range(200):
        c.inc(rng.choice([1, 2.5, 1e7]), kind=rng.choice(["a", "b\nc"]))
        g.set(rng.uniform(-5, 5), node=rng.choice(["n1", 'q"x']))
        h.observe(rng.expovariate(10.0), stage=rng.choice(["x", "y"]))
    plain.inc(3)
    g.inc(2.0, node="n1")
    g.dec(1.0, node="n1")
    return reg.expose()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exposition_byte_identical(seed):
    text = _drive_registry(metrics, seed)
    assert text == _drive_registry(ref_metrics, seed)
    assert promcheck.validate_exposition(text) == []


_GOOD = _drive_registry(ref_metrics, 7)
_BROKEN = [
    "",
    "# TYPE x counter\nx 1\nx 2\n",
    "# TYPE x counter\nx{a=\"1\" 2\n",
    "x_total 1\n# TYPE x_total counter\n",
    "# HELP y h\n# TYPE y gauge\ny NaNx\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\n"
    "h_count 1\nh_sum 0.5\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_count 1\nh_sum 1\n",
    "# TYPE z counter\n# TYPE z counter\nz 1\n",
    "bad metric name 1\n",
    _GOOD.replace("# TYPE SeaweedFS_t_gauge gauge\n", ""),
    _GOOD + _GOOD,
]


@pytest.mark.parametrize("text", [_GOOD] + _BROKEN,
                         ids=lambda t: f"len{len(t)}")
def test_validate_exposition_same_verdicts(text):
    assert promcheck.validate_exposition(text) == \
        ref_promcheck.validate_exposition(text)


def test_batch_stage_helpers_match():
    for m in (metrics, ref_metrics):
        assert m.ec_stage_seconds.name == "SeaweedFS_ec_stage_seconds"
    docs = []
    for m in (metrics, ref_metrics):
        stages: dict = {}
        m.observe_batch_stage(stages, "t_obs_stage_a", 0.25, 100)
        m.observe_batch_stage(stages, "t_obs_stage_a", 0.5, 28)
        m.observe_batch_stage(stages, "t_obs_stage_b", 1.0, 0)
        docs.append(m.stage_attrs(stages))
    assert docs[0] == docs[1] == {
        "t_obs_stage_a_seconds": 0.75, "t_obs_stage_a_bytes": 128,
        "t_obs_stage_b_seconds": 1.0, "t_obs_stage_b_bytes": 0}


def test_every_metric_name_matches():
    def names(m):
        return sorted(v.name for v in vars(m).values()
                      if isinstance(v, m._Metric))
    assert names(metrics) == names(ref_metrics)


# -- sketches and heavy hitters ---------------------------------------------

@pytest.mark.parametrize("dist", ["lognormal", "bimodal", "constant"])
def test_quantile_sketch_equal(dist):
    rng = np.random.default_rng(3)
    if dist == "lognormal":
        xs = rng.lognormal(-5, 1.5, 3000)
    elif dist == "bimodal":
        xs = np.concatenate([rng.normal(0.001, 1e-4, 1500),
                             rng.normal(0.2, 0.01, 1500)])
    else:
        xs = np.full(500, 0.0042)
    a, b = sketch.QuantileSketch(), ref_sketch.QuantileSketch()
    for x in xs:
        a.observe(float(x))
        b.observe(float(x))
    qs = [0.0, 0.01, 0.5, 0.9, 0.99, 1.0]
    assert [a.quantile(q) for q in qs] == [b.quantile(q) for q in qs]
    assert a.to_dict() == b.to_dict()
    merged = sketch.QuantileSketch.from_dict(b.to_dict()).merge(a)
    ref_merged = ref_sketch.QuantileSketch.from_dict(a.to_dict()).merge(b)
    assert merged.to_dict() == ref_merged.to_dict()


def test_windowed_sketch_equal_with_injected_clock():
    now = [1000.0]
    a = sketch.WindowedSketch(window=60.0, clock=lambda: now[0])
    b = ref_sketch.WindowedSketch(window=60.0, clock=lambda: now[0])
    rng = random.Random(11)
    seen = []
    for step in range(400):
        now[0] += rng.uniform(0, 1.5)
        x = rng.expovariate(50.0)
        a.observe(x)
        b.observe(x)
        if step % 37 == 0:
            seen.append(([a.quantile(q) for q in (0.5, 0.99)], a.count(),
                         [b.quantile(q) for q in (0.5, 0.99)], b.count()))
    for mine, n_mine, ref, n_ref in seen:
        assert mine == ref and n_mine == n_ref
    assert a.to_dict() == b.to_dict()


def test_space_saving_and_hotkeys_equal():
    rng = np.random.default_rng(5)
    keys = rng.zipf(1.3, 5000) % 400
    a, b = hotkeys.SpaceSaving(32), ref_hotkeys.SpaceSaving(32)
    ta, tb = hotkeys.HotKeyTracker(16), ref_hotkeys.HotKeyTracker(16)
    for i, k in enumerate(keys):
        a.offer(int(k))
        b.offer(int(k))
        op = "read" if i % 3 else "write"
        getattr(ta, op)(int(k) % 7, int(k), f"10.0.0.{k % 5}")
        getattr(tb, op)(int(k) % 7, int(k), f"10.0.0.{k % 5}")
    assert a.top(20) == b.top(20)
    assert [a.count(k) for k in range(50)] == [b.count(k) for k in range(50)]
    snaps = [t.snapshot(8) for t in (ta, tb)]
    for snap in snaps:
        snap.pop("started")
    assert snaps[0] == snaps[1]


def test_phase_ledger_equal():
    assert phases.PHASES == ref_phases.PHASES
    docs = []
    for ph in (phases, ref_phases):
        led = ph.start(queue_seconds=0.002)
        assert led is not None
        ph.note("disk", 0.001)
        ph.note("device", 0.003)
        ph.finish(led)
        d = led.to_dict()
        docs.append(sorted(k for k, v in d.items() if v))
    assert docs[0] == docs[1]


# -- the tracer ---------------------------------------------------------------

@pytest.mark.parametrize("header", [
    "", "garbage", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    " 00-" + "A" * 32 + "-" + "B" * 16 + "-03 ",
    "00-" + "a" * 32 + "-" + "b" * 16,
])
def test_parse_traceparent_equal(header):
    assert tracer.parse_traceparent(header) == \
        ref_tracer.parse_traceparent(header)


def _span_tree(tr):
    """A root span with nested children; returns (name, parent name,
    attrs, status) for every recorded span."""
    tr.BUFFER.clear()
    with tr.root_span("ec.batch_encode", "ec", volumes=3) as root:
        with tr.span("stage.a", bytes=10):
            with tr.span("stage.a.inner", k=1) as inner:
                inner.set(extra="x")
        try:
            with tr.span("stage.b"):
                raise KeyError("boom")
        except KeyError:
            pass
    spans = tr.BUFFER.get(root.trace_id)
    by_id = {s["span_id"]: s["name"] for s in spans}
    assert all(s["trace_id"] == root.trace_id for s in spans)
    return sorted((s["name"], by_id.get(s["parent_id"], ""),
                   sorted(s["attrs"].items()), s["status"], s["kind"],
                   s["service"]) for s in spans)


def test_root_span_trees_equal(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE", "1")
    mine, ref = _span_tree(tracer), _span_tree(ref_tracer)
    assert mine == ref
    assert [s[0] for s in mine] == ["ec.batch_encode", "stage.a",
                                    "stage.a.inner", "stage.b"]
    assert tracer.current_span() is None


def test_span_without_trace_is_noop():
    with tracer.span("free") as sp:
        assert sp is tracer.NOOP


# -- the event journal --------------------------------------------------------

def test_journal_catalog_equal():
    assert journal.TYPES == ref_journal.TYPES
    assert journal.SEVERITIES == ref_journal.SEVERITIES
    assert "ec.repair.local" in journal.TYPES
    assert "device.slow" in journal.TYPES


def _journal_run(jm):
    j = jm.EventJournal(capacity=5)
    errs = []
    for i in range(8):
        j.emit("ec.repair.local", node=f"n{i % 2}",
               severity=("info", "warn")[i % 2], vid=i, codec="lrc")
    for bad in (("no.such.type", "info"), ("ec.repair.local", "fatal")):
        try:
            j.emit(bad[0], severity=bad[1])
        except ValueError as e:
            errs.append(type(e).__name__)
    snap = j.snapshot()
    strip = [(e["type"], e["node"], e["severity"], e["attrs"], e["seq"])
             for e in snap]
    warn = [e["seq"] for e in j.snapshot(severity="warn")]
    tail = [e["seq"] for e in j.snapshot(limit=2)]
    none = j.snapshot(type_="volume.grow")
    return strip, warn, tail, none, j.dropped, j.emitted, errs


def test_journal_ring_filter_seq_and_unknown_types_equal():
    assert _journal_run(journal) == _journal_run(ref_journal)


# -- fault points -------------------------------------------------------------

def test_fault_catalog_equal():
    assert fault.POINTS == ref_fault.POINTS
    assert fault.KINDS == ref_fault.KINDS


@pytest.mark.parametrize("spec", [
    "fail", "fail*2", "delay:0.25", "delay:0.1*3@0.5", "status:503",
    "status:429*1~vid=7", "drop@0.25", "fail~shard=3", "fail@1.0*4",
    # rejected alike
    "explode", "status:200", "fail@0", "fail@1.5", "fail*0", "delay:x",
])
def test_fault_grammar_parsed_alike(spec):
    def parse(reg):
        try:
            s = reg.FaultSpec("volume.corrupt", spec)
        except ValueError as e:
            return ("error", type(e).__name__)
        return (s.kind, s.arg, s.times, s.prob, s.match)
    assert parse(fault) == parse(ref_fault)


def _seeded_hits(reg, n=200):
    reg.disarm_all()
    reg.arm("ec.fetch_shard", "fail@0.3")
    hits = []
    try:
        for i in range(n):
            try:
                reg.hit("ec.fetch_shard", shard=i)
                hits.append(0)
            except reg.FaultInjected:
                hits.append(1)
        return hits, reg.snapshot()
    finally:
        reg.disarm_all()


def test_seeded_probabilistic_hits_equal(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_FAULTS_SEED", "17")
    mine, ref = _seeded_hits(fault), _seeded_hits(ref_fault)
    assert mine == ref
    assert 20 < sum(mine[0]) < 100


def test_status_fault_raises_the_ports_rpc_error():
    fault.arm("volume.read", "status:503*1")
    try:
        with pytest.raises(RpcError) as ei:
            fault.hit("volume.read", vid=1)
        assert ei.value.status == 503
        assert "injected fault at volume.read" in ei.value.message
        fault.hit("volume.read")  # exhausted after one
    finally:
        fault.disarm_all()
    ref_fault.arm("volume.read", "status:503*1")
    try:
        with pytest.raises(Exception) as ref_ei:
            ref_fault.hit("volume.read", vid=1)
        assert ref_ei.value.status == ei.value.status
        assert str(ref_ei.value) == str(ei.value)
    finally:
        ref_fault.disarm_all()


def test_arm_from_env_equal():
    spec = "volume.corrupt=fail*1; ec.scatter=delay:0.01,disk.read=fail@0.5"
    try:
        assert fault.arm_from_env(spec) == ref_fault.arm_from_env(spec)
        assert fault.snapshot() == ref_fault.snapshot()
    finally:
        fault.disarm_all()
        ref_fault.disarm_all()
    for bad in ("nope=fail", "volume.corrupt"):
        with pytest.raises(ValueError):
            fault.arm_from_env(bad)
        with pytest.raises(ValueError):
            ref_fault.arm_from_env(bad)


# -- metered locks -------------------------------------------------------------

def _lock_counts(cm, rwm, name):
    """Uncontended, reentrant and contended acquires of a MeteredLock,
    and metered RWLock writes; returns the counters both keep."""
    lk = cm.MeteredLock(name)
    for _ in range(5):
        with lk:
            pass
    rl = cm.MeteredLock(name + ".r", lock=threading.RLock())
    with rl:
        with rl:
            pass
    held, go = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            go.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5)
    waiter = threading.Thread(target=lambda: lk.acquire() and lk.release())
    waiter.start()
    while not lk._waiters:
        threading.Event().wait(0.001)
    go.set()
    t.join(5)
    waiter.join(5)
    assert not t.is_alive() and not waiter.is_alive()
    rw = rwm.RWLock(name + ".rw")
    for _ in range(3):
        with rw.write():
            pass
        with rw.read():
            pass
    totals = {r["lock"]: (r["acquired"], r["contended"])
              for r in cm.totals() if r["lock"].startswith(name)}
    return totals, lk.contended, rl.acquired


def test_metered_lock_and_rwlock_counts_equal():
    assert contention.ENABLED and ref_contention.ENABLED
    mine = _lock_counts(contention, rwlock, "t.obs.port")
    ref = _lock_counts(ref_contention, ref_rwlock, "t.obs.port")
    assert mine == ref
    assert mine[0]["t.obs.port"] == (7, 1)


def test_ecc_lock_is_metered():
    a = integrity.ecc_lock("/x/1")
    assert isinstance(a, contention.MeteredLock)
    assert a is integrity.ecc_lock("/x/1")
    assert a.name == ref_integrity.ecc_lock("/x/1").name == "integrity.ecc"


# -- wire flows ----------------------------------------------------------------

def test_flow_purposes_equal():
    assert flows.PURPOSES == ref_flows.PURPOSES
    assert flows.DIRECTIONS == ref_flows.DIRECTIONS


@pytest.mark.parametrize("req", [
    ("GET", "/3,01637037d6", "", "", False),
    ("POST", "/3,01637037d6", "", "", False),
    ("HEAD", "/3,01", "ec.gather", "", False),
    ("POST", "/3,01", "not.a.purpose", "", False),
    ("POST", "/3,01", "", "replicate", False),
    ("GET", "/dir/lookup?volumeId=3", "", "", False),
    ("GET", "/metrics", "", "", False),
    ("POST", "/admin/ec/receive", "", "", True),
    ("GET", "/x", "", "", True),
])
def test_flow_resolve_equal(req):
    assert flows.resolve(*req) == ref_flows.resolve(*req)


@pytest.mark.parametrize("spec", ["50MB/s", "512KB", "1.5GB/s", "7", " 3 B ",
                                  "10kb/s"])
def test_parse_rate_equal(spec):
    assert flows.parse_rate(spec) == ref_flows.parse_rate(spec)


@pytest.mark.parametrize("spec", ["", "ec.gather=50MB/s,replicate.fanout=1MB",
                                  "user.read=1GB/s,", "bogus=1MB",
                                  "ec.gather"])
def test_parse_budgets_equal(spec):
    def parse(fm):
        try:
            return fm.parse_budgets(spec)
        except ValueError as e:
            return type(e).__name__
    assert parse(flows) == parse(ref_flows)


def test_flow_ledger_totals_equal():
    def drive(fm):
        led = fm.FlowLedger()
        led.note("ec.gather", "in", 4096, local="a:1", peer="b:2",
                 peer_role="volume")
        led.note("ec.gather", "out", 4096, local="b:2", peer="a:1",
                 peer_role="volume")
        led.note("user.read", "out", 100, local="a:1", peer="c",
                 peer_role="client")
        return led.totals(), led.totals(purpose_="ec.gather",
                                        direction="in")
    assert drive(flows) == drive(ref_flows)


# -- the EC path's hooks -------------------------------------------------------

def _ref_volume(root) -> str:
    rng = random.Random(42)
    os.makedirs(root, exist_ok=True)
    v = Volume(str(root), "", 1)
    for nid in range(1, 121):
        n = RefNeedle(cookie=0x9999 + nid, id=nid,
                      data=bytes(rng.randrange(256)
                                 for _ in range(rng.randrange(1, 800))))
        n.append_at_ns = nid
        v.write_needle(n)
    v.sync()
    base = v.file_name()
    v.close()
    return base


def _clone(base: str, root) -> str:
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(str(root), os.path.basename(base))
    for ext in (".dat", ".idx"):
        shutil.copyfile(base + ext, dst + ext)
    return dst


@pytest.mark.parametrize("spec", ["fail*1", "fail*3~12"])
def test_volume_corrupt_injects_alike(tmp_path, spec):
    """An armed volume.corrupt flips the first byte of a shard write in
    both packages: identical shard files, and `.ecc` sidecars that
    record the intended bytes."""
    base = _ref_volume(tmp_path / "src")
    ref, port = _clone(base, tmp_path / "ref"), _clone(base, tmp_path / "port")
    kw = dict(large_block_size=LARGE, small_block_size=SMALL,
              chunk_size=SMALL)
    ref_encoder.write_sorted_file_from_idx(ref)
    encoder.write_sorted_file_from_idx(port)
    ref_fault.arm("volume.corrupt", spec)
    try:
        ref_encoder.write_ec_files(ref, coder=RefNumpyCoder(), **kw)
    finally:
        ref_fault.disarm_all()
    fault.arm("volume.corrupt", spec)
    try:
        encoder.write_ec_files(port, coder=new_coder(device="cpu"), **kw)
    finally:
        fault.disarm_all()
    corrupt = 0
    for ext in [to_ext(i) for i in range(14)] + [".ecc", ".ecx", ".vif"]:
        assert os.path.exists(ref + ext) == os.path.exists(port + ext), ext
        if os.path.exists(ref + ext):
            with open(ref + ext, "rb") as fa, open(port + ext, "rb") as fb:
                assert fa.read() == fb.read(), ext
    ecc = integrity.ShardChecksums.load(port)
    for sid in range(14):
        corrupt += ecc.get(sid) != integrity.file_block_crcs(port + to_ext(sid))
    assert corrupt == 1


def test_dat_rebuild_span_and_stage(tmp_path, monkeypatch):
    """write_dat_file reports the `dat_rebuild` stage and opens the
    `ec.dat_rebuild` span under an active trace, as the reference does,
    and writes the same `.dat`."""
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE", "1")
    base = _ref_volume(tmp_path / "src")
    ref, port = _clone(base, tmp_path / "ref"), _clone(base, tmp_path / "port")
    encoder.write_sorted_file_from_idx(port)
    encoder.write_ec_files(port, coder=new_coder(device="cpu"),
                           large_block_size=LARGE, small_block_size=SMALL,
                           chunk_size=SMALL)
    size = decoder.find_dat_file_size(port)
    os.rename(port + ".dat", port + ".orig")
    for ext in [to_ext(i) for i in range(10)] + [".ecx"]:
        shutil.copyfile(port + ext, ref + ext)
    docs = []
    for dec, tr, m, b in ((decoder, tracer, metrics, port),
                          (ref_decoder, ref_tracer, ref_metrics, ref)):
        before = m.ec_stage_bytes.value(stage="dat_rebuild")
        tr.BUFFER.clear()
        with tr.root_span("ec.to_volume", "ec") as root:
            dec.write_dat_file(b, size, LARGE, SMALL)
        docs.append((sorted((s["name"], s["attrs"])
                            for s in tr.BUFFER.get(root.trace_id)
                            if s["name"] == "ec.dat_rebuild"),
                     m.ec_stage_bytes.value(stage="dat_rebuild") - before))
    assert docs[0] == docs[1] == ([("ec.dat_rebuild", {"bytes": size})], size)
    with open(ref + ".dat", "rb") as a, open(port + ".dat", "rb") as b:
        assert a.read() == b.read()
    with open(port + ".dat", "rb") as a, open(port + ".orig", "rb") as b:
        assert a.read() == b.read()[:size]
