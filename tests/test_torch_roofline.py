"""The port's roofline plane held against seaweedfs_tpu's.

The catalog, the cost model and the GF(2) work counts must be the
reference's; the ledger must keep the same rows, tables, occupancy docs
and `device.slow` events for the same calls; and the EC path must record
the same work: `write_ec_files` -> `rebuild_ec_files` -> `EcVolume`
reads through both packages (the reference's Pallas kernels in
interpret mode, the port's plain versions on the CPU) leave the same
multiset of (kernel, codec, geometry, bytes, macs, measured_bytes) rows
and move the same stage and repair-read counters.  Only `seconds`,
`achieved` and `dtype` differ by design (device time of a CUDA event
pair; the port's kernels read against the int8 roof).
"""

from __future__ import annotations

import collections
import json
import os
import random
import shutil
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu import codecs as ref_codecs
from seaweedfs_tpu.core.needle import Needle as RefNeedle
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.volume import EcVolume as RefEcVolume
from seaweedfs_tpu.events.journal import JOURNAL as REF_JOURNAL
from seaweedfs_tpu.ops.coder_pallas import PallasCoder
from seaweedfs_tpu.parallel.stream_pipeline import \
    PipelineRecorder as RefRecorder
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.stats import roofline as ref_roofline
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch import codecs
from seaweedfs_tpu_torch.core.needle import Needle
from seaweedfs_tpu_torch.ec import encoder, to_ext
from seaweedfs_tpu_torch.ec.volume import EcVolume
from seaweedfs_tpu_torch.events.journal import JOURNAL
from seaweedfs_tpu_torch.ops import coder_cuda
from seaweedfs_tpu_torch.ops.coder_cuda import CudaCoder
from seaweedfs_tpu_torch.parallel import sharded_codec
from seaweedfs_tpu_torch.parallel.cluster_encode import batch_encode_files
from seaweedfs_tpu_torch.parallel.cluster_rebuild import batch_rebuild_files
from seaweedfs_tpu_torch.parallel.mesh import make_mesh
from seaweedfs_tpu_torch.parallel.stream_pipeline import PipelineRecorder
from seaweedfs_tpu_torch.stats import metrics, roofline
from seaweedfs_tpu_torch.storage.dat_writer import DatWriter

pytestmark = pytest.mark.torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-sensitive tests in other files must not lose their cores.
torch.set_num_threads(1)

LARGE, SMALL = 10000, 100  # the Go test's shrunken block sizes
CHUNK = 1000               # ten small rows per coder call

FAKE_PEAKS = {"version": 2, "backend": "fake", "device_kind": "fake",
              "matmul_flops": {"int8": 1e9, "bf16": 1e9, "f32": 1e9},
              "membw_bps": 1e8, "h2d_bps": 1e9, "d2h_bps": 1e9,
              "host_stream_bps": 1e9, "probe_seconds": 0.0}


@pytest.fixture
def fake_peaks(monkeypatch):
    """The same fixed peaks in both packages: achieved fractions become
    exact algebra instead of measurements."""
    monkeypatch.setattr(roofline, "probe_peaks",
                        lambda device=None, force=False: dict(FAKE_PEAKS))
    monkeypatch.setattr(roofline, "known_peaks",
                        lambda device=None: dict(FAKE_PEAKS))
    monkeypatch.setattr(ref_roofline, "_peaks", dict(FAKE_PEAKS))


@pytest.fixture
def ledgers(fake_peaks):
    """Both process ledgers armed and empty, and emptied again after."""
    for r in (roofline, ref_roofline):
        r.LEDGER.reset()
        r.set_armed(True)
    yield
    for r in (roofline, ref_roofline):
        r.LEDGER.reset()
        r.set_armed(True)


# -- catalog, cost model, GF(2) work -----------------------------------------

def test_catalog_equal():
    assert set(roofline.KERNELS) == set(ref_roofline.KERNELS)
    assert all(roofline.KERNELS.values())
    assert roofline.PIPELINE_STAGES == ref_roofline.PIPELINE_STAGES
    for k in roofline.KERNELS:
        assert roofline.validate(k) == k
    for bad in ("encode", "", "ENCODE_KERNEL", "matmul"):
        with pytest.raises(ValueError):
            roofline.validate(bad)
    with pytest.raises(ValueError):
        roofline.RooflineLedger().record("matmul", "rs", "int8", out_rows=4,
                                         in_rows=10, n=64, seconds=0.1)


@pytest.mark.parametrize("geom", [(4, 10, 4096, 1), (1, 10, 1 << 20, 1),
                                  (1, 5, 777, 1), (4, 10, 4 << 20, 4),
                                  (4, 10, 0, 1), (3, 12, 65536, 2)])
@pytest.mark.parametrize("crc", [False, True])
def test_cost_model_and_geometry_equal(geom, crc):
    out_rows, in_rows, n, batch = geom
    assert roofline.cost_model(out_rows, in_rows, n, batch=batch, crc=crc) \
        == ref_roofline.cost_model(out_rows, in_rows, n, batch=batch, crc=crc)
    assert roofline.geometry_key(out_rows, in_rows, n, batch) == \
        ref_roofline.geometry_key(out_rows, in_rows, n, batch)


def _decode_cases(name: str, seed: int = 0, count: int = 6):
    codec = codecs.get_codec(name)
    rng = random.Random(f"{name}:{seed}")
    out = []
    while len(out) < count:
        lost = tuple(sorted(rng.sample(range(codec.total_shards),
                                       rng.randint(1, codec.parity_shards))))
        present = tuple(s for s in range(codec.total_shards)
                        if s not in lost)
        try:
            codec.repair_plan(present, list(lost))
        except ValueError:
            continue
        out.append((present, lost))
    return out


@pytest.mark.parametrize("name", ["rs", "lrc"])
def test_gf2_work_equal_over_codec_matrices(name):
    mine, ref = codecs.get_codec(name), ref_codecs.get_codec(name)
    pb, ref_pb = mine.parity_bitmatrix(), ref.parity_bitmatrix()
    assert roofline.dense_gf2_work(pb) == ref_roofline.dense_gf2_work(ref_pb)
    assert roofline.effective_gf2_work(pb) == \
        ref_roofline.effective_gf2_work(ref_pb)
    assert 0 < roofline.effective_gf2_work(pb) < roofline.dense_gf2_work(pb)
    for present, lost in _decode_cases(name):
        bm, used = mine.decode_bitmatrix(present, lost)
        ref_bm, ref_used = ref.decode_bitmatrix(present, lost)
        assert tuple(used) == tuple(ref_used)
        assert roofline.dense_gf2_work(bm) == \
            ref_roofline.dense_gf2_work(ref_bm)
        assert roofline.effective_gf2_work(bm) == \
            ref_roofline.effective_gf2_work(ref_bm)


def test_gf2_work_hand_case():
    m = np.array([[1, 1, 1, 0], [1, 1, 0, 1]], np.uint8)
    assert roofline.dense_gf2_work(m) == 4
    assert roofline.effective_gf2_work(m) == 3
    assert roofline.dense_gf2_work(np.eye(4, dtype=np.uint8)) == 0


def test_roofline_floor_equal():
    for args in ((2e9, 1e6, FAKE_PEAKS, "int8"), (1e6, 1e9, FAKE_PEAKS, "bf16"),
                 (1e6, 1e6, FAKE_PEAKS, "fp4"),
                 (1e6, 1e6, {"matmul_flops": {}, "membw_bps": 0.0}, "int8")):
        assert roofline.roofline_floor_seconds(*args) == \
            ref_roofline.roofline_floor_seconds(*args)


# -- the ledger ----------------------------------------------------------------

def _drive_ledger(r, clock, calls):
    led = r.RooflineLedger(clock=clock[0])
    rows = [led.record(*c[0], **c[1]) for c in calls]
    return (rows, led.kernel_table(), led.conservation(), led.recent(5),
            led.occupancy_summary())


def test_ledger_rows_tables_and_conservation_equal(fake_peaks):
    rng = random.Random(4)
    calls = []
    for i in range(300):
        kernel = rng.choice(sorted(roofline.KERNELS))
        out_rows, in_rows = rng.choice([(4, 10), (1, 10), (1, 5)])
        n = rng.choice([4096, 1 << 20, 123])
        batch = rng.choice([1, 1, 3]) if kernel.startswith("batch") else 1
        cost = roofline.cost_model(out_rows, in_rows, n, batch=batch)
        measured = cost["bytes"] * (2 if i == 250 else 1)
        calls.append(((kernel, rng.choice(["rs", "lrc"]), "int8"),
                      dict(out_rows=out_rows, in_rows=in_rows, n=n,
                           batch=batch, crc=kernel == "encode_crc_kernel",
                           seconds=rng.uniform(1e-6, 1e-2),
                           measured_bytes=measured)))

    def run(r):
        t = [0.0]

        def clock():
            t[0] += 0.01
            return t[0]
        return _drive_ledger(r, [clock], calls)

    mine, ref = run(roofline), run(ref_roofline)
    assert mine == ref
    cons = mine[2]
    assert not cons["ok"] and cons["violations"][0]["analytic"] * 2 == \
        cons["violations"][0]["measured"]
    assert cons["checked"] == roofline._RING_MAX == ref_roofline._RING_MAX
    assert sum(row["count"] for row in mine[1]) == 300


def _recorders(rec_cls):
    bad = rec_cls()
    bad.note_span("stack", 0, 0.0, 1.0)
    bad.note_span("dispatch", 0, 1.0, 9.0)
    bad.note_span("device", 0, 9.0, 10.0)      # 10 % busy
    good = rec_cls()
    good.note_span("stack", 0, 0.0, 0.5)
    good.note_span("device", 0, 0.5, 9.5)
    good.note_span("drain", 0, 9.5, 10.0)      # 90 % busy
    return bad, good


def test_note_pipeline_docs_and_device_slow_equal(fake_peaks):
    def run(r, rec_cls, journal):
        now = [100.0]
        led = r.RooflineLedger(clock=lambda: now[0])
        bad, good = _recorders(rec_cls)
        seq0 = journal._seq
        docs = []
        for step in range(7):
            if step == 5:
                now[0] += r._EMIT_EVERY + 1.0
            docs.append(led.note_pipeline("encode", good if step == 6 else bad,
                                          node="t:0"))
        docs.append(led.note_pipeline("rebuild", bad))
        events = [(e["severity"], e["attrs"])
                  for e in journal.snapshot(type_="device.slow")
                  if e["seq"] > seq0]
        return (docs, led.pipelines(16), led.occupancy_summary(), events,
                r.device_occupancy.value(stage="device"))

    mine = run(roofline, PipelineRecorder, JOURNAL)
    ref = run(ref_roofline, RefRecorder, REF_JOURNAL)
    assert mine == ref
    events = mine[3]
    assert len(events) == 2
    assert events[0][0] == "warn"
    assert events[0][1]["starving_stage"] == "dispatch"
    assert events[0][1]["occupancy"] == pytest.approx(0.1)


def test_debug_doc_shape_equal(fake_peaks):
    mine = roofline.debug_doc("n:1", "volume")
    ref = ref_roofline.debug_doc("n:1", "volume")
    assert set(mine) == set(ref)
    assert set(mine["peaks"]) == set(ref["peaks"])
    assert mine["devices"] == []


# -- peak probing ---------------------------------------------------------------

def test_probe_peaks_cpu_and_disk_cache(tmp_path, monkeypatch):
    """A CPU probe writes the cache under the device kind; a process
    'restart' (memo cleared) reads it back — a tampered value coming
    back proves no re-measurement — and force re-probes."""
    monkeypatch.setenv("SEAWEEDFS_TPU_ROOFLINE_CACHE", str(tmp_path))
    monkeypatch.setitem(roofline.PROBE_SIZES, "cpu",
                        {"m": 64, "membw_bytes": 1 << 16,
                         "copy_bytes": 1 << 16, "reps": 2})
    monkeypatch.setattr(roofline, "_peaks", {})
    doc = roofline.probe_peaks("cpu", force=True)
    assert set(doc) == set(FAKE_PEAKS)
    assert doc["backend"] == "cpu" and "error" not in doc
    assert doc["matmul_flops"]["int8"] > 0 and doc["matmul_flops"]["bf16"] > 0
    assert min(doc["membw_bps"], doc["h2d_bps"], doc["d2h_bps"],
               doc["host_stream_bps"]) > 0
    path = roofline._cache_path("cpu", doc["device_kind"])
    assert os.path.dirname(path) == str(tmp_path)
    with open(path, encoding="utf-8") as f:
        on_disk = json.load(f)
    on_disk["membw_bps"] = 123456.0
    with open(path, "w", encoding="utf-8") as f:
        json.dump(on_disk, f)
    monkeypatch.setattr(roofline, "_peaks", {})
    assert roofline.probe_peaks("cpu")["membw_bps"] == 123456.0
    assert roofline.probe_peaks(torch.device("cpu"))["membw_bps"] == 123456.0
    assert roofline.probe_peaks("cpu", force=True)["membw_bps"] != 123456.0


def test_failed_probe_degrades_and_is_not_cached(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_ROOFLINE_CACHE", str(tmp_path))
    monkeypatch.setattr(roofline, "_peaks", {})

    def broken(*a, **k):
        raise RuntimeError("no matmul here")

    monkeypatch.setattr(roofline, "_probe_matmul", broken)
    doc = roofline.probe_peaks("cpu", force=True)
    assert doc["error"] == "RuntimeError: no matmul here"
    assert roofline.roofline_floor_seconds(1.0, 1.0, doc, "int8") is None
    assert os.listdir(tmp_path) == []
    assert roofline.probe_peaks("not-a-device")["backend"] == "none"


def test_record_never_probes(tmp_path, monkeypatch):
    """The ledger reads the roof from peaks in hand and never measures:
    without them `achieved` is None; the disk cache is looked for once;
    once probe_peaks has run, rows carry `achieved`."""
    monkeypatch.setenv("SEAWEEDFS_TPU_ROOFLINE_CACHE", str(tmp_path))
    monkeypatch.setattr(roofline, "_peaks", {})
    monkeypatch.setattr(roofline, "_uncached", set())
    real = roofline._probe_matmul
    monkeypatch.setattr(roofline, "_probe_matmul", lambda *a, **k: pytest.fail(
        "record probed the device"))
    led = roofline.RooflineLedger()
    kw = dict(out_rows=4, in_rows=10, n=4096, seconds=1e-3, device="cpu")
    assert led.record("encode_kernel", "rs", "int8", **kw)["achieved"] is None
    assert roofline.known_peaks("cpu") is None
    assert len(roofline._uncached) == 1
    # A cache written by another process is not looked for again ...
    key = next(iter(roofline._uncached))
    with open(roofline._cache_path(*key), "w", encoding="utf-8") as f:
        json.dump(FAKE_PEAKS, f)
    assert roofline.known_peaks("cpu") is None
    # ... until probe_peaks runs, which reads it (no measurement either).
    assert roofline.probe_peaks("cpu") == FAKE_PEAKS
    assert roofline.known_peaks("cpu") == FAKE_PEAKS
    row = led.record("encode_kernel", "rs", "int8", **kw)
    assert row["achieved"] == round(min(roofline.roofline_floor_seconds(
        row["macs"] * 2, row["bytes"], FAKE_PEAKS, "int8") / 1e-3, 1.0), 6)
    # A fresh process finds the cache on its first record.
    monkeypatch.setattr(roofline, "_peaks", {})
    monkeypatch.setattr(roofline, "_uncached", set())
    assert led.record("encode_kernel", "rs", "int8", **kw)["achieved"] \
        == row["achieved"]
    monkeypatch.setattr(roofline, "_probe_matmul", real)


def test_default_cache_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("SEAWEEDFS_TPU_ROOFLINE_CACHE", raising=False)
    assert roofline._cache_dir().endswith(
        os.path.join(".cache", "seaweedfs_tpu_torch"))
    assert roofline._cache_dir() != ref_roofline._cache_dir()


# -- timing without a synchronisation ------------------------------------------

class _FakeTimer:
    """Stands in for a card's KernelTimer: its seconds appear only once
    its 'end event' has completed."""

    def __init__(self):
        self.done = False

    def seconds(self):
        return 0.25 if self.done else None


def test_pending_launches_settle_once_complete():
    pend = roofline._Pending()
    got = []
    timers = [_FakeTimer() for _ in range(3)]
    for i, t in enumerate(timers):
        pend.add(t, lambda s, i=i: got.append((i, s)))
    pend.add(_FakeTimer(), lambda s: 1 / 0)
    pend.settle()
    assert got == []
    timers[1].done = True
    pend.settle()
    assert got == [(1, 0.25)]
    for t in timers:
        t.done = True
    pend._items[-1][0].done = True
    pend.settle()                      # a failing callback is swallowed
    assert sorted(got) == [(0, 0.25), (1, 0.25), (2, 0.25)]
    pend.settle()
    assert len(got) == 3 and pend._items == []


def test_ledger_reset_drops_unsettled_launches(fake_peaks):
    roofline._PENDING.add(_FakeTimer(), lambda s: pytest.fail("settled"))
    roofline.LEDGER.reset()
    assert roofline._PENDING._items == []


class _FakeEvent:
    """Stands in for a CUDA timing event: complete once `done`."""

    def __init__(self, at_ms):
        self.at_ms, self.done = at_ms, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.at_ms - self.at_ms


def test_card_timer_reads_pooled_events_once_complete(monkeypatch):
    """On a card the launcher records the timer's pooled pair; seconds
    appear once the end event has completed, and reading them gives the
    pair back for the next launch."""
    made = []

    def new_pair(device):
        made.append((_FakeEvent(1.0), _FakeEvent(1.25)))
        return made[-1]

    pool = roofline._EventPool()
    monkeypatch.setattr(pool, "_new_pair", new_pair)
    monkeypatch.setattr(roofline, "_EVENTS", pool)
    card = torch.device("cuda", 0)
    t = roofline.KernelTimer(card)
    start, end = t.events()
    assert t.seconds() is None
    t2 = roofline.KernelTimer(card)
    assert t2.events() is not (start, end) and len(made) == 2
    end.done = True
    assert t.seconds() == pytest.approx(0.25e-3)
    assert roofline.KernelTimer(card).events() == (start, end)
    assert len(made) == 2


def test_cpu_timer_reports_at_once():
    t = roofline.KernelTimer(torch.device("cpu"))
    t.start()
    time.sleep(0.01)
    t.end()
    got = []
    t.then(got.append)
    assert got and got[0] >= 0.01 and t.seconds() == got[0]


# -- the EC path end to end, both packages ---------------------------------------

def _ref_volume(root) -> tuple[str, dict]:
    rng = random.Random(42)
    os.makedirs(root, exist_ok=True)
    v = Volume(str(root), "", 1)
    payloads = {}
    for nid in range(1, 121):
        payloads[nid] = bytes(rng.randrange(256)
                              for _ in range(rng.randrange(1, 800)))
        n = RefNeedle(cookie=0x9999 + nid, id=nid, data=payloads[nid])
        n.append_at_ns = nid
        v.write_needle(n)
    v.sync()
    base = v.file_name()
    v.close()
    return base, payloads


def _clone(base: str, root) -> str:
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(str(root), os.path.basename(base))
    for ext in (".dat", ".idx"):
        shutil.copyfile(base + ext, dst + ext)
    return dst


_STAGES = ("encode_kernel", "encode_crc_kernel", "reconstruct_kernel")


def _counters(m) -> dict:
    out = {}
    for stage in _STAGES:
        out[f"bytes/{stage}"] = m.ec_stage_bytes.value(stage=stage)
        out[f"count/{stage}"] = m.ec_stage_seconds.count(stage=stage)
    for codec in ("rs", "lrc"):
        out[f"repair/{codec}"] = \
            m.ec_repair_read_bytes_total.value(codec=codec)
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _drive_ec(enc, vol_cls, coder_fn, base, payloads, ids):
    enc.write_sorted_file_from_idx(base)
    enc.write_ec_files(base, coder=coder_fn(), large_block_size=LARGE,
                       small_block_size=SMALL, chunk_size=CHUNK)
    for sid in (1, 3, 9, 12):
        os.remove(base + to_ext(sid))
    assert enc.rebuild_ec_files(base, coder=coder_fn()) == [1, 3, 9, 12]
    for sid in (0, 4, 8, 13):
        os.remove(base + to_ext(sid))
    vol = vol_cls(base, coder=coder_fn(), large_block_size=LARGE,
                  small_block_size=SMALL)
    try:
        for nid in ids:
            assert vol.read_needle(nid).data == payloads[nid]
    finally:
        vol.close()


def _rows(r) -> collections.Counter:
    return collections.Counter(
        (row["kernel"], row["codec"], row["geometry"], row["bytes"],
         row["macs"], row["measured_bytes"]) for row in r.LEDGER.recent(256))


def test_ec_path_records_the_same_work(ledgers, tmp_path):
    base, payloads = _ref_volume(tmp_path / "src")
    ids = random.Random(7).sample(sorted(payloads), 20)
    before = (_counters(metrics), _counters(ref_metrics))
    _drive_ec(encoder, EcVolume, lambda: CudaCoder(device="cpu"),
              _clone(base, tmp_path / "port"), payloads, ids)
    _drive_ec(ref_encoder, RefEcVolume, lambda: PallasCoder(interpret=True),
              _clone(base, tmp_path / "ref"), payloads, ids)
    mine, ref = _rows(roofline), _rows(ref_roofline)
    assert mine == ref
    kinds = {k[0] for k in mine}
    assert kinds == {"encode_kernel", "reconstruct_kernel"}
    assert sum(mine.values()) < roofline._RING_MAX
    assert _delta(_counters(metrics), before[0]) == \
        _delta(_counters(ref_metrics), before[1])
    assert roofline.LEDGER.conservation()["ok"]
    assert ref_roofline.LEDGER.conservation()["ok"]
    assert {r["dtype"] for r in roofline.LEDGER.recent(256)} == {"int8"}
    assert all(0 < r["seconds"] and 0 < r["achieved"] <= 1.0
               for r in roofline.LEDGER.recent(256))


def test_fused_encode_records_encode_crc_kernel(ledgers, monkeypatch):
    """The fused encode (K2) records `encode_crc_kernel` at the caller's
    width, as PallasCoder.encode_with_crc does."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", "1")
    data = np.random.default_rng(1).integers(0, 256, (10, 5000), np.uint8)
    CudaCoder(device="cpu").encode_with_crc(data)
    PallasCoder(interpret=True).encode_with_crc(data)
    assert _rows(roofline) == _rows(ref_roofline)
    (row,) = roofline.LEDGER.recent()
    assert row["kernel"] == "encode_crc_kernel"
    assert row["geometry"] == "4x10x5000"


@pytest.mark.parametrize("call", ["encode_all", "verify"])
def test_encode_all_and_verify_record_like_reference(ledgers, call):
    data = np.random.default_rng(2).integers(0, 256, (10, 3000), np.uint8)
    if call == "verify":
        full = CudaCoder(device="cpu").encode_all(data)
        roofline.LEDGER.reset()
        args = (full.numpy(),)
    else:
        args = (data,)
    getattr(CudaCoder(device="cpu"), call)(*args)
    getattr(PallasCoder(interpret=True), call)(*args)
    assert _rows(roofline) == _rows(ref_roofline)


# -- the batched path --------------------------------------------------------------

def _write_port_volume(base: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with DatWriter(base) as w:
        for i in range(1, 40):
            w.write_needle(Needle(cookie=i, id=i,
                                  data=rng.bytes(int(rng.integers(1, 3000)))))


@pytest.mark.parametrize("fused", ["0", "1"])
def test_batched_rows_follow_the_cost_model(ledgers, tmp_path, monkeypatch,
                                            fused):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", fused)
    mesh = make_mesh(devices=[torch.device("cpu")])
    bases = [str(tmp_path / str(i)) for i in (1, 2)]
    for i, b in enumerate(bases):
        _write_port_volume(b, i)
    batch_encode_files(bases, mesh)
    shard_bytes = [os.path.getsize(b + to_ext(0)) for b in bases]
    for b in bases:
        os.remove(b + to_ext(2))
    batch_rebuild_files(bases, mesh)
    rows = roofline.LEDGER.recent(256)
    assert {r["kernel"] for r in rows} == {"batch_encode",
                                           "batch_reconstruct"}
    covered = collections.Counter()
    for r in rows:
        out_rows, in_rows, rest = r["geometry"].split("x")
        n, _, batch = rest.partition("b")
        cost = roofline.cost_model(int(out_rows), int(in_rows), int(n),
                                   batch=int(batch or 1),
                                   crc=fused == "1")
        assert (r["bytes"], r["macs"]) == (cost["bytes"], cost["macs"])
        assert r["measured_bytes"] == cost["bytes"]
        assert r["seconds"] > 0
        covered[r["kernel"]] += int(n) * int(batch or 1)
    assert roofline.LEDGER.conservation()["ok"]
    # Each step's stacked width covers every volume's shard columns.
    assert covered["batch_encode"] >= sum(shard_bytes)
    assert covered["batch_reconstruct"] >= sum(shard_bytes)
    kinds = [d["kind"] for d in roofline.LEDGER.pipelines(16)]
    assert kinds == ["encode", "rebuild"]
    for doc in roofline.LEDGER.pipelines(16):
        assert doc["occupancy"]["fraction"] is not None
        assert "starving_stage" in doc["bubbles"]


def test_lrc_local_repair_emits_the_reference_event(ledgers, tmp_path):
    mesh = make_mesh(devices=[torch.device("cpu")])
    base = str(tmp_path / "8")
    _write_port_volume(base, 3)
    batch_encode_files([base], mesh, codec="lrc")
    os.remove(base + to_ext(3))
    seq0 = JOURNAL._seq
    before = metrics.ec_repair_read_bytes_total.value(codec="lrc")
    msgs = batch_rebuild_files([base], mesh)
    assert "read 5 shards" in msgs[0]
    shard = os.path.getsize(base + to_ext(0))
    events = [e for e in JOURNAL.snapshot(type_="ec.repair.local")
              if e["seq"] > seq0]
    assert [e["attrs"] for e in events] == [
        {"vid": base, "codec": "lrc", "shard": [3], "reads": 5,
         "bytes": 5 * shard}]
    assert metrics.ec_repair_read_bytes_total.value(codec="lrc") - before \
        == 5 * shard
    (row,) = [r for r in roofline.LEDGER.recent()
              if r["kernel"] == "batch_reconstruct"]
    assert row["geometry"].startswith("1x5x")


def test_rs_rebuild_emits_no_local_repair_event(ledgers, tmp_path):
    mesh = make_mesh(devices=[torch.device("cpu")])
    base = str(tmp_path / "9")
    _write_port_volume(base, 4)
    batch_encode_files([base], mesh)
    os.remove(base + to_ext(3))
    seq0 = JOURNAL._seq
    batch_rebuild_files([base], mesh)
    assert not [e for e in JOURNAL.snapshot(type_="ec.repair.local")
                if e["seq"] > seq0]


# -- switches ---------------------------------------------------------------------

def test_disarmed_call_sites_are_one_flag_check(monkeypatch, tmp_path):
    """roofline disarmed: a booby-trapped record hook proves the
    accounting is never reached, single-volume or batched, and the
    kernels still run; the batched steps make no timer and the
    pipelines no recorder."""
    def boom(*a, **k):
        raise AssertionError("roofline hook reached while disarmed")

    monkeypatch.setattr(coder_cuda, "_record_roofline", boom)
    monkeypatch.setattr(roofline.RooflineLedger, "record", boom)
    monkeypatch.setattr(roofline.RooflineLedger, "note_pipeline", boom)
    roofline.set_armed(False)
    try:
        coder = CudaCoder(device="cpu")
        data = np.ones((10, 1024), np.uint8)
        assert coder.encode(data).shape == (4, 1024)
        coder.encode_with_crc(data)
        coder.reconstruct({i: data[0] for i in range(1, 11)}, wanted=[0])
        # The batched steps time their launches for the ledger only.
        monkeypatch.setattr(roofline, "KernelTimer", boom)
        monkeypatch.setattr(sharded_codec, "record_fenced_batch", boom)
        mesh = make_mesh(devices=[torch.device("cpu")])
        base = str(tmp_path / "5")
        _write_port_volume(base, 5)
        batch_encode_files([base], mesh)
        os.remove(base + to_ext(1))
        batch_rebuild_files([base], mesh)
    finally:
        roofline.set_armed(True)


def test_ec_prof_off_skips_timing(ledgers, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_PROF", "0")
    before = metrics.ec_stage_seconds.count(stage="encode_kernel")
    CudaCoder(device="cpu").encode(np.ones((10, 64), np.uint8))
    assert metrics.ec_stage_seconds.count(stage="encode_kernel") == before
    assert roofline.LEDGER.recent() == []


def test_slow_plain_kernel_shows_in_seconds(ledgers, monkeypatch):
    """A plain version that takes 50 ms more must show in the recorded
    seconds: the timer brackets the kernel call, not its dispatch."""
    real = coder_cuda.apply_bitmatrix_torch

    def slow(masks, shards):
        time.sleep(0.05)
        return real(masks, shards)

    monkeypatch.setattr(coder_cuda, "apply_bitmatrix_torch", slow)
    CudaCoder(device="cpu").encode(np.ones((10, 1024), np.uint8))
    rows = [r for r in roofline.LEDGER.recent()
            if r["kernel"] == "encode_kernel"]
    assert rows and rows[-1]["seconds"] >= 0.05


def test_observe_ec_stage_counts_zero_bytes():
    stage = "t_torch_zero_byte_stage"
    assert f'stage="{stage}"' not in "\n".join(metrics.ec_stage_bytes.expose())
    metrics.observe_ec_stage(stage, 0.001, 0)
    assert f'stage="{stage}"' in "\n".join(metrics.ec_stage_bytes.expose())
    metrics.observe_ec_stage(stage, 0.001, 7)
    assert metrics.ec_stage_bytes.value(stage=stage) == 7.0
