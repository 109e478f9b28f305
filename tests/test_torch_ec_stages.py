"""The port's EC file pipeline observes its own stages.

One `write_sorted_file_from_idx` + `write_ec_files(device="cpu")` call
on a small volume: at the shrunken block sizes (large and small rows,
the CPU byte accumulators) and at the default sizes with fused CRC
(small rows, the kernel's CRC partials).  Each stage's bytes are exact
(`encode_read` = `encode_submit` = 10 shards, `encode_write` = 14,
`encode_fetch` = 4, the waits `encode_read_wait`, `encode_ring_wait`
and `encode_write_drain` 0), the main thread's stages fit in the call's
wall time and so does the shard writer's `encode_write`, the spans of
one encode share a trace id, the stages' profiler ranges carry their
thread (read-ahead, writer and main thread apart) and the spans' clock,
and without a profiler no range is entered.
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from seaweedfs_tpu_torch.core.needle import Needle
from seaweedfs_tpu_torch.ec import encoder, to_ext
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.storage.dat_writer import DatWriter
from seaweedfs_tpu_torch.trace import root_span, tracer

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

MIB = 1024 * 1024
PIPELINE = ("encode_read", "encode_read_wait", "encode_submit",
            "encode_write", "encode_fetch", "encode_ring_wait",
            "encode_write_drain")
STAGES = PIPELINE + ("encode_index",)
MAIN_THREAD = ("encode_read_wait", "encode_submit", "encode_fetch",
               "encode_write_drain", "encode_index")
# (large block, small block, chunk, needle bytes, fused CRC): shrunken
# blocks give two large rows and a tail of small rows; the default ones
# small rows only, with the CRC fused into the encode.
GEOMETRIES = {
    "shrunken": (10000, 100, 1000, 260_000, "0"),
    "fused": (1024 * MIB, MIB, 4 * MIB, 2 * MIB, "1"),
}


def _volume(tmp_path, needle_bytes: int) -> str:
    base = str(tmp_path / "1")
    rng = random.Random(11)
    with DatWriter(base) as w:
        i, left = 1, needle_bytes
        while left > 0:
            n = min(left, rng.randrange(1, 40_000))
            w.write_needle(Needle(cookie=i, id=i, data=rng.randbytes(n)))
            left -= n
            i += 1
    return base


def _stage_totals() -> dict:
    """(seconds, bytes) of each stage as /metrics exposes them."""
    lines = dict(line.rsplit(" ", 1)
                 for m in (metrics.ec_stage_seconds, metrics.ec_stage_bytes)
                 for line in m.expose() if not line.startswith("#"))
    return {s: tuple(float(lines.get(f'{name}{{stage="{s}"}}', 0.0))
                     for name in ("SeaweedFS_ec_stage_seconds_sum",
                                  "SeaweedFS_ec_stage_bytes_total"))
            for s in STAGES}


def _encode(base: str, geometry: str, monkeypatch) -> float:
    large, small, chunk, _, fused = GEOMETRIES[geometry]
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_FUSED_CRC", fused)
    t0 = time.perf_counter()
    encoder.write_sorted_file_from_idx(base)
    encoder.write_ec_files(base, device="cpu", large_block_size=large,
                           small_block_size=small, chunk_size=chunk)
    return time.perf_counter() - t0


@pytest.fixture(params=sorted(GEOMETRIES))
def volume(request, tmp_path):
    return request.param, _volume(tmp_path, GEOMETRIES[request.param][3])


def test_stage_bytes_are_exact_and_fit_the_call(volume, monkeypatch):
    geometry, base = volume
    before = _stage_totals()
    wall = _encode(base, geometry, monkeypatch)
    after = _stage_totals()
    seconds = {s: after[s][0] - before[s][0] for s in STAGES}
    nbytes = {s: after[s][1] - before[s][1] for s in STAGES}
    shard = os.path.getsize(base + to_ext(0))
    assert all(os.path.getsize(base + to_ext(i)) == shard
               for i in range(14))
    assert nbytes == {"encode_read": 10 * shard, "encode_read_wait": 0,
                      "encode_submit": 10 * shard,
                      "encode_write": 14 * shard,
                      "encode_fetch": 4 * shard,
                      "encode_ring_wait": 0, "encode_write_drain": 0,
                      "encode_index": os.path.getsize(base + ".idx")}
    assert all(seconds[s] > 0 for s in STAGES)
    assert sum(seconds[s] for s in MAIN_THREAD) <= wall
    # The shard writes run on their own thread, inside the call.
    assert seconds["encode_write"] <= wall


def test_spans_of_one_encode_share_a_trace_id(volume, monkeypatch):
    """Inside a request's span (as /admin/ec/generate runs it), the sort
    and the encode are children of the request; the encode's pipeline
    and sidecars are children of `ec.encode`, the pipeline carrying
    its stages' totals."""
    geometry, base = volume
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE", "1")
    tracer.BUFFER.clear()
    with root_span("POST /admin/ec/generate", "volumeServer") as req:
        _encode(base, geometry, monkeypatch)
    spans = {s["name"]: s for s in tracer.BUFFER.get(req.trace_id)}
    assert set(spans) == {"POST /admin/ec/generate", "ec.encode",
                          "ec.encode.ecx", "ec.encode.shards",
                          "ec.encode.sidecars"}
    top = spans["ec.encode"]
    assert spans["ec.encode.ecx"]["parent_id"] == req.span_id
    assert top["parent_id"] == req.span_id
    assert spans["ec.encode.shards"]["parent_id"] == top["span_id"]
    assert spans["ec.encode.sidecars"]["parent_id"] == top["span_id"]
    assert top["attrs"]["bytes"] == os.path.getsize(base + ".dat")
    assert spans["ec.encode.ecx"]["attrs"]["bytes"] == \
        os.path.getsize(base + ".idx")
    attrs = spans["ec.encode.shards"]["attrs"]
    shard = os.path.getsize(base + to_ext(0))
    assert {k: v for k, v in attrs.items() if k.endswith("_bytes")} == {
        "encode_read_bytes": 10 * shard, "encode_read_wait_bytes": 0,
        "encode_submit_bytes": 10 * shard, "encode_write_bytes": 14 * shard,
        "encode_fetch_bytes": 4 * shard, "encode_ring_wait_bytes": 0,
        "encode_write_drain_bytes": 0}
    assert all(attrs[f"{s}_seconds"] > 0 for s in PIPELINE)


def test_sort_alone_opens_its_own_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE", "1")
    tracer.BUFFER.clear()
    base = _volume(tmp_path, 50_000)
    encoder.write_sorted_file_from_idx(base)
    (summary,) = tracer.BUFFER.summaries()
    assert summary["root"] == "ec: ec.encode.ecx"
    assert summary["spans"] == 1


def _profiled(base, geometry, monkeypatch) -> dict:
    monkeypatch.setenv("SEAWEEDFS_TPU_TRACE", "1")
    tracer.BUFFER.clear()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        _encode(base, geometry, monkeypatch)
    path = base + ".trace.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def test_ranges_carry_their_thread_and_the_spans_clock(volume, monkeypatch):
    geometry, base = volume
    doc = _profiled(base, geometry, monkeypatch)
    ranges = [e for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("ec.")]
    names = {e["name"] for e in ranges}
    assert {"ec." + s for s in STAGES} <= names
    assert {"ec.encode", "ec.encode.ecx", "ec.encode.shards",
            "ec.encode.sidecars"} <= names
    tids = {s: {e["tid"] for e in ranges if e["name"] == "ec." + s}
            for s in STAGES}
    reader, writer = tids["encode_read"], tids["encode_write"]
    main = tids["encode_submit"]
    assert reader and writer and not reader & writer
    assert tids["encode_ring_wait"] == reader
    assert not writer & main and not reader & main
    assert tids["encode_write_drain"] == main
    # The span's start (time.time()) and its range's start, on the
    # trace's clock, agree.
    (top,) = [e for e in ranges if e["name"] == "ec.encode"]
    at_us = float(top["ts"]) + doc["baseTimeNanoseconds"] / 1000
    (span,) = [s for t in tracer.BUFFER.summaries()
               for s in tracer.BUFFER.get(t["trace_id"])
               if s["name"] == "ec.encode"]
    assert abs(span["start"] * 1e6 - at_us) < 2000


def test_no_range_without_a_profiler(tmp_path, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    geometry = "shrunken"
    base = _volume(tmp_path, GEOMETRIES[geometry][3])
    _encode(base, geometry, monkeypatch)
    assert calls == []
    # The same call under a profiler enters its ranges there.
    with profile(activities=[ProfilerActivity.CPU]):
        _encode(base, geometry, monkeypatch)
    assert "ec.encode" in calls and "ec.encode_write" in calls


def test_ec_stage_observes_accumulates_and_skips_a_failure():
    stage = "test_stage_helper"
    stages: dict = {}
    before = (metrics.ec_stage_seconds.count(stage=stage),
              metrics.ec_stage_bytes.value(stage=stage))
    with metrics.ec_stage(stage, 7, stages):
        time.sleep(0.001)
    with metrics.ec_stage(stage, 5):
        pass
    with pytest.raises(OSError):
        with metrics.ec_stage(stage, 100, stages):
            raise OSError("a failed write")
    assert metrics.ec_stage_seconds.count(stage=stage) - before[0] == 2
    assert metrics.ec_stage_bytes.value(stage=stage) - before[1] == 12
    assert stages[stage][1] == 7 and stages[stage][0] >= 0.001


def test_stages_from_many_threads_share_one_accumulator():
    """Threads add to one per-call accumulator, each under its own stage
    (as the read-ahead thread and the calling thread do), and lose no
    observation."""
    stages: dict = {}
    names = [f"test_stage_{i}" for i in range(8)]

    def observe(stage):
        for _ in range(500):
            with metrics.ec_stage(stage, 1, stages):
                pass

    threads = [threading.Thread(target=observe, args=(s,)) for s in names]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert {s: stages[s][1] for s in names} == dict.fromkeys(names, 500)
