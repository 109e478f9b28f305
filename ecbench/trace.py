"""The traced run: a torch.profiler trace of the window (every kernel,
copy and fill on the card, from CUPTI) and a sample of what each host
thread was doing every 10 ms.

The profiler records CPU operators of the thread that started it only,
so the host side comes from the sampler: each sample names, per thread
that is not waiting on a lock, queue or event, the innermost frame in
the program (or the innermost frame), and an idle gap of the card is
named by the label most samples inside it carry.  The window is placed
in the trace by a marker the main thread records when it opens."""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

import torch

MARK = "ecbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SAMPLE_S = 0.01
TOP = 10
_WAITS = {"wait", "get", "put", "join", "acquire", "_wait_for_tstate_lock",
          "sleep", "select", "poll"}


def _label(frame) -> str | None:
    inner, mine = frame, None
    f = frame
    while f is not None:
        if mine is None and "seaweedfs_tpu_torch" + os.sep in \
                f.f_code.co_filename:
            mine = f
        f = f.f_back
    base = os.path.basename(inner.f_code.co_filename)
    if inner.f_code.co_name in _WAITS and base in ("threading.py",
                                                   "queue.py"):
        return None
    use = mine or inner
    path = use.f_code.co_filename
    cut = path.rfind("seaweedfs_tpu_torch" + os.sep)
    path = path[cut + len("seaweedfs_tpu_torch") + 1:] if cut >= 0 \
        else os.path.basename(path)
    return f"{path}:{use.f_code.co_name}"


class Tracer:
    def __init__(self, work: str):
        self.path = os.path.join(work, "trace.json")
        self.samples: list[tuple[int, list[str]]] = []
        self._stop = threading.Event()
        self._prof = None
        self._thread = None
        self.t_open_ns = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._thread = threading.Thread(target=self._sample, daemon=True,
                                        name="ecbench-sampler")
        self._thread.start()

    def _sample(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(SAMPLE_S):
            t = time.perf_counter_ns()
            labels = [lab for tid, fr in sys._current_frames().items()
                      if tid != me and (lab := _label(fr)) is not None]
            self.samples.append((t, labels))

    def mark_open(self) -> None:
        """Called by the main thread as the window opens."""
        with torch.profiler.record_function(MARK):
            self.t_open_ns = time.perf_counter_ns()

    def stop(self) -> dict:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._stop.set()
        self._thread.join()
        self._prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                return json.load(f)
        finally:
            os.remove(self.path)


def _union(spans: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Summary:
    """The trace's device activity inside the window [t0, t1] (us)."""

    def __init__(self, doc: dict, window_s: float, samples=(),
                 t_open_ns: int | None = None):
        events = doc.get("traceEvents", [])
        marks = [e for e in events if e.get("name") == MARK
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError(f"the trace has no {MARK} marker")
        self.t0 = float(marks[0]["ts"])
        self.t1 = self.t0 + window_s * 1e6
        self.window_s = window_s
        # Every device record from the window's opening to the trace's
        # end (the pass running at the close runs to its end in it), and
        # those started in the window.
        self.from_open = [e for e in events if e.get("cat") in DEVICE_CATS
                          and e.get("ph") == "X"
                          and self.t0 <= float(e["ts"])]
        self.device = [e for e in self.from_open
                       if float(e["ts"]) < self.t1]
        clipped = [(float(e["ts"]), min(self.t1, float(e["ts"])
                                        + float(e.get("dur", 0))))
                   for e in self.device]
        self.busy = _union(clipped)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6
        self._samples = [((t - t_open_ns) / 1e3 + self.t0, labels)
                         for t, labels in samples] if t_open_ns else []

    def kernels(self, fragment: str, whole_passes: bool = False
                ) -> list[dict]:
        """Kernel events whose name holds `fragment`, started in the
        window (whole durations); with `whole_passes`, also those of the
        pass that ran on after the close."""
        return [e for e in (self.from_open if whole_passes else self.device)
                if e["cat"] == "kernel" and fragment in e["name"]]

    def copies(self, prefix: str) -> list[dict]:
        return [e for e in self.device if e["cat"] == "gpu_memcpy"
                and e["name"].startswith(prefix)]

    def device_ops(self) -> list[list]:
        by: dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            end = min(self.t1, float(e["ts"]) + float(e.get("dur", 0)))
            by[e["name"]] += (end - float(e["ts"])) / 1e6
        return [[name, secs] for name, secs in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        gaps, at = [], self.t0
        for a, b in self.busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(a, b), (b - a) / 1e6] for a, b in gaps[:TOP]]

    def _host_at(self, a: float, b: float) -> str:
        inside = [labels for t, labels in self._samples if a <= t <= b]
        if not inside and self._samples:
            mid = (a + b) / 2
            inside = [min(self._samples, key=lambda s: abs(s[0] - mid))[1]]
        count = collections.Counter(lab for labels in inside
                                    for lab in labels)
        if not count:
            return "host: no busy thread sampled"
        return "host: " + count.most_common(1)[0][0]
