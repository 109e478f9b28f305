"""Run one cell of the benchmark once and print its result.

    python3 -m ecbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the chips the cell asks
for.  Set-up (imports, CUDA, the kernels' build on a checkout's first
run, the inputs made from the seed, one warm pass) is `setup_s`; then
the cell's driver runs passes of its program entry for `--seconds`
(the window), the pass that is running when it closes runs to its end,
and the reference judges what the window wrote.  The last line of
standard output is the result as JSON (the end-to-end metrics with
--trace 0, the per-layer ones and the trace's breakdown with --trace 1);
the last lines of standard error are the numbers compared, each beside
its limit.  No result is printed, and the exit code is not 0, without
as many CUDA cards as the cell asks for, or when JAX or the JAX package
was imported.  `--control` puts the plain reference, with one stated
guarantee broken, in the program's place (a run that must come out not
correct; the benchmark's own runs never set it)."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402

from . import cells, memfiles, program  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "seaweedfs_tpu")
# The most a share of a roofline or of a peak may read.
ROOF_LIMIT_PCT = 100.0
# Host memory kept free beyond what the driver says its cell holds: the
# program's pinned staging and the process itself.
HOST_SLACK = 6 << 30


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among `names` (default: sys.modules) that a
    run may not import, each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    cell: cells.Cell
    setup_s: float
    window_s: float
    progress: dict
    before: dict
    after: dict
    work: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    def delta(self, key: str) -> float | None:
        if key not in self.after:
            return None
        return self.after[key] - self.before.get(key, 0.0)


def run_cell(cell: cells.Cell, seconds: float, trace: bool,
             t_start: float) -> dict:
    """Set up, run the window, judge; returns the pieces of the result."""
    import torch
    on_card = cell.device.type == "cuda"
    drv = cells.driver(cell.mix["driver"])(cell)
    try:
        need = drv.host_bytes() + HOST_SLACK
        have = memfiles.mem_available()
        if need > have:
            raise SystemExit(
                f"{cell.name}: needs {need} bytes of host memory, "
                f"{have} are available; the configuration is not cut to fit")
        t_setup = time.monotonic()
        drv.setup()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.monotonic() - t_start
        parts = {"start_s": t_setup - t_start, **drv.timings}
        print(f"ecbench: set-up {setup_s:.3f} s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()), file=sys.stderr)
        tracer = None
        if trace:
            from .trace import Tracer
            tracer = Tracer(cell.work)
            tracer.start()
        lock = threading.Lock()
        closed: dict = {}

        def close_window() -> None:
            with lock:
                if not closed:
                    closed["t"] = time.monotonic()
                    closed["progress"] = drv.progress()
                    closed["counters"] = program.counters()

        before = program.counters()
        if tracer:
            tracer.mark_open()
        t_open = time.monotonic()
        timer = threading.Timer(seconds, close_window)
        timer.start()
        step = drv.control_pass if cell.control else drv.run_pass
        more = True
        pass_s: list[float] = []
        try:
            while more:
                with lock:
                    drv.begin()
                t_pass = time.monotonic()
                step()
                pass_s.append(time.monotonic() - t_pass)
                with lock:
                    more = not closed and time.monotonic() < t_open + seconds
                    drv.boundary(more)
        except Exception as e:  # noqa: BLE001 — reported as not correct
            drv.error = e
            traceback.print_exc()
            timer.cancel()
            close_window()
        timer.join()
        window_s = closed["t"] - t_open
        work = drv.work()
        print("ecbench: passes s " + " ".join(f"{p:.3f}" for p in pass_s),
              file=sys.stderr)
        summary = None
        if tracer:
            from .trace import Summary
            doc = tracer.stop()
            summary = Summary(doc, window_s, tracer.samples,
                              tracer.t_open_ns)
            if not summary.device:
                raise SystemExit("the traced window holds no device "
                                 "operation: the profiler saw no card work")
        peak = 0
        if on_card:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        if drv.error is None:
            numbers, attempted, failed = drv.judge()
        else:
            numbers, attempted, failed = {}, drv.started, drv.started
        ctx = Context(cell, setup_s, window_s, closed["progress"], before,
                      closed["counters"], work, summary)
        return {"ctx": ctx, "numbers": numbers, "attempted": attempted,
                "failed": failed, "peak": peak, "error": drv.error}
    finally:
        drv.close()


def _values(ctx: Context, entries: list[dict]) -> dict:
    out = {}
    for m in entries:
        value = cells.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _is_share_of_a_roof(name: str, unit: str) -> bool:
    return unit == "%" and ("_roofline" in name or "mfu" in name)


def result_line(bench: dict, name: str, chips: int, kind: str,
                trace: bool, got: dict, power_limit_w=None) -> dict:
    ctx = got["ctx"]
    e2e, layer = cells.metrics(bench, name)
    metrics = _values(ctx, layer if trace else e2e)
    # A share of a roofline or a peak over 100 % counts the work too
    # high or leaves work out of the time: the run is not correct.
    numbers = dict(got["numbers"])
    numbers.update({k: (v["value"], ROOF_LIMIT_PCT)
                    for k, v in metrics.items()
                    if _is_share_of_a_roof(k, v["unit"])})
    correct = (got["error"] is None and got["attempted"] > 0
               and got["failed"] == 0
               and all(v <= lim for v, lim in numbers.values()))
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": got["peak"],
              "power_limit_w": power_limit_w}
    out = {"correct": correct, "attempted": got["attempted"],
           "failed": got["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.window_s
        out["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                            "idle_gaps": ctx.trace.idle_gaps()}
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    return out


def power_limit(index: int) -> float | None:
    """The card's power limit in watts as nvidia-smi reads it (a card
    set below its maximum runs slower under load), or None."""
    import subprocess
    import torch
    uuid = str(getattr(torch.cuda.get_device_properties(index), "uuid",
                       "") or "")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    rows = [[x.strip() for x in line.split(",")]
            for line in out.splitlines() if line.count(",") == 1]
    mine = [w for gpu, w in rows if uuid and gpu.endswith(uuid)] or \
        [w for _, w in rows if len(rows) == 1]
    try:
        return float(mine[0]) if mine else None
    except ValueError:
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m ecbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the reference with a broken guarantee")
    args = p.parse_args(argv)
    found = forbidden_modules()
    if found:
        print(f"ecbench: imported before the run: {found}", file=sys.stderr)
        return 4
    bench = cells.load_benchmark()
    w, c = cells.workload(bench, args.workload)
    config = cells.load_json(c["file"])
    mix = cells.mix(w["traffic"])
    import torch
    chips = int(w["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ecbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(0)
    power_limit_w = power_limit(0)
    print(f"ecbench: {kind}, power limit {power_limit_w} W",
          file=sys.stderr)
    work = tempfile.mkdtemp(prefix="ecbench-")
    try:
        cell = cells.Cell(args.workload, w, config, mix, args.seed,
                          torch.device("cuda", 0), work, args.control)
        got = run_cell(cell, args.seconds, bool(args.trace), T_START)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"ecbench: the run imported {found}", file=sys.stderr)
        return 4
    line = result_line(bench, args.workload, chips, kind, bool(args.trace),
                       got, power_limit_w)
    for k, v in line["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
