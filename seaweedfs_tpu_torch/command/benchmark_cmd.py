"""weed benchmark: write/read load generator with latency stats.

Reference: weed/command/benchmark.go:26-141 (write then random read
via assign+upload against a live master, concurrency workers,
latency percentiles printed by printStats :434, synthetic payloads
:523).

The reference's goroutine workers share one multi-core Go process;
Python threads share the GIL, so `-procs=K` (default 4 when c >= 8)
forks K worker processes each running c/K client threads — the same
aggregate concurrency with real CPU parallelism.  `-procs=1` keeps
everything in-process (used by tests).

The port's copy of `seaweedfs_tpu/command/benchmark_cmd.py`.
"""

from __future__ import annotations

import random
import threading
import time

from . import Command, Flags, register


class _Stats:
    def __init__(self) -> None:
        self.latencies_ms: list[float] = []
        self.bytes = 0
        self.errors = 0
        self.lock = threading.Lock()

    def add(self, seconds: float, nbytes: int) -> None:
        with self.lock:
            self.latencies_ms.append(seconds * 1000.0)
            self.bytes += nbytes

    def error(self) -> None:
        with self.lock:
            self.errors += 1

    def report(self, title: str, wall: float,
               cpu: dict | None = None) -> dict:
        lat = sorted(self.latencies_ms)
        n = len(lat)

        def pct(p: float) -> float:
            return lat[min(n - 1, int(n * p))] if n else 0.0
        out = {
            "title": title, "requests": n, "errors": self.errors,
            "seconds": round(wall, 3),
            "req_per_sec": round(n / wall, 2) if wall else 0.0,
            "mb_per_sec": round(self.bytes / wall / 1e6, 2)
            if wall else 0.0,
            "latency_ms": {
                "avg": round(sum(lat) / n, 2) if n else 0.0,
                "p50": round(pct(0.50), 2), "p90": round(pct(0.90), 2),
                "p99": round(pct(0.99), 2),
                "max": round(lat[-1], 2) if n else 0.0,
            },
        }
        if cpu is not None:
            total = cpu.get("client_s", 0.0) + cpu.get("server_s", 0.0)
            out["cpu"] = {
                "client_s": round(cpu.get("client_s", 0.0), 3),
                "server_s": round(cpu.get("server_s", 0.0), 3),
                "total_s": round(total, 3),
                "req_per_core_sec": round(n / total, 1)
                if total > 0 else 0.0,
                "cpu_us_per_req": round(total / n * 1e6, 1)
                if n else 0.0,
            }
        print(f"\n--- {title} ---")
        print(f"requests      {n}  (errors {self.errors})")
        print(f"time          {out['seconds']} s")
        print(f"throughput    {out['req_per_sec']} req/s, "
              f"{out['mb_per_sec']} MB/s")
        lm = out["latency_ms"]
        print(f"latency ms    avg {lm['avg']}  p50 {lm['p50']}  "
              f"p90 {lm['p90']}  p99 {lm['p99']}  max {lm['max']}")
        if cpu is not None and out.get("cpu"):
            c = out["cpu"]
            print(f"cpu           client {c['client_s']}s + servers "
                  f"{c['server_s']}s = {c['total_s']}s  ->  "
                  f"{c['req_per_core_sec']} req/core-sec  "
                  f"({c['cpu_us_per_req']} us CPU/req)")
        return out


def _mp_worker(outq, barrier, master: str, phase: str, count: int,
               size: int, collection: str, nthreads: int,
               fids_in: list[str], seed: int) -> None:
    """One forked load process: nthreads client threads, own stats."""
    from ..cluster.client import WeedClient
    client = WeedClient(master)
    payload = random.Random(7).randbytes(size)
    stats = _Stats()
    fids: list[str] = []
    fid_lock = threading.Lock()

    def w_write(c: int) -> None:
        for _ in range(c):
            t0 = time.perf_counter()
            try:
                fid = client.upload_data(payload, collection=collection)
            except Exception:  # noqa: BLE001 — count, keep loading
                stats.error()
                continue
            stats.add(time.perf_counter() - t0, size)
            with fid_lock:
                fids.append(fid)

    def w_read(c: int, rng: random.Random) -> None:
        for _ in range(c):
            fid = rng.choice(fids_in)
            t0 = time.perf_counter()
            try:
                data = client.download(fid)
            except Exception:  # noqa: BLE001
                stats.error()
                continue
            stats.add(time.perf_counter() - t0, len(data))

    per = count // nthreads
    counts = [per + (1 if i < count % nthreads else 0)
              for i in range(nthreads)]
    if phase == "write":
        threads = [threading.Thread(target=w_write, args=(c,), daemon=True)
                   for c in counts if c]
    else:
        threads = [threading.Thread(
            target=w_read, args=(c, random.Random(seed * 1000 + i)),
            daemon=True) for i, c in enumerate(counts) if c]
    barrier.wait()
    import resource
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    outq.put({"lat": stats.latencies_ms, "bytes": stats.bytes,
              "errors": stats.errors, "fids": fids,
              "wall": time.perf_counter() - t0,
              "cpu": (ru1.ru_utime + ru1.ru_stime)
              - (ru0.ru_utime + ru0.ru_stime)})


def _server_cpus(master: str) -> dict[int, float]:
    """pid -> cpu_seconds for every reachable server process (master +
    volume servers from /vol/list).  Keyed by pid so co-located roles
    (weed server all-in-one, in-process tests) are never double-counted.
    The per-request CPU breakdown is what makes the reference's
    multi-core req/s comparable to a 1-core run (BASELINE.md)."""
    from ..cluster import rpc
    out: dict[int, float] = {}
    try:
        st = rpc.call(f"{master}/cluster/status")
        if "pid" in st:
            out[st["pid"]] = st["cpu_seconds"]
    except Exception:  # noqa: BLE001 — cpu sampling is best-effort
        pass
    try:
        vl = rpc.call(f"{master}/vol/list")
        urls = {n["url"]
                for dc in vl.get("topology", {}).get("data_centers", [])
                for rack in dc.get("racks", [])
                for n in rack.get("nodes", [])}
        for u in urls:
            try:
                st = rpc.call(f"http://{u}/admin/status")
                if "pid" in st:
                    out[st["pid"]] = st["cpu_seconds"]
            except Exception:  # noqa: BLE001
                pass
    except Exception:  # noqa: BLE001
        pass
    return out


def _cpu_delta(before: dict[int, float],
               after: dict[int, float]) -> float:
    return sum(after[pid] - before[pid]
               for pid in after if pid in before)


def run_benchmark(flags: Flags, args: list[str],
                  reports: list | None = None) -> int:
    from ..cluster.client import WeedClient
    master = flags.get("master", "127.0.0.1:9333")
    master = master if master.startswith("http") else f"http://{master}"
    n = flags.get_int("n", 1024)
    size = flags.get_int("size", 1024)
    concurrency = flags.get_int("c", 16)
    procs = flags.get_int("procs", 4 if concurrency >= 8 else 1)
    do_write = flags.get("write", "true").lower() != "false"
    do_read = flags.get("read", "true").lower() != "false"
    sample_cpu = flags.get("cpu", "true").lower() != "false"
    collection = flags.get("collection", "")
    if procs > 1:
        return _run_benchmark_mp(master, n, size, concurrency, procs,
                                 do_write, do_read, collection, reports,
                                 sample_cpu)
    client = WeedClient(master)
    payload = random.Random(7).randbytes(size)
    fids: list[str] = []
    fid_lock = threading.Lock()

    def worker_write(count: int, stats: _Stats) -> None:
        for _ in range(count):
            t0 = time.perf_counter()
            try:
                fid = client.upload_data(payload,
                                         collection=collection)
            except Exception:  # noqa: BLE001 — count, keep loading
                stats.error()
                continue
            stats.add(time.perf_counter() - t0, size)
            with fid_lock:
                fids.append(fid)

    def worker_read(count: int, stats: _Stats,
                    local_rng: random.Random) -> None:
        for _ in range(count):
            with fid_lock:
                fid = local_rng.choice(fids)
            t0 = time.perf_counter()
            try:
                data = client.download(fid)
            except Exception:  # noqa: BLE001
                stats.error()
                continue
            stats.add(time.perf_counter() - t0, len(data))

    def run_phase(fn, title: str, extra_args=()) -> None:
        import resource
        stats = _Stats()
        per = n // concurrency
        counts = [per + (1 if i < n % concurrency else 0)
                  for i in range(concurrency)]
        threads = [threading.Thread(
            target=fn, args=(c, stats, *extra_args), daemon=True)
            for c in counts if c]
        import os
        srv0 = _server_cpus(master) if sample_cpu else {}
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        cpu = None
        if sample_cpu:
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            srv1 = _server_cpus(master)
            client_cpu = (ru1.ru_utime + ru1.ru_stime) \
                - (ru0.ru_utime + ru0.ru_stime)
            me = os.getpid()
            if me in srv1:
                # In-process servers (tests): their CPU is already
                # inside the client rusage; don't count twice.
                srv0.pop(me, None)
                srv1.pop(me, None)
            cpu = {"client_s": client_cpu,
                   "server_s": _cpu_delta(srv0, srv1)}
        out = stats.report(title, wall, cpu)
        if reports is not None:
            reports.append(out)

    print(f"benchmarking {master}: n={n} size={size}B "
          f"concurrency={concurrency}")
    if do_write:
        run_phase(lambda c, s: worker_write(c, s), "write")
    if do_read:
        if not fids:
            print("nothing to read (write phase skipped/failed)")
            return 1
        run_phase(lambda c, s: worker_read(c, s, random.Random()),
                  "random read")
    return 0


def _run_benchmark_mp(master: str, n: int, size: int, concurrency: int,
                      procs: int, do_write: bool, do_read: bool,
                      collection: str, reports: list | None,
                      sample_cpu: bool = True) -> int:
    """Spawn `procs` load processes per phase and merge their stats."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")  # safe even if the parent touched CUDA
    nthreads = max(1, concurrency // procs)

    def run_phase(phase: str, fids_in: list[str]) -> list[str]:
        outq = ctx.Queue()
        per = n // procs
        counts = [c for c in
                  (per + (1 if i < n % procs else 0)
                   for i in range(procs)) if c]
        # Barrier parties must match the workers actually spawned, or a
        # small -n with zero-count slots would deadlock everyone.
        barrier = ctx.Barrier(len(counts) + 1)
        workers = [ctx.Process(
            target=_mp_worker,
            args=(outq, barrier, master, phase, c, size, collection,
                  nthreads, fids_in, i), daemon=True)
            for i, c in enumerate(counts)]
        for w in workers:
            w.start()
        barrier.wait()  # everyone imported and connected; go
        srv0 = _server_cpus(master) if sample_cpu else {}
        t0 = time.perf_counter()
        stats = _Stats()
        fids: list[str] = []
        client_cpu = 0.0
        for _ in workers:
            out = outq.get()
            stats.latencies_ms.extend(out["lat"])
            stats.bytes += out["bytes"]
            stats.errors += out["errors"]
            fids.extend(out["fids"])
            client_cpu += out.get("cpu", 0.0)
        wall = time.perf_counter() - t0
        for w in workers:
            w.join()
        cpu = None
        if sample_cpu:
            cpu = {"client_s": client_cpu,
                   "server_s": _cpu_delta(srv0, _server_cpus(master))}
        title = "write" if phase == "write" else "random read"
        rep = stats.report(f"{title} ({procs} procs x "
                           f"{nthreads} threads)", wall, cpu)
        if reports is not None:
            reports.append(rep)
        return fids

    print(f"benchmarking {master}: n={n} size={size}B "
          f"concurrency={concurrency} procs={procs}")
    fids: list[str] = []
    if do_write:
        fids = run_phase("write", [])
    if do_read:
        if not fids:
            print("nothing to read (write phase skipped/failed)")
            return 1
        run_phase("read", fids)
    return 0


register(Command(
    "benchmark",
    "benchmark -master=host:9333 -n=1024 -size=1024 -c=16 -procs=4",
    "write/read load test against a cluster", run_benchmark))
