"""A read-only pytest plugin that watches both packages' keep-alive
client pools (`cluster/rpc.py` `_ConnPool.acquire`) and their servers'
starts, for finding which tests hand a call a connection its server has
already closed.

Before each pooled acquire it polls every idle connection of the key
(zero timeout; a socket readable while idle has the server's FIN) and,
when any is dead, appends a JSON line: the package, the key, how many
idle connections there were and how many were dead, whether the two the
reference would pop were both dead (its call then raises
`ConnectionResetError`), and the running test.  Each `JsonHttpServer.
start` adds a line with its key, so a dead key can be traced to the
server that held its port before.  Nothing the packages do changes.

    PYTHONPATH=tests python -m pytest tests/ -p _torch_pool_probe ...

writes `pool-probe-<xdist worker>.jsonl` under `$POOL_PROBE_DIR`
(default `_smoke_work/pool_probe` in the working directory)."""

from __future__ import annotations

import importlib
import json
import os
import select
import time

PACKAGES = ("seaweedfs_tpu", "seaweedfs_tpu_torch")


def _log_path() -> str:
    d = os.environ.get("POOL_PROBE_DIR",
                       os.path.join("_smoke_work", "pool_probe"))
    os.makedirs(d, exist_ok=True)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    return os.path.join(d, f"pool-probe-{worker}.jsonl")


def _write(rec: dict) -> None:
    rec["t"] = time.time()
    rec["test"] = os.environ.get("PYTEST_CURRENT_TEST", "")
    with open(_log_path(), "a") as f:
        f.write(json.dumps(rec) + "\n")


def _dead(conn) -> bool:
    p = select.poll()
    try:
        p.register(conn.sock.fileno(), select.POLLIN)
        return bool(p.poll(0))
    except (OSError, ValueError):
        return True


def _watch(pkg: str) -> None:
    rpc = importlib.import_module(f"{pkg}.cluster.rpc")
    acquire = rpc._ConnPool.acquire
    start = rpc.JsonHttpServer.start

    def watched_acquire(self, scheme, host, port, timeout, *a, **kw):
        dead = [_dead(c) for c in self._idle.get((scheme, host, port), ())]
        if any(dead):
            _write({"pkg": pkg, "key": f"{host}:{port}", "idle": len(dead),
                    "dead": sum(dead),
                    "last_two_dead": len(dead) >= 2 and all(dead[-2:])})
        return acquire(self, scheme, host, port, timeout, *a, **kw)

    def watched_start(self):
        _write({"pkg": pkg, "start": f"{self.host}:{self.port}"})
        return start(self)

    rpc._ConnPool.acquire = watched_acquire
    rpc.JsonHttpServer.start = watched_start


def pytest_configure(config):
    for pkg in PACKAGES:
        _watch(pkg)
