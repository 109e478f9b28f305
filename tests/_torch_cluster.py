"""Both packages' control planes side by side, for the port's cluster
tests (tests/test_torch_master.py, _topology.py, _rpc.py,
_resilience.py, _tenancy.py, _slo.py, _lifecycle.py, _repair_daemon.py,
_frontdoor.py, _security.py).

`mod(pkg, name)` imports one package's module by its path below the
package, `pair(name)` both (the JAX package's first).  `both(scenario)`
runs `scenario(pkg)` for each package with the module-global `random`
seeded alike (topology cookies and placement picks read it), holds the
two answers equal and returns the port's.

`count_plain_launches` lets chip_smoke's phases rehearse on the CPU.

`hermetic_port_state` is the port's twin of the autouse fixture in
tests/conftest.py, which resets only the JAX package's process globals;
a test file uses it by importing it.  `pin_clocks` stands a settable
clock in for `time` in every module whose answers carry the wall clock,
in both packages, so that two masters fed the same beats answer alike.
"""

from __future__ import annotations

import importlib
import random
import time

import pytest
import torch

# One intra-op thread: the suite runs several workers side by side, and
# timing-bound tests in other files must not lose their cores.
torch.set_num_threads(1)

PACKAGES = ("seaweedfs_tpu", "seaweedfs_tpu_torch")
# Modules whose answers carry time.time(): heartbeat ages and sweeps,
# SLO exemplars, usage snapshots, the lifecycle and repair daemons'
# histories, JWT expiries.
CLOCKED = ("cluster.master", "topology.topology", "stats.slo",
           "tenancy.accounting", "lifecycle.daemon", "cluster.repair_daemon",
           "utils.security")
EPOCH_S = 1_700_000_000.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def pair(name: str) -> tuple:
    return tuple(mod(pkg, name) for pkg in PACKAGES)


def both(scenario, seed: int = 0):
    """scenario(pkg) for each package, `random` seeded alike before
    each; the answers must be equal.  Returns the port's."""
    out = []
    for pkg in PACKAGES:
        random.seed(seed)
        out.append(scenario(pkg))
    assert out[1] == out[0]
    return out[1]


def outcome(fn, *args, **kw):
    """("ok", value) or ("raise", exception class name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        return ("raise", type(e).__name__, str(e))


@pytest.fixture(autouse=True)
def hermetic_port_state():
    """The port's per-host breakers, armed faults, wire-flow ledger and
    chunk cache are process-global: start and end every test clean."""
    from seaweedfs_tpu_torch import fault
    from seaweedfs_tpu_torch.cluster import resilience
    from seaweedfs_tpu_torch.stats import flows
    from seaweedfs_tpu_torch.storage import chunk_cache
    resilience.reset_breakers()
    fault.disarm_all()
    flows.LEDGER.reset()
    chunk_cache.CACHE.reset()
    yield
    fault.disarm_all()
    resilience.reset_breakers()
    flows.LEDGER.reset()
    chunk_cache.CACHE.reset()


class Clock:
    """Stands in for the `time` module: `time()` reads `now`, which the
    test moves; everything else is the real module."""

    def __init__(self, now: float = EPOCH_S):
        self.now = now

    def time(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def pin_clocks(monkeypatch, now: float = EPOCH_S) -> Clock:
    """One Clock as `time` in every CLOCKED module of both packages."""
    clock = Clock(now)
    for pkg in PACKAGES:
        for name in CLOCKED:
            monkeypatch.setattr(mod(pkg, name), "time", clock)
    return clock


def count_plain_launches(monkeypatch) -> None:
    """On the CPU the kernel wrappers run their plain versions and count
    no launch; for a rehearsal of chip_smoke's phases count each
    OUTERMOST plain K1/K2 call as one launch of its instantiation (K2's
    plain version calls K1's, and with a volume axis both loop)."""
    from seaweedfs_tpu_torch.ops import coder_cuda as cc
    depth = [0]

    def counted(fn, wrapper, variants, pick):
        def inner(masks, shards, *a, **k):
            depth[0] += 1
            try:
                out = fn(masks, shards, *a, **k)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                wrapper.launches += 1
                wrapper.variant_launches[variants[pick(
                    shards.shape[-2], masks.shape[0] // 8)]] += 1
            return out
        return inner

    monkeypatch.setattr(cc, "apply_bitmatrix_torch", counted(
        cc.apply_bitmatrix_torch, cc.apply_bitmatrix, cc.K1_VARIANTS,
        cc.k1_variant))
    monkeypatch.setattr(cc, "apply_bitmatrix_crc_torch", counted(
        cc.apply_bitmatrix_crc_torch, cc.apply_bitmatrix_crc,
        cc.K2_VARIANTS, cc.k2_variant))
