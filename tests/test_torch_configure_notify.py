"""The port's `volume.configure.replication`, `fs.meta.notify` and the
filer's notification.toml wiring (`replication/notification.py`)
held against the JAX package's.

Every case of tests/test_configure_notify.py runs in both packages through
`_torch_twin`: the same seeded inputs, the reference's own asserts in
each, and the values those asserts compare must be equal across the
two (masked fields: see `_torch_twin`).  One case,
`test_fs_meta_notify_bootstraps_queue`, ends by driving a `Replicator`
into a `LocalSink`; it runs whole through the twin, and its first half
also runs here on its own, consuming the spool with `FileQueue.consume`
in each package.
"""

from __future__ import annotations

import json
import random

import pytest

from _torch_cluster import (PACKAGES, LiveCluster,  # noqa: F401
                            device_kw, hermetic_port_state, mod)
from _torch_twin import Recorder, TwinFile

pytestmark = pytest.mark.torch

TWIN = TwinFile("test_configure_notify.py")


@pytest.mark.parametrize("case", TWIN.ids())
def test_configure_notify_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)


def _notify_scenario(pkg: str, root) -> list:
    cluster = LiveCluster(pkg, root, n=2)
    fs = mod(pkg, "filer.server").FilerServer(
        cluster.url(), port=0, store_path=str(root / "f.db"))
    fs.start()
    try:
        rpc = mod(pkg, "cluster.rpc")
        base = fs.url()
        rpc.call(f"{base}/boot/a.txt", "POST", b"one")
        rpc.call(f"{base}/boot/sub/b.txt", "POST", b"two")
        shell = mod(pkg, "shell")
        env = shell.CommandEnv(cluster.url(), filer_url=base,
                               **device_kw(pkg))
        spool = root / "notify" / "spool.jsonl"
        out = shell.run_command(env,
                                f"fs.meta.notify -queue=file://{spool} /boot")
        assert "notified" in out
        lines = [json.loads(ln) for ln in open(spool).read().splitlines()]
        keys = {ln["key"] for ln in lines}
        assert {"/boot/a.txt", "/boot/sub", "/boot/sub/b.txt"} <= keys
        ev = next(ln["message"] for ln in lines
                  if ln["key"] == "/boot/a.txt")
        assert ev["new_entry"]["path"] == "/boot/a.txt"
        assert ev["old_entry"] is None
        consumed: list = []
        mod(pkg, "replication.notification").FileQueue(str(spool)).consume(
            lambda k, m: consumed.append((k, m)))
        assert [k for k, _m in consumed] == [ln["key"] for ln in lines]
        env.close()
        rec = Recorder()
        rec.roots = [str(root)]
        return rec.norm([out, lines, consumed])
    finally:
        fs.stop()
        cluster.stop()


def test_fs_meta_notify_bootstraps_queue_in_both_packages(tmp_path):
    """The reference case up to its replicator, in both packages: the
    shell's output, every spooled event and what the spool's consumer
    receives must be equal across the two."""
    out = []
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        random.seed(0)
        out.append(_notify_scenario(pkg, root))
    assert out[1] == out[0]
