"""The port's cloud queues and sinks (SQS, GCS, B2, Azure, S3) held
against the JAX package's.

Every case of tests/test_replication_cloud.py runs in both packages through `_torch_twin`:
the same seeded inputs, the reference's own asserts in each, and the
values those asserts compare must be equal across the two (masked
fields: see `_torch_twin`).  The Azure sink signs over its `x-ms-date`
header, which it reads from `time.gmtime()`: `replication.sink` runs on
the twin's pinned clock in both packages, so that the two halves sign
the same date and the signatures are compared in full.
"""

from __future__ import annotations

import time

import pytest

import _torch_twin
from _torch_cluster import EPOCH_S, hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWIN = TwinFile("test_replication_cloud.py", clocked=("replication.sink",))
AZURE = "test_azure_sharedkey_put_delete"


@pytest.mark.parametrize("case", TWIN.ids())
def test_replication_cloud_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)


def _step_between_halves(monkeypatch) -> dict:
    """The real `time.gmtime()` reads a clock that moves one second
    just before the port's half of a twin case starts."""
    real = time.gmtime
    clock = {"now": EPOCH_S + 0.5}
    monkeypatch.setattr(time, "gmtime", lambda secs=None: real(
        clock["now"] if secs is None else secs))
    reset = _torch_twin._reset_port_globals

    def step_then_reset():
        clock["now"] += 1.0
        reset()

    monkeypatch.setattr(_torch_twin, "_reset_port_globals", step_then_reset)
    return clock


def test_azure_twin_signs_on_one_clock_across_a_second(tmp_path,
                                                       monkeypatch):
    """The second-boundary race: the two halves of the Azure case run on
    either side of a second.  Unpinned, the halves sign different
    `x-ms-date`s and record different signatures; on the pinned clock
    they record equal ones."""
    clock = _step_between_halves(monkeypatch)
    for d in ("unpinned", "pinned"):
        (tmp_path / d).mkdir()
    unpinned = TwinFile("test_replication_cloud.py")
    with pytest.raises(AssertionError, match="records differently"):
        unpinned.run(AZURE, tmp_path / "unpinned")
    assert clock["now"] == EPOCH_S + 1.5
    TWIN.run(AZURE, tmp_path / "pinned")
    assert clock["now"] == EPOCH_S + 2.5
