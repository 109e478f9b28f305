"""The judge against a broken timed path: a run on the CPU at a small
size, its program broken underneath, comes out not correct, once for
each fault a cell can have (a step that leaves its output as it was;
half of a step's columns left out; one byte altered where it is made;
for the encode, an unsorted index), and so does the control, the
reference with RS(10,4)'s matrix swapped for ISA-L's Cauchy matrix.
(One chip: no exchange between chips to leave out.)"""

import time
import types

import pytest

from ecbench import cells, run
from ecbench.tests import small

ENCODE = "rs10_4-1000mb.encode"


def _not_correct(name, tmp_path):
    line = small.result(small.cell(name, tmp_path), seconds=0.5)
    assert not line["correct"], line
    assert line["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in line["compared"].values())
    return line


def test_encode_that_writes_nothing(monkeypatch, tmp_path):
    from seaweedfs_tpu_torch.ec import encoder
    monkeypatch.setattr(encoder, "write_ec_files", lambda *a, **k: None)
    _not_correct(ENCODE, tmp_path)


def test_encode_with_half_of_each_chunk_left_out(monkeypatch, tmp_path):
    from seaweedfs_tpu_torch.ec import encoder
    real = encoder._chunk_reader

    def half(*args):
        for data in real(*args):
            data[:, data.shape[1] // 2:] = 0
            yield data
    monkeypatch.setattr(encoder, "_chunk_reader", half)
    _not_correct(ENCODE, tmp_path)


def test_encode_parity_byte_altered_where_made(monkeypatch, tmp_path):
    from seaweedfs_tpu_torch.ec import encoder
    real = encoder._shard_write

    def flip(f, sid, buf, accs):
        if sid == 12 and len(buf):
            b = bytearray(buf)
            b[len(b) // 2] ^= 0x10
            buf = bytes(b)
        real(f, sid, buf, accs)
    monkeypatch.setattr(encoder, "_shard_write", flip)
    line = _not_correct(ENCODE, tmp_path)
    assert line["compared"]["shard_blocks_wrong"]["value"] >= 1


def test_encode_with_an_unsorted_index(monkeypatch, tmp_path):
    from seaweedfs_tpu_torch.ec import encoder

    def copy(base, ext=".ecx"):
        with open(base + ".idx", "rb") as f, open(base + ext, "wb") as out:
            out.write(f.read())
    monkeypatch.setattr(encoder, "write_sorted_file_from_idx", copy)
    line = _not_correct(ENCODE, tmp_path)
    assert line["compared"]["ecx_entries_wrong"]["value"] >= 1


def test_the_control_is_not_correct(tmp_path):
    line = small.result(small.cell(ENCODE, tmp_path, control=True),
                        seconds=0.5)
    assert not line["correct"], line
    assert line["compared"]["ecc_entries_wrong"]["value"] >= 1
    assert line["compared"]["shard_blocks_wrong"]["value"] >= 1


@pytest.mark.parametrize("share,correct", [(99.5, True), (100.5, False)])
def test_a_share_over_its_roof_is_not_correct(monkeypatch, tmp_path, share,
                                              correct):
    """A roofline share past 100 % counts the work too high or leaves
    work out of the time: the traced run's line says not correct and
    shows the share beside its limit."""
    got = run.run_cell(small.cell(ENCODE, tmp_path), 0.5, False,
                       time.monotonic())
    got["ctx"].trace = types.SimpleNamespace(
        busy_s=1.0, device_ops=lambda: [], idle_gaps=lambda: [])
    monkeypatch.setattr(cells, "reader", lambda m: types.SimpleNamespace(
        read=lambda ctx: share if "_roofline" in m else None))
    line = run.result_line(cells.load_benchmark(), ENCODE, 1, "cpu", True,
                           got, 700.0)
    assert line["correct"] is correct
    assert line["compared"]["k2_roofline.encode"] == {"value": share,
                                                      "limit": 100.0}
    assert line["device"]["power_limit_w"] == 700.0
