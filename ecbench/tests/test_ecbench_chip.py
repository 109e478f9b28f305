"""The cells at a small size on the card, traced: correct, with the
kernels in the trace, and their control not correct.  Run on a machine
with a CUDA card: python -m pytest ecbench/tests -m chip"""

import pytest
import torch

from ecbench.tests import small

CELLS = ["rs10_4-1000mb.encode"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_small_cell_on_the_card(name, tmp_path):
    _card()
    line = small.result(small.cell(name, tmp_path, device="cuda"),
                        seconds=2.0, trace=True)
    assert line["correct"], line
    assert line["device"]["busy_s"] > 0
    assert any("rs_crc" in op for op, _ in line["breakdown"]["device_ops"])
    roof = [v["value"] for k, v in line["metrics"].items()
            if "roofline" in k]
    assert roof and all(0 < r <= 100 for r in roof)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name, tmp_path):
    _card()
    line = small.result(small.cell(name, tmp_path, device="cuda",
                                   control=True), seconds=0.5)
    assert not line["correct"], line
