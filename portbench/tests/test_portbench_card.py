"""On the card: a short run of the 512-bit cell at its own size is
correct, and its control (the port's re-randomized Mult, which breaks the
configuration's determinism guarantee) is not.  Skips without a card;
on the card: python3 -m pytest portbench/tests -m card -o addopts="".
"""

import time

import pytest
import torch

from portbench import control, harness
from portbench.conftest import HERE


@pytest.mark.card
@pytest.mark.parametrize("use_control", [False, True])
def test_cell_and_control_on_card(use_control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell(HERE.parent, "bgn512-det.mult")
    hooks = {"deploy": control.control_deploy} if use_control else None
    r = harness.run_cell(cell, 2**31 + 11, 4.0, False, time.perf_counter(),
                         hooks=hooks)
    assert r["correct"] is not use_control, r["checks"]
    if use_control:
        assert r["checks"]["lanes_wrong"]["value"] > 0
