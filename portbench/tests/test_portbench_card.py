"""Each cell at its own size on the card, with a short window: the program
passes the check, and the control in its place (a match taken on a 16-bit
hash, bytes not compared) fails it. Needs a CUDA device; run there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench_tiny import SEED, cells

from portbench import run
from portbench.control import control_program


def _need_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the program's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_cell_on_card(workload):
    _need_card()
    r = run.run_cell(workload, SEED, 2.0, False, t_start=time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_control_on_card(workload):
    _need_card()
    r = run.run_cell(workload, SEED + 1, 2.0, False, t_start=time.perf_counter(),
                     program=control_program(workload, 16))
    assert r["correct"] is False
