"""The comparison that decides `correct` fails what it has to: the
control (the reference in the program's place with its products in
TF32, emulated here by rounding their operands) and each fault a
one-worker train cell can have, planted in the timed path, with the rest
of a run driven as on the card. Tiny sizes on the CPU: the readings the
limits are set from are the card's, at the cells' sizes
(`bench/calibrate.py`); these tests hold the same limits."""
from __future__ import annotations

import time

import pytest
import torch

import tiny
from bench import calibrate, harness, run, train

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(name):
    c = tiny.cell(name)
    gaps = calibrate.control_gaps(c, 11, CPU)
    ok, _ = harness.judge(gaps, c["limits"])
    assert not ok, gaps


@pytest.mark.parametrize("fault", train.FAULTS)
@pytest.mark.parametrize("name", tiny.CELLS)
def test_planted_fault_is_not_correct(name, fault):
    done = run.execute(tiny.cell(name), 2 ** 35 + 1, 0.2, False, CPU,
                       time.perf_counter(), fault)
    assert done["out"]["correct"] is False, done["out"]["gaps"]
