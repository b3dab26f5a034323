"""The control comes out not correct and the program correct, at each
cell's own size on the card, three seeds each: the float8 control of
``benchmark/control.py``, and the program's side as the timed path gives
it (a short serving run; training's checked steps). Run on a machine
with an H100: ``python -m pytest benchmark/tests -m cuda``."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import cells, check, control, serve

SEEDS = (7001, 7002, 7003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size on the card")


def _fails(cell, gaps) -> bool:
    return not all(r["ok"] for r in check.judge(gaps, cell.limits))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["r101-serve-b8"])
def test_serving_control_fails_and_program_passes(card, name):
    """The program's side is a short run of the cell's own timed path."""
    cell = cells.load_cell(name)
    for seed in SEEDS:
        rec = serve.run(cell, seed, 2.0, False, time.perf_counter())
        assert not _fails(cell, rec["numbers"]), (seed, rec["numbers"])
        gaps = control.serve_control(cell, seed)
        assert _fails(cell, gaps), (seed, gaps)


@pytest.mark.cuda
def test_training_control_fails_and_program_passes(card):
    cell = cells.load_cell("r101-train-b6")
    for seed in SEEDS:
        r = control.train_readings(cell, seed, True, True)
        assert not _fails(cell, r["program"]), (seed, r)
        assert _fails(cell, r["control"]), (seed, r)
