"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped, the rest of a run is driven at a
tiny size on the CPU with the cells' own limits."""
from __future__ import annotations

import time

import pytest

from benchmark import faults, run, serve, train
from benchmark.tests.tiny import tiny_cell

DEVICE = {"platform": "cpu", "kind": "test", "count": 1,
          "memory_peak_bytes": 0}


def _serve(fault=None):
    # A 2 s window answers every entry of the tiny pool even on a loaded
    # host, so the check compares the same calls in every run.
    cell = tiny_cell("r101-serve-b8")
    rec = serve.run(cell, 21, 2.0, False, time.perf_counter(), "cpu",
                    predictor_hook=fault)
    return run.result_line(cell, rec, False, DEVICE)[0]


def _train(fault=None):
    cell = tiny_cell("r101-train-b6")
    rec = train.run(cell, 23, 0.3, False, time.perf_counter(), "cpu",
                    step_hook=fault)
    return run.result_line(cell, rec, False, DEVICE)[0]


def test_sound_runs_are_correct():
    for out in (_serve(), _train()):
        assert out["correct"] is True
        assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault, numbers", [
    ("altered_answer", ["box_gap"]),
    # The pairing joins each score to the nearer of the two queries, so
    # the swap reads in whichever of the two gaps is the smaller.
    ("swapped_boxes", ["score_gap", "box_gap"]),
    ("reversed_order", ["unsorted"])])
def test_an_altered_answer_is_not_correct(fault, numbers):
    out = _serve(faults.SERVE[fault])
    assert out["correct"] is False
    assert any(out["check"][n]["value"] > out["check"][n]["limit"]
               for n in numbers)


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
def test_a_broken_step_is_not_correct(fault):
    out = _train(faults.TRAIN[fault])
    assert out["correct"] is False
