"""The plain reference against the program's plain path at a tiny size on
the CPU (a test may import both; the reference imports nothing of the
program)."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import serve, train
from benchmark.reference.toist import hashed_keep
from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_serving_answers_match_in_f32(seed):
    rec = serve.run(tiny_cell("r101-serve-b8"), seed, 0.3, False,
                    time.perf_counter(), device="cpu")
    n = rec["numbers"]
    assert n["score_gap"] < 1e-3 and n["box_gap"] < 1e-5
    assert n["unsorted"] == 0


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 17])
def test_training_steps_match_in_f32(seed):
    """Three steps with dropout 0.1 on both sides: the reference draws the
    program's dropout streams in its order and matches its losses, first
    gradient, change and EMA."""
    rec = train.run(tiny_cell("r101-train-b6"), seed, 0.3, False,
                    time.perf_counter(), device="cpu")
    n = rec["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-3
    assert n["change_gap"] < 1e-3 and n["ema_change_gap"] < 1e-2


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 62 - 7])
def test_hashed_dropout_mask_is_the_kernels(seed):
    from toist_tpu_torch.ops.flash_attention import dropout_keep_mask_plain

    for shape in ((2, 3, 7, 9), (1, 8, 100, 333)):
        got = hashed_keep(torch.tensor([seed]), *shape, 26)
        want = dropout_keep_mask_plain(seed, *shape, 0.1)
        assert torch.equal(got, want)
