"""Faults planted in the timed path, for the tests that show the check
fails them and for the chip readings that bound its limits. Each is a hook
the runners accept: ``predictor_hook(predictor)`` for serving,
``step_hook(step) -> step`` for training."""
from __future__ import annotations

import torch


def altered_answer(predictor) -> None:
    """One image's boxes of every call moved by 5% of their coordinates,
    as an answer altered where it is produced."""
    inner = predictor.predict_batch

    def predict_batch(batch):
        res = inner(batch)
        res[0]["boxes"] = res[0]["boxes"] * 1.05
        return res

    predictor.predict_batch = predict_batch


def swapped_boxes(predictor) -> None:
    """One image's best and worst answers trade boxes in every call, as
    scores joined to the wrong queries."""
    inner = predictor.predict_batch

    def predict_batch(batch):
        res = inner(batch)
        res[0]["boxes"] = res[0]["boxes"].copy()
        res[0]["boxes"][[0, -1]] = res[0]["boxes"][[-1, 0]]
        return res

    predictor.predict_batch = predict_batch


def reversed_order(predictor) -> None:
    """One image's answers come worst first in every call."""
    inner = predictor.predict_batch

    def predict_batch(batch):
        res = inner(batch)
        res[0] = {k: v[::-1] for k, v in res[0].items()}
        return res

    predictor.predict_batch = predict_batch


def half_batch(step):
    """The step sees the first half of each batch: its mean is taken over
    the rest."""
    def broken(state, batch):
        n = batch["images"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})

    return broken


def unchanged_state(step):
    """The step computes its losses and returns the state as it was."""
    def broken(state, batch):
        masters = [m.detach().clone() for _, m in state.masters]
        ema = {k: v.clone() for k, v in (state.ema or {}).items()}
        state, scalars = step(state, batch)
        with torch.no_grad():
            for (p, m), m0 in zip(state.masters, masters):
                m.copy_(m0)
                if p is not m:
                    p.copy_(m0)
            for k, v in ema.items():
                state.ema[k].copy_(v)
        return state, scalars

    return broken


SERVE = {"altered_answer": altered_answer, "swapped_boxes": swapped_boxes,
         "reversed_order": reversed_order}
TRAIN = {"half_batch": half_batch, "unchanged_state": unchanged_state}
