"""The training epoch loop.

Counterpart of ``toist_tpu/train/engine.py:train_one_epoch``: iterate the
bucketed batches of a ``toist_tpu_torch.data.batcher.BatchIterator``, copy
each to the model's device from pinned memory, run the train step, and read
the scalars back (a host sync) only every ``print_freq`` steps and at the
last one, stopping the process on a non-finite loss as the reference does
(engine.py:82-85).
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, Tuple

from toist_tpu_torch.data.batcher import BatchIterator
from toist_tpu_torch.utils.logging import MetricLogger
from toist_tpu_torch.train.state import TrainState
from toist_tpu_torch.train.step import TRAIN_KEYS, batch_to_device

LOGGED = ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm",
          "loss_contrastive_align")


def train_one_epoch(train_step: Callable, state: TrainState,
                    batch_iter: BatchIterator, epoch: int,
                    print_freq: int = 10) -> Tuple[TrainState,
                                                   Dict[str, float]]:
    logger = MetricLogger(print_freq=print_freq, header=f"Epoch [{epoch}]")
    device = state.masters[0][1].device
    n_batches = len(batch_iter)
    for i, batch in enumerate(logger.log_every(batch_iter.epoch(epoch),
                                               total=n_batches)):
        state, scalars = train_step(
            state, batch_to_device(batch, device, TRAIN_KEYS))
        if i % print_freq == 0 or i == n_batches - 1:
            host = {k: float(v) for k, v in scalars.items()}
            if not host["loss_is_finite"]:
                print(f"Loss is not finite: {host}", flush=True)
                sys.exit(1)
            logger.update(**{k: host[k] for k in LOGGED if k in host})
    return state, logger.summary()
