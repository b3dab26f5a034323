"""The training state: the model, f32 master weights, AdamW, the per-group
schedules, the EMA copy and the step.

Counterpart of ``toist_tpu/train/state.py`` (the reference's {model,
model_ema, optimizer, epoch}, main.py:641-652), held as a mutable object
that the train step updates in place. With a bf16 compute dtype the model's
trunk parameters are bf16 (``TOIST.to_compute_dtype``) and the optimizer
updates f32 master copies, which are copied back after every step: the
JAX package's policy of f32 params cast to bf16 inside each op, whose
gradients are likewise bf16 products carried in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from toist_tpu_torch.config import Config
from toist_tpu_torch.train.optim import (GROUPS, freeze_parameters,
                                         label_params, make_optimizer,
                                         make_schedules)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    schedules: Dict[str, Callable[[int], float]]
    # (parameter, its f32 master) for every trainable parameter; the master
    # is the parameter itself when that is f32.
    masters: List[Tuple[torch.nn.Parameter, torch.Tensor]]
    # f32 EMA of every trainable parameter, by name (None: EMA off).
    ema: Optional[Dict[str, torch.Tensor]]
    step: int = 0


def init_train_state(model: torch.nn.Module, cfg: Config,
                     steps_per_epoch: int, total_steps: int) -> TrainState:
    """Freeze, group and wrap ``model`` (on its device, in its compute
    dtype) for training."""
    labels = label_params(model, cfg.model.frozen_detector,
                          cfg.model.freeze_text_encoder)
    freeze_parameters(model, labels)
    masters, groups = [], {g: [] for g in GROUPS}
    names = []
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            continue
        m = p if p.dtype == torch.float32 else p.detach().float().clone()
        masters.append((p, m))
        groups[labels[name]].append(m)
        names.append(name)
    ema = ({n: m.detach().clone() for n, (_, m) in zip(names, masters)}
           if cfg.optim.ema else None)
    return TrainState(model=model,
                      optimizer=make_optimizer(groups, cfg.optim),
                      schedules=make_schedules(cfg.optim, steps_per_epoch,
                                               total_steps),
                      masters=masters, ema=ema)
