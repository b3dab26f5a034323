"""The training state: the model, f32 master weights, AdamW, the per-group
schedules, the EMA copy and the step.

Counterpart of ``toist_tpu/train/state.py`` (the reference's {model,
model_ema, optimizer, epoch}, main.py:641-652), held as a mutable object
that the train step updates in place. With a bf16 compute dtype the model's
trunk parameters are bf16 (``TOIST.to_compute_dtype``) and the optimizer
updates f32 master copies, which are copied back after every step: the
JAX package's policy of f32 params cast to bf16 inside each op, whose
gradients are likewise bf16 products carried in f32.

Distillation adds the teacher (the reference's model_noun), its EMA and the
cluster bank (``toist_tpu/train/state.py:22-24``). The teacher trains
beside the student under the same AdamW: its masters follow the student's
in ``masters``, and each of the optimizer's groups holds the student's
tensors of that group, then the teacher's. With more than one rank and
``run.shard_opt_state`` (the default, as in JAX, ``toist_tpu/config.py:
238``) the optimizer is ZeRO-1: each rank keeps a share of the moments.
Under tensor parallelism the model holds this rank's shards (``parallel/
tp.shard_model``, before this state is built), the masters, EMA and
moments are shards too, and ZeRO-1 runs over the data group on them (as
JAX's ``_zero1_spec(base=tp_spec)`` composes the two).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from toist_tpu_torch.config import Config
from toist_tpu_torch.train.cluster import ClusterBank
from toist_tpu_torch.train.optim import (GROUPS, freeze_parameters,
                                         label_params, make_optimizer,
                                         make_schedules)
from toist_tpu_torch.utils import dist


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedules: Dict[str, Callable[[int], float]]
    # (parameter, its f32 master) for every trainable parameter; the master
    # is the parameter itself when that is f32.
    masters: List[Tuple[torch.nn.Parameter, torch.Tensor]]
    # f32 EMA of every trainable parameter, by name (None: EMA off).
    ema: Optional[Dict[str, torch.Tensor]]
    step: int = 0
    # Distillation only: the teacher, its EMA (by name) and the bank.
    teacher: Optional[torch.nn.Module] = None
    teacher_ema: Optional[Dict[str, torch.Tensor]] = None
    cluster_bank: Optional[ClusterBank] = None


def init_train_state(model: torch.nn.Module, cfg: Config,
                     steps_per_epoch: int, total_steps: int,
                     teacher: Optional[torch.nn.Module] = None,
                     cluster_bank: Optional[ClusterBank] = None
                     ) -> TrainState:
    """Freeze, group and wrap ``model`` (on its device, in its compute
    dtype), and the ``teacher`` when given, for training."""
    masters, groups, emas = [], {g: [] for g in GROUPS}, []
    for mod in (model, teacher):
        if mod is None:
            continue
        labels = label_params(mod, cfg.model.frozen_detector,
                              cfg.model.freeze_text_encoder)
        freeze_parameters(mod, labels)
        ema = {} if cfg.optim.ema else None
        for name, p in mod.named_parameters():
            if labels[name] == "frozen":
                continue
            m = p if p.dtype == torch.float32 else p.detach().float().clone()
            masters.append((p, m))
            groups[labels[name]].append(m)
            if ema is not None:
                ema[name] = m.detach().clone()
        emas.append(ema)
    return TrainState(model=model,
                      optimizer=make_optimizer(
                          groups, cfg.optim,
                          zero1=cfg.run.shard_opt_state
                          and dist.data_count() > 1),
                      schedules=make_schedules(cfg.optim, steps_per_epoch,
                                               total_steps),
                      masters=masters, ema=emas[0], teacher=teacher,
                      teacher_ema=emas[1] if teacher is not None else None,
                      cluster_bank=cluster_bank)


def model_masters(state: TrainState, teacher: bool = False
                  ) -> List[Tuple[str, torch.nn.Parameter, torch.Tensor]]:
    """(name, parameter, master) of the student's (or the teacher's)
    trainable parameters, in the order of ``state.masters``."""
    model = state.teacher if teacher else state.model
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names[id(p)], p, m) for p, m in state.masters if id(p) in names]


@torch.no_grad()
def load_masters(state: TrainState, weights: Mapping[str, torch.Tensor],
                 ema: Optional[Mapping[str, torch.Tensor]] = None,
                 teacher: bool = False) -> None:
    """Set the f32 masters of the student's (or the teacher's) trainable
    parameters from ``weights`` (a reference-layout state dict, by name)
    and the model's parameters to them cast to its dtype; set its EMA from
    ``ema``, or to the masters when ``ema`` is None (a fresh start)."""
    own_ema = state.teacher_ema if teacher else state.ema
    for name, p, m in model_masters(state, teacher):
        m.copy_(weights[name])
        if m is not p:
            p.copy_(m)
        if own_ema is not None:
            own_ema[name].copy_((ema if ema is not None else weights)[name])
