"""The train and eval steps.

Counterpart of ``toist_tpu/train/step.py``. One train step (reference
engine.py:23-116): forward in training mode with the step's dropout
generator, the set criterion with its on-device Hungarian matching, the
weighted total, backward, gradient accumulation over microbatches,
``clip_grad_norm_`` over the trainable parameters, AdamW with the per-group
schedules, EMA. The NaN guard is the ``loss_is_finite`` scalar; the epoch
loop decides to stop. Scalars stay on the device: reading them is the
caller's host sync.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from toist_tpu_torch.config import Config
from toist_tpu_torch.models.postprocess import postprocess_boxes
from toist_tpu_torch.train import criterion as crit
from toist_tpu_torch.train.optim import ema_update
from toist_tpu_torch.train.state import TrainState

INPUT_KEYS = ("images", "image_mask", "text_ids", "text_mask")
TARGET_KEYS = ("boxes", "positive_map", "box_valid", "sample_valid")
EVAL_KEYS = INPUT_KEYS + ("orig_size",)
TRAIN_KEYS = INPUT_KEYS + TARGET_KEYS


def batch_to_device(batch: Mapping[str, np.ndarray], device: torch.device,
                    keys: Sequence[str] = EVAL_KEYS
                    ) -> Dict[str, torch.Tensor]:
    """``keys`` of a batcher ``Batch`` (numpy) as tensors on ``device``;
    copies to a CUDA device go from pinned memory, asynchronously."""
    device = torch.device(device)
    out = {}
    for k in keys:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def _as_tensors(batch, device, keys):
    if all(isinstance(batch[k], torch.Tensor) for k in keys):
        return {k: batch[k] for k in keys}
    return batch_to_device(batch, device, keys)


def dropout_generator(device: torch.device, seed: int, step: int,
                      micro: int = 0) -> torch.Generator:
    """The step's dropout randomness (``make_dropout_rng``: the run seed
    folded with the step, and with the microbatch under accumulation)."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed * 1_000_003 + step) * 1_009 + micro) % 2 ** 63)
    return g


def forward_losses(model: torch.nn.Module, batch: Mapping[str, torch.Tensor],
                   cfg: Config, weight_dict: Mapping[str, float],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + criterion -> (weighted total, losses incl. "_tgt2query*"
    matchings and "loss")."""
    out, _ = model(batch["images"], batch["image_mask"], batch["text_ids"],
                   batch["text_mask"], generator=generator)
    losses = crit.set_criterion(out, batch, cfg.loss)
    total = crit.total_loss(losses, weight_dict)
    losses["loss"] = total
    return total, losses


def _scalars(losses: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in losses.items() if not k.startswith("_")}


def accumulate_gradients(state: TrainState, batch: Mapping[str, torch.Tensor],
                         cfg: Config, weight_dict: Mapping[str, float]
                         ) -> Dict[str, torch.Tensor]:
    """Forward and backward over ``optim.grad_accum_steps`` = A microbatches
    of ``batch`` (``accumulate_gradients``, step.py:62-119), leaving the mean
    gradient on the f32 masters (zero for a trainable parameter the loss
    does not reach, as in optax). Each microbatch is normalised by the
    batch's valid-box count / A, so the result equals one pass over the
    whole batch; each draws its own dropout generator. Returns the
    microbatch-mean scalars."""
    accum = max(1, cfg.optim.grad_accum_steps)
    model = state.model.train()
    B = batch["images"].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} is not {accum} microbatches")
    n = B // accum
    num_boxes = crit.compute_num_boxes(batch["box_valid"],
                                       batch["sample_valid"])
    device = state.masters[0][1].device
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        if accum > 1:
            mb["num_boxes_override"] = num_boxes / accum
        g = dropout_generator(device, cfg.run.seed, state.step, i)
        total, losses = forward_losses(model, mb, cfg, weight_dict, g)
        total.backward()
        for p, m in state.masters:               # bf16 grads -> f32 masters
            if m is not p and p.grad is not None:
                m.grad = (p.grad.float() if m.grad is None
                          else m.grad.add_(p.grad))
                p.grad = None
        for k, v in _scalars(losses).items():
            sums[k] = sums[k] + v if k in sums else v
    grads = []
    for _, m in state.masters:
        if m.grad is None:
            m.grad = torch.zeros_like(m)
        grads.append(m.grad)
    if accum > 1:
        torch._foreach_mul_(grads, 1.0 / accum)
    return {k: v / accum for k, v in sums.items()}


def make_train_step(cfg: Config, weight_dict: Mapping[str, float]
                    ) -> Callable:
    """(state, batch) -> (state, scalars): ``accumulate_gradients``, then
    ``clip_grad_norm_`` over the trainable parameters, AdamW at the groups'
    scheduled lr, the bf16 copy of the masters, EMA. ``batch`` is a batcher
    ``Batch`` (numpy, copied here) or its tensors already on the model's
    device."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = _as_tensors(batch, state.masters[0][1].device, TRAIN_KEYS)
        scalars = accumulate_gradients(state, batch, cfg, weight_dict)
        masters = [m for _, m in state.masters]
        scalars["grad_norm"] = torch.nn.utils.clip_grad_norm_(
            masters, cfg.optim.clip_max_norm)
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedules[group["name"]](state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for p, m in state.masters:
                if m is not p:
                    p.copy_(m)
        if state.ema is not None:
            ema_update(list(state.ema.values()), masters, cfg.optim.ema_decay)
        state.step += 1
        scalars["loss_is_finite"] = torch.isfinite(scalars["loss"])
        return state, scalars

    return train_step


@torch.inference_mode()
def eval_forward(model: torch.nn.Module, batch: Mapping[str, np.ndarray]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Forward + postprocess of one batch -> (model outputs, postprocessed
    scores/labels/boxes)."""
    device = next(model.parameters()).device
    x = batch_to_device(batch, device)
    out, _ = model(x["images"], x["image_mask"], x["text_ids"],
                   x["text_mask"])
    post = postprocess_boxes(out["pred_logits"], out["pred_boxes"],
                             x["orig_size"])
    return out, post


def make_eval_step(model: torch.nn.Module, cfg: Config,
                   weight_dict: Mapping[str, float]) -> Callable:
    """batch -> {"post": postprocessed detections, "scalars": eval losses}.
    ``run.compute_eval_losses`` False skips the criterion and its matching
    (scalars {}); predictions are the same either way."""

    @torch.inference_mode()
    def eval_step(batch):
        model.eval()
        device = next(model.parameters()).device
        keys = EVAL_KEYS + (TARGET_KEYS if cfg.run.compute_eval_losses
                            else ())
        x = batch_to_device(batch, device, keys)
        out, _ = model(x["images"], x["image_mask"], x["text_ids"],
                       x["text_mask"])
        scalars = {}
        if cfg.run.compute_eval_losses:
            losses = crit.set_criterion(out, x, cfg.loss)
            losses["loss"] = crit.total_loss(losses, weight_dict)
            scalars = _scalars(losses)
        post = postprocess_boxes(out["pred_logits"], out["pred_boxes"],
                                 x["orig_size"])
        return {"post": post, "scalars": scalars}

    return eval_step
