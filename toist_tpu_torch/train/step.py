"""The train and eval steps.

Counterpart of ``toist_tpu/train/step.py``. One train step (reference
engine.py:23-116): forward in training mode with the step's dropout
generator, the set criterion with its on-device Hungarian matching, the
weighted total, backward, gradient accumulation over microbatches,
``clip_grad_norm_`` over the trainable parameters, AdamW with the per-group
schedules, EMA. The NaN guard is the ``loss_is_finite`` scalar; the epoch
loop decides to stop. With ``loss.cluster`` the step snaps the "something"
span to its cluster center between encode and decode and threads the bank
through ``TrainState.cluster_bank``. With masks (segmentation) the mask
head runs on the matched queries and adds the focal and dice losses; under
``model.frozen_detector`` the detector's forward builds no autograd graph,
so only the mask branch has a backward. Scalars stay on the device: reading
them is the caller's host sync. The distillation step (``train/distill.py``)
shares ``accumulate_gradients`` and ``apply_gradients``.

Across ranks (``utils/dist.init_distributed``) each rank steps on its slice
of the global batch: the losses' denominators are the global batch's (one
all-reduce of the counts per step), the gradients and scalars are summed
over the ranks before the clip (``parallel/data.reduce_gradients``), every
rank applies the same update, and the dropout streams differ by rank.
Under tensor parallelism (``parallel/tp.py``) those ranks are the data
group's: the ranks of a model group run the same batch on one replica, so
the dropout stream folds the data index, and the clip sees the norm of the
whole replica (``tp.clip_grad_norm_``).
"""
from __future__ import annotations

from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from toist_tpu_torch.config import Config
from toist_tpu_torch.models.postprocess import postprocess_boxes
from toist_tpu_torch.parallel import data as dp
from toist_tpu_torch.parallel import tp
from toist_tpu_torch.train import cluster as cl
from toist_tpu_torch.train import criterion as crit
from toist_tpu_torch.train.optim import ema_update
from toist_tpu_torch.train.state import TrainState, model_masters
from toist_tpu_torch.utils import dist

INPUT_KEYS = ("images", "image_mask", "text_ids", "text_mask")
TARGET_KEYS = ("boxes", "positive_map", "box_valid", "sample_valid")
# What the cluster bank and the distillation losses read besides.
CLUSTER_KEYS = ("noun_token_spans", "caption_noun_span", "task_id")
MASK_KEYS = ("gt_masks",)
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


def train_batch_to_device(batch, device: torch.device
                          ) -> Dict[str, torch.Tensor]:
    """A training batch on ``device``: the train and cluster keys it has,
    or, for a distillation pair {"noun": Batch, "sth": Batch}, each
    stream's."""
    if "noun" in batch:
        return {k: train_batch_to_device(b, device) for k, b in batch.items()}
    if all(isinstance(batch[k], torch.Tensor) for k in TRAIN_KEYS):
        return dict(batch)
    return batch_to_device(batch, device, [
        k for k in TRAIN_KEYS + CLUSTER_KEYS + MASK_KEYS if k in batch])


def dropout_generator(device: torch.device, seed: int, step: int,
                      micro: int = 0, stream: int = 0) -> torch.Generator:
    """The step's dropout randomness (``make_dropout_rng``: the run seed
    folded with the step, and with the microbatch under accumulation);
    ``stream`` tells apart the distillation step's four forward halves
    (JAX's r1..r4). The data index is folded in too: the attention
    kernels hash a sample's local batch index, so without it every replica
    would drop the same elements of its sample 0, where JAX's global array
    gives each sample its own bits. It is the data index and not the rank,
    so that the ranks of a model group draw in lockstep."""
    g = torch.Generator(device=device)
    g.manual_seed((((seed * 1_000_003 + step) * 1_009 + micro)
                   + stream * 0x9E3779B97F4A7C15
                   + dist.data_index() * 0xD1B54A32D192ED03) % 2 ** 63)
    return g


def forward_losses(model: torch.nn.Module, batch: Mapping[str, torch.Tensor],
                   cfg: Config, weight_dict: Mapping[str, float],
                   generator: Optional[torch.Generator] = None,
                   bank: Optional[cl.ClusterBank] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Optional[cl.ClusterBank]]:
    """Forward + criterion -> (weighted total, losses incl. "_tgt2query*"
    matchings and "loss", the bank). With a cluster ``bank``
    (``loss.cluster`` without distillation, step.py:127-177), the
    "something" span is snapped to its cluster center between encode and
    decode, with no cluster loss; the bank's centers move on. With
    ``model.masks`` the mask head runs on the matched queries (the matching
    detached) and adds "loss_mask" and "loss_dice" (step.py:164-173).
    Under ``model.frozen_detector`` the detector's forward runs without
    autograd: the counterpart of ``stop_frozen_gradients``, and no
    attention backward."""
    args = [batch[k] for k in INPUT_KEYS]
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not cfg.model.frozen_detector):
        if bank is None:
            out, cache = model(*args, generator=generator)
        else:
            cache = model.encode(*args, generator=generator)
            bank, cache["img_memory_mod"], _ = cl.student_cluster(
                bank, cache, batch, cfg.loss.kmeans_max_iters,
                cfg.loss.kmeans_tol, train=False, across_ranks=True)
            out = model.decode(cache, use_modified_memory=True,
                               generator=generator)
        losses = crit.set_criterion(out, batch, cfg.loss)
    if cfg.model.masks:
        pred_masks_sel = model.compute_masks(
            cache, out["hs"][-1], losses["_tgt2query"].detach())
        losses.update(crit.mask_losses(
            pred_masks_sel, batch["gt_masks"], batch["box_valid"],
            batch["sample_valid"],
            num_boxes=batch.get("num_boxes_override")))
    total = crit.total_loss(losses, weight_dict)
    losses["loss"] = total
    return total, losses, bank


def _scalars(losses: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in losses.items() if not k.startswith("_")}


def _plain_losses(state: TrainState, batch: Mapping[str, torch.Tensor],
                  cfg: Config, weight_dict: Mapping[str, float], micro: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    g = dropout_generator(state.masters[0][1].device, cfg.run.seed,
                          state.step, micro)
    total, losses, state.cluster_bank = forward_losses(
        state.model.train(), batch, cfg, weight_dict, g, state.cluster_bank)
    return total, losses


def _with_normalisers(micro: List[Dict[object, Dict[str, torch.Tensor]]],
                      accum: int) -> None:
    """Put the global denominators into each microbatch of each stream: the
    step's valid-box count / A (``num_boxes_override``, as JAX's
    accumulation passes it) and the microbatch's counts of valid samples,
    of samples with a box and of samples with a caption span, each summed
    over the ranks (one all-reduce) and clamped to 1."""
    counts = torch.stack([torch.stack([crit.normaliser_counts(b)
                                       for b in mb.values()])
                          for mb in micro])                     # [A, S, 4]
    dist.all_reduce_sum(counts)
    num_boxes = counts[..., 0].sum(0).clamp(min=1.0) / accum      # [S]
    counts = counts.clamp(min=1.0)
    for i, mb in enumerate(micro):
        for j, b in enumerate(mb.values()):
            b.update(num_boxes_override=num_boxes[j],
                     num_samples_override=counts[i, j, 1],
                     num_with_boxes_override=counts[i, j, 2],
                     num_with_span_override=counts[i, j, 3])


def accumulate_gradients(state: TrainState, batch: Mapping[str, torch.Tensor],
                         cfg: Config, weight_dict: Mapping[str, float],
                         losses_fn: Callable = _plain_losses
                         ) -> Dict[str, torch.Tensor]:
    """Forward and backward over ``optim.grad_accum_steps`` = A microbatches
    of ``batch`` (``accumulate_gradients``, step.py:62-119), leaving the mean
    gradient on the f32 masters (zero for a trainable parameter the loss
    does not reach, as in optax). Each microbatch is normalised by the
    batch's valid-box count / A (per stream for a distillation pair), so the
    result equals one pass over the whole batch; each draws its own dropout
    generators. The cluster bank threads through the microbatches in order.
    Across ranks every count is the global batch's (``_with_normalisers``),
    so each rank's gradient is its share of the global batch's.
    ``losses_fn(state, microbatch, cfg, weight_dict, i) -> (total, losses)``
    runs one microbatch's forward (``_plain_losses``, or distillation's).
    Returns the microbatch-mean scalars (this rank's shares)."""
    accum = max(1, cfg.optim.grad_accum_steps)
    streams = batch if "box_valid" not in batch else {None: batch}
    B = next(iter(streams.values()))["images"].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} is not {accum} microbatches")
    n = B // accum
    micro = [{s: {k: v[i * n:(i + 1) * n] for k, v in b.items()}
              for s, b in streams.items()} for i in range(accum)]
    _with_normalisers(micro, accum)
    sums: Dict[str, torch.Tensor] = {}
    for i, mb in enumerate(micro):
        total, losses = losses_fn(state, mb[None] if None in mb else mb, cfg,
                                  weight_dict, i)
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


def apply_gradients(state: TrainState, cfg: Config,
                    scalars: Dict[str, torch.Tensor]) -> TrainState:
    """The gradients and ``scalars`` summed over the ranks
    (``reduce_gradients``), then ``clip_grad_norm_`` over every trainable
    master (both models' in distillation), AdamW at the groups' scheduled
    lr, the masters copied into the models' parameters, the EMA of each
    model, the step. Adds "grad_norm" and "loss_is_finite" to
    ``scalars``."""
    masters = [m for _, m in state.masters]
    dp.reduce_gradients([m.grad for m in masters], scalars)
    scalars["grad_norm"] = tp.clip_grad_norm_(
        [m.grad for m in masters],
        [hasattr(p, "tp_spec") for p, _ in state.masters],
        cfg.optim.clip_max_norm)
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedules[group["name"]](state.step)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        for p, m in state.masters:
            if m is not p:
                p.copy_(m)
    for ema, teacher in ((state.ema, False), (state.teacher_ema, True)):
        if ema is not None:
            ema_update(list(ema.values()),
                       [m for _, _, m in model_masters(state, teacher)],
                       cfg.optim.ema_decay)
    state.step += 1
    scalars["loss_is_finite"] = torch.isfinite(scalars["loss"])
    return state


def make_train_step(cfg: Config, weight_dict: Mapping[str, float]
                    ) -> Callable:
    """(state, batch) -> (state, scalars): ``accumulate_gradients``, then
    ``apply_gradients``. ``batch`` is a batcher ``Batch`` (numpy, copied
    here) or its tensors already on the model's device (with
    ``model.masks`` it carries "gt_masks")."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = train_batch_to_device(batch, state.masters[0][1].device)
        scalars = accumulate_gradients(state, batch, cfg, weight_dict)
        return apply_gradients(state, cfg, scalars), scalars

    return train_step


@torch.inference_mode()
def eval_forward(model: torch.nn.Module, batch: Mapping[str, np.ndarray]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Forward + postprocess of one batch -> (model outputs, postprocessed
    scores/labels/boxes). A model with a mask head adds "pred_masks"
    [B, Q, H/4, W/4] to the outputs."""
    device = next(model.parameters()).device
    x = batch_to_device(batch, device)
    out, cache = model(x["images"], x["image_mask"], x["text_ids"],
                       x["text_mask"])
    if model.cfg.masks:
        out["pred_masks"] = model.compute_masks(cache, out["hs"][-1])
    post = postprocess_boxes(out["pred_logits"], out["pred_boxes"],
                             x["orig_size"])
    return out, post


def make_eval_step(model: torch.nn.Module, cfg: Config,
                   weight_dict: Mapping[str, float]) -> Callable:
    """batch -> {"post": postprocessed detections, "scalars": eval losses},
    and with ``model.masks`` "pred_masks", every query's stride-4 logits.
    ``run.compute_eval_losses`` False skips the criterion and its matching
    (scalars {}); predictions are the same either way."""

    @torch.inference_mode()
    def eval_step(batch):
        model.eval()
        device = next(model.parameters()).device
        keys = EVAL_KEYS + (TARGET_KEYS if cfg.run.compute_eval_losses
                            else ())
        x = batch_to_device(batch, device, keys)
        out, cache = model(x["images"], x["image_mask"], x["text_ids"],
                           x["text_mask"])
        scalars = {}
        if cfg.run.compute_eval_losses:
            losses = crit.set_criterion(out, x, cfg.loss)
            losses["loss"] = crit.total_loss(losses, weight_dict)
            scalars = _scalars(losses)
        post = postprocess_boxes(out["pred_logits"], out["pred_boxes"],
                                 x["orig_size"])
        result = {"post": post, "scalars": scalars}
        if cfg.model.masks:
            result["pred_masks"] = model.compute_masks(cache, out["hs"][-1])
        return result

    return eval_step
