"""Noun-pronoun distillation: the dual-model train step and the cluster eval
step.

Counterpart of ``toist_tpu/train/distill.py`` (reference engine.py:119-250
train_one_epoch_distillation): the teacher (noun captions) forward, the
cluster bank update and the noun-span snapping, the student (pronoun
captions) forward with the "something"-span snapping and the cluster loss,
each stream's set losses (noun_ / sth_ prefixes), softkd (main and aux
levels in one re-pairing solve) and nsthl2; one backward over both models,
one clip by the global norm over both, one AdamW, the masters copied into
both models, the dual EMA. The bank changes under no gradient. Across
ranks, as the plain step (``train/step.py``): global denominators, one
reduction of both models' gradients, and the bank fed the global batch's
rows in rank order on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from toist_tpu_torch.config import Config
from toist_tpu_torch.models.postprocess import postprocess_boxes
from toist_tpu_torch.train import cluster as cl
from toist_tpu_torch.train import criterion as crit
from toist_tpu_torch.train.state import TrainState
from toist_tpu_torch.train.step import (EVAL_KEYS, INPUT_KEYS, TARGET_KEYS,
                                        _scalars, accumulate_gradients,
                                        apply_gradients, batch_to_device,
                                        dropout_generator,
                                        train_batch_to_device)


def distillation_losses(state: TrainState,
                        batches: Mapping[str, Mapping[str, torch.Tensor]],
                        cfg: Config, weight_dict: Mapping[str, float],
                        micro: int = 0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One microbatch of a distillation pair {"noun": Batch, "sth": Batch}
    -> (weighted total, losses incl. "loss" and the "_*tgt2query*"
    matchings). Moves ``state.cluster_bank`` on under ``loss.cluster``.
    Four dropout generators stand for JAX's r1..r4: the teacher's encode
    and decode, the student's encode and decode."""
    lcfg = cfg.loss
    noun_b, sth_b = batches["noun"], batches["sth"]
    teacher, student = state.teacher.train(), state.model.train()
    device = state.masters[0][1].device
    r1, r2, r3, r4 = (dropout_generator(device, cfg.run.seed, state.step,
                                        micro, stream)
                      for stream in range(1, 5))

    # Teacher (noun) stream.
    tcache = teacher.encode(*(noun_b[k] for k in INPUT_KEYS), generator=r1)
    if lcfg.cluster:
        state.cluster_bank, tcache["img_memory_mod"], _ = \
            cl.teacher_update_and_snap(
                state.cluster_bank, tcache, noun_b, lcfg.kmeans_max_iters,
                lcfg.kmeans_tol, lcfg.fifo_memory, across_ranks=True)
    tout = teacher.decode(tcache, use_modified_memory=lcfg.cluster,
                          generator=r2)

    # Student (pronoun) stream.
    scache = student.encode(*(sth_b[k] for k in INPUT_KEYS), generator=r3)
    losses: Dict[str, torch.Tensor] = {}
    if lcfg.cluster:
        state.cluster_bank, scache["img_memory_mod"], saux = \
            cl.student_cluster(state.cluster_bank, scache, sth_b,
                               lcfg.kmeans_max_iters, lcfg.kmeans_tol,
                               train=True,
                               num_valid=sth_b.get("num_with_span_override"),
                               across_ranks=True)
        losses["loss_cluster_feature"] = saux["loss_cluster_feature"]
        losses["loss_cluster_choice"] = saux["loss_cluster_choice"]
    sout = student.decode(scache, use_modified_memory=lcfg.cluster,
                          generator=r4)

    losses.update(crit.set_criterion(tout, noun_b, lcfg, prefix="noun_"))
    losses.update(crit.set_criterion(sout, sth_b, lcfg, prefix="sth_"))
    bv, sv = sth_b["box_valid"], sth_b["sample_valid"]
    num_samples = sth_b.get("num_samples_override")
    if lcfg.softkd_loss:
        if lcfg.aux_loss and "aux_pred_logits" in tout:
            # Levels aux 0..n-1, then main, in one re-pairing solve.
            n_aux = tout["aux_pred_logits"].shape[0]

            def cat(o, k):
                return torch.cat([o[f"aux_{k}"], o[k][None]])

            def t2q(p):
                return torch.stack([losses[f"_{p}_tgt2query_{i}"]
                                    for i in range(n_aux)]
                                   + [losses[f"_{p}_tgt2query"]])

            kd = crit.loss_softkd_levels(
                cat(tout, "pred_logits"), cat(sout, "pred_logits"),
                cat(tout, "pred_boxes"), cat(sout, "pred_boxes"),
                t2q("noun"), t2q("sth"), bv, sv, num_samples)
            losses["loss_softkd"] = kd[-1]
            for i in range(n_aux):
                losses[f"loss_softkd_{i}"] = kd[i]
        else:
            losses["loss_softkd"] = crit.loss_softkd(
                tout["pred_logits"], sout["pred_logits"],
                tout["pred_boxes"], sout["pred_boxes"],
                losses["_noun_tgt2query"], losses["_sth_tgt2query"], bv, sv,
                num_samples)
    if lcfg.nsthl2_loss:
        losses["loss_nsthl2"] = crit.loss_nsthl2(
            tcache["text_memory"], scache["text_memory"],
            noun_b["noun_token_spans"], sth_b["noun_token_spans"], bv, sv,
            sth_b.get("num_with_boxes_override"))
    total = crit.total_loss(losses, weight_dict)
    losses["loss"] = total
    return total, losses


def make_distillation_train_step(cfg: Config,
                                 weight_dict: Mapping[str, float]
                                 ) -> Callable:
    """(state, {"noun": Batch, "sth": Batch}) -> (state, scalars), with the
    teacher and the bank in ``state``. The scalars add the bank's per-task
    ``bank_update_count`` and ``bank_full`` ([T] int32)."""

    def train_step(state: TrainState, batches) -> Tuple[TrainState, Dict]:
        batches = train_batch_to_device(batches, state.masters[0][1].device)
        scalars = accumulate_gradients(state, batches, cfg, weight_dict,
                                       distillation_losses)
        state = apply_gradients(state, cfg, scalars)
        if state.cluster_bank is not None:
            scalars["bank_update_count"] = state.cluster_bank.update_count
            scalars["bank_full"] = state.cluster_bank.full.to(torch.int32)
        return state, scalars

    return train_step


def make_cluster_eval_step(model: torch.nn.Module, cfg: Config,
                           weight_dict: Mapping[str, float]) -> Callable:
    """(bank, batch) -> {"post", "scalars"}: the eval step with the
    "something" span snapped to its cluster center between encode and
    decode (reference engine.py:288-291, mdetr.py:282-312). The bank is
    read only: the refreshed centers are thrown away. Under
    ``model.masks`` it adds "pred_masks" from the unsnapped memory
    (``toist_tpu/train/distill.py:217-220``; eval_seg_dis).
    ``run.compute_eval_losses`` False skips the criterion."""
    lcfg = cfg.loss

    @torch.inference_mode()
    def eval_step(bank: cl.ClusterBank, batch):
        model.eval()
        device = next(model.parameters()).device
        keys = EVAL_KEYS + ("caption_noun_span", "task_id") + (
            TARGET_KEYS if cfg.run.compute_eval_losses else ("sample_valid",))
        x = batch_to_device(batch, device, keys)
        cache = model.encode(*(x[k] for k in INPUT_KEYS))
        _, cache["img_memory_mod"], _ = cl.student_cluster(
            bank, cache, x, lcfg.kmeans_max_iters, lcfg.kmeans_tol,
            train=False)
        out = model.decode(cache, use_modified_memory=True)
        scalars = {}
        if cfg.run.compute_eval_losses:
            losses = crit.set_criterion(out, x, lcfg)
            losses["loss"] = crit.total_loss(losses, weight_dict)
            scalars = _scalars(losses)
        post = postprocess_boxes(out["pred_logits"], out["pred_boxes"],
                                 x["orig_size"])
        result = {"post": post, "scalars": scalars}
        if cfg.model.masks:
            result["pred_masks"] = model.compute_masks(cache, out["hs"][-1])
        return result

    return eval_step
