"""Noun-pronoun distillation: the dual-model train step. (Its eval, the
cluster eval, is ``train/step.make_eval_step`` given the bank.)

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
from toist_tpu_torch.infer import INPUT_KEYS
from toist_tpu_torch.train import cluster as cl
from toist_tpu_torch.train import criterion as crit
from toist_tpu_torch.train.state import TrainState
from toist_tpu_torch.train.step import (accumulate_gradients,
                                        apply_gradients, dropout_generator,
                                        train_batch_to_device)
from toist_tpu_torch.utils.tracing import span, spanned


def distillation_losses(state: TrainState,
                        batches: Mapping[str, Mapping[str, torch.Tensor]],
                        cfg: Config, weight_dict: Mapping[str, float],
                        micro: int = 0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One microbatch of a distillation pair {"noun": Batch, "sth": Batch}
    -> (weighted total, losses incl. "loss" and the "_*tgt2query*"
    matchings). Moves ``state.cluster_bank`` on under ``loss.cluster``,
    and adds the two bank calls' k-means counters as "_kmeans_iters" (on
    the device) and "_kmeans_issued" (a host integer). Four dropout
    generators stand for JAX's r1..r4: the teacher's encode and decode,
    the student's encode and decode."""
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
        state.cluster_bank, tcache["img_memory_mod"], taux = \
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
        for k in ("kmeans_iters", "kmeans_issued"):
            losses[f"_{k}"] = taux[k] + saux[k]
    sout = student.decode(scache, use_modified_memory=lcfg.cluster,
                          generator=r4)

    losses.update(crit.set_criterion(tout, noun_b, lcfg, prefix="noun_"))
    losses.update(crit.set_criterion(sout, sth_b, lcfg, prefix="sth_"))
    bv, sv = sth_b["box_valid"], sth_b["sample_valid"]
    num_samples = sth_b.get("num_samples_override")
    if lcfg.softkd_loss:
        with span("toist.softkd"):
            # Levels aux 0..n-1, then main, in one re-pairing solve.
            n_aux = (tout["aux_pred_logits"].shape[0]
                     if lcfg.aux_loss and "aux_pred_logits" in tout else 0)

            def cat(o, k):
                main = o[k][None]
                return torch.cat([o[f"aux_{k}"], main]) if n_aux else main

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
    teacher and the bank in ``state``. Under ``loss.cluster`` the scalars
    add the bank's per-task ``bank_update_count`` and ``bank_full`` ([T]
    int32), and the step's k-means counters summed over its microbatches:
    ``kmeans_iters``, the iterations that found centers moving (int32 on
    the device, read with the other scalars), and ``kmeans_issued``, the
    iterations queued (a host integer in a CPU tensor). The bank runs the
    global batch's solves on every rank, so neither is summed over the
    ranks."""

    @spanned("toist.train_step")
    def train_step(state: TrainState, batches) -> Tuple[TrainState, Dict]:
        batches = train_batch_to_device(batches, state.masters[0][1].device)
        counts = []

        def losses_fn(*args):
            total, losses = distillation_losses(*args)
            if "_kmeans_iters" in losses:
                counts.append((losses["_kmeans_iters"],
                               losses["_kmeans_issued"]))
            return total, losses

        scalars = accumulate_gradients(state, batches, cfg, weight_dict,
                                       losses_fn)
        state = apply_gradients(state, cfg, scalars)
        if state.cluster_bank is not None:
            scalars["bank_update_count"] = state.cluster_bank.update_count
            scalars["bank_full"] = state.cluster_bank.full.to(torch.int32)
        if counts:
            iters, issued = zip(*counts)
            scalars["kmeans_iters"] = sum(iters[1:], iters[0])
            scalars["kmeans_issued"] = torch.tensor(sum(issued))
        return state, scalars

    return train_step
