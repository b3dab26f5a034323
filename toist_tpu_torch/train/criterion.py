"""Set-prediction losses of plain detection, fixed-shape, on the device.

Counterpart of the plain-detection part of ``toist_tpu/train/criterion.py``
(reference models/mdetr.py SetCriterion): soft-token cross-entropy with eos
down-weighting, L1 + GIoU box losses over matched pairs, the logging-only
cardinality error, and the bidirectional contrastive alignment loss, each
normalised by the batch's valid-box count. All decoder levels are matched in
one assignment solve (``ops/matching.hungarian_match_levels``). Inputs follow
the batcher's ``Batch`` layout (padded targets with validity masks) and the
``tgt2query`` convention (-1 for invalid targets). The softkd, nsthl2, focal,
dice and mask losses belong to the distillation and segmentation slices.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from toist_tpu_torch.config import LossConfig
from toist_tpu_torch.ops import box_ops
from toist_tpu_torch.ops.matching import hungarian_match_levels


def _gather_queries(arr: torch.Tensor, tgt2query: torch.Tensor
                    ) -> torch.Tensor:
    """arr [B, Q, ...], tgt2query [B, N] -> [B, N, ...] (query 0 for invalid
    targets)."""
    idx = tgt2query.clamp(0, arr.shape[1] - 1).long()
    idx = idx.reshape(idx.shape + (1,) * (arr.ndim - 2)).expand(
        idx.shape + arr.shape[2:])
    return torch.gather(arr, 1, idx)


def _target_onehot(tgt2query: torch.Tensor, box_valid: torch.Tensor,
                   num_queries: int) -> torch.Tensor:
    """[B, N] -> [B, N, Q] f32: row n is the one-hot of its matched query,
    zero for invalid targets."""
    idx = torch.where(tgt2query >= 0, tgt2query, num_queries).long()
    oh = F.one_hot(idx, num_queries + 1)[..., :num_queries].float()
    return oh * box_valid[..., None].float()


def loss_labels(pred_logits: torch.Tensor, positive_map: torch.Tensor,
                tgt2query: torch.Tensor, box_valid: torch.Tensor,
                sample_valid: torch.Tensor, eos_coef: float,
                num_boxes: torch.Tensor) -> torch.Tensor:
    B, Q, L = pred_logits.shape
    logprob = torch.log_softmax(pred_logits.float(), dim=-1)
    oh = _target_onehot(tgt2query, box_valid, Q)                   # [B,N,Q]
    matched_map = torch.einsum("bnq,bnl->bql", oh, positive_map.float())
    is_matched = oh.sum(1) > 0                                     # [B, Q]
    noobj = torch.zeros(L, device=pred_logits.device)
    noobj[L - 1] = 1.0
    target_sim = torch.where(is_matched[..., None], matched_map, noobj)
    ce = -(logprob * target_sim).sum(-1)                           # [B, Q]
    w = torch.where(is_matched, 1.0, eos_coef) * sample_valid[:, None]
    return (ce * w).sum() / num_boxes


def loss_boxes(pred_boxes: torch.Tensor, tgt_boxes: torch.Tensor,
               tgt2query: torch.Tensor, box_valid: torch.Tensor,
               num_boxes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    src = _gather_queries(pred_boxes.float(), tgt2query)           # [B,N,4]
    mask = box_valid.float()
    l1 = (src - tgt_boxes).abs().sum(-1) * mask
    giou = box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(src),
                                       box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    lg = (1.0 - torch.diagonal(giou, dim1=-2, dim2=-1)) * mask
    return l1.sum() / num_boxes, lg.sum() / num_boxes


@torch.no_grad()
def loss_cardinality(pred_logits: torch.Tensor, box_valid: torch.Tensor,
                     sample_valid: torch.Tensor) -> torch.Tensor:
    """Logging only: |predicted non-empty queries - targets|, mean over the
    valid images."""
    card_pred = (pred_logits.argmax(-1) != pred_logits.shape[-1] - 1).sum(1)
    err = (card_pred.float() - box_valid.sum(1).float()).abs()
    sv = sample_valid.float()
    return (err * sv).sum() / sv.sum().clamp(min=1.0)


def loss_contrastive_align(proj_queries: torch.Tensor,
                           proj_tokens: torch.Tensor,
                           positive_map: torch.Tensor,
                           tgt2query: torch.Tensor, box_valid: torch.Tensor,
                           text_mask: torch.Tensor,
                           sample_valid: torch.Tensor, temperature: float,
                           num_boxes: torch.Tensor) -> torch.Tensor:
    """proj_queries [B,Q,h], proj_tokens [B,T,h], positive_map [B,N,L]
    (L >= T). Padded text slots are left out of the logsumexp, as in the JAX
    package."""
    B, Q, _ = proj_queries.shape
    T = proj_tokens.shape[1]
    logits = torch.einsum("bqh,bth->bqt", proj_queries.float(),
                          proj_tokens.float()) / temperature
    pm_bool = (positive_map[:, :, :T] > 0).float()
    oh = _target_onehot(tgt2query, box_valid, Q)
    pos = torch.einsum("bnq,bnt->bqt", oh, pm_bool) > 0           # [B,Q,T]
    pos = pos & (~text_mask)[:, None, :] & sample_valid[:, None, None]

    neg_logits = torch.where((~text_mask)[:, None, :], logits, -1e9)
    boxes_with_pos = pos.any(2)
    pos_term = torch.where(pos, -logits, 0.0).sum(2)
    neg_term = torch.logsumexp(neg_logits, dim=2)
    nb_pos = pos.sum(2) + 1e-6
    box_to_token = torch.where(boxes_with_pos, pos_term / nb_pos + neg_term,
                               0.0).sum()

    tokens_with_pos = pos.any(1)
    pos_term_t = torch.where(pos, -logits, 0.0).sum(1)
    neg_term_t = torch.logsumexp(logits, dim=1)   # over queries (all valid)
    nb_pos_t = pos.sum(1) + 1e-6
    token_to_box = torch.where(tokens_with_pos,
                               pos_term_t / nb_pos_t + neg_term_t, 0.0).sum()
    return (box_to_token + token_to_box) / 2.0 / num_boxes


def compute_num_boxes(box_valid: torch.Tensor,
                      sample_valid: torch.Tensor) -> torch.Tensor:
    n = (box_valid & sample_valid[:, None]).sum()
    return n.float().clamp(min=1.0)


def set_criterion(outputs: Mapping[str, torch.Tensor],
                  batch: Mapping[str, torch.Tensor], cfg: LossConfig,
                  matching: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Main + aux losses of one model stream (``criterion.py:181-253``).

    Returns the unweighted losses keyed like the reference ("loss_ce",
    "loss_bbox", ..., "loss_ce_0", ...), plus the matching of each level
    under "_tgt2query" (main) and "_tgt2query_{i}" (aux level i).
    ``batch["num_boxes_override"]``, when present, replaces the batch's
    valid-box count (gradient accumulation passes global / accum).
    ``matching`` ([L, B, N], aux levels then main, as
    ``hungarian_match_levels`` returns it) replaces the solve: it holds the
    losses of two runs to one matching where near-tied costs could flip
    it."""
    boxes = batch["boxes"]
    pm = batch["positive_map"]
    bv = batch["box_valid"] & batch["sample_valid"][:, None]
    sv = batch["sample_valid"].float()
    num_boxes: Optional[torch.Tensor] = batch.get("num_boxes_override")
    if num_boxes is None:
        num_boxes = compute_num_boxes(batch["box_valid"],
                                      batch["sample_valid"])

    has_aux = cfg.aux_loss and "aux_pred_logits" in outputs
    logits_lvl = outputs["pred_logits"][None]
    boxes_lvl = outputs["pred_boxes"][None]
    if has_aux:
        logits_lvl = torch.cat([outputs["aux_pred_logits"], logits_lvl])
        boxes_lvl = torch.cat([outputs["aux_pred_boxes"], boxes_lvl])
    t2q_lvl = matching
    if t2q_lvl is None:
        t2q_lvl = hungarian_match_levels(
            logits_lvl.detach(), boxes_lvl.detach(), boxes, pm, bv,
            cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
            cost_giou=cfg.set_cost_giou)                           # [L,B,N]

    losses: Dict[str, torch.Tensor] = {}

    def one_level(logits, pboxes, proj_q, suffix, t2q):
        losses[f"loss_ce{suffix}"] = loss_labels(
            logits, pm, t2q, bv, sv, cfg.eos_coef, num_boxes)
        losses[f"loss_bbox{suffix}"], losses[f"loss_giou{suffix}"] = \
            loss_boxes(pboxes, boxes, t2q, bv, num_boxes)
        losses[f"cardinality_error{suffix}"] = loss_cardinality(logits, bv,
                                                                sv)
        if proj_q is not None:
            losses[f"loss_contrastive_align{suffix}"] = \
                loss_contrastive_align(
                    proj_q, outputs["proj_tokens"], pm, t2q, bv,
                    batch["text_mask"], batch["sample_valid"],
                    cfg.temperature_NCE, num_boxes)
        losses[f"_tgt2query{suffix}"] = t2q

    proj_q = outputs.get("proj_queries")
    one_level(outputs["pred_logits"], outputs["pred_boxes"], proj_q, "",
              t2q_lvl[-1])
    if has_aux:
        for i in range(outputs["aux_pred_logits"].shape[0]):
            aux_pq = (outputs["aux_proj_queries"][i]
                      if proj_q is not None else None)
            one_level(outputs["aux_pred_logits"][i],
                      outputs["aux_pred_boxes"][i], aux_pq, f"_{i}",
                      t2q_lvl[i])
    return losses


def build_weight_dict(cfg: LossConfig, masks: bool,
                      num_dec_layers: int = 6) -> Dict[str, float]:
    """Reference models/mdetr.py:1067-1103 weight registry, replicated for
    each aux level."""
    wd = {"loss_ce": cfg.ce_loss_coef, "loss_bbox": cfg.bbox_loss_coef,
          "loss_giou": cfg.giou_loss_coef,
          "loss_contrastive_align": cfg.contrastive_align_loss_coef}
    if masks:
        wd["loss_mask"] = cfg.mask_loss_coef
        wd["loss_dice"] = cfg.dice_loss_coef
    if cfg.nsthl2_loss:
        wd["loss_nsthl2"] = cfg.nsthl2_coef
    if cfg.softkd_loss:
        wd["loss_softkd"] = cfg.softkd_coef
    if cfg.cluster:
        wd["loss_cluster_choice"] = cfg.cluster_choice_loss
        wd["loss_cluster_feature"] = cfg.cluster_feature_loss
    base = dict(wd)
    for i in range(num_dec_layers - 1):
        wd.update({f"{k}_{i}": v for k, v in base.items()})
    return wd


def total_loss(losses: Mapping[str, torch.Tensor],
               weight_dict: Mapping[str, float]) -> torch.Tensor:
    """Weighted sum over the keys present in the weight dict (reference
    engine.py:72-74); "_" keys are not losses."""
    terms = [weight_dict[k] * v for k, v in losses.items()
             if not k.startswith("_") and k in weight_dict]
    return torch.stack(terms).sum()
