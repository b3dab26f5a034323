"""Set-prediction losses of plain detection, fixed-shape, on the device.

Counterpart of the plain-detection part of ``toist_tpu/train/criterion.py``
(reference models/mdetr.py SetCriterion): soft-token cross-entropy with eos
down-weighting, L1 + GIoU box losses over matched pairs, the logging-only
cardinality error, and the bidirectional contrastive alignment loss, each
normalised by the batch's valid-box count. All decoder levels are matched in
one assignment solve (``ops/matching.hungarian_match_levels``). Inputs follow
the batcher's ``Batch`` layout (padded targets with validity masks) and the
``tgt2query`` convention (-1 for invalid targets). Distillation adds the
per-stream prefixes (``set_criterion(prefix="noun_")``), softkd (the
teacher's binary object probabilities distilled into the student's on
matched and on re-paired false-positive queries) and nsthl2 (the student's
pooled "something" feature pulled to the teacher's pooled noun feature).
Segmentation adds the sigmoid focal and dice losses on the matched queries'
stride-4 masks (``mask_losses``).

Every denominator is a count over the batch (valid boxes, valid samples,
samples with a valid box), and JAX takes it over the global batch. The
train step computes them once per (micro)batch over all ranks
(``normaliser_counts``, ``train/step.accumulate_gradients``) and passes them
in the batch as ``num_boxes_override``, ``num_samples_override`` and
``num_with_boxes_override``; each rank's losses are then its own sums over
the global denominators, and their sum over the ranks is the global loss.
Without them a loss takes the count of the batch it is given.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from toist_tpu_torch.config import LossConfig
from toist_tpu_torch.ops import box_ops
from toist_tpu_torch.ops.lsa import solve_lsa_batch
from toist_tpu_torch.ops.matching import (hungarian_match_levels,
                                          query_is_matched)
from toist_tpu_torch.train.cluster import (caption_span_mask,
                                           pool_span_features)
from toist_tpu_torch.utils.tracing import spanned


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
                     sample_valid: torch.Tensor,
                     num_samples: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Logging only: |predicted non-empty queries - targets|, mean over the
    valid images (``num_samples`` of them, by default the batch's)."""
    card_pred = (pred_logits.argmax(-1) != pred_logits.shape[-1] - 1).sum(1)
    err = (card_pred.float() - box_valid.sum(1).float()).abs()
    sv = sample_valid.float()
    if num_samples is None:
        num_samples = sv.sum().clamp(min=1.0)
    return (err * sv).sum() / num_samples


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


def normaliser_counts(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """[valid boxes, valid samples, valid samples with a valid box, valid
    samples with a caption span] of one stream's batch, f32 [4]: the
    unclamped counts under every denominator of the losses (the last one
    the cluster feature loss's, ``train/cluster.student_cluster``)."""
    sv = batch["sample_valid"]
    bv = batch["box_valid"] & sv[:, None]
    span = sv
    if "caption_noun_span" in batch:
        span = caption_span_mask(batch, batch["text_ids"].shape[1]).any(-1) \
            & sv
    return torch.stack([bv.sum(), sv.sum(), (bv.any(-1) & sv).sum(),
                        span.sum()]).float()


# The focal loss's class balance and focusing exponent (the reference's
# defaults, models/segmentation.py:294).
FOCAL_ALPHA = 0.25
FOCAL_GAMMA = 2.0


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       valid: torch.Tensor, num_boxes: torch.Tensor
                       ) -> torch.Tensor:
    """Reference models/segmentation.py:294-319, masked (``criterion.py:
    127-139``). logits / targets [B, N, P], valid [B, N] f32."""
    prob = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** FOCAL_GAMMA)
    loss = loss * (FOCAL_ALPHA * targets + (1 - FOCAL_ALPHA) * (1 - targets))
    return (loss.mean(-1) * valid).sum() / num_boxes


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor, num_boxes: torch.Tensor) -> torch.Tensor:
    """Reference models/segmentation.py:276-291, masked (``criterion.py:
    142-149``)."""
    prob = torch.sigmoid(logits)
    num = 2 * (prob * targets).sum(-1)
    den = prob.sum(-1) + targets.sum(-1)
    return ((1 - (num + 1) / (den + 1)) * valid).sum() / num_boxes


def mask_losses(pred_masks_sel: torch.Tensor, gt_masks: torch.Tensor,
                box_valid: torch.Tensor, sample_valid: torch.Tensor,
                num_boxes: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Focal + dice on the matched queries' masks (reference mdetr.py:
    827-853, ``criterion.py:158-179``): pred_masks_sel [B, N, h, w] aligned
    with gt_masks [B, N, h, w] (both at the GT stride 4; the caller gathered
    each target's matched query through ``compute_masks(query_idx=t2q)``).
    ``num_boxes`` replaces the batch's valid-box count (gradient
    accumulation passes global / accum)."""
    bv = box_valid & sample_valid[:, None]
    if num_boxes is None:
        num_boxes = compute_num_boxes(box_valid, sample_valid)
    src = pred_masks_sel.reshape(*pred_masks_sel.shape[:2], -1)
    tgt = gt_masks.float().reshape(*gt_masks.shape[:2], -1)
    v = bv.float()
    return {"loss_mask": sigmoid_focal_loss(src, tgt, v, num_boxes),
            "loss_dice": dice_loss(src, tgt, v, num_boxes)}


@spanned("toist.criterion")
def set_criterion(outputs: Mapping[str, torch.Tensor],
                  batch: Mapping[str, torch.Tensor], cfg: LossConfig,
                  matching: Optional[torch.Tensor] = None,
                  prefix: str = "") -> Dict[str, torch.Tensor]:
    """Main + aux losses of one model stream (``criterion.py:181-253``).

    Returns the unweighted losses keyed like the reference ("loss_ce",
    "loss_bbox", ..., "loss_ce_0", ...), plus the matching of each level
    under "_tgt2query" (main) and "_tgt2query_{i}" (aux level i). A
    distillation stream's ``prefix`` ("noun_", "sth_") goes before each
    loss key, and its matchings are "_{prefix}tgt2query{suffix}".
    ``batch["num_boxes_override"]`` and ``batch["num_samples_override"]``,
    when present, replace the batch's valid-box and valid-sample counts
    (the train step passes the global batch's, the box count / accum under
    gradient accumulation).
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
        losses[f"{prefix}loss_ce{suffix}"] = loss_labels(
            logits, pm, t2q, bv, sv, cfg.eos_coef, num_boxes)
        (losses[f"{prefix}loss_bbox{suffix}"],
         losses[f"{prefix}loss_giou{suffix}"]) = loss_boxes(
             pboxes, boxes, t2q, bv, num_boxes)
        losses[f"{prefix}cardinality_error{suffix}"] = loss_cardinality(
            logits, bv, sv, batch.get("num_samples_override"))
        if proj_q is not None:
            losses[f"{prefix}loss_contrastive_align{suffix}"] = \
                loss_contrastive_align(
                    proj_q, outputs["proj_tokens"], pm, t2q, bv,
                    batch["text_mask"], batch["sample_valid"],
                    cfg.temperature_NCE, num_boxes)
        losses[f"_{prefix}tgt2query{suffix}"] = t2q

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


def _binary_prob(logits: torch.Tensor) -> torch.Tensor:
    """Soft binary target [P(any object), P(no object)] (mdetr.py:555-556)."""
    p = torch.softmax(logits.float(), dim=-1)
    return torch.stack([p[..., :-1].sum(-1), p[..., -1]], -1)


def _kl2(p_tgt: torch.Tensor, p_src: torch.Tensor) -> torch.Tensor:
    """KL(p_tgt || p_src) over the last (2-class) axis, eps-guarded."""
    eps = 1e-10
    return (p_tgt * (torch.log(p_tgt + eps) - torch.log(p_src + eps))).sum(-1)


def _take_rows(arr: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """arr [B, Q, K], order [B, Q] -> arr rows in that order."""
    return torch.gather(arr, 1, order[..., None].expand(-1, -1,
                                                        arr.shape[-1]))


def _softkd_per_image(noun_logits: torch.Tensor, sth_logits: torch.Tensor,
                      noun_boxes: torch.Tensor, sth_boxes: torch.Tensor,
                      t2q_noun: torch.Tensor, t2q_sth: torch.Tensor,
                      box_valid: torch.Tensor,
                      sample_valid: torch.Tensor) -> torch.Tensor:
    """Per-image softkd [(sum TP KL + sum FP KL) / Q], shape [B]
    (``criterion.py:268-340``, reference mdetr.py:520-599).

    TP pairs: the queries the two streams matched to the same target. FP
    pairs: each stream's unmatched queries, compacted to the front in
    order, re-paired by one assignment solve over KL + L1 - GIoU (unit
    weights); columns past a row's count cost 1e6. The solve is
    ``ops/lsa.solve_lsa_batch``: the kernel for CUDA tensors, the plain
    version for CPU ones. KL(teacher || student) per pair; the teacher's
    probabilities and the solve's inputs are detached."""
    B, Q = noun_logits.shape[:2]
    bi_noun = _binary_prob(noun_logits).detach()                   # [B,Q,2]
    bi_sth = _binary_prob(sth_logits)
    bv = box_valid & sample_valid[:, None]

    tp_kl = _kl2(_gather_queries(bi_noun, t2q_noun),
                 _gather_queries(bi_sth, t2q_sth)) * bv            # [B, N]

    # Unmatched queries first, in query order (a stable sort of the flags).
    ord_noun = torch.argsort(query_is_matched(t2q_noun, Q).to(torch.int8),
                             dim=-1, stable=True)
    ord_sth = torch.argsort(query_is_matched(t2q_sth, Q).to(torch.int8),
                            dim=-1, stable=True)
    fpn_bi, fps_bi = _take_rows(bi_noun, ord_noun), _take_rows(bi_sth,
                                                                ord_sth)
    fpn_box = _take_rows(noun_boxes.float(), ord_noun)
    fps_box = _take_rows(sth_boxes.float(), ord_sth)
    n_fp = Q - bv.sum(-1)                                          # [B]

    # Cost [B, Q (sth rows), Q (noun cols)]: KL(noun || sth) + L1 - GIoU.
    c_kl = (fpn_bi[:, None, :, :] * (torch.log(fpn_bi[:, None, :, :] + 1e-10)
                                     - torch.log(fps_bi[:, :, None, :]
                                                 + 1e-10))).sum(-1)
    c_l1 = (fps_box[:, :, None, :] - fpn_box[:, None, :, :]).abs().sum(-1)
    c_giou = -box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(fps_box),
                                          box_ops.box_cxcywh_to_xyxy(fpn_box))
    cost = c_kl + c_l1 + c_giou
    col = torch.arange(Q, device=cost.device)
    cost = torch.where((col[None, :] >= n_fp[:, None])[:, None, :], 1e6, cost)
    assign = solve_lsa_batch(cost.detach(), n_fp.to(torch.int32))   # [B, Q]
    paired_noun = _gather_queries(fpn_bi, assign)
    fp_row_valid = (col[None, :] < n_fp[:, None]) & sample_valid[:, None]
    fp_kl = _kl2(paired_noun, fps_bi) * fp_row_valid
    return (tp_kl.sum(-1) + fp_kl.sum(-1)) / Q


def loss_softkd_levels(noun_logits: torch.Tensor, sth_logits: torch.Tensor,
                       noun_boxes: torch.Tensor, sth_boxes: torch.Tensor,
                       t2q_noun: torch.Tensor, t2q_sth: torch.Tensor,
                       box_valid: torch.Tensor, sample_valid: torch.Tensor,
                       num_samples: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Softkd of all decoder levels in ONE re-pairing solve: inputs stacked
    [L, B, ...] (aux levels, then main; L = 1 without aux levels),
    box_valid / sample_valid shared [B, ...] -> [L] per-level losses, each
    the mean over valid images (``num_samples`` of them, by default the
    batch's)."""
    L, B = noun_logits.shape[:2]

    def flat(x):
        return x.reshape((L * B,) + x.shape[2:])

    def tile(x):
        return flat(x[None].expand((L,) + x.shape))

    per_image = _softkd_per_image(
        flat(noun_logits), flat(sth_logits), flat(noun_boxes),
        flat(sth_boxes), flat(t2q_noun), flat(t2q_sth), tile(box_valid),
        tile(sample_valid)).reshape(L, B)
    if num_samples is None:
        num_samples = sample_valid.sum().clamp(min=1)
    return (per_image * sample_valid[None, :]).sum(-1) / num_samples


def loss_nsthl2(noun_text_memory: torch.Tensor,
                sth_text_memory: torch.Tensor, noun_spans: torch.Tensor,
                sth_spans: torch.Tensor, box_valid: torch.Tensor,
                sample_valid: torch.Tensor,
                num_with_boxes: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """L2 text-feature distillation (reference mdetr.py:668-781): the MSE
    between the student's pooled "something" feature and the teacher's
    pooled noun feature (detached), averaged over the images with boxes
    (``num_with_boxes`` of them, by default the batch's)."""
    bv = box_valid & sample_valid[:, None]
    pooled_noun, _ = pool_span_features(noun_text_memory.float(), noun_spans,
                                        bv)
    pooled_sth, _ = pool_span_features(sth_text_memory.float(), sth_spans,
                                       bv)
    ok = (bv.sum(-1) > 0) & sample_valid
    mse = ((pooled_sth - pooled_noun.detach()) ** 2).mean(-1)
    if num_with_boxes is None:
        num_with_boxes = ok.sum().clamp(min=1)
    return (mse * ok).sum() / num_with_boxes


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
    engine.py:72-74); "_" and "*_tgt2query" keys are not losses. A
    distillation stream's key is weighed by its unprefixed name
    ("noun_loss_ce" by "loss_ce", mdetr.py:1084-1092)."""
    terms = []
    for k, v in losses.items():
        if k.startswith("_") or k.endswith("_tgt2query"):
            continue
        for p in ("noun_", "sth_"):
            if k.startswith(p):
                k = k[len(p):]
        if k in weight_dict:
            terms.append(weight_dict[k] * v)
    return torch.stack(terms).sum()
