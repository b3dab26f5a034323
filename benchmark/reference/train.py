"""Plain PyTorch reference of TOIST's training step: the set criterion with
Hungarian matching over every decoder level, the backward, the gradient
clip, AdamW with the per-group learning rates, and the EMA.

Written from the published method (MDETR's SetCriterion and
HungarianMatcher, Kamath et al. 2021; TOIST's training script) for the
benchmark's output check. It imports nothing of the program. The matching
is scipy's exact assignment solver on the reference's own f32 costs.

- Matching cost per (query, target): 5 L1(box) - 1 softmax(logits) .
  positive map - 2 GIoU; one assignment per image and decoder level.
- Losses per level (the last and five auxiliary), each normalised by the
  batch's valid boxes: soft-token cross-entropy against the matched
  target's positive map (the no-object column for unmatched queries,
  weighted by eos_coef), L1 and 1 - GIoU of matched boxes, and the
  bidirectional contrastive alignment loss over unpadded text tokens;
  weighted 1, 5, 2 and 1 and summed.
- Gradient clip: every trainable tensor scaled by min(1, max_norm /
  (global norm + 1e-6)).
- AdamW (torch's update: decoupled decay, eps after the bias-corrected
  root) with one learning rate per group: backbone, text encoder, rest.
- EMA: ema = decay ema + (1 - decay) weight after every update.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

_EPS = 1e-9


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise generalized IoU of xyxy boxes [..., N, 4] x [..., M, 4]."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / union.clamp(min=_EPS)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=_EPS)


@torch.no_grad()
def match(logits: torch.Tensor, boxes: torch.Tensor, tgt_boxes: torch.Tensor,
          pos_map: torch.Tensor, valid: torch.Tensor, w_class: float,
          w_bbox: float, w_giou: float) -> List[List[Tuple[np.ndarray,
                                                            np.ndarray]]]:
    """Per level and image, (target indices, query indices) of the least
    cost assignment. logits [L, B, Q, C], boxes [L, B, Q, 4], tgt_boxes
    [B, N, 4], pos_map [B, N, C], valid [B, N]."""
    prob = torch.softmax(logits, -1)
    c_class = -torch.einsum("lbqc,bnc->lbqn", prob, pos_map)
    c_bbox = (boxes[:, :, :, None, :] - tgt_boxes[None, :, None]).abs().sum(-1)
    c_giou = -giou(cxcywh_to_xyxy(boxes),
                   cxcywh_to_xyxy(tgt_boxes)[None].expand(
                       boxes.shape[0], -1, -1, -1))
    cost = (w_bbox * c_bbox + w_class * c_class + w_giou * c_giou).cpu()
    valid = valid.cpu().numpy()
    out = []
    for lvl in range(cost.shape[0]):
        per = []
        for b in range(cost.shape[1]):
            t_idx = np.flatnonzero(valid[b])
            c = cost[lvl, b][:, t_idx].numpy().T                    # [n, Q]
            r, q = linear_sum_assignment(c)
            per.append((t_idx[r], q))
        out.append(per)
    return out


def level_losses(logits, boxes, proj_q, proj_t, text_mask, tgt_boxes,
                 pos_map, assignment, eos_coef, temperature, num_boxes
                 ) -> Dict[str, torch.Tensor]:
    """The four losses of one decoder level. logits [B, Q, C], boxes
    [B, Q, 4], proj_q [B, Q, h], proj_t [B, T, h]."""
    B, Q, C = logits.shape
    T = proj_t.shape[1]
    logprob = torch.log_softmax(logits, -1)
    target = torch.zeros_like(logits)
    target[..., C - 1] = 1.0
    weight = torch.full((B, Q), eos_coef, device=logits.device)
    pos = torch.zeros(B, Q, T, dtype=torch.bool, device=logits.device)
    l1 = giou_l = logits.new_zeros(())
    for b, (t_idx, q_idx) in enumerate(assignment):
        if len(t_idx) == 0:
            continue
        t = torch.as_tensor(t_idx, device=logits.device)
        q = torch.as_tensor(q_idx, device=logits.device)
        target[b, q] = pos_map[b, t]
        weight[b, q] = 1.0
        pos[b, q] = pos_map[b, t, :T] > 0
        src, tgt = boxes[b, q], tgt_boxes[b, t]
        l1 = l1 + (src - tgt).abs().sum()
        g = giou(cxcywh_to_xyxy(src), cxcywh_to_xyxy(tgt))
        giou_l = giou_l + (1 - torch.diagonal(g)).sum()
    ce = (-(logprob * target).sum(-1) * weight).sum() / num_boxes

    pos = pos & (~text_mask)[:, None, :]
    sim = torch.einsum("bqh,bth->bqt", proj_q, proj_t) / temperature
    neg = torch.logsumexp(sim.masked_fill(text_mask[:, None, :], -1e9), 2)
    pos_sum = torch.where(pos, -sim, 0.0).sum(2)
    n_pos = pos.sum(2) + 1e-6
    box_to_token = torch.where(pos.any(2), pos_sum / n_pos + neg, 0.0).sum()
    neg_t = torch.logsumexp(sim, 1)
    pos_sum_t = torch.where(pos, -sim, 0.0).sum(1)
    n_pos_t = pos.sum(1) + 1e-6
    token_to_box = torch.where(pos.any(1), pos_sum_t / n_pos_t + neg_t,
                               0.0).sum()
    align = (box_to_token + token_to_box) / 2 / num_boxes
    return {"ce": ce, "bbox": l1 / num_boxes, "giou": giou_l / num_boxes,
            "align": align}


def total_loss(out: Mapping[str, torch.Tensor], batch: Mapping[str,
               torch.Tensor], loss: Mapping[str, float]) -> torch.Tensor:
    """The weighted sum of every level's losses (the model's outputs
    ``out`` as ``Reference.forward`` returns them)."""
    logits = torch.cat([out["aux_pred_logits"], out["pred_logits"][None]])
    boxes = torch.cat([out["aux_pred_boxes"], out["pred_boxes"][None]])
    proj = torch.cat([out["aux_proj_queries"], out["proj_queries"][None]])
    valid = batch["box_valid"] & batch["sample_valid"][:, None]
    pos_map = batch["positive_map"].float()
    num_boxes = valid.sum().float().clamp(min=1.0)
    assign = match(logits.detach(), boxes.detach(), batch["boxes"], pos_map,
                   valid, loss["set_cost_class"], loss["set_cost_bbox"],
                   loss["set_cost_giou"])
    w = {"ce": loss["ce_loss_coef"], "bbox": loss["bbox_loss_coef"],
         "giou": loss["giou_loss_coef"],
         "align": loss["contrastive_align_loss_coef"]}
    total = logits.new_zeros(())
    for lvl in range(logits.shape[0]):
        ls = level_losses(logits[lvl], boxes[lvl], proj[lvl],
                          out["proj_tokens"], batch["text_mask"],
                          batch["boxes"], pos_map, assign[lvl],
                          loss["eos_coef"], loss["temperature_NCE"],
                          num_boxes)
        total = total + sum(w[k] * v for k, v in ls.items())
    return total


def clip_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale in place to a global norm of at most ``max_norm``; returns
    the norm before."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return norm


class AdamW:
    """torch.optim.AdamW's update for one list of f32 tensors."""

    def __init__(self, params: List[torch.Tensor], weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.wd, (self.b1, self.b2), self.eps = weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lrs: List[float]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, (1 - self.b2 ** self.t) ** 0.5
        for p, g, m, v, lr in zip(self.params, grads, self.m, self.v, lrs):
            p.mul_(1 - lr * self.wd)
            m.lerp_(g, 1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, v.sqrt().div_(c2).add_(self.eps), value=-lr / c1)
