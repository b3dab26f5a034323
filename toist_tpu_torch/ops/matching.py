"""Hungarian matching for set prediction, on the tensors' device.

Counterpart of ``toist_tpu/ops/matching.py``: the per-image cost
C = cost_bbox * L1 + cost_class * (-softmax(logits) . positive_map)
  + cost_giou * (-GIoU)
over padded targets, solved with rows = targets (the small side) by
``ops/lsa.solve_lsa_batch``: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors. There is no backend policy (the JAX package's
``_lsa_backend_for`` chooses between XLA and Pallas on a TPU).

``tgt2query[b, t]`` is the query assigned to target t, or -1 where
``tgt_valid[b, t]`` is False.
"""
from __future__ import annotations

import torch

from toist_tpu_torch.ops import box_ops
from toist_tpu_torch.ops.lsa import solve_lsa_batch


def match_costs(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                tgt_boxes: torch.Tensor, positive_map: torch.Tensor,
                cost_class: float, cost_bbox: float, cost_giou: float
                ) -> torch.Tensor:
    """The [B, Q, T] matching cost (reference matcher.py:63-81)."""
    out_prob = torch.softmax(pred_logits.float(), dim=-1)          # [B,Q,L]
    c_class = -torch.einsum("bql,btl->bqt", out_prob, positive_map.float())
    c_bbox = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs() \
        .sum(-1)
    pb = box_ops.box_cxcywh_to_xyxy(pred_boxes)
    tb = box_ops.box_cxcywh_to_xyxy(tgt_boxes)
    c_giou = -box_ops.generalized_box_iou(pb, tb)
    return cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou


def assignment_problem(cost: torch.Tensor, tgt_valid: torch.Tensor
                       ) -> tuple:
    """The solver's input for matching costs [B, Q, T] and tgt_valid [B, T]:
    (cost [B, T, Q] with the valid targets first, their count [B] int32,
    the order [B, T] that put them first). Stable, so the solver's "first
    n rows" contract holds for any validity mask (matching.py:139-151)."""
    n_valid = tgt_valid.sum(-1, dtype=torch.int32)
    order = torch.sort((~tgt_valid).to(torch.uint8), dim=-1,
                       stable=True).indices
    cost_t = torch.gather(cost.transpose(1, 2), 1,
                          order[:, :, None].expand(-1, -1, cost.shape[1]))
    return cost_t, n_valid, order


@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_boxes: torch.Tensor, positive_map: torch.Tensor,
                    tgt_valid: torch.Tensor, cost_class: float = 1.0,
                    cost_bbox: float = 5.0, cost_giou: float = 2.0
                    ) -> torch.Tensor:
    """pred_logits [B, Q, L], pred_boxes [B, Q, 4] cxcywh, tgt_boxes
    [B, T, 4], positive_map [B, T, L], tgt_valid [B, T] bool -> tgt2query
    [B, T] int32. One assignment solve for the whole batch."""
    cost = match_costs(pred_logits, pred_boxes, tgt_boxes, positive_map,
                       cost_class, cost_bbox, cost_giou)
    cost_t, n_valid, order = assignment_problem(cost, tgt_valid)
    assigned = solve_lsa_batch(cost_t, n_valid)                     # [B, T]
    tgt2query = torch.full_like(assigned, -1)
    tgt2query.scatter_(1, order, assigned)
    return torch.where(tgt_valid, tgt2query, torch.full_like(tgt2query, -1))


def hungarian_match_levels(pred_logits: torch.Tensor,
                           pred_boxes: torch.Tensor, tgt_boxes: torch.Tensor,
                           positive_map: torch.Tensor,
                           tgt_valid: torch.Tensor, cost_class: float = 1.0,
                           cost_bbox: float = 5.0, cost_giou: float = 2.0
                           ) -> torch.Tensor:
    """All decoder levels in ONE solve: pred_logits [L, B, Q, C], pred_boxes
    [L, B, Q, 4], targets shared [B, ...] -> tgt2query [L, B, T]."""
    L, B = pred_logits.shape[:2]

    def flat(x):
        return x.reshape((L * B,) + x.shape[2:])

    def tile(x):
        return flat(x[None].expand((L,) + x.shape))

    t2q = hungarian_match(flat(pred_logits), flat(pred_boxes),
                          tile(tgt_boxes), tile(positive_map),
                          tile(tgt_valid), cost_class, cost_bbox, cost_giou)
    return t2q.reshape(L, B, -1)


def query_is_matched(tgt2query: torch.Tensor, num_queries: int
                     ) -> torch.Tensor:
    """[B, T] -> [B, Q] bool: which queries got matched to a valid target."""
    B = tgt2query.shape[0]
    hit = torch.zeros((B, num_queries + 1), dtype=torch.bool,
                      device=tgt2query.device)
    idx = torch.where(tgt2query >= 0, tgt2query, num_queries).long()
    hit.scatter_(1, idx, True)
    return hit[:, :num_queries]
