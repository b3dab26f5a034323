"""Box utilities (cxcywh<->xyxy, IoU, GIoU, masks_to_boxes) in PyTorch.

Counterpart of ``toist_tpu/ops/box_ops.py``: no degeneracy asserts, and
division guards so padded all-zero boxes give finite values.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack(
        [(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape [..., 4] -> [...]."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU + union for xyxy boxes [N,4],[M,4] -> ([N,M],[N,M])."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / union.clamp(min=_EPS)
    return iou, union


def generalized_box_iou(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU for xyxy boxes [N,4],[M,4] -> [N,M]."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=_EPS)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """Bounding boxes (xyxy) around binary masks [N,H,W] -> [N,4]; empty
    masks give zeros."""
    if masks.numel() == 0:
        return torch.zeros(masks.shape[:-2] + (4,), dtype=torch.float32,
                           device=masks.device)
    h, w = masks.shape[-2], masks.shape[-1]
    y = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=masks.device)[None, :]
    m = masks.float()
    big = torch.tensor(1e8, dtype=torch.float32, device=masks.device)
    x_max = (m * x).amax(dim=(-2, -1))
    x_min = torch.where(m > 0, x, big).amin(dim=(-2, -1))
    y_max = (m * y).amax(dim=(-2, -1))
    y_min = torch.where(m > 0, y, big).amin(dim=(-2, -1))
    empty = m.amax(dim=(-2, -1)) == 0
    out = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where(empty[..., None], torch.zeros_like(out), out)
