"""Output postprocessing to absolute-coordinate detections.

Counterpart of ``postprocess_boxes`` in ``toist_tpu/models/postprocess.py``
(the mask paths belong to the segmentation slice): score = 1 - P(no-object)
from the softmax over the logit columns, every label 1, boxes cxcywh -> xyxy
scaled by the original (unpadded) image size.
"""
from __future__ import annotations

from typing import Dict

import torch

from toist_tpu_torch.ops import box_ops


def postprocess_boxes(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                      orig_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B,Q,C] logits, [B,Q,4] cxcywh, [B,2] (h,w) -> scores/labels/boxes."""
    prob = torch.softmax(pred_logits.float(), dim=-1)
    scores = 1.0 - prob[..., -1]
    labels = torch.ones(scores.shape, dtype=torch.int32,
                        device=scores.device)
    boxes = box_ops.box_cxcywh_to_xyxy(pred_boxes)
    h = orig_sizes[:, 0].float()
    w = orig_sizes[:, 1].float()
    scale = torch.stack([w, h, w, h], dim=1)[:, None, :]
    return {"scores": scores, "labels": labels, "boxes": boxes * scale}
