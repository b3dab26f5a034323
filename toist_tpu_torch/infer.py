"""The inference forward: one body for ``Predictor.predict_batch``,
``visualize`` and the eval step (``train/step.make_eval_step``), the
cluster eval included. It sits below both the serving API and the
training step, and of ``toist_tpu_torch.train`` imports the cluster bank
alone. The eval step runs its criterion between ``forward`` and
``postprocess``, so they are two functions.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from toist_tpu_torch.models.postprocess import postprocess_boxes
from toist_tpu_torch.train import cluster as cl
from toist_tpu_torch.utils.tracing import spanned

INPUT_KEYS = ("images", "image_mask", "text_ids", "text_mask")
EVAL_KEYS = INPUT_KEYS + ("orig_size",)
# What the cluster snap reads besides.
SNAP_KEYS = ("caption_noun_span", "task_id", "sample_valid")


@spanned("toist.h2d")
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


@torch.inference_mode()
def forward(model: torch.nn.Module, batch: Mapping[str, np.ndarray],
            keys: Sequence[str] = EVAL_KEYS,
            unimodal: Optional[Callable] = None,
            bank: Optional[cl.ClusterBank] = None,
            kmeans: Optional[Tuple[int, float]] = None
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One batch's forward -> (model outputs, the batch's ``keys`` on the
    model's device). ``unimodal`` goes to ``TOIST.encode``. With a cluster
    ``bank`` (read only: the refreshed centers are thrown away) the
    "something" span is snapped to its center between encode and decode
    (reference engine.py:288-291, mdetr.py:282-312), by k-means with
    ``kmeans`` = (max_iters, tol). A model with a mask head adds
    "pred_masks" [B, Q, H/4, W/4], from the unsnapped memory."""
    if bank is not None:
        keys = tuple(keys) + tuple(k for k in SNAP_KEYS if k not in keys)
    x = batch_to_device(batch, next(model.parameters()).device, keys)
    cache = model.encode(*(x[k] for k in INPUT_KEYS), unimodal=unimodal)
    if bank is not None:
        _, cache["img_memory_mod"], _ = cl.student_cluster(
            bank, cache, x, *kmeans, train=False)
    out = model.decode(cache, use_modified_memory=bank is not None)
    if model.cfg.masks:
        out["pred_masks"] = model.compute_masks(cache, out["hs"][-1])
    return out, x


@torch.inference_mode()
def postprocess(out: Mapping[str, torch.Tensor],
                x: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``forward``'s outputs as scores, labels and xyxy boxes in the
    original image's pixels."""
    return postprocess_boxes(out["pred_logits"], out["pred_boxes"],
                             x["orig_size"])
