"""The evaluation step: forward plus ``postprocess_boxes``.

Counterpart of ``toist_tpu/train/step.py:make_eval_step``. The criterion
(eval losses, with its Hungarian matching) belongs to the training slice and
is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from toist_tpu.config import Config
from toist_tpu_torch.models.postprocess import postprocess_boxes

_INPUT_KEYS = ("images", "image_mask", "text_ids", "text_mask", "orig_size")


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The model inputs of a batcher ``Batch`` (numpy) as tensors on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in _INPUT_KEYS}


@torch.inference_mode()
def eval_forward(model: torch.nn.Module, batch: Mapping[str, np.ndarray]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Forward + postprocess of one batch -> (model outputs, postprocessed
    scores/labels/boxes)."""
    device = next(model.parameters()).device
    x = batch_to_device(batch, device)
    out, _ = model(x["images"], x["image_mask"], x["text_ids"],
                   x["text_mask"])
    post = postprocess_boxes(out["pred_logits"], out["pred_boxes"],
                             x["orig_size"])
    return out, post


def make_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """batch -> {"post": postprocessed detections, "scalars": {}}."""
    if cfg.run.compute_eval_losses:
        raise NotImplementedError(
            "run.compute_eval_losses=True needs the set criterion and its "
            "Hungarian matcher, which come with the training (criterion) "
            "slice; set run.compute_eval_losses=False")

    def eval_step(batch):
        _, post = eval_forward(model, batch)
        return {"post": post, "scalars": {}}

    return eval_step
