"""Batched inference / serving API.

Counterpart of ``toist_tpu/predict.py:Predictor``: images are bucketed onto
the static eval canvases (``toist_tpu/data/batcher.py``), each batch runs the
forward plus ``postprocess_boxes``, and each image gets its boxes sorted by
score and filtered by the threshold. A model with a mask head also answers
with each kept box's mask, a COCO RLE of the original image size
(``postprocess_masks_device``).

Example:
    predictor = Predictor.from_checkpoint("runs/dete/checkpoint", cfg)
    # or Predictor.from_state_dict(state_dict, cfg, device="cuda")
    dets = predictor(images=[img1, img2], task_ids=[3, 3])
    dets[0]["boxes"], dets[0]["scores"]   # xyxy absolute, 1-P(noobj)
    dets[0]["masks"]                      # with a mask head: RLE dicts

Canvases are shipped as u8 and normalized on the device, which the JAX
package shows bit-equal to host normalization (``device_normalize``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from toist_tpu_torch.config import Config
from toist_tpu_torch.data.batcher import BucketSpec, collate, default_buckets
from toist_tpu_torch.data.tokenizer import RobertaBPE
from toist_tpu_torch.data.captions import build_tokenizer, task_caption
from toist_tpu_torch.models.postprocess import postprocess_masks_device
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.train.step import eval_forward


class Predictor:
    """A TOIST model as a batched task-driven detector."""

    def __init__(self, model: TOIST, tokenizer: RobertaBPE, cfg: Config,
                 score_threshold: float = 0.0):
        self.model = model
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.score_threshold = score_threshold
        self.spec = BucketSpec(
            buckets=cfg.data.image_buckets if cfg.data.image_buckets else
            default_buckets(cfg.data.max_size, cfg.data.val_size),
            max_text_len=cfg.data.max_text_len, max_boxes=cfg.data.max_boxes,
            num_logit_cols=cfg.data.num_logit_cols)

    @classmethod
    def from_state_dict(cls, state_dict: Mapping[str, torch.Tensor],
                        cfg: Config, device="cuda",
                        tokenizer: Optional[RobertaBPE] = None,
                        score_threshold: float = 0.0) -> "Predictor":
        """From a reference-layout state dict (e.g. ``torch.load`` of a
        reference checkpoint's ``model_ema``/``model``, or
        ``utils.convert.jax_params_to_state_dict``)."""
        tokenizer = tokenizer or build_tokenizer(cfg)
        model = TOIST.from_state_dict(state_dict, cfg.model, device)
        return cls(model, tokenizer, cfg, score_threshold=score_threshold)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Config,
                        tokenizer: Optional[RobertaBPE] = None,
                        prefer_ema: bool = True, score_threshold: float = 0.0,
                        device="cuda") -> "Predictor":
        """From a reference-format checkpoint (the port's own or the
        reference's ``.pth``; its EMA weights when ``prefer_ema`` and
        present), as ``toist_tpu/predict.py:52-66`` reads one."""
        from toist_tpu_torch.train.checkpoint import load_params

        return cls.from_state_dict(load_params(path, prefer_ema=prefer_ema),
                                   cfg, device=device, tokenizer=tokenizer,
                                   score_threshold=score_threshold)

    def prepare(self, image: np.ndarray, task_id: int,
                orig_size: Optional[Tuple[int, int]] = None) -> dict:
        """One sample from an already resized u8 image [h, w, 3] and a task
        id. ``orig_size`` (h, w) is the size boxes are scaled back to; it
        defaults to the image's own."""
        from toist_tpu_torch.data.cocotasks import finalize_text

        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("image must be u8 [h, w, 3]")
        h, w = image.shape[:2]
        target = {"caption": task_caption(task_id), "tokens_positive": [],
                  "noun_tokens_positive": []}
        target = finalize_text(target, self.tokenizer,
                               num_cols=self.cfg.data.num_logit_cols,
                               max_text_len=self.cfg.data.max_text_len)
        return {
            "image": np.ascontiguousarray(image),
            "text_ids": target["text_ids"],
            "text_len": target["text_len"],
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int64),
            "positive_map": np.zeros((0, self.cfg.data.num_logit_cols),
                                     np.float32),
            "noun_token_spans": np.zeros((0, 2), np.int32),
            "caption_noun_span": target["caption_noun_span"],
            "image_id": 0, "task_id": task_id,
            "orig_size": np.asarray(orig_size or (h, w), np.int32),
            "size": np.asarray([h, w], np.int32),
        }

    def bucket(self, sample: dict) -> int:
        h, w = sample["image"].shape[:2]
        bi = self.spec.pick(h, w)
        if bi < 0:
            raise ValueError(f"image {h}x{w} fits no canvas of "
                             f"{self.spec.buckets}")
        return bi

    def predict_batch(self, batch: Mapping[str, np.ndarray]
                      ) -> List[Dict[str, np.ndarray]]:
        """Run one collated batch; one result per valid row, boxes sorted by
        score (descending) and filtered by ``score_threshold``; with a
        mask head each also holds "masks", the kept boxes' RLEs."""
        out, post = eval_forward(self.model, batch)
        masks = None
        if "pred_masks" in out:
            masks = postprocess_masks_device(
                out["pred_masks"], batch["size"], batch["orig_size"],
                batch["sample_valid"])
        scores = post["scores"].cpu().numpy()
        boxes = post["boxes"].cpu().numpy()
        results = []
        for row in np.flatnonzero(batch["sample_valid"]):
            sc = scores[row]
            keep = np.argsort(-sc)
            keep = keep[sc[keep] >= self.score_threshold]
            res = {"boxes": boxes[row][keep], "scores": sc[keep],
                   "labels": np.ones(len(keep), np.int32)}
            if masks is not None:
                res["masks"] = [masks[row][q] for q in keep]
            results.append(res)
        return results

    def __call__(self, images: Sequence, task_ids: Sequence[int]
                 ) -> List[Dict[str, np.ndarray]]:
        """PIL images + task ids -> one dict per image: {"boxes" [K,4] xyxy
        absolute, "scores" [K], "labels" [K]}, and "masks" [K] (RLE
        dicts) with a mask head."""
        from toist_tpu_torch.data.transforms import resize, to_array_u8

        if len(images) != len(task_ids):
            raise ValueError("one task id per image")
        samples = []
        for im, t in zip(images, task_ids):
            w0, h0 = im.size
            im, _ = resize(im, None, self.cfg.data.val_size,
                           max_size=self.cfg.data.max_size)
            arr, _ = to_array_u8(im, None)
            samples.append(self.prepare(arr, t, orig_size=(h0, w0)))
        order: Dict[int, List[int]] = {}
        for i, s in enumerate(samples):
            order.setdefault(self.bucket(s), []).append(i)
        results: List[Optional[dict]] = [None] * len(samples)
        for bi, idxs in order.items():
            batch = collate([samples[i] for i in idxs], self.spec, bi,
                            batch_size=len(idxs))
            for i, res in zip(idxs, self.predict_batch(batch)):
                results[i] = res
        return results
