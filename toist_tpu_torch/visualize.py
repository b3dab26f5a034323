"""Qualitative visualization: ground-truth vs predicted boxes and masks as
PNGs.

Counterpart of ``toist_tpu/visualize.py`` (reference visualize.py: a
batch-of-1 eval over the val set, GT and the predictions above a score
threshold of 0.95 drawn side by side). Each image of each task in
``data.tasks`` becomes ``task{t}_img{id}.png``: the ground truth on the
left, the predictions on the right. The model is the checkpoint of
``run.resume`` (its EMA weights when ``optim.ema``), else a fresh one from
``run.seed``.

Drawing is numpy on the RGB image (no OpenCV): a mask is blended at alpha
0.45 as ``cv2.addWeighted`` rounds it (one fused multiply-add in f32), and
a box is outlined as ``cv2.rectangle`` draws thickness 2: every pixel
within distance 1 of the rectangle's edges. The masks come from the host
mask postprocess (``models/postprocess.postprocess_masks_host``, PIL
bilinear), as the JAX package's do.

Run: python -m toist_tpu_torch.visualize --config c.json --resume ckpt
         --output-dir vis_dir [--set k=v ...] [--device cpu]
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from toist_tpu_torch.config import Config

# RGB (the JAX package gives them in BGR: (60, 200, 60), (60, 60, 230)).
GT_COLOR = (60, 200, 60)
PRED_COLOR = (230, 60, 60)


def blend(image: np.ndarray, overlay: np.ndarray,
          alpha: float = 0.45) -> np.ndarray:
    """``cv2.addWeighted(overlay, alpha, image, 1 - alpha, 0)`` on u8
    images: round_f32(overlay * a + round_f32(image * b)), rounded half to
    even, with a and b the f32 weights."""
    a = np.float64(np.float32(alpha))
    b = np.float64(np.float32(1.0 - alpha))
    inner = (image.astype(np.float64) * b).astype(np.float32)
    out = (overlay.astype(np.float64) * a
           + inner.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def outline(h: int, w: int, box: Sequence[float]) -> np.ndarray:
    """[h, w] bool: the pixels within distance 1 of the rectangle with
    corners at the box's rounded coordinates (``cv2.rectangle`` at
    thickness 2)."""
    x0, y0, x1, y1 = [int(round(v)) for v in box]
    x0, x1 = min(x0, x1), max(x0, x1)
    y0, y1 = min(y0, y1), max(y0, y1)
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    dx = np.maximum(np.maximum(x0 - xs, xs - x1), 0)
    dy = np.maximum(np.maximum(y0 - ys, ys - y1), 0)
    inside = (dx == 0) & (dy == 0)
    edge = np.minimum(np.minimum(xs - x0, x1 - xs),
                      np.minimum(ys - y0, y1 - ys))
    return np.where(inside, edge <= 1, dx * dx + dy * dy <= 1)


def draw_box_mask(image_rgb: np.ndarray, boxes_xyxy, color, masks=None,
                  alpha: float = 0.45) -> np.ndarray:
    """Boxes (and, when given, binary masks) drawn on an RGB u8 image."""
    img = image_rgb.copy()
    if masks is not None:
        overlay = img.copy()
        for m in masks:
            overlay[m.astype(bool)] = color
        img = blend(img, overlay, alpha)
    h, w = img.shape[:2]
    for b in boxes_xyxy:
        img[outline(h, w, b)] = color
    return img


def _model(cfg: Config, tokenizer, device):
    from toist_tpu_torch.models.init import init_like_jax
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train.checkpoint import load_params

    if cfg.run.resume:
        return TOIST.from_state_dict(
            load_params(cfg.run.resume, prefer_ema=cfg.optim.ema),
            cfg.model, device)
    with torch.device(device):
        model = TOIST(cfg.model, text_vocab_size=tokenizer.vocab_size)
    init_like_jax(model, torch.Generator(device).manual_seed(cfg.run.seed))
    return model.to_compute_dtype().eval()


def visualize(cfg: Config, out_dir: str, score_threshold: float = 0.95,
              max_images: Optional[int] = 20, device="cuda") -> int:
    """Render side-by-side GT / prediction images; returns the number
    written."""
    from PIL import Image

    from toist_tpu_torch import infer
    from toist_tpu_torch.data.batcher import BatchIterator
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.main import build_specs
    from toist_tpu_torch.models.postprocess import postprocess_masks_host
    from toist_tpu_torch.ops import rle as rle_ops

    os.makedirs(out_dir, exist_ok=True)
    tokenizer = build_tokenizer(cfg)
    spec = build_specs(cfg)[1]
    model = _model(cfg, tokenizer, torch.device(device))
    written = 0
    for task in cfg.data.tasks:
        ds = build_task_dataset(cfg.data, task, "val", tokenizer,
                                masks=cfg.model.masks)
        it = BatchIterator([ds], spec, batch_size=1, shuffle=False)
        for batch in it.epoch(0):
            out, x = infer.forward(model, batch)
            post = infer.postprocess(out, x)
            if not batch["sample_valid"][0]:
                continue
            image_id = int(batch["image_id"][0])
            info = ds.coco.imgs[image_id]
            rgb = np.asarray(Image.open(os.path.join(
                ds.img_dir, info["file_name"])).convert("RGB"))
            oh, ow = rgb.shape[:2]

            keep = (post["scores"][0] > score_threshold).cpu()
            pred_boxes = post["boxes"][0][keep].cpu().numpy()
            pred_masks = None
            if cfg.model.masks and "pred_masks" in out:
                rles = postprocess_masks_host(
                    out["pred_masks"][:, keep.to(out["pred_masks"].device)],
                    batch["size"], batch["orig_size"],
                    batch["sample_valid"])
                if rles[0] is not None:
                    pred_masks = [rle_ops.decode(r) for r in rles[0]]

            anns = [a for a in ds.coco.img_to_anns.get(image_id, [])
                    if a.get("category_id") == 1]
            gt_boxes = [[a["bbox"][0], a["bbox"][1],
                         a["bbox"][0] + a["bbox"][2],
                         a["bbox"][1] + a["bbox"][3]] for a in anns]
            gt_masks = None
            if cfg.model.masks:
                gt_masks = [rle_ops.polygons_to_mask(a["segmentation"], oh,
                                                     ow)
                            for a in anns if isinstance(a.get("segmentation"),
                                                        list)]
            side = np.concatenate([
                draw_box_mask(rgb, gt_boxes, GT_COLOR, gt_masks),
                draw_box_mask(rgb, pred_boxes, PRED_COLOR, pred_masks)],
                axis=1)
            Image.fromarray(side).save(
                os.path.join(out_dir, f"task{task}_img{image_id}.png"))
            written += 1
            if max_images and written >= max_images:
                return written
    return written


def cli(argv=None):
    from toist_tpu_torch.main import _config, _parser

    args = _parser().parse_args(argv)
    cfg = _config(args)
    out = cfg.run.output_dir or "visualizations"
    n = visualize(cfg, out, device=args.device)
    print(f"wrote {n} visualizations to {out}")


if __name__ == "__main__":
    cli()
