"""Synthetic COCO-Tasks-format fixture dataset.

The port's own copy of ``toist_tpu/data/fixtures.py``, kept line for line so that it
diffs against it (the port imports nothing of the JAX package).

Generates a hermetic mini dataset (images + task_N_{train,test}.json + id2name.json)
with the exact schema the reference consumes (datasets/tdod.py:338-357): images dir
train2014/val2014, per-task annotation files, annotations carrying category_id (1 =
preferred), COCO_category_id (the underlying COCO class), bbox xywh, polygon
segmentation, area, iscrowd.

Objects are simple colored rectangles and ellipses drawn on noise backgrounds, so a
model can actually learn/overfit them and eval numbers are meaningful.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw

FIXTURE_CATEGORIES = {
    44: "bottle", 46: "wine glass", 47: "cup", 48: "fork", 49: "knife",
    50: "spoon", 51: "bowl", 62: "chair", 63: "couch", 64: "potted plant",
}


def _ellipse_polygon(cx, cy, rx, ry, n=16) -> List[float]:
    ts = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([cx + rx * np.cos(ts), cy + ry * np.sin(ts)], 1)
    return [float(v) for v in pts.reshape(-1)]


def _rect_polygon(x0, y0, x1, y1) -> List[float]:
    return [x0, y0, x1, y0, x1, y1, x0, y1]


def generate_fixture(root: str, num_tasks: int = 2, imgs_per_split: int = 8,
                     img_size: Tuple[int, int] = (240, 320), seed: int = 0,
                     max_objects: int = 3) -> str:
    """Write a fixture dataset under `root`; returns root."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    with open(os.path.join(ann_dir, "id2name.json"), "w") as f:
        json.dump({str(k): v for k, v in FIXTURE_CATEGORIES.items()}, f)

    cat_ids = sorted(FIXTURE_CATEGORIES)
    next_img_id, next_ann_id = 1, 1
    h, w = img_size

    for task in range(1, num_tasks + 1):
        for split, sub in (("train", "train2014"), ("test", "val2014")):
            img_dir = os.path.join(root, sub)
            os.makedirs(img_dir, exist_ok=True)
            images, annotations = [], []
            for _ in range(imgs_per_split):
                img_id = next_img_id
                next_img_id += 1
                fname = f"fix_{img_id:08d}.jpg"
                bg = rng.integers(0, 60, size=(h, w, 3), dtype=np.uint8)
                im = Image.fromarray(bg, "RGB")
                draw = ImageDraw.Draw(im)
                n_obj = int(rng.integers(1, max_objects + 1))
                for oi in range(n_obj):
                    ow = int(rng.integers(30, w // 3))
                    oh = int(rng.integers(30, h // 3))
                    x0 = int(rng.integers(0, w - ow))
                    y0 = int(rng.integers(0, h - oh))
                    color = tuple(int(c) for c in rng.integers(90, 255, 3))
                    coco_cat = int(cat_ids[int(rng.integers(len(cat_ids)))])
                    preferred = bool(rng.uniform() < 0.7) or oi == 0
                    if rng.uniform() < 0.5:
                        draw.rectangle([x0, y0, x0 + ow, y0 + oh], fill=color)
                        poly = _rect_polygon(x0, y0, x0 + ow, y0 + oh)
                    else:
                        draw.ellipse([x0, y0, x0 + ow, y0 + oh], fill=color)
                        poly = _ellipse_polygon(x0 + ow / 2, y0 + oh / 2,
                                                ow / 2, oh / 2)
                    annotations.append({
                        "id": next_ann_id,
                        "image_id": img_id,
                        "category_id": 1 if preferred else 2,
                        "COCO_category_id": coco_cat,
                        "bbox": [x0, y0, ow, oh],
                        "area": float(ow * oh),
                        "iscrowd": 0,
                        "segmentation": [poly],
                    })
                    next_ann_id += 1
                im.save(os.path.join(img_dir, fname), quality=90)
                images.append({"id": img_id, "file_name": fname,
                               "height": h, "width": w})
            ann = {
                "images": images,
                "annotations": annotations,
                "categories": ([{"id": 1, "name": "preferred"},
                                {"id": 2, "name": "other"}]),
            }
            with open(os.path.join(ann_dir, f"task_{task}_{split}.json"),
                      "w") as f:
                json.dump(ann, f)
    return root


def fixture_captions() -> List[str]:
    """Corpus for BPE training: every caption the fixture datasets can emit."""
    from toist_tpu_torch.data.cocotasks import TASKS
    caps = []
    for t in TASKS.values():
        caps.append(t + "something")
        for name in FIXTURE_CATEGORIES.values():
            caps.append(t + name)
    return caps
