"""Image + box/mask/caption transforms on numpy/PIL (host data pipeline).

The port's own copy of ``toist_tpu/data/transforms.py``, kept line for line so that it
diffs against it (the port imports nothing of the JAX package).

Behavioral spec from reference datasets/transforms.py: box-aware crop (:18-59),
hflip with caption left/right swap (:62-80), aspect-preserving resize with max_size
(:83-138), RandomSizeCrop with respect_boxes retry<=150 (:163-181), Normalize that also
converts boxes to normalized cxcywh (:257-273). Rewritten for numpy HWC arrays with an
explicit np.random.Generator (the reference uses the global `random` module; explicit
state makes the pipeline reproducible and shardable).

Targets are plain dicts of numpy arrays:
  boxes [N,4] xyxy absolute (until Normalize), labels [N], area [N], iscrowd [N],
  masks [N,H,W] uint8 (optional), caption str, tokens_positive / noun_tokens_positive
  (list per box), positive_map [N,256], size (h,w), orig_size (h,w).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_PER_BOX_FIELDS = ("labels", "area", "iscrowd", "positive_map", "boxes", "masks",
                   "tokens_positive", "noun_tokens_positive")


def _filter_boxes(target: dict, keep: np.ndarray) -> dict:
    out = dict(target)
    for f in _PER_BOX_FIELDS:
        if f in out:
            v = out[f]
            if isinstance(v, list):
                out[f] = [x for x, k in zip(v, keep) if k]
            else:
                out[f] = v[keep]
    return out


def crop(image: Image.Image, target: dict, region: Tuple[int, int, int, int]):
    """region = (top, left, h, w) — reference transforms.py:18-59."""
    i, j, h, w = region
    image = image.crop((j, i, j + w, i + h))
    target = dict(target)
    target["size"] = np.array([h, w])
    if "boxes" in target:
        boxes = target["boxes"] - np.array([j, i, j, i], np.float32)
        boxes = boxes.reshape(-1, 2, 2)
        boxes = np.minimum(boxes, np.array([w, h], np.float32))
        boxes = np.clip(boxes, 0, None)
        target["area"] = np.prod(boxes[:, 1] - boxes[:, 0], axis=1)
        target["boxes"] = boxes.reshape(-1, 4)
    if "masks" in target:
        target["masks"] = target["masks"][:, i:i + h, j:j + w]
    if "boxes" in target or "masks" in target:
        if "boxes" in target:
            b = target["boxes"].reshape(-1, 2, 2)
            keep = np.all(b[:, 1] > b[:, 0], axis=1)
        else:
            keep = target["masks"].reshape(len(target["masks"]), -1).any(1)
        target = _filter_boxes(target, keep)
    return image, target


def hflip(image: Image.Image, target: dict):
    image = image.transpose(Image.FLIP_LEFT_RIGHT)
    w = image.size[0]
    target = dict(target)
    if "boxes" in target:
        b = target["boxes"]
        target["boxes"] = np.stack(
            [w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], axis=1)
    if "masks" in target:
        target["masks"] = target["masks"][:, :, ::-1].copy()
    if "caption" in target:
        target["caption"] = (target["caption"].replace("left", "[TMP]")
                             .replace("right", "left").replace("[TMP]", "right"))
    return image, target


def get_size_with_aspect_ratio(image_size: Tuple[int, int], size: int,
                               max_size: Optional[int] = None) -> Tuple[int, int]:
    """(w, h), short-side target -> output (oh, ow). Reference :86-104."""
    w, h = image_size
    if max_size is not None:
        min_o, max_o = float(min(w, h)), float(max(w, h))
        if max_o / min_o * size > max_size:
            size = int(round(max_size * min_o / max_o))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return (oh, ow)


def resize(image: Image.Image, target: Optional[dict], size,
           max_size: Optional[int] = None):
    if isinstance(size, (list, tuple)):
        oh, ow = size[::-1]
    else:
        oh, ow = get_size_with_aspect_ratio(image.size, size, max_size)
    rescaled = image.resize((ow, oh), Image.BILINEAR)
    if target is None:
        return rescaled, None
    rw = ow / image.size[0]
    rh = oh / image.size[1]
    target = dict(target)
    if "boxes" in target:
        target["boxes"] = target["boxes"] * np.array([rw, rh, rw, rh], np.float32)
    if "area" in target:
        target["area"] = target["area"] * (rw * rh)
    target["size"] = np.array([oh, ow])
    if "masks" in target and len(target["masks"]):
        m = target["masks"]
        # nearest-neighbor resize per mask (reference uses interpolate nearest >0.5)
        ys = (np.arange(oh) * (m.shape[1] / oh)).astype(np.int64)
        xs = (np.arange(ow) * (m.shape[2] / ow)).astype(np.int64)
        target["masks"] = m[:, ys][:, :, xs]
    elif "masks" in target:
        target["masks"] = np.zeros((0, oh, ow), np.uint8)
    return rescaled, target


_NORM_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_NORM_SHIFT = (IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)


def _boxes_to_normalized_cxcywh(target: Optional[dict], h: int, w: int):
    """Boxes xyxy absolute -> normalized cxcywh (reference :257-273)."""
    if target is None:
        return None
    target = dict(target)
    if "boxes" in target and len(target["boxes"]):
        b = target["boxes"]
        cxcywh = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                           b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)
        target["boxes"] = cxcywh / np.array([w, h, w, h], np.float32)
    return target


def to_array_and_normalize(image: Image.Image, target: Optional[dict]):
    """PIL -> float32 HWC normalized; boxes -> normalized cxcywh (reference :257-273)."""
    # (x/255 - mean)/std == x*scale - shift, computed without a separate
    # uint8->f32 astype pass (the convert() copy and the extra pass were
    # ~40% of the measured per-image host cost on a 1-core VM).
    if image.mode != "RGB":
        image = image.convert("RGB")
    u8 = np.asarray(image)
    arr = np.empty(u8.shape, np.float32)
    np.multiply(u8, _NORM_SCALE, out=arr)
    np.subtract(arr, _NORM_SHIFT, out=arr)
    if target is None:
        return arr, None
    h, w = arr.shape[:2]
    return arr, _boxes_to_normalized_cxcywh(target, h, w)


def to_array_u8(image: Image.Image, target: Optional[dict]):
    """PIL -> uint8 HWC, normalization deferred to the device; boxes as above.

    The geometric transforms operate on u8 PIL images (like the reference,
    whose Normalize runs after ToTensor), so shipping u8 and normalizing
    on-device with the same x*scale - shift affine is bit-equivalent to
    to_array_and_normalize while moving 4x fewer host->device bytes and
    skipping the host f32 pass (models/toist.py normalize_uint8_images)."""
    if image.mode != "RGB":
        image = image.convert("RGB")
    arr = np.ascontiguousarray(np.asarray(image))
    if target is None:
        return arr, None
    h, w = arr.shape[:2]
    return arr, _boxes_to_normalized_cxcywh(target, h, w)


# --------------------------------------------------------------------------
# Composable transform objects; every random op takes rng explicitly.
# --------------------------------------------------------------------------

class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, target, rng: np.random.Generator):
        for t in self.transforms:
            img, target = t(img, target, rng)
        return img, target


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, target, rng):
        if rng.uniform() < self.p:
            return hflip(img, target)
        return img, target


class RandomResize:
    def __init__(self, sizes, max_size=None):
        self.sizes = list(sizes)
        self.max_size = max_size

    def __call__(self, img, target, rng):
        size = self.sizes[rng.integers(len(self.sizes))]
        return resize(img, target, size, self.max_size)


class RandomSizeCrop:
    def __init__(self, min_size: int, max_size: int, respect_boxes: bool = False):
        self.min_size = min_size
        self.max_size = max_size
        self.respect_boxes = respect_boxes

    def __call__(self, img, target, rng):
        init_boxes = len(target["boxes"])
        # Clamp so images outside [min_size, max_size] stay valid (the
        # reference assumes pre-resize >= 400 and would raise otherwise).
        whi = min(img.width, self.max_size)
        hhi = min(img.height, self.max_size)
        wlo = min(self.min_size, whi)
        hlo = min(self.min_size, hhi)
        for _ in range(150):
            w = int(rng.integers(wlo, whi + 1))
            h = int(rng.integers(hlo, hhi + 1))
            top = int(rng.integers(0, img.height - h + 1))
            left = int(rng.integers(0, img.width - w + 1))
            out_img, out_t = crop(img, target, (top, left, h, w))
            if not self.respect_boxes or len(out_t["boxes"]) == init_boxes:
                return out_img, out_t
        return img, target


class RandomSelect:
    def __init__(self, t1, t2, p: float = 0.5):
        self.t1, self.t2, self.p = t1, t2, p

    def __call__(self, img, target, rng):
        return self.t1(img, target, rng) if rng.uniform() < self.p \
            else self.t2(img, target, rng)


class Normalize:
    """to_float=False keeps the image u8 for on-device normalization
    (DataConfig.device_normalize); box conversion is identical either way."""

    def __init__(self, to_float: bool = True):
        self.to_float = to_float

    def __call__(self, img, target, rng):
        if self.to_float:
            return to_array_and_normalize(img, target)
        return to_array_u8(img, target)


def make_transforms(image_set: str, cautious: bool = True,
                    scales=(480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800),
                    max_size: int = 1333, val_size: int = 800,
                    device_normalize: bool = False):
    """Train/val recipes (reference datasets/tdod.py:301-335)."""
    normalize = Normalize(to_float=not device_normalize)
    if image_set == "train":
        horizontal = [] if cautious else [RandomHorizontalFlip()]
        # The reference hardcodes pre-crop scales [400, 500, 600] and crop
        # min 384 for max scale 800; keep those exact values there and scale
        # them proportionally for non-default scale sets (tiny test configs).
        m = max(scales)
        if m == 800:
            pre_crop, crop_min = [400, 500, 600], 384
        else:
            pre_crop = sorted({max(1, m // 2), max(1, (m * 5) // 8),
                               max(1, (m * 3) // 4)})
            crop_min = max(1, (m * 48) // 100)
        return Compose(horizontal + [
            RandomSelect(
                RandomResize(scales, max_size=max_size),
                Compose([
                    RandomResize(pre_crop),
                    RandomSizeCrop(crop_min, max_size, respect_boxes=cautious),
                    RandomResize(scales, max_size=max_size),
                ])),
            normalize,
        ])
    if image_set == "val":
        return Compose([RandomResize([val_size], max_size=max_size), normalize])
    raise ValueError(f"unknown image_set {image_set}")
