"""COCO-Tasks dataset: json parsing, caption construction, annotation prep.

The port's own copy of ``toist_tpu/data/cocotasks.py``, kept line for line so that it
diffs against it (the port imports nothing of the JAX package).

Behavioral spec from reference datasets/tdod.py:
  * 14 verb-phrase tasks (:23-38)
  * caption modes — pronoun "verb + something" (:82-89), teacher "verb + noun" built
    from GT COCO_category_id names (:66-79), distillation train returning paired
    (noun, sth) samples sharing post-transform geometry (:90-120)
  * only category_id == 1 ("preferred") annotations kept (:199), iscrowd dropped (:198)
  * tokens_positive char spans: whole caption for pronoun mode (:241-249), task+noun
    span for teacher mode (:229-240); noun_tokens_positive for distillation
  * degenerate boxes dropped after clamping (:251)
  * positive_map via tokenizer char_to_token (:294-297)

No torch DataLoader: samples are plain numpy dicts consumed by data/batcher.py.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from toist_tpu_torch.data import transforms as T
from toist_tpu_torch.data.positive_map import create_positive_map, token_span
from toist_tpu_torch.data.tokenizer import RobertaBPE
from toist_tpu_torch.ops import rle as rle_ops

TASKS: Dict[int, str] = {
    1: "step on ",
    2: "sit comfortably on ",
    3: "place flowers in ",
    4: "get potatoes out of fire with ",
    5: "water plant with ",
    6: "get lemon out of tea with ",
    7: "dig hole with ",
    8: "open bottle of beer with ",
    9: "open parcel with ",
    10: "serve wine with ",
    11: "pour sugar with ",
    12: "smear butter with ",
    13: "extinguish fire with ",
    14: "pound carpet with ",
}


class CocoTasksJson:
    """Minimal indexed view of a COCO-format annotation file."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.anns = {a["id"]: a for a in data.get("annotations", [])}
        self.img_to_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for a in data.get("annotations", []):
            self.img_to_anns.setdefault(a["image_id"], []).append(a)
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_ids = sorted(self.imgs.keys())


def _caption_noun(task_caption: str, anns: List[dict],
                  catid2name: Dict[str, str]) -> str:
    """Teacher caption: space-joined unique 'verb + noun' phrases.

    The reference uses list(set(...)) (tdod.py:69) whose order is hash-dependent;
    here insertion order of first occurrence is kept (deterministic)."""
    seen, parts = set(), []
    for item in anns:
        if item["category_id"] != 1:
            continue
        phrase = task_caption + catid2name[str(item["COCO_category_id"])]
        if phrase not in seen:
            seen.add(phrase)
            parts.append(phrase)
    return " ".join(parts)


def prepare_annotations(anno: List[dict], caption: str, task_caption: str,
                        w: int, h: int, gt_obj: int,
                        catid2name: Optional[Dict[str, str]],
                        return_masks: bool, tokenizer: RobertaBPE,
                        num_cols: int = 256) -> dict:
    """Reference TOISTConvertCocoPolysToMask.__call__ (tdod.py:186-298)."""
    anno = [o for o in anno if o.get("iscrowd", 0) == 0]
    anno = [o for o in anno if o["category_id"] == 1]  # preferred objects only

    boxes = np.asarray([o["bbox"] for o in anno], np.float32).reshape(-1, 4)
    boxes[:, 2:] += boxes[:, :2]  # xywh -> xyxy
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    classes = np.asarray([o["category_id"] for o in anno], np.int64)

    masks = None
    if return_masks:
        ms = []
        for o in anno:
            seg = o.get("segmentation")
            if seg is None:
                ms.append(np.zeros((h, w), np.uint8))
            elif isinstance(seg, dict):
                ms.append(rle_ops.decode(rle_ops.frPyObjects(seg, h, w)))
            else:
                ms.append(rle_ops.polygons_to_mask(seg, h, w))
        masks = (np.stack(ms) if ms else np.zeros((0, h, w), np.uint8))

    tokens_positive, noun_tokens_positive = [], []
    if gt_obj == 1:  # noun (teacher) mode: span of "verb + noun" per box
        for o in anno:
            name = task_caption + catid2name[str(o["COCO_category_id"])]
            b = caption.find(name)
            tokens_positive.append([[b, b + len(name)]])
        for o in anno:
            name = catid2name[str(o["COCO_category_id"])]
            b = caption.find(name)
            noun_tokens_positive.append([[b, b + len(name)]])
    else:  # pronoun mode: whole caption per box; noun span = "something"
        for _ in anno:
            tokens_positive.append([[0, len(caption)]])
        b = caption.find("something")
        for _ in anno:
            noun_tokens_positive.append([[b, b + len("something")]])

    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    area = np.asarray([o["area"] for o in anno], np.float32)
    iscrowd = np.asarray([o.get("iscrowd", 0) for o in anno], np.int64)

    target = {
        "boxes": boxes[keep],
        "labels": classes[keep],
        "caption": caption,
        "tokens_positive": [t for t, k in zip(tokens_positive, keep) if k],
        "noun_tokens_positive": [t for t, k in zip(noun_tokens_positive, keep) if k],
        "area": area[keep],
        "iscrowd": iscrowd[keep],
        "orig_size": np.array([h, w]),
        "size": np.array([h, w]),
    }
    if masks is not None:
        target["masks"] = masks[keep]
    return target


def finalize_text(target: dict, tokenizer: RobertaBPE, num_cols: int = 256,
                  max_text_len: int = 64) -> dict:
    """Tokenize caption, build positive_map + span arrays (static shapes).

    Done AFTER transforms because hflip may rewrite the caption
    (left/right swap, transforms.py hflip)."""
    tok = tokenizer.encode(target["caption"])
    target = dict(target)
    target["positive_map"] = create_positive_map(
        tok, target["tokens_positive"], num_cols)
    ids = tok.input_ids[:max_text_len]
    text_ids = np.full(max_text_len, 1, np.int32)  # PAD_ID = 1
    text_ids[:len(ids)] = ids
    target["text_ids"] = text_ids
    target["text_len"] = np.int32(len(ids))
    # Inclusive token spans per box for noun tokens (distillation losses).
    spans = np.full((len(target["noun_tokens_positive"]), 2), -1, np.int32)
    for i, sp in enumerate(target["noun_tokens_positive"]):
        ts = token_span(tok, sp[0][0], sp[0][1])
        if ts is not None:
            spans[i] = ts
    target["noun_token_spans"] = spans
    # Caption-level "something" span, independent of GT boxes: the reference's
    # cluster snapping derives it from the caption itself (mdetr.py:282-312,
    # captions[i].find('something')), so images with zero preferred annotations
    # are still snapped at eval time.
    cap_span = np.full(2, -1, np.int32)
    b = target["caption"].find("something")
    if b >= 0:
        ts = token_span(tok, b, b + len("something"))
        if ts is not None:
            cap_span[:] = ts
    target["caption_noun_span"] = cap_span
    return target


class CocoTasksDataset:
    """One task split. Yields per-index sample(s) depending on mode."""

    def __init__(self, img_dir: str, ann_file: str, task_id: int,
                 image_set: str, tokenizer: RobertaBPE,
                 catid2name: Optional[Dict[str, str]] = None,
                 return_masks: bool = False, verb_noun_input: bool = False,
                 distillation: bool = False, transforms=None,
                 max_text_len: int = 64):
        self.coco = CocoTasksJson(ann_file)
        self.img_dir = img_dir
        self.task_id = task_id
        self.task_caption = TASKS[task_id]
        self.image_set = image_set
        self.tokenizer = tokenizer
        self.catid2name = catid2name or {}
        self.return_masks = return_masks
        self.verb_noun_input = verb_noun_input
        self.distillation = distillation
        self.transforms = transforms
        self.max_text_len = max_text_len
        self.ids = self.coco.img_ids

    def __len__(self):
        return len(self.ids)

    def _load_image(self, image_id: int) -> Image.Image:
        info = self.coco.imgs[image_id]
        path = os.path.join(self.img_dir, info["file_name"])
        img = Image.open(path)
        # convert("RGB") on an already-RGB JPEG is a full-frame copy; skip it.
        return img if img.mode == "RGB" else img.convert("RGB")

    def _make(self, image, anns, image_id, gt_obj: int,
              rng: np.random.Generator) -> dict:
        w, h = image.size
        if gt_obj == 1:
            caption = _caption_noun(self.task_caption, anns, self.catid2name)
        else:
            caption = self.task_caption + "something"
        target = prepare_annotations(
            anns, caption, self.task_caption, w, h, gt_obj,
            self.catid2name, self.return_masks, self.tokenizer)
        target["image_id"] = image_id
        target["task_id"] = self.task_id
        if self.transforms is not None:
            image, target = self.transforms(image, target, rng)
        else:
            image, target = T.to_array_and_normalize(image, target)
        target = finalize_text(target, self.tokenizer,
                               max_text_len=self.max_text_len)
        target["image"] = image
        return target

    def get(self, idx: int, rng: np.random.Generator) -> List[dict]:
        """Returns [sample] or [noun_sample, sth_sample] (distillation train)."""
        image_id = self.ids[idx]
        anns = self.coco.img_to_anns.get(image_id, [])
        image = self._load_image(image_id)

        if self.distillation and self.image_set == "train":
            # Paired streams sharing identical transform geometry: replicate the
            # rng so both samples draw the same randomness (reference instead
            # copies post-transform tensors, tdod.py:104-115).
            seed = rng.integers(2**31)
            s_noun = self._make(image, anns, image_id, 1,
                                np.random.default_rng(seed))
            s_sth = self._make(image, anns, image_id, 0,
                               np.random.default_rng(seed))
            # Geometry (boxes/masks) must match exactly; captions differ.
            return [s_noun, s_sth]
        gt_obj = 1 if self.verb_noun_input else 0
        return [self._make(image, anns, image_id, gt_obj, rng)]


def build_task_dataset(cfg_data, task_id: int, image_set: str,
                       tokenizer: RobertaBPE, masks: bool = False,
                       distillation: bool = False) -> CocoTasksDataset:
    """Path layout per reference datasets/tdod.py:338-357."""
    sub = "train2014" if image_set == "train" else "val2014"
    split = "train" if image_set == "train" else "test"
    img_dir = os.path.join(cfg_data.coco_path, sub)
    ann_file = os.path.join(cfg_data.refexp_ann_path,
                            f"task_{task_id}_{split}.json")
    catid2name_path = os.path.join(cfg_data.refexp_ann_path, "id2name.json")
    catid2name = {}
    if os.path.exists(catid2name_path):
        with open(catid2name_path) as f:
            catid2name = json.load(f)
    tfs = T.make_transforms("train" if image_set == "train" else "val",
                            cautious=True, scales=list(cfg_data.train_scales),
                            max_size=cfg_data.max_size,
                            val_size=getattr(cfg_data, "val_size", 800),
                            device_normalize=getattr(cfg_data,
                                                     "device_normalize", False))
    return CocoTasksDataset(
        img_dir, ann_file, task_id, image_set, tokenizer,
        catid2name=catid2name, return_masks=masks,
        verb_noun_input=cfg_data.verb_noun_input, distillation=distillation,
        transforms=tfs, max_text_len=cfg_data.max_text_len)
