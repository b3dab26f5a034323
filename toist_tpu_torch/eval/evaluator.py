"""Per-task evaluation driver (the reference's TDODCocoEvaluator equivalent).

Collects postprocessed predictions batch by batch, converts them to COCO detection
records (xyxy -> xywh, mask -> RLE; reference datasets/coco_eval.py:232-288), merges
across hosts, and scores with the numpy COCOEval pinned to category 1.

The reference gathers pickled pycocotools evalImgs across ranks
(coco_eval.py:322-341); here each host contributes fixed-shape prediction arrays and
the merge is a simple list concatenation keyed by image id.

The port's own copy of ``toist_tpu/eval/evaluator.py``, line for line but for the
transport of one method: ``synchronize_between_processes`` gathers the pickled
records with ``torch.distributed`` (``utils/dist.all_gather_object``) where the JAX
package uses ``jax.experimental.multihost_utils``; the per-image-ownership merge is
the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from toist_tpu_torch.eval.coco_eval import COCOEval, EvalParams
from toist_tpu_torch.ops import rle as rle_ops


def gt_records_from_json(coco_json: dict) -> List[dict]:
    """COCO-Tasks annotation dicts -> GT records for COCOEval (preferred only)."""
    out = []
    img_hw = {im["id"]: (im["height"], im["width"])
              for im in coco_json.get("images", [])}
    for a in coco_json.get("annotations", []):
        if a.get("category_id") != 1:
            continue
        rec = {
            "id": a["id"],
            "image_id": a["image_id"],
            "category_id": 1,
            "bbox": list(map(float, a["bbox"])),
            "area": float(a.get("area", a["bbox"][2] * a["bbox"][3])),
            "iscrowd": int(a.get("iscrowd", 0)),
        }
        seg = a.get("segmentation")
        if seg is not None and a["image_id"] in img_hw:
            h, w = img_hw[a["image_id"]]
            if isinstance(seg, dict):
                rec["segmentation"] = rle_ops.frPyObjects(seg, h, w)
            else:
                rec["segmentation"] = rle_ops.encode(
                    rle_ops.polygons_to_mask(seg, h, w))
        out.append(rec)
    return out


class TaskEvaluator:
    """Accumulates one task's predictions; scores bbox (and optionally segm)."""

    def __init__(self, gt_records: Sequence[dict], iou_types=("bbox",),
                 score_threshold: float = 0.0):
        self.gt_records = list(gt_records)
        self.iou_types = tuple(iou_types)
        self.score_threshold = score_threshold
        self.dt_records: List[dict] = []
        self._seen_imgs = set()

    def update(self, image_ids: np.ndarray, scores: np.ndarray,
               boxes_xyxy: np.ndarray, valid: Optional[np.ndarray] = None,
               masks: Optional[List[Optional[List[dict]]]] = None) -> None:
        """Add one batch: image_ids [B], scores [B,Q], boxes [B,Q,4] absolute xyxy.

        `masks`, if given, is a per-sample list of per-query RLE dicts.
        Batch-padding rows are skipped via `valid` [B].
        """
        B, Q = scores.shape
        for b in range(B):
            if valid is not None and not valid[b]:
                continue
            img_id = int(image_ids[b])
            if img_id in self._seen_imgs:
                continue  # an image evaluated once (duplicate batch pad guard)
            self._seen_imgs.add(img_id)
            for q in range(Q):
                sc = float(scores[b, q])
                if sc < self.score_threshold:
                    continue
                x0, y0, x1, y1 = map(float, boxes_xyxy[b, q])
                rec = {
                    "image_id": img_id,
                    "category_id": 1,
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "score": sc,
                }
                if masks is not None and masks[b] is not None:
                    rec["segmentation"] = masks[b][q]
                    rec["area"] = float(rle_ops.area(masks[b][q]))
                self.dt_records.append(rec)

    def synchronize_between_processes(self) -> None:
        """Merge detection records across hosts (no-op single-host)."""
        from toist_tpu_torch.utils import dist
        if dist.process_count() == 1:
            return
        gathered = dist.all_gather_object(self.dt_records)
        # Per-image ownership: every image is scored by exactly one host (the
        # lowest-indexed one that produced records for it). The data sharding
        # already assigns each image to one host; ownership here only guards
        # against batch-pad duplicates, and — unlike a per-record dedup key —
        # can never drop two distinct detections that happen to coincide.
        merged, owner = [], {}
        for i, recs in enumerate(gathered):
            for r in recs:
                if owner.setdefault(r["image_id"], i) == i:
                    merged.append(r)
        self.dt_records = merged

    def summarize(self) -> Dict[str, np.ndarray]:
        """Returns {'bbox': stats12, 'segm': stats12?}; stats[1] = AP@0.5."""
        out = {}
        for iou_type in self.iou_types:
            gts = self.gt_records
            dts = self.dt_records
            if iou_type == "segm":
                gts = [g for g in gts if "segmentation" in g]
                dts = [d for d in dts if "segmentation" in d]
            ev = COCOEval(gts, dts, iou_type=iou_type, params=EvalParams())
            out[iou_type] = ev.stats()
        return out


def mean_ap50(per_task_stats: Dict[int, Dict[str, np.ndarray]],
              iou_type: str = "bbox") -> float:
    """The COCO-Tasks headline number: mean AP@0.5 over tasks (main.py:581-590)."""
    vals = [s[iou_type][1] for s in per_task_stats.values()
            if s[iou_type][1] > -1]
    return float(np.mean(vals)) if vals else -1.0
