"""COCO detection/segmentation mAP evaluation, from scratch in numpy.

Implements the published COCOeval algorithm semantics (the reference wraps
pycocotools' COCOeval, datasets/coco_eval.py:170-220; pycocotools is not available in
this image, so this module is the framework's metric core):

  * per-(image, category) greedy matching of score-sorted detections to GTs at 10 IoU
    thresholds, crowd GTs matchable many times and ignored, area-range ignore rules,
    unmatched out-of-range detections ignored
  * accumulation with stable score sort across images, precision envelope, 101-point
    recall interpolation
  * the standard 12-element stats vector; stats[1] = AP@0.5 is THE COCO-Tasks metric
    (reference main.py:570,581-590)

Box IoU follows the COCO convention (xywh, crowd union = det area). Mask IoU uses the
C++ RLE core (toist_tpu_torch.ops.rle).

The port's own copy of ``toist_tpu/eval/coco_eval.py``, line for line; only its
imports name the port's RLE module and native library.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from toist_tpu_torch.ops import rle as rle_ops


@dataclasses.dataclass
class EvalParams:
    iou_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.5, 0.95, 10))
    rec_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.0, 1.0, 101))
    max_dets: Tuple[int, ...] = (1, 10, 100)
    area_rngs: Tuple[Tuple[float, float], ...] = (
        (0.0, 1e10), (0.0, 32.0 ** 2), (32.0 ** 2, 96.0 ** 2), (96.0 ** 2, 1e10))
    area_labels: Tuple[str, ...] = ("all", "small", "medium", "large")
    cat_ids: Tuple[int, ...] = (1,)   # COCO-Tasks pins catIds=1 (coco_eval.py:202)


def _native_match(ious: np.ndarray, gt_ignore: np.ndarray,
                  iscrowd: np.ndarray, thrs: np.ndarray, D: int, G: int):
    """C++ greedy matcher; returns (dtm_idx [T,D] 1-based, dt_ignore [T,D])."""
    import ctypes

    from toist_tpu_torch import native

    T = len(thrs)
    dtm = np.zeros((T, D), np.int32)
    dt_ig = np.zeros((T, D), np.uint8)
    gtm = np.zeros((T, max(G, 1)), np.int32)
    if D:
        lib = native.load()
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        gi = np.ascontiguousarray(gt_ignore, np.uint8)
        ic = np.ascontiguousarray(iscrowd, np.uint8)
        lib.coco_match(ious.ctypes.data_as(f64p), D, G,
                       gi.ctypes.data_as(u8p), ic.ctypes.data_as(u8p),
                       np.ascontiguousarray(thrs).ctypes.data_as(f64p), T,
                       dtm.ctypes.data_as(i32p), dt_ig.ctypes.data_as(u8p),
                       gtm.ctypes.data_as(i32p))
    return dtm, dt_ig.astype(bool)


def box_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                 iscrowd: np.ndarray) -> np.ndarray:
    """[D,4],[G,4] xywh -> [D,G] IoU with crowd handling."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx0, dy0 = dt[:, 0], dt[:, 1]
    dx1, dy1 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = (np.minimum(dx1[:, None], gx1[None]) -
          np.maximum(dx0[:, None], gx0[None])).clip(0)
    iy = (np.minimum(dy1[:, None], gy1[None]) -
          np.maximum(dy0[:, None], gy0[None])).clip(0)
    inter = ix * iy
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEval:
    """Evaluate detections against ground truth.

    gts / dts: lists of dicts with keys
      gt: image_id, category_id, bbox (xywh), area, iscrowd, id, [segmentation RLE]
      dt: image_id, category_id, bbox (xywh), score, [segmentation RLE]
    """

    def __init__(self, gts: Sequence[dict], dts: Sequence[dict],
                 iou_type: str = "bbox", params: Optional[EvalParams] = None):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type
        self.p = params or EvalParams()
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for i, g in enumerate(gts):
            g = dict(g)
            g.setdefault("id", i + 1)
            g.setdefault("iscrowd", 0)
            self._gts[(g["image_id"], g["category_id"])].append(g)
        for i, d in enumerate(dts):
            d = dict(d)
            d.setdefault("id", i + 1)
            self._dts[(d["image_id"], d["category_id"])].append(d)
        self.img_ids = sorted({k[0] for k in self._gts} |
                              {k[0] for k in self._dts})
        self.eval_imgs: Dict[Tuple, Optional[dict]] = {}
        self.eval: Optional[dict] = None

    # -- per-image evaluation ------------------------------------------------

    def _compute_iou(self, img_id, cat_id, max_det) -> np.ndarray:
        gt = self._gts[(img_id, cat_id)]
        dt = sorted(self._dts[(img_id, cat_id)],
                    key=lambda d: -d["score"])[:max_det]
        if not gt or not dt:
            return np.zeros((len(dt), len(gt)))
        iscrowd = np.array([g["iscrowd"] for g in gt])
        if self.iou_type == "bbox":
            return box_iou_xywh(np.array([d["bbox"] for d in dt], float),
                                np.array([g["bbox"] for g in gt], float),
                                iscrowd)
        return rle_ops.iou([d["segmentation"] for d in dt],
                           [g["segmentation"] for g in gt],
                           iscrowd.tolist())

    def evaluate_img(self, img_id, cat_id, area_rng, max_det,
                     ious: np.ndarray) -> Optional[dict]:
        gt = self._gts[(img_id, cat_id)]
        dt = sorted(self._dts[(img_id, cat_id)], key=lambda d: -d["score"])
        if not gt and not dt:
            return None
        gt_ignore_base = np.array(
            [g["iscrowd"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]
             for g in gt], bool) if gt else np.zeros(0, bool)
        # Sort gt: non-ignored first (stable), like pycocotools.
        gt_order = np.argsort(gt_ignore_base, kind="stable")
        gt_sorted = [gt[i] for i in gt_order]
        gt_ig = gt_ignore_base[gt_order]
        dt = dt[:max_det]
        iscrowd = np.array([g["iscrowd"] for g in gt_sorted], bool)
        ious_s = ious[:, gt_order] if len(gt) else ious

        T = len(self.p.iou_thrs)
        D, G = len(dt), len(gt_sorted)
        # Greedy matching runs in C++ (toist_native.coco_match); the Python
        # loop is the dominant cost of full-dataset eval otherwise.
        dtm_idx, dt_ig = _native_match(
            np.ascontiguousarray(ious_s, np.float64), gt_ig, iscrowd,
            np.asarray(self.p.iou_thrs, np.float64), D, G)
        gt_ids = np.array([g["id"] for g in gt_sorted], np.int64) \
            if G else np.zeros(0, np.int64)
        dtm = np.where(dtm_idx > 0, gt_ids[np.maximum(dtm_idx - 1, 0)]
                       if G else 0, 0)
        # Unmatched detections outside the area range are ignored.
        d_areas = np.array(
            [d.get("area", d["bbox"][2] * d["bbox"][3]) for d in dt]) \
            if D else np.zeros(0)
        d_out = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
        dt_ig = dt_ig | ((dtm == 0) & d_out[None, :])
        return {
            "dt_matches": dtm,
            "dt_scores": np.array([d["score"] for d in dt]),
            "dt_ignore": dt_ig,
            "gt_ignore": gt_ig,
            "num_gt": int((~gt_ig).sum()),
        }

    # -- accumulate ----------------------------------------------------------

    def run(self) -> dict:
        p = self.p
        max_det_largest = max(p.max_dets)
        ious = {(img, cat): self._compute_iou(img, cat, max_det_largest)
                for img in self.img_ids for cat in p.cat_ids}

        T, R = len(p.iou_thrs), len(p.rec_thrs)
        K, A, M = len(p.cat_ids), len(p.area_rngs), len(p.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat in enumerate(p.cat_ids):
            for a, area_rng in enumerate(p.area_rngs):
                for m, max_det in enumerate(p.max_dets):
                    evs = [self.evaluate_img(img, cat, area_rng, max_det,
                                             ious[(img, cat)])
                           for img in self.img_ids]
                    evs = [e for e in evs if e is not None]
                    if not evs:
                        continue
                    dt_scores = np.concatenate([e["dt_scores"] for e in evs])
                    order = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores_sorted = dt_scores[order]
                    dtm = np.concatenate([e["dt_matches"] for e in evs],
                                         axis=1)[:, order]
                    dt_ig = np.concatenate([e["dt_ignore"] for e in evs],
                                           axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in evs)
                    if npig == 0:
                        continue
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        # Exactly pycocotools' guard: ADD spacing(1), never
                        # clamp — tied-to-the-last-ulp parity on pr values.
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # Precision envelope (monotone from the right).
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, p.rec_thrs, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dt_scores_sorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {"precision": precision, "recall": recall,
                     "scores": scores, "params": p}
        return self.eval

    # -- summarize -----------------------------------------------------------

    def _summarize(self, ap: bool, iou_thr: Optional[float] = None,
                   area: str = "all", max_det: int = 100) -> float:
        p = self.p
        aind = p.area_labels.index(area)
        mind = list(p.max_dets).index(max_det)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(p.iou_thrs, iou_thr))[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(p.iou_thrs, iou_thr))[0]]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def stats(self) -> np.ndarray:
        """The standard 12-element COCO stats vector; stats[1] = AP@0.5."""
        if self.eval is None:
            self.run()
        md = max(self.p.max_dets)
        s = np.array([
            self._summarize(True, None, "all", md),
            self._summarize(True, 0.5, "all", md),
            self._summarize(True, 0.75, "all", md),
            self._summarize(True, None, "small", md),
            self._summarize(True, None, "medium", md),
            self._summarize(True, None, "large", md),
            self._summarize(False, None, "all", self.p.max_dets[0]),
            self._summarize(False, None, "all", self.p.max_dets[1]),
            self._summarize(False, None, "all", self.p.max_dets[2]),
            self._summarize(False, None, "small", md),
            self._summarize(False, None, "medium", md),
            self._summarize(False, None, "large", md),
        ])
        return s
