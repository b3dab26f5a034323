"""The port's evaluation (toist_tpu_torch.eval and train/engine.evaluate)
against the JAX package on the CPU.

- The copied ``COCOEval`` / ``TaskEvaluator`` give the JAX package's stats
  exactly (the cases of tests/test_coco_eval.py and seeded random ones).
- Both packages' ``evaluate`` fed one deterministic fake eval step
  (detections built from each batch's GT boxes plus jitter seeded by the
  image id) give identical per-task stats: the loop's batching, padded rows,
  duplicate images and task order, exactly.
- The tiny model on shared weights through both ``evaluate``s: per-batch
  detections within scores 1e-5 and boxes 1e-3 px, and equal stats; the
  tiny seg model with bbox and segm: mask logits within 2e-3 of their max
  abs and equal bbox and segm stats.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from toist_tpu.config import Config as JConfig
from toist_tpu.config import ModelConfig
from toist_tpu.data.cocotasks import build_task_dataset as jbuild_dataset
from toist_tpu.data.fixtures import generate_fixture
from toist_tpu.data.tokenizer import RobertaBPE as JaxBPE
from toist_tpu.eval import coco_eval as jcoco
from toist_tpu.eval import evaluator as jevaluator
from toist_tpu.models.toist import build_model
from toist_tpu.ops import rle as jrle
from toist_tpu.train import engine as jengine
from toist_tpu.train.criterion import build_weight_dict
from toist_tpu.train.step import make_eval_step as jax_make_eval_step
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.data.batcher import BucketSpec
from toist_tpu_torch.data.captions import build_tokenizer
from toist_tpu_torch.data.cocotasks import build_task_dataset
from toist_tpu_torch.eval import coco_eval as pcoco
from toist_tpu_torch.eval import evaluator as pevaluator
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.train import engine as pengine
from toist_tpu_torch.train.step import make_eval_step
from toist_tpu_torch.utils.convert import jax_params_to_state_dict

# tests/test_torch_train.py's TINY; the JAX side runs its unfused attention.
TINY = ModelConfig(
    backbone="resnet18-test", hidden_dim=64, nheads=4, dim_feedforward=128,
    enc_layers=2, dec_layers=2, num_queries=12, compute_dtype="float32",
    contrastive_align_loss=True, contrastive_hdim=16, text_hidden=64,
    text_layers=2, text_heads=4, text_intermediate=128, dropout=0.0,
    resizer_dropout=0.0, fused_attention="off")


def _g(img, x=0, y=0, w=10, h=10, crowd=0, gid=None, area=None):
    g = {"image_id": img, "category_id": 1, "bbox": [x, y, w, h],
         "area": float(w * h if area is None else area), "iscrowd": crowd}
    if gid is not None:
        g["id"] = gid
    return g


def _d(img, score, x=0, y=0, w=10, h=10):
    return {"image_id": img, "category_id": 1, "bbox": [x, y, w, h],
            "score": score}


def _mask_rle(rle_mod, bbox, hw=64):
    m = np.zeros((hw, hw), np.uint8)
    x, y, bw, bh = bbox
    m[y:y + bh, x:x + bw] = 1
    return rle_mod.encode(m)


def _random_case(seed, n_img=12):
    """Several images, 0-4 GTs each (a few crowd, a spread of areas), up to
    30 detections each: near and far jittered copies of the GTs and random
    boxes, with scores that tie in places (rounded to 0.05)."""
    rng = np.random.default_rng(seed)
    gts, dts, gid = [], [], 1
    for img in range(1, n_img + 1):
        boxes = []
        for _ in range(int(rng.integers(0, 5))):
            w, h = rng.uniform(3, 150, 2)
            x, y = rng.uniform(0, 400, 2)
            boxes.append([x, y, w, h])
            gts.append(_g(img, x, y, w, h, crowd=int(rng.uniform() < 0.1),
                          gid=gid))
            gid += 1
        for _ in range(int(rng.integers(0, 30))):
            if boxes and rng.uniform() < 0.6:
                x, y, w, h = boxes[int(rng.integers(len(boxes)))]
                j = rng.normal(scale=0.15, size=4)
                box = [x + j[0] * w, y + j[1] * h, w * (1 + j[2]),
                       h * (1 + j[3])]
            else:
                box = list(rng.uniform(0, 300, 2)) + list(
                    rng.uniform(2, 120, 2))
            dts.append(_d(img, float(np.round(rng.uniform(), 1) / 2 + 0.05),
                          *box))
    return gts, dts


# The cases of tests/test_coco_eval.py, by name: (gts, dts).
CASES = {
    "perfect": ([_g(1, 10, 10, 20, 20, gid=1), _g(1, 50, 50, 10, 10, gid=2)],
                [_d(1, 0.9, 10, 10, 20, 20), _d(1, 0.8, 50, 50, 10, 10)]),
    "fp_before_tp": ([_g(1, 10, 10, 20, 20, gid=1)],
                     [_d(1, 1.0, 200, 200, 5, 5), _d(1, 0.5, 10, 10, 20, 20)]),
    "localization": ([_g(1, 0, 0, 10, 10, gid=1)],
                     [_d(1, 0.9, 0, 0, 10, 6)]),
    "missed_gt": ([_g(1, 0, 0, 10, 10, gid=1), _g(1, 100, 100, gid=2)],
                  [_d(1, 0.9, 0, 0, 10, 10)]),
    "crowd": ([_g(1, 0, 0, 10, 10, gid=1),
               _g(1, 100, 100, 50, 50, gid=2, crowd=1)],
              [_d(1, 0.9, 0, 0), _d(1, 0.8, 100, 100, 50, 50),
               _d(1, 0.7, 110, 110, 40, 40)]),
    "area_ranges": ([_g(1, 0, 0, 4, 4, gid=1), _g(1, 50, 50, 100, 100, gid=2)],
                    [_d(1, 0.9, 0, 0, 4, 4), _d(1, 0.8, 50, 50, 100, 100)]),
    "max_dets": ([_g(1, i * 20, 0, gid=i + 1) for i in range(3)],
                 [_d(1, 0.99, 200, 200, 5, 5)]
                 + [_d(1, 0.5 - 0.01 * i, i * 20, 0) for i in range(3)]),
    "tied_scores": ([g for img in range(1, 9)
                     for g in (_g(img, 0), _g(img, 30))],
                    [d for img in range(1, 9)
                     for d in (_d(img, 0.5, 0), _d(img, 0.5, 100),
                               _d(img, 0.25, 30))]),
    "tied_hand": ([_g(1), _g(2)],
                  [_d(1, 0.5, 0), _d(1, 0.5, 100), _d(2, 0.5, 0),
                   _d(2, 0.5, 100)]),
    "det_count_boundary": ([_g(i) for i in range(1, 6)],
                           [_d(i, 0.9 - 0.1 * i) for i in range(1, 6)]),
    "all_ignored": ([_g(1, crowd=1), _g(2, crowd=1)],
                    [_d(1, 0.9), _d(2, 0.8)]),
    "crowd_and_real": ([_g(1, crowd=1), _g(2)], [_d(1, 0.9), _d(2, 0.8)]),
    "exact_recall": ([_g(1, 30 * i) for i in range(4)],
                     [_d(1, 0.9, 0), _d(1, 0.8, 30)]),
    "gt_ignore_order": ([_g(1, 0, crowd=1, gid=7), _g(1, 2, gid=8)],
                        [_d(1, 0.9, 0)]),
    "score_stability": ([_g(1, gid=3)], [_d(1, 0.7, 3), _d(1, 0.7, 0)]),
    "random_0": _random_case(0),
    "random_1": _random_case(1),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["segm_solid_masks"])
def test_coco_eval_matches_jax(case):
    if case == "segm_solid_masks":
        outs = []
        for co, rle_mod in ((jcoco, jrle), (pcoco, pevaluator.rle_ops)):
            gts = [dict(_g(1, 8.0, 8.0, 16.0, 16.0, gid=1),
                        segmentation=_mask_rle(rle_mod, [8, 8, 16, 16]))]
            dts = [dict(_d(1, 0.9, 10.0, 8.0, 16.0, 16.0),
                        segmentation=_mask_rle(rle_mod, [10, 8, 16, 16]))]
            outs.append([co.COCOEval(gts, dts, t).stats()
                         for t in ("bbox", "segm")])
        np.testing.assert_array_equal(outs[1], outs[0])
        return
    gts, dts = CASES[case]
    want = jcoco.COCOEval(gts, dts)
    got = pcoco.COCOEval(gts, dts)
    np.testing.assert_array_equal(got.stats(), want.stats())
    for k in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(got.eval[k], want.eval[k], err_msg=k)
    for img in want.img_ids:
        a = want.evaluate_img(img, 1, want.p.area_rngs[0], 100,
                              want._compute_iou(img, 1, 100))
        b = got.evaluate_img(img, 1, got.p.area_rngs[0], 100,
                             got._compute_iou(img, 1, 100))
        assert (a is None) == (b is None)
        for k in (a or {}):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _evaluator_case():
    """A COCO-Tasks annotation json of 4 images and two batches of 3
    detections with masks: image 3 in both, a padded row."""
    rng = np.random.default_rng(4)
    images = [{"id": i, "height": 64, "width": 80} for i in range(1, 5)]
    anns = []
    for i in range(1, 5):
        for j in range(2):
            x, y = rng.uniform(0, 40, 2)
            w, h = rng.uniform(8, 30, 2)
            anns.append({
                "id": 10 * i + j, "image_id": i,
                "category_id": 2 if (i, j) == (3, 1) else 1,
                "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
                "segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]]})
    coco_json = {"images": images, "annotations": anns}
    B, Q = 3, 6
    batches = []
    for ids in ([1, 2, 3], [3, 4, 4]):
        scores = rng.uniform(size=(B, Q))
        boxes = np.concatenate([rng.uniform(0, 40, (B, Q, 2)),
                                rng.uniform(40, 80, (B, Q, 2))], -1)
        masks = (rng.uniform(size=(B, Q, 64, 80)) < 0.5).astype(np.uint8)
        valid = np.array([True, True, ids[1] != 4])
        batches.append((np.array(ids), scores, boxes, masks, valid))
    return coco_json, batches


def _evaluate(ev_mod, coco_json, batches):
    gts = ev_mod.gt_records_from_json(coco_json)
    ev = ev_mod.TaskEvaluator(gts, iou_types=("bbox", "segm"),
                              score_threshold=0.1)
    for ids, scores, boxes, masks, valid in batches:
        rles = [[ev_mod.rle_ops.encode(m) for m in row] for row in masks]
        ev.update(ids, scores, boxes, valid=valid, masks=rles)
    ev.synchronize_between_processes()
    return ev.summarize()


def test_task_evaluator_matches_jax():
    """gt_records_from_json (polygons to masks), update with padded rows,
    duplicate images and a score threshold, bbox and segm stats, and
    mean_ap50."""
    coco_json, batches = _evaluator_case()
    stats = []
    for ev_mod in (jevaluator, pevaluator):
        s = _evaluate(ev_mod, coco_json, batches)
        stats.append((s, ev_mod.mean_ap50({1: s}),
                      ev_mod.mean_ap50({1: s}, "segm")))
    (sj, mj, msj), (sp, mp, msp) = stats
    assert set(sp) == set(sj) == {"bbox", "segm"}
    for k in sj:
        np.testing.assert_array_equal(sp[k], sj[k], err_msg=k)
    assert (mp, msp) == (mj, msj)


def test_synchronize_raises_with_more_than_one_process(tmp_path):
    """Two ranks (gloo, ``tests/torch_ranks.py``) each update a
    TaskEvaluator with one of the two batches and merge: image 3, on both
    ranks, is rank 0's. Both ranks score what one evaluator of both batches
    scores, as the JAX package's does."""
    from tests.torch_ranks import Ranks

    coco_json, batches = _evaluator_case()
    per_rank = [[(ids, scores, boxes,
                  [[pevaluator.rle_ops.encode(m) for m in row]
                   for row in masks], valid)]
                for ids, scores, boxes, masks, valid in batches]
    ranks = Ranks("eval_merge", tmp_path, {
        "gts": pevaluator.gt_records_from_json(coco_json),
        "batches": per_rank}, timeout=120)
    want = _evaluate(jevaluator, coco_json, batches)
    one = pevaluator.TaskEvaluator([])
    one.synchronize_between_processes()          # one process: no-op
    results = ranks.wait()
    n_records = {r["records"] for r in results}
    assert len(n_records) == 1
    for r in results:
        assert set(r["stats"]) == {"bbox", "segm"}
        for k, v in want.items():
            np.testing.assert_array_equal(r["stats"][k], v, err_msg=k)


# -- evaluate: both packages' loops ----------------------------------------

Q_FAKE = 10


def _fake_detections(batch):
    """Detections of one batch, built from its GT boxes: for each row the
    first queries are the valid GT boxes jittered (rng seeded by the image
    id), the rest random boxes; scores from the same rng, mostly higher on
    the GT copies; absolute xyxy by orig_size, as postprocess_boxes gives
    them."""
    B = batch["images"].shape[0]
    scores = np.zeros((B, Q_FAKE), np.float32)
    boxes = np.zeros((B, Q_FAKE, 4), np.float32)
    for b in range(B):
        rng = np.random.default_rng(int(batch["image_id"][b]))
        cxcywh = np.concatenate([rng.uniform(0.2, 0.8, (Q_FAKE, 2)),
                                 rng.uniform(0.05, 0.5, (Q_FAKE, 2))], -1)
        gt = batch["boxes"][b][batch["box_valid"][b]][:Q_FAKE]
        cxcywh[:len(gt)] = gt + rng.normal(scale=0.02, size=gt.shape)
        scores[b] = rng.uniform(size=Q_FAKE) / 2
        scores[b, :len(gt)] += 0.4               # mostly above the others
        h, w = batch["orig_size"][b]
        cx, cy, bw, bh = cxcywh.T
        boxes[b] = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                             (cx + bw / 2) * w, (cy + bh / 2) * h], -1)
    loss = np.float32(batch["boxes"].sum() + batch["image_id"].sum())
    return scores, boxes, loss


@pytest.fixture(scope="module")
def fixture_sets(tmp_path_factory):
    """The fixture (2 tasks x 4 images) as both packages' val datasets, with
    each package's own tokenizer."""
    root = generate_fixture(str(tmp_path_factory.mktemp("eval")),
                            num_tasks=2, imgs_per_split=4, img_size=(96, 128),
                            seed=1)
    over = {"data": {"coco_path": root, "refexp_ann_path": f"{root}/annotations",
                     "tasks": [2, 1], "image_buckets": [[128, 128]],
                     "max_text_len": 48, "max_boxes": 8, "train_scales": [96],
                     "max_size": 128, "val_size": 96}}
    jcfg = JConfig.from_sources(None, over)
    pcfg = pconfig.Config.from_sources(None, over)
    ptok = build_tokenizer(pcfg)
    from toist_tpu.main import build_tokenizer as jbuild_tokenizer
    jtok = jbuild_tokenizer(jcfg)
    assert isinstance(jtok, JaxBPE) and jtok.vocab_size == ptok.vocab_size
    jsets = {t: jbuild_dataset(jcfg.data, t, "val", jtok)
             for t in jcfg.data.tasks}
    psets = {t: build_task_dataset(pcfg.data, t, "val", ptok)
             for t in pcfg.data.tasks}
    d = pcfg.data
    spec = dict(buckets=d.image_buckets, max_text_len=d.max_text_len,
                max_boxes=d.max_boxes, num_logit_cols=d.num_logit_cols)
    return jsets, psets, spec, jcfg, pcfg, ptok.vocab_size


def _assert_same_results(got, want):
    assert list(got) == list(want)                  # task order
    for t in want:
        assert set(got[t]) == set(want[t])
        for k in want[t]:
            np.testing.assert_array_equal(got[t][k], want[t][k],
                                          err_msg=f"task {t} {k}")
    assert pevaluator.mean_ap50(got) == jevaluator.mean_ap50(want)


@pytest.mark.parametrize("batch_size", [3, 8])
def test_evaluate_loop_matches_jax(fixture_sets, batch_size):
    """One fake eval step for both loops: identical stats. Batch 3 over 4
    images per task pads the second batch; batch 8 pads one batch."""
    from toist_tpu.data.batcher import BucketSpec as JSpec

    jsets, psets, spec, *_ = fixture_sets
    seen = {"jax": [], "port": []}

    def jstep(params, batch):
        seen["jax"].append(np.asarray(batch["image_id"]).tolist())
        s, b, loss = _fake_detections(batch)
        return {"post": {"scores": s, "boxes": b}, "scalars": {"loss": loss}}

    def pstep(batch):
        seen["port"].append(batch["image_id"].tolist())
        s, b, loss = _fake_detections(batch)
        return {"post": {"scores": torch.from_numpy(s),
                         "boxes": torch.from_numpy(b)},
                "scalars": {"loss": torch.tensor(loss)}}

    want = jengine.evaluate(jstep, None, jsets, JSpec(**spec), batch_size)
    got = pengine.evaluate(pstep, psets, BucketSpec(**spec), batch_size)
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == 2 * -(-4 // batch_size)
    _assert_same_results(got, want)
    assert pevaluator.mean_ap50(got) > 0.5        # the jittered GTs score


def test_evaluate_segm_matches_jax(fixture_sets):
    """The tiny seg model (tests/test_torch_segmentation.py's, on the
    fixture's vocabulary) through both evaluates with bbox and segm: each
    batch's mask logits within 2e-3 of their max abs, and equal bbox and
    segm stats (the masks through each package's device postprocess)."""
    from toist_tpu.data.batcher import BucketSpec as JSpec
    from tests.test_torch_segmentation import SEG

    jsets, psets, spec, _, _, vocab = fixture_sets
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=128, dim_feedforward=128,
        text_layers=1, text_hidden=64, text_intermediate=128, num_queries=8,
        vocab_size=vocab, contrastive=False, with_masks=True, seed=3)
    sd["bbox_embed.layers.2.weight"][:2] *= 8.0
    sd["bbox_embed.layers.2.bias"][:] = [0.0, 0.0, -0.7, -0.7]
    params, frozen = convert_torch_state_dict(
        sd, d_model=128, enc_layers=1, dec_layers=1,
        stage_sizes=(1, 1, 1, 1), with_masks=True)
    over = {"run": {"compute_eval_losses": False},
            "model": dataclasses.asdict(SEG)}
    jcfg = JConfig.from_sources(None, over)
    pcfg = pconfig.Config.from_sources(None, over)
    jmodel = build_model(SEG, text_vocab_size=vocab)
    wd = build_weight_dict(jcfg.loss, True, 1)
    jeval = jax_make_eval_step(jmodel, jcfg, wd, frozen, with_masks=True)
    port = TOIST.from_state_dict(jax_params_to_state_dict(params, frozen),
                                 pcfg.model, device="cpu")
    peval = make_eval_step(port, pcfg, wd)
    masks = {"jax": [], "port": []}

    def jstep(p, batch):
        res = jeval(p, batch)
        masks["jax"].append(np.asarray(res["pred_masks"]))
        return res

    def pstep(batch):
        res = peval(batch)
        masks["port"].append(res["pred_masks"].numpy())
        return res

    iou = ("bbox", "segm")
    want = jengine.evaluate(jstep, params, jsets, JSpec(**spec), 3,
                            iou_types=iou)
    got = pengine.evaluate(pstep, psets, BucketSpec(**spec), 3,
                           iou_types=iou)
    assert len(masks["port"]) == len(masks["jax"]) == 4
    for a, b in zip(masks["port"], masks["jax"]):
        assert a.shape == b.shape == (3, 8, 32, 32)
        np.testing.assert_allclose(a, b, atol=2e-3 * np.abs(b).max())
        assert (a > 0).any() and (a < 0).any()       # masks neither empty
    _assert_same_results(got, want)                  # nor full
    # Every task's GT masks were scored (a random model's AP is 0 here).
    assert all(set(s) == {"bbox", "segm"} and s["segm"][1] >= 0
               for s in got.values())


def _ties_only(jrecs, precs, tol=1e-5):
    """The two detection lists of one image, each sorted by its own scores,
    differ only where scores tie within ``tol``."""
    a = sorted(jrecs, key=lambda r: -r["score"])
    b = sorted(precs, key=lambda r: -r["score"])
    for ra, rb in zip(a, b):
        if not np.allclose(ra["bbox"], rb["bbox"], atol=1e-3):
            close = [r for r in b if abs(r["score"] - ra["score"]) <= tol]
            assert any(np.allclose(ra["bbox"], r["bbox"], atol=1e-3)
                       for r in close)


def test_tiny_model_evaluate_matches_jax(fixture_sets):
    """The tiny model on shared weights through both evaluates: each batch's
    detections within scores 1e-5 and boxes 1e-3 px; equal stats (or, where
    a score tie flips two detections, detection sets that differ only in
    the order of tied scores)."""
    from toist_tpu.data.batcher import BucketSpec as JSpec

    jsets, psets, spec, jcfg, pcfg, vocab = fixture_sets
    mcfg = TINY
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=2, dec=2, d=64, dim_feedforward=128,
        text_layers=2, text_hidden=64, text_intermediate=128,
        num_queries=12, vocab_size=vocab, contrastive_hdim=16,
        with_masks=False, seed=3)
    # Spread the box centres over the canvas, sizes near the fixture's
    # objects (a third of the image), and the scores: a random model whose
    # detections match some ground truth, so that the stats are not all 0.
    sd["bbox_embed.layers.2.weight"][:2] *= 8.0
    sd["bbox_embed.layers.2.bias"][:] = [0.0, 0.0, -0.7, -0.7]
    sd["class_embed.weight"] *= 5.0
    params, frozen = convert_torch_state_dict(
        sd, d_model=64, enc_layers=2, dec_layers=2, stage_sizes=(1, 1, 1, 1))
    over = {"run": {"compute_eval_losses": False},
            "model": dataclasses.asdict(mcfg)}
    jcfg = JConfig.from_sources(None, over)
    pcfg = pconfig.Config.from_sources(None, over)
    jmodel = build_model(mcfg, text_vocab_size=vocab, tiny_text=True,
                         backbone_norm="frozen_bn")
    wd = build_weight_dict(jcfg.loss, False, 2)
    jeval = jax_make_eval_step(jmodel, jcfg, wd, frozen)
    port = TOIST.from_state_dict(jax_params_to_state_dict(params, frozen),
                                 pcfg.model, device="cpu")
    peval = make_eval_step(port, pcfg, wd)
    outs = {"jax": [], "port": []}

    def jstep(p, batch):
        res = jeval(p, batch)
        outs["jax"].append({k: np.asarray(v) for k, v in res["post"].items()})
        return res

    def pstep(batch):
        res = peval(batch)
        outs["port"].append(dict(
            {k: v.numpy() for k, v in res["post"].items()},
            valid=batch["sample_valid"]))
        return res

    want = jengine.evaluate(jstep, params, jsets, JSpec(**spec), 3)
    got = pengine.evaluate(pstep, psets, BucketSpec(**spec), 3)
    assert len(outs["port"]) == len(outs["jax"]) == 4
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5)
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3)
    if all(np.array_equal(got[t]["bbox"], want[t]["bbox"]) for t in want):
        _assert_same_results(got, want)
        assert pevaluator.mean_ap50(got) > 0
        return
    # A score tie flipped: show the detection sets differ only there.
    for a, b in zip(outs["port"], outs["jax"]):
        for r in np.flatnonzero(a["valid"]):
            recs = [[{"score": float(sc), "bbox": bx}
                     for sc, bx in zip(o["scores"][r], o["boxes"][r])]
                    for o in (b, a)]
            _ties_only(*recs)
