"""``toist_tpu_torch/visualize.py`` against ``toist_tpu/visualize.py``.

Drawing: the port draws with numpy (the card's machine has no OpenCV),
the JAX package with cv2. On random images, masks and boxes (inside,
across and outside the image's edges, reversed corners, fractional
coordinates) the port's mask blend and box outline equal JAX's
``draw_box_mask`` output pixel for pixel.

The run: ``python -m toist_tpu_torch.visualize`` on the fixture (a tiny
model with a mask head, a checkpoint given by --resume) writes one PNG per
valid val image, ``task{t}_img{id}.png``, with the file names and count
that the JAX package's dataset iteration gives (the JAX function's batch
of 1 over ``build_task_dataset``), each GT beside prediction at twice the
original width; ``max_images`` stops it early.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from toist_tpu.config import Config as JConfig
from toist_tpu.data.batcher import BatchIterator as JBatchIterator
from toist_tpu.data.cocotasks import build_task_dataset as jbuild
from toist_tpu.main import build_all
from toist_tpu.visualize import draw_box_mask as jdraw
from toist_tpu_torch.config import Config
from toist_tpu_torch.data.captions import build_tokenizer
from toist_tpu_torch.data.fixtures import generate_fixture
from toist_tpu_torch.utils.convert import synth_reference_state_dict
from toist_tpu_torch.visualize import (GT_COLOR, PRED_COLOR, blend,
                                       draw_box_mask, visualize)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_BGR = {GT_COLOR: (60, 200, 60), PRED_COLOR: (60, 60, 230)}


def _case(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    masks = [rng.random((h, w)) < p for p in (0.3, 0.05)]
    boxes = [[3.4, 5.5, 20.6, 30.5], [-4.0, -3.0, 10.2, 8.9],
             [40.0, 30.0, 60.0, 45.0], [25.5, 20.0, 12.0, 9.0],
             [0.0, 0.0, w - 1, h - 1], [7.0, 7.0, 8.0, 7.0]]
    boxes += rng.uniform(-5, max(h, w) + 5, (6, 4)).tolist()
    return img, masks, boxes


@pytest.mark.parametrize("color", [GT_COLOR, PRED_COLOR],
                         ids=["gt", "pred"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drawing_equals_jax(seed, color):
    img, masks, boxes = _case(seed)
    want_blend = jdraw(img, [], _JAX_BGR[color], masks)
    np.testing.assert_array_equal(draw_box_mask(img, [], color, masks),
                                  want_blend)
    want = jdraw(img, boxes, _JAX_BGR[color], masks)
    np.testing.assert_array_equal(draw_box_mask(img, boxes, color, masks),
                                  want)
    np.testing.assert_array_equal(draw_box_mask(img, boxes, color),
                                  jdraw(img, boxes, _JAX_BGR[color]))


def test_blend_is_cv2_add_weighted_on_every_pair():
    import cv2
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    a3, b3 = np.stack([a] * 3, -1), np.stack([a.T] * 3, -1)
    np.testing.assert_array_equal(blend(b3, a3),
                                  cv2.addWeighted(a3, 0.45, b3, 0.55, 0))


def _setup(tmp_path):
    root = generate_fixture(str(tmp_path / "data"), num_tasks=2,
                            imgs_per_split=3, img_size=(96, 128), seed=3)
    over = {
        "model": {"backbone": "resnet18-test", "hidden_dim": 128,
                  "nheads": 8, "dim_feedforward": 128, "enc_layers": 1,
                  "dec_layers": 1, "num_queries": 8,
                  "compute_dtype": "float32", "contrastive_align_loss": False,
                  "mask_model": "smallconv", "text_hidden": 64,
                  "text_layers": 1, "text_heads": 4,
                  "text_intermediate": 128},
        "data": {"coco_path": root, "refexp_ann_path": root + "/annotations",
                 "tasks": [1, 2], "image_buckets": [[128, 128]],
                 "max_text_len": 48, "max_boxes": 8, "train_scales": [96],
                 "max_size": 128, "val_size": 96},
        "optim": {"ema": True},
        "run": {"seed": 0}}
    cfg = Config.from_sources(None, over)
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=128, dim_feedforward=128,
        text_layers=1, text_hidden=64, text_intermediate=128, num_queries=8,
        vocab_size=build_tokenizer(cfg).vocab_size, contrastive=False,
        with_masks=True, seed=1)
    ckpt = str(tmp_path / "checkpoint")
    weights = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save({"model": weights, "model_ema": weights}, ckpt)
    return over, ckpt


def _jax_names(over, max_images=None):
    """The file names the JAX package's visualize gives: its batch of 1
    over each task's val set, valid samples only."""
    cfg = JConfig.from_sources(None, over)
    tokenizer, _, _, spec = build_all(cfg)
    names = []
    for task in cfg.data.tasks:
        ds = jbuild(cfg.data, task, "val", tokenizer, masks=True)
        for batch in JBatchIterator([ds], spec, batch_size=1,
                                    shuffle=False).epoch(0):
            if batch["sample_valid"][0]:
                names.append(f"task{task}_img{int(batch['image_id'][0])}"
                             ".png")
    return names[:max_images] if max_images else names


def test_cli_writes_jax_file_names(tmp_path):
    over, ckpt = _setup(tmp_path)
    out = str(tmp_path / "vis")
    sets = [f"data.{k}={v}" for k, v in over["data"].items()
            if not isinstance(v, list)] + [
        "data.tasks=[1,2]", "data.image_buckets=[[128,128]]",
        "data.train_scales=[96]"] + [
        f"model.{k}={str(v).lower() if isinstance(v, bool) else v}"
        for k, v in over["model"].items()]
    proc = subprocess.run(
        [sys.executable, "-m", "toist_tpu_torch.visualize", "--device", "cpu",
         "--resume", ckpt, "--output-dir", out, "--set", *sets],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = _jax_names(over, max_images=20)
    assert sorted(os.listdir(out)) == sorted(want) and len(want) == 6
    assert f"wrote {len(want)} visualizations" in proc.stdout
    img = np.asarray(Image.open(os.path.join(out, want[0])))
    assert img.shape == (96, 2 * 128, 3)


def test_visualize_max_images_and_masks(tmp_path):
    """max_images stops the run; at threshold 0 every kept prediction is
    drawn (its mask blended), so the prediction half differs from the
    image."""
    over, ckpt = _setup(tmp_path)
    over["run"]["resume"] = ckpt
    out = str(tmp_path / "vis")
    n = visualize(Config.from_sources(None, over), out, score_threshold=0.0,
                  max_images=4, device="cpu")
    assert n == 4 and sorted(os.listdir(out)) == sorted(
        _jax_names(over, max_images=4))
    side = np.asarray(Image.open(os.path.join(out, sorted(
        os.listdir(out))[0])))
    assert (side[:, :128] != side[:, 128:]).any()
