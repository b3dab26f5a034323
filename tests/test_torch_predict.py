"""The port's serving API (toist_tpu_torch.predict) against the JAX package.

Both Predictors get one reference-layout state dict and one tokenizer, and
answer the same PIL images on the CPU; detections agree within the
full-model tolerance 2e-3. With a mask head (hidden 128, 8 heads) each
kept box carries an RLE of its image's original size, within 1% of the
pixels of the JAX Predictor's mask. Also: the port's copy of
``build_tokenizer`` equals the JAX package's, and importing the port leaves
jax unloaded.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from toist_tpu.config import Config
from toist_tpu.data.cocotasks import TASKS
from toist_tpu.models.toist import build_model
from toist_tpu.predict import Predictor as JaxPredictor
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.data import captions
from toist_tpu_torch.predict import Predictor
from toist_tpu_torch.utils.convert import jax_params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3


def _cfg(config=Config):
    """The test's configuration as ``config`` (the JAX package's Config
    or the port's own) builds it from the same sources."""
    return config.from_sources(None, {
        "model": {"backbone": "resnet18-test", "hidden_dim": 64, "nheads": 4,
                  "dim_feedforward": 128, "enc_layers": 1, "dec_layers": 1,
                  "num_queries": 10, "compute_dtype": "float32",
                  "contrastive_align_loss": False, "dropout": 0.0,
                  "resizer_dropout": 0.0, "text_hidden": 64,
                  "text_layers": 1, "text_heads": 4,
                  "text_intermediate": 128},
        "data": {"image_buckets": [[96, 128], [128, 96]], "max_text_len": 32,
                 "max_boxes": 8, "max_size": 128, "val_size": 96},
    })


@pytest.fixture(scope="module")
def predictors():
    cfg, pcfg = _cfg(), _cfg(pconfig.Config)
    tokenizer = captions.build_tokenizer(pcfg)
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=64, dim_feedforward=128,
        text_layers=1, text_hidden=64, text_intermediate=128,
        num_queries=10, vocab_size=tokenizer.vocab_size, contrastive=False,
        with_masks=False, seed=2)
    params, frozen = convert_torch_state_dict(
        sd, d_model=64, enc_layers=1, dec_layers=1, stage_sizes=(1, 1, 1, 1))
    jmodel = build_model(cfg.model, text_vocab_size=tokenizer.vocab_size)
    jax_pred = JaxPredictor(jmodel, params, frozen, tokenizer, cfg)
    port = Predictor.from_state_dict(jax_params_to_state_dict(params, frozen),
                                     pcfg, device="cpu", tokenizer=tokenizer)
    return jax_pred, port


def test_predictor_matches_jax(predictors):
    jax_pred, port = predictors
    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, (120, 160, 3), np.uint8)),
            Image.fromarray(rng.integers(0, 255, (160, 120, 3), np.uint8))]
    want = jax_pred(imgs, task_ids=[1, 7])
    got = port(imgs, task_ids=[1, 7])
    assert len(got) == 2
    for g, w, im in zip(got, want, imgs):
        assert g["boxes"].shape == (10, 4) and g["scores"].shape == (10,)
        assert (np.diff(g["scores"]) <= 0).all()
        np.testing.assert_allclose(g["scores"], w["scores"], atol=TOL)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=TOL * max(
            im.size), rtol=TOL)
        np.testing.assert_array_equal(g["labels"], w["labels"])
    port.score_threshold = 1.1
    assert port(imgs[:1], task_ids=[1])[0]["scores"].size == 0
    port.score_threshold = 0.0


def test_predictor_returns_masks():
    from toist_tpu.ops import rle as jrle

    over = {"hidden_dim": 128, "nheads": 8, "mask_model": "smallconv"}
    cfg, pcfg = (c.__class__.from_sources(None, dict(
        c.to_dict(), model=dict(c.to_dict()["model"], **over)))
        for c in (_cfg(), _cfg(pconfig.Config)))
    assert cfg.model.masks and pcfg.model.masks
    tokenizer = captions.build_tokenizer(pcfg)
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=128, dim_feedforward=128,
        text_layers=1, text_hidden=64, text_intermediate=128,
        num_queries=10, vocab_size=tokenizer.vocab_size, contrastive=False,
        with_masks=True, seed=2)
    params, frozen = convert_torch_state_dict(
        sd, d_model=128, enc_layers=1, dec_layers=1,
        stage_sizes=(1, 1, 1, 1), with_masks=True)
    jmodel = build_model(cfg.model, text_vocab_size=tokenizer.vocab_size)
    jax_pred = JaxPredictor(jmodel, params, frozen, tokenizer, cfg)
    port = Predictor.from_state_dict(jax_params_to_state_dict(params, frozen),
                                     pcfg, device="cpu", tokenizer=tokenizer)
    rng = np.random.default_rng(4)
    imgs = [Image.fromarray(rng.integers(0, 255, (120, 160, 3), np.uint8)),
            Image.fromarray(rng.integers(0, 255, (90, 70, 3), np.uint8))]
    port.score_threshold = jax_pred.score_threshold = 0.3
    want = jax_pred(imgs, task_ids=[3, 5])
    got = port(imgs, task_ids=[3, 5])
    for g, w, im in zip(got, want, imgs):
        assert len(g["masks"]) == len(g["scores"]) == len(w["masks"]) > 0
        np.testing.assert_allclose(g["scores"], w["scores"], atol=TOL)
        for rg, rw in zip(g["masks"], w["masks"]):
            assert rg["size"] == [im.size[1], im.size[0]]
            diff = (jrle.decode(rg) != jrle.decode(rw)).sum()
            assert diff <= 0.01 * im.size[0] * im.size[1]


def test_predict_batch_half_empty(predictors):
    """A batch with fewer images than rows answers only the real rows."""
    from toist_tpu_torch.data.batcher import collate

    _, port = predictors
    rng = np.random.default_rng(1)
    samples = [port.prepare(rng.integers(0, 256, (96, 120, 3), np.uint8), t)
               for t in (2, 9)]
    bi = port.bucket(samples[0])
    batch = collate(samples, port.spec, bi, batch_size=4)
    res = port.predict_batch(batch)
    assert len(res) == 2
    full = port.predict_batch(collate(samples[:1], port.spec, bi,
                                      batch_size=1))
    np.testing.assert_allclose(res[0]["scores"], full[0]["scores"],
                               atol=1e-5)
    with pytest.raises(ValueError):
        port.prepare(np.zeros((96, 120, 3), np.float32), 1)


def test_captions_match_jax_package():
    from toist_tpu.main import build_tokenizer as jax_build_tokenizer

    ours = captions.build_tokenizer(_cfg(pconfig.Config))
    theirs = jax_build_tokenizer(_cfg())
    assert ours.vocab_size == theirs.vocab_size
    for t in TASKS:
        cap = captions.task_caption(t)
        assert cap == TASKS[t] + "something"
        assert ours.encode(cap).input_ids == theirs.encode(cap).input_ids


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import toist_tpu_torch, toist_tpu_torch.predict, "
        "toist_tpu_torch.train.step, toist_tpu_torch.utils.convert, "
        "toist_tpu_torch.ops.flash_attention, toist_tpu_torch.ops._build, "
        "toist_tpu_torch.models.toist, toist_tpu_torch.ops.box_ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py has no CPU path, and needs the repository beside it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for script in (os.path.join(REPO, "chip_smoke.py"), str(alone)):
        proc = subprocess.run([sys.executable, script], capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("prefer_ema", [True, False], ids=["ema", "model"])
def test_from_checkpoint(predictors, tmp_path, prefer_ema):
    """``Predictor.from_checkpoint`` of a reference-format file equals
    ``from_state_dict`` on the same weights (the EMA's when preferred and
    present), and JAX's Predictor on the weights that its
    ``load_reference_checkpoint`` reads from the same file."""
    from toist_tpu.utils.convert import load_reference_checkpoint

    jax_pred, port = predictors
    sd = port.model.state_dict()
    ema = {k: v + 0.01 if v.is_floating_point() else v for k, v in sd.items()}
    path = str(tmp_path / "checkpoint")
    torch.save({"model": sd, "model_ema": ema, "epoch": 0}, path)
    pcfg = port.cfg
    got = Predictor.from_checkpoint(path, pcfg, tokenizer=port.tokenizer,
                                    prefer_ema=prefer_ema, device="cpu")
    want_sd = ema if prefer_ema else sd
    same = Predictor.from_state_dict(want_sd, pcfg, device="cpu",
                                     tokenizer=port.tokenizer)
    params, frozen = load_reference_checkpoint(
        path, prefer_ema=prefer_ema, d_model=64, enc_layers=1, dec_layers=1,
        stage_sizes=(1, 1, 1, 1))
    jp = JaxPredictor(jax_pred.model, params, frozen, port.tokenizer,
                      jax_pred.cfg)
    rng = np.random.default_rng(1)
    imgs = [Image.fromarray(rng.integers(0, 255, (120, 160, 3), np.uint8))]
    a, b, w = got(imgs, [2]), same(imgs, [2]), jp(imgs, [2])
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(a[0][k], b[0][k])
    np.testing.assert_allclose(a[0]["scores"], w[0]["scores"], atol=TOL)
    np.testing.assert_allclose(a[0]["boxes"], w[0]["boxes"],
                               atol=TOL * 160, rtol=TOL)
