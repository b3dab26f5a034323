"""The whole port model (toist_tpu_torch TOIST) against the JAX package.

Weights: one reference-layout state dict; the port gets it back from the
JAX tree through ``jax_params_to_state_dict``, which must invert
``convert_torch_state_dict`` bit for bit. The tiny model of
tests/test_model_forward.py runs on a 448x640 canvas, so the joint sequence
(14*20 image + 16 text = 296 tokens) reaches FUSED_MIN_KV and the JAX side
takes its Pallas kernel in interpret mode. Full-model tolerance 2e-3 (as in
tests/test_reference_parity.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from toist_tpu.config import ModelConfig
from toist_tpu.models.postprocess import postprocess_boxes
from toist_tpu.models.toist import build_model
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.models.layers import FUSED_MIN_KV
from toist_tpu_torch.models.postprocess import \
    postprocess_boxes as p_postprocess
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.train.criterion import build_weight_dict
from toist_tpu_torch.train.step import make_eval_step
from toist_tpu_torch.utils.convert import jax_params_to_state_dict

TINY = ModelConfig(backbone="resnet18-test", hidden_dim=64, nheads=4,
                   dim_feedforward=128, enc_layers=2, dec_layers=2,
                   num_queries=20, compute_dtype="float32",
                   contrastive_align_loss=True, contrastive_hdim=16,
                   text_hidden=64, text_layers=2, text_heads=4,
                   text_intermediate=128, dropout=0.0, resizer_dropout=0.0,
                   fused_attention="interpret")
PTINY = pconfig.ModelConfig(**dataclasses.asdict(TINY))   # the port's own
VOCAB = 600
B, HI, WI, T = 2, 448, 640, 16
TOL = 2e-3


def _synth(**kw):
    return synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=2, dec=2, d=64, dim_feedforward=128,
        text_layers=2, text_hidden=64, text_intermediate=128, num_queries=20,
        vocab_size=VOCAB, contrastive_hdim=16, **kw)


@pytest.mark.parametrize("variant", ["masks", "no_masks", "cls_learned",
                                     "resnet_stages"])
def test_converter_round_trip_bit_exact(variant):
    kw = {"with_masks": variant == "masks"}
    stages = (2, 1, 3, 1) if variant == "resnet_stages" else (1, 1, 1, 1)
    sd = synth_reference_state_dict(stage_sizes=stages, **kw)
    if variant == "cls_learned":
        rng = np.random.default_rng(1)
        sd["transformer.CLS.weight"] = rng.normal(size=(1, 16)).astype(
            np.float32)
        sd["backbone.1.row_embed.weight"] = rng.uniform(
            size=(50, 8)).astype(np.float32)
        sd["backbone.1.col_embed.weight"] = rng.uniform(
            size=(50, 8)).astype(np.float32)
        sd["transformer.text_encoder.pooler.dense.weight"] = rng.normal(
            size=(24, 24)).astype(np.float32)
        sd["transformer.text_encoder.pooler.dense.bias"] = rng.normal(
            size=(24,)).astype(np.float32)
    params, frozen = convert_torch_state_dict(
        sd, d_model=16, enc_layers=1, dec_layers=1, stage_sizes=stages,
        with_masks=kw["with_masks"])
    back = jax_params_to_state_dict(params, frozen)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def tiny_pair():
    sd = _synth(with_masks=False, seed=5)
    params, frozen = convert_torch_state_dict(
        sd, d_model=64, enc_layers=2, dec_layers=2, stage_sizes=(1, 1, 1, 1))
    port = TOIST.from_state_dict(jax_params_to_state_dict(params, frozen),
                                 PTINY, device="cpu")
    jmodel = build_model(TINY, text_vocab_size=VOCAB, tiny_text=True,
                         backbone_norm="frozen_bn")
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (B, HI, WI, 3)).astype(np.uint8)
    image_mask = np.zeros((B, HI, WI), bool)
    image_mask[1, 384:, :] = True
    image_mask[1, :, 512:] = True
    text_ids = np.full((B, T), 1, np.int32)
    text_ids[0, :9] = rng.integers(3, VOCAB, 9)
    text_ids[1, :5] = rng.integers(3, VOCAB, 5)
    text_mask = text_ids == 1
    batch = {"images": images, "image_mask": image_mask,
             "text_ids": text_ids, "text_mask": text_mask,
             "orig_size": np.asarray([[420, 600], [380, 500]], np.int32)}
    return port, jmodel, {"params": params, **frozen}, batch


def test_tiny_model_matches_jax(tiny_pair):
    port, jmodel, variables, batch = tiny_pair
    args = [batch[k] for k in ("images", "image_mask", "text_ids",
                               "text_mask")]
    encode = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=jmodel.encode))
    decode = jax.jit(lambda v, c: jmodel.apply(v, c, method=jmodel.decode))
    jcache = encode(variables, *args)
    jout = decode(variables, jcache)
    jpost = jax.jit(postprocess_boxes)(jout["pred_logits"],
                                       jout["pred_boxes"], batch["orig_size"])
    with torch.inference_mode():
        cache = port.encode(*(torch.from_numpy(a) for a in args))
        out = port.decode(cache)
        post = p_postprocess(out["pred_logits"], out["pred_boxes"],
                             torch.from_numpy(batch["orig_size"]))

    fh, fw = cache["feature_hw"]
    assert (fh, fw) == tuple(int(x) for x in jcache["feature_hw"]) == (14, 20)
    assert cache["img_memory"].shape[1] == fh * fw + T >= FUSED_MIN_KV
    for key in ("mask", "text_attention_mask", "feature_mask"):
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]), err_msg=key)
    for key in ("img_memory", "text_memory", "text_memory_resized",
                "pos_embed"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=TOL,
                                   err_msg=key)
    for key in ("features_c2", "features_c3", "features_c4", "src_proj"):
        got = cache[key].permute(0, 2, 3, 1).numpy()
        want = np.asarray(jcache[key])
        np.testing.assert_allclose(got, want, atol=TOL * max(
            1.0, np.abs(want).max()), err_msg=key)
    for key in ("pred_logits", "pred_boxes", "aux_pred_logits",
                "aux_pred_boxes", "hs", "proj_queries", "proj_tokens",
                "aux_proj_queries"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   atol=TOL, err_msg=key)
    for key in ("scores", "boxes"):
        np.testing.assert_allclose(post[key].numpy(), np.asarray(jpost[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)
    np.testing.assert_array_equal(post["labels"].numpy(),
                                  np.asarray(jpost["labels"]))


def test_modified_memory_seam(tiny_pair):
    port, _, _, batch = tiny_pair
    args = [torch.from_numpy(batch[k]) for k in ("images", "image_mask",
                                                 "text_ids", "text_mask")]
    with torch.inference_mode():
        cache = port.encode(*args)
        base = port.decode(cache)["pred_logits"]
        cache["img_memory_mod"] = cache["img_memory"] + 0.3
        mod = port.decode(cache, use_modified_memory=True)["pred_logits"]
        same = port.decode(cache)["pred_logits"]
    assert (base - mod).abs().max() > 1e-6
    assert torch.equal(base, same)


def test_eval_step(tiny_pair):
    port, _, _, batch = tiny_pair
    wd = build_weight_dict(pconfig.Config().loss, False, TINY.dec_layers)
    cfg = pconfig.Config.from_sources(None, {"run": {
        "compute_eval_losses": False}})
    res = make_eval_step(port, cfg, wd)(batch)
    assert res["scalars"] == {}
    assert res["post"]["scores"].shape == (B, 20)
    assert res["post"]["boxes"].shape == (B, 20, 4)
    assert torch.isfinite(res["post"]["boxes"]).all()
    # compute_eval_losses (the default) runs the criterion on the targets
    targets = {"boxes": np.tile(np.float32([0.5, 0.5, 0.2, 0.3]), (B, 2, 1)),
               "box_valid": np.array([[True, True], [True, False]]),
               "positive_map": np.zeros((B, 2, 256), np.float32),
               "sample_valid": np.ones((B,), bool)}
    targets["positive_map"][:, :, 1:3] = 0.5
    full = make_eval_step(port, pconfig.Config(), wd)(dict(batch,
                                                          **targets))
    assert {"loss", "loss_ce", "loss_bbox", "loss_giou",
            "loss_contrastive_align"} <= set(full["scalars"])
    assert all(torch.isfinite(v) for v in full["scalars"].values())
    for k in ("scores", "boxes"):
        assert torch.equal(full["post"][k], res["post"][k])


def test_train_mode_with_dropout_raises():
    cfg = dataclasses.replace(PTINY, dropout=0.1)
    sd = jax_params_to_state_dict(*convert_torch_state_dict(
        _synth(with_masks=False), d_model=64, enc_layers=2, dec_layers=2,
        stage_sizes=(1, 1, 1, 1)))
    model = TOIST.from_state_dict(sd, cfg, device="cpu").train()
    x = torch.zeros(1, 64, 64, 3, dtype=torch.uint8)
    m = torch.zeros(1, 64, 64, dtype=torch.bool)
    ids = torch.full((1, 4), 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="dropout"):   # no generator given
        model(x, m, ids, torch.zeros(1, 4, dtype=torch.bool))
