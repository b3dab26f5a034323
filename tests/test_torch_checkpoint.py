"""The port's checkpoint (toist_tpu_torch.train.checkpoint and
utils/convert.load_reference_checkpoint) on the CPU.

- save, restore, then one step equals one step without the round trip,
  exactly (f32; bf16 with f32 masters too);
- the async save writes what the sync one writes;
- ``merge_params`` as ``tests/test_checkpoint.py`` holds the JAX one;
- a port checkpoint is a reference ``.pth``: the JAX package's
  ``load_reference_checkpoint`` reads it, and the JAX tiny model on those
  weights gives the port model's outputs within the full-model tolerance
  2e-3;
- the port's ``load_reference_checkpoint`` reads a reference-style payload
  (``argparse.Namespace`` args, DDP prefixes, empty ``model_ema``);
- a distillation checkpoint has the reference's keys (the teacher as
  ``model_noun`` and ``model_noun_ema``, the bank as ``cluster_criterion``),
  restores bit for bit and steps on as the live state does, and both
  packages read its ``model`` and ``model_noun``;
- a segmentation checkpoint (bf16, frozen detector) holds the mask head,
  its masters, EMA and moments (``out_lay`` in f32), restores bit for bit
  and steps on as the live state does.
"""
import argparse
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from toist_tpu.config import ModelConfig
from toist_tpu.models.toist import build_model
from toist_tpu.utils import convert as jconvert
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.train import checkpoint as ckpt
from toist_tpu_torch.train.cluster import init_bank
from toist_tpu_torch.train.criterion import build_weight_dict
from toist_tpu_torch.train.distill import make_distillation_train_step
from toist_tpu_torch.train.state import init_train_state
from toist_tpu_torch.train.step import make_train_step
from toist_tpu_torch.utils.convert import (jax_params_to_state_dict,
                                           load_reference_checkpoint,
                                           synth_reference_state_dict)

TINY = ModelConfig(backbone="resnet18-test", hidden_dim=64, nheads=4,
                   dim_feedforward=128, enc_layers=2, dec_layers=2,
                   num_queries=20, compute_dtype="float32",
                   contrastive_align_loss=True, contrastive_hdim=16,
                   text_hidden=64, text_layers=2, text_heads=4,
                   text_intermediate=128, dropout=0.1, resizer_dropout=0.1,
                   fused_attention="off")
SD_KW = dict(stage_sizes=(1, 1, 1, 1), enc=2, dec=2, d=64,
             dim_feedforward=128, text_layers=2, text_hidden=64,
             text_intermediate=128, num_queries=20, vocab_size=600,
             contrastive_hdim=16, with_masks=False)
VOCAB = 600
C = 256


def _cfg(dtype="float32"):
    model = dataclasses.asdict(dataclasses.replace(TINY,
                                                   compute_dtype=dtype))
    return pconfig.Config.from_sources(None, {"model": model})


def _sd(seed=5):
    return {k: torch.from_numpy(v)
            for k, v in synth_reference_state_dict(seed=seed, **SD_KW).items()}


def _batch(seed=9, b=3, h=96, w=128, n=4):
    rng = np.random.default_rng(seed)
    batch = {"images": rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8),
             "image_mask": np.zeros((b, h, w), bool),
             "text_ids": np.full((b, 12), 1, np.int32),
             "text_mask": np.ones((b, 12), bool),
             "boxes": np.zeros((b, n, 4), np.float32),
             "box_valid": np.zeros((b, n), bool),
             "positive_map": np.zeros((b, n, C), np.float32),
             "sample_valid": np.ones((b,), bool),
             "orig_size": np.full((b, 2), [h, w], np.int32)}
    batch["image_mask"][1, 64:] = True
    for i in range(b):
        k = i + 1
        batch["text_ids"][i, :4 + i] = rng.integers(3, VOCAB, 4 + i)
        batch["text_mask"][i, :4 + i] = False
        batch["boxes"][i, :k] = np.concatenate(
            [rng.uniform(0.3, 0.7, (k, 2)), rng.uniform(0.1, 0.4, (k, 2))],
            -1)
        batch["box_valid"][i, :k] = True
        for j in range(k):
            batch["positive_map"][i, j, 1 + j:3 + j] = 0.5
    return batch


def _state(cfg, sd=None):
    model = TOIST.from_state_dict(sd if sd is not None else _sd(), cfg.model,
                                  device="cpu")
    return init_train_state(model, cfg, steps_per_epoch=10, total_steps=100)


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert len(a.masters) == len(b.masters)
    for (pa, ma), (pb, mb) in zip(a.masters, b.masters):
        assert pa.dtype == pb.dtype
        assert torch.equal(pa, pb) and torch.equal(ma, mb)
    for ma, mb in ((a.model, b.model), (a.teacher, b.teacher)):
        assert (ma is None) == (mb is None)
        if ma is None:
            continue
        for (na, ta), (nb, tb) in zip(ma.state_dict().items(),
                                      mb.state_dict().items()):
            assert na == nb and torch.equal(ta, tb), na
    for ea, eb in ((a.ema, b.ema), (a.teacher_ema, b.teacher_ema)):
        assert (ea is None) == (eb is None)
        assert list(ea or ()) == list(eb or ())
        for n in ea or ():
            assert torch.equal(ea[n], eb[n]), n
    assert (a.cluster_bank is None) == (b.cluster_bank is None)
    if a.cluster_bank is not None:
        for f in dataclasses.fields(a.cluster_bank):
            ta = getattr(a.cluster_bank, f.name)
            tb = getattr(b.cluster_bank, f.name)
            assert ta.dtype == tb.dtype and torch.equal(ta, tb), f.name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert set(sa["state"]) == set(sb["state"])
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_then_step_equals_step(tmp_path, dtype):
    """Two steps, then save; the restored state and the live one take one
    more step each (dropout 0.1, so the step's generator counts too) and
    stay equal bit for bit: masters, bf16 model, moments and step counts,
    EMA, step."""
    cfg = _cfg(dtype)
    wd = build_weight_dict(cfg.loss, False, 2)
    step = make_train_step(cfg, wd)
    state = _state(cfg)
    for seed in (1, 2):
        state, _ = step(state, _batch(seed))
    path = str(tmp_path / "checkpoint")
    ckpt.save(path, state, epoch=3, args=cfg.to_dict())
    restored, epoch = ckpt.restore(path, cfg, 10, 100, device="cpu")
    assert epoch == 3
    _assert_states_equal(restored, state)
    for p, m in restored.masters:      # the model is the masters cast down
        assert torch.equal(p, m.to(p.dtype))
    state, sc = step(state, _batch(3))
    restored, sc2 = step(restored, _batch(3))
    _assert_states_equal(restored, state)
    assert float(sc["loss"]) == float(sc2["loss"])


def test_async_save_equals_sync(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    state, _ = make_train_step(cfg, build_weight_dict(cfg.loss, False, 2))(
        state, _batch())
    sync, asyn = str(tmp_path / "sync"), str(tmp_path / "async")
    ckpt.save(sync, state, epoch=1, args=cfg.to_dict())
    ckpt.save(asyn, state, epoch=1, async_save=True, args=cfg.to_dict())
    # The host copy was taken at save: updating the state now changes
    # nothing in the file being written.
    with torch.no_grad():
        for _, m in state.masters:
            m.add_(1.0)
    ckpt.wait_for_async_saves()
    assert sorted(os.listdir(tmp_path)) == ["async", "sync"]  # no tmp left
    a = torch.load(sync, weights_only=True)
    b = torch.load(asyn, weights_only=True)
    assert set(a) == set(b) == {"model", "model_ema", "optimizer", "epoch",
                                "step", "args"}
    assert (a["epoch"], a["step"], a["args"]) == (b["epoch"], b["step"],
                                                  b["args"])
    for key in ("model", "model_ema"):
        assert list(a[key]) == list(b[key])
        for k in a[key]:
            assert a[key][k].dtype == torch.float32
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k])
    assert [r["path"] for r in ckpt.SAVES[-2:]] == [sync, asyn]


def test_merge_params_overlay():
    init = {"a": {"w": np.zeros((2, 3)), "mask_head": {"k": np.ones(4)}},
            "b": np.zeros(5)}
    loaded = {"a": {"w": np.full((2, 3), 7.0), "extra": np.ones(9)},
              "b": np.full(5, 2.0)}
    merged = ckpt.merge_params(init, loaded)
    np.testing.assert_allclose(merged["a"]["w"], 7.0)
    np.testing.assert_allclose(merged["b"], 2.0)
    np.testing.assert_allclose(merged["a"]["mask_head"]["k"], 1.0)  # kept
    assert "extra" not in merged["a"]                                # dropped
    # Flat state dicts of tensors, the port's layout.
    flat = ckpt.merge_params({"w": torch.zeros(2), "head.b": torch.ones(3)},
                             {"w": torch.full((2,), 5.0), "x": torch.ones(1)})
    assert list(flat) == ["w", "head.b"]
    assert flat["w"].tolist() == [5.0, 5.0] and flat["head.b"].sum() == 3


def test_merge_params_shape_mismatch():
    with pytest.raises(ValueError):
        ckpt.merge_params({"w": np.zeros((2, 3))}, {"w": np.zeros((3, 2))})
    with pytest.raises(ValueError):
        ckpt.merge_params({"w": torch.zeros(2, 3)}, {"w": torch.zeros(3, 2)})


def test_port_checkpoint_loads_in_both_packages(tmp_path):
    """A port checkpoint (EMA moved away from the weights by a step) read
    by the JAX package's load_reference_checkpoint and by the port's: the
    JAX tiny model and the port model on those weights agree within 2e-3,
    and both loaders pick the EMA."""
    cfg = _cfg()
    state = _state(cfg)
    assert state.ema is not None          # EMA on by default
    state, _ = make_train_step(cfg, build_weight_dict(cfg.loss, False, 2))(
        state, _batch())
    path = str(tmp_path / "checkpoint.pth")
    ckpt.save(path, state, epoch=0, args=cfg.to_dict())
    sd = load_reference_checkpoint(path)
    assert torch.equal(sd["query_embed.weight"],
                       state.ema["query_embed.weight"])
    assert not torch.equal(sd["query_embed.weight"],
                           state.model.query_embed.weight)
    params, frozen = jconvert.load_reference_checkpoint(
        path, d_model=64, enc_layers=2, dec_layers=2,
        stage_sizes=(1, 1, 1, 1))
    jmodel = build_model(dataclasses.replace(TINY, dropout=0.0,
                                             resizer_dropout=0.0),
                         text_vocab_size=VOCAB, tiny_text=True,
                         backbone_norm="frozen_bn")
    b = _batch(4)
    args = [b[k] for k in ("images", "image_mask", "text_ids", "text_mask")]
    jout, _ = jax.jit(lambda v, *a: jmodel.apply(v, *a))(
        {"params": params, **frozen}, *args)
    port = TOIST.from_state_dict(sd, cfg.model, device="cpu")
    with torch.inference_mode():
        out, _ = port(*(torch.from_numpy(a) for a in args))
    for k in ("pred_logits", "pred_boxes", "proj_queries", "proj_tokens"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-3, err_msg=k)


def test_load_reference_checkpoint_of_a_reference_payload(tmp_path):
    """torch.save of a reference-style payload: the weights under `model`
    with the DDP prefix, an empty `model_ema`, `args` an
    argparse.Namespace (loaded under weights_only with that one class
    allowed)."""
    sd = synth_reference_state_dict(seed=2, **SD_KW)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v)
                          for k, v in sd.items()},
                "model_ema": {}, "optimizer": {}, "epoch": 7,
                "args": argparse.Namespace(lr=1e-4, backbone="resnet101")},
               path)
    got = load_reference_checkpoint(path)
    assert list(got) == list(sd)
    model = TOIST.from_state_dict(got, _cfg().model, device="cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert ckpt.load_params(path).keys() == got.keys()


DIS_LOSS = {"distillation": True, "softkd_loss": True, "nsthl2_loss": True,
            "nsthl2_coef": 1.0, "cluster": True, "cluster_memory_size": 8,
            "cluster_num": 2, "kmeans_max_iters": 4}


def _paired(seed):
    """A distillation pair from ``_batch``: the student's captions differ
    and carry the "something" span."""
    noun = _batch(seed)
    sth = {k: v.copy() for k, v in noun.items()}
    sth["text_ids"] = np.where(sth["text_mask"], 1,
                               (noun["text_ids"] * 3) % (VOCAB - 3) + 3)
    b, n = noun["box_valid"].shape
    for x, span in ((noun, (1, 2)), (sth, (2, 2))):
        x["noun_token_spans"] = np.full((b, n, 2), -1, np.int32)
        x["noun_token_spans"][:, :2] = span
        x["caption_noun_span"] = np.tile(np.array(span, np.int32), (b, 1))
        x["task_id"] = np.array([1, 2, 1], np.int32)[:b]
    return {"noun": noun, "sth": sth}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distillation_checkpoint(tmp_path, dtype):
    """Two distillation steps (dropout 0.1), then save: the payload has the
    reference's distillation keys; the restored state equals the live one
    bit for bit (student, teacher, both EMAs, AdamW over both, bank, step)
    and takes the next step as the live one does; both packages read its
    ``model`` and ``model_noun``."""
    cfg = pconfig.Config.from_sources(None, {
        "model": dataclasses.asdict(dataclasses.replace(
            TINY, compute_dtype=dtype)), "loss": DIS_LOSS})
    wd = build_weight_dict(cfg.loss, False, 2)
    step = make_distillation_train_step(cfg, wd)
    teacher = TOIST.from_state_dict(_sd(6), cfg.model, device="cpu")
    bank = init_bank(14, 8, 2, 64, torch.Generator().manual_seed(0))
    model = TOIST.from_state_dict(_sd(), cfg.model, device="cpu")
    state = init_train_state(model, cfg, 10, 100, teacher=teacher,
                             cluster_bank=bank)
    for seed in (1, 2):
        state, _ = step(state, _paired(seed))
    path = str(tmp_path / "checkpoint")
    ckpt.save(path, state, epoch=1, args=cfg.to_dict())
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"model", "model_ema", "model_noun",
                            "model_noun_ema", "optimizer", "epoch", "step",
                            "args", "cluster_criterion"}
    assert set(payload["cluster_criterion"]) == {
        "feature_bank", "cluster_centers", "update_count", "full"}
    assert payload["cluster_criterion"]["update_count"][:2].tolist() == [4, 2]
    restored, epoch = ckpt.restore(path, cfg, 10, 100, device="cpu")
    assert epoch == 1
    _assert_states_equal(restored, state)
    state, sc = step(state, _paired(3))
    restored, sc2 = step(restored, _paired(3))
    _assert_states_equal(restored, state)
    assert float(sc["loss"]) == float(sc2["loss"])

    for key in ("model", "model_noun"):
        one = str(tmp_path / f"{key}.pth")
        torch.save({"model": payload[key]}, one)
        sd = load_reference_checkpoint(one, prefer_ema=False)
        params, frozen = jconvert.load_reference_checkpoint(
            one, prefer_ema=False, d_model=64, enc_layers=2, dec_layers=2,
            stage_sizes=(1, 1, 1, 1))
        back = jax_params_to_state_dict(params, frozen)
        assert set(sd) == set(payload[key]) >= set(back)
        for k, v in back.items():
            assert torch.equal(v, sd[k]), (key, k)
    assert not torch.equal(payload["model"]["query_embed.weight"],
                           payload["model_noun"]["query_embed.weight"])


def test_mask_head_survives_save_and_restore(tmp_path):
    from tests.seg_cases import seg_batch as _batch
    from tests.test_torch_segmentation import SEG, _state_dict

    mcfg = dataclasses.replace(SEG, compute_dtype="bfloat16",
                               frozen_detector=True, dropout=0.1,
                               resizer_dropout=0.1)
    cfg = pconfig.Config.from_sources(None, {
        "model": dataclasses.asdict(mcfg), "loss": {"aux_loss": False}})
    sd = {k: torch.from_numpy(v) for k, v in _state_dict().items()}
    model = TOIST.from_state_dict(sd, cfg.model, device="cpu")
    assert model.mask_head.out_lay.weight.dtype == torch.float32
    assert model.mask_head.lay1.weight.dtype == torch.bfloat16
    state = init_train_state(model, cfg, steps_per_epoch=10, total_steps=100)
    step = make_train_step(cfg, build_weight_dict(cfg.loss, True, 1))
    for seed in (1, 2):
        state, _ = step(state, _batch(seed))
    path = str(tmp_path / "checkpoint")
    ckpt.save(path, state, epoch=0, args=cfg.to_dict())
    payload = torch.load(path)
    heads = [k for k in payload["model"]
             if k.startswith(("bbox_attention.", "mask_head."))]
    assert len(heads) == 32 and len(payload["optimizer"]["state"]) == 32
    for k in heads:
        assert torch.equal(payload["model_ema"][k], state.ema[k])
    restored, _ = ckpt.restore(path, cfg, 10, 100, device="cpu")
    _assert_states_equal(restored, state)
    state, sc = step(state, _batch(3))
    restored, sc2 = step(restored, _batch(3))
    _assert_states_equal(restored, state)
    assert float(sc["loss_mask"]) == float(sc2["loss_mask"])
