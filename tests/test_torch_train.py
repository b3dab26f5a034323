"""The port's training slice (toist_tpu_torch.train and ops.matching) against
the JAX package on the CPU.

The same numpy inputs go through both. Tolerances: matching exact (the LSA
solvers run one algorithm); losses of the criterion rtol 1e-5 (f32, same
formulas); optimizer and schedules rtol 1e-6. The tiny-model training step
(the TINY config of tests/test_torch_model.py at dropout 0, unfused JAX
attention as the oracle) holds losses to 1e-4 relative, every gradient to
2e-3 of its tensor's max abs (a gradient that is 0 by construction: to
1e-4 of its module's other parameter's), and the parameters after one AdamW
step to 2 * lr (a first Adam step is about lr * sign(g), so an element whose
gradient is ~0 may move either way).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toist_tpu.config import Config, LossConfig, ModelConfig, OptimConfig
from toist_tpu.models.toist import build_model
from toist_tpu.ops import matching as jmatch
from toist_tpu.train import criterion as jcrit
from toist_tpu.train import optim as joptim
from toist_tpu.train.step import make_eval_step as jax_make_eval_step
from toist_tpu.train.step import model_forward
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.ops import matching as pmatch
from toist_tpu_torch.train import criterion as pcrit
from toist_tpu_torch.train import optim as poptim
from toist_tpu_torch.train.engine import train_one_epoch
from toist_tpu_torch.train.state import init_train_state
from toist_tpu_torch.train.step import (TRAIN_KEYS, accumulate_gradients,
                                        forward_losses, make_eval_step,
                                        make_train_step)
from toist_tpu_torch.utils.convert import jax_params_to_state_dict

L_LVL, B, Q, N, C, T, HP = 3, 3, 12, 5, 256, 10, 16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _outputs_and_batch(seed=0):
    """Model outputs of 3 decoder levels and a padded target batch: targets
    not front-packed, one image without targets, one batch-padding row."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(L_LVL, B, Q, C)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (L_LVL, B, Q, 2)),
                            rng.uniform(0.05, 0.4, (L_LVL, B, Q, 2))],
                           -1).astype(np.float32)
    pq = rng.normal(size=(L_LVL, B, Q, HP)).astype(np.float32)
    pq /= np.linalg.norm(pq, axis=-1, keepdims=True)
    pt = rng.normal(size=(B, T, HP)).astype(np.float32)
    pt /= np.linalg.norm(pt, axis=-1, keepdims=True)
    out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
           "aux_pred_logits": logits[:-1], "aux_pred_boxes": boxes[:-1],
           "proj_queries": pq[-1], "aux_proj_queries": pq[:-1],
           "proj_tokens": pt}
    tb = np.concatenate([rng.uniform(0.2, 0.8, (B, N, 2)),
                         rng.uniform(0.05, 0.4, (B, N, 2))],
                        -1).astype(np.float32)
    bv = np.array([[1, 0, 1, 1, 0], [0, 0, 0, 0, 0], [1, 1, 0, 0, 0]], bool)
    pm = np.zeros((B, N, C), np.float32)
    for b in range(B):
        for n in range(N):
            s = int(rng.integers(1, T - 2))
            pm[b, n, s:s + 2] = 0.5
    text_mask = np.ones((B, T), bool)
    text_mask[:, :7] = False
    batch = {"boxes": tb * bv[..., None], "positive_map": pm,
             "box_valid": bv, "sample_valid": np.array([True, True, False]),
             "text_mask": text_mask}
    return out, batch


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: _t(v) for k, v in d.items()}


def test_match_costs_match_jax():
    out, batch = _outputs_and_batch()
    args = (out["pred_logits"], out["pred_boxes"], batch["boxes"],
            batch["positive_map"])
    want = jmatch.match_costs(*map(jnp.asarray, args), 1.0, 5.0, 2.0)
    got = pmatch.match_costs(*map(_t, args), 1.0, 5.0, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_hungarian_match_levels_match_jax():
    out, batch = _outputs_and_batch(1)
    lg = np.concatenate([out["aux_pred_logits"], out["pred_logits"][None]])
    bx = np.concatenate([out["aux_pred_boxes"], out["pred_boxes"][None]])
    args = (lg, bx, batch["boxes"], batch["positive_map"], batch["box_valid"])
    want = jax.jit(jmatch.hungarian_match_levels)(*map(jnp.asarray, args))
    got = pmatch.hungarian_match_levels(*map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 1] == -1).all() and (got[:, 0, 1] == -1).all()
    np.testing.assert_array_equal(
        pmatch.query_is_matched(got[-1], Q).numpy(),
        np.asarray(jmatch.query_is_matched(jnp.asarray(got[-1].numpy()), Q)))


def _matched(out, batch):
    return np.asarray(jmatch.hungarian_match(
        *(jnp.asarray(x) for x in (out["pred_logits"], out["pred_boxes"],
                                   batch["boxes"], batch["positive_map"],
                                   batch["box_valid"]))).tgt2query)


@pytest.mark.parametrize("loss", ["labels", "boxes", "cardinality",
                                  "contrastive_align"])
def test_loss_matches_jax(loss):
    out, batch = _outputs_and_batch(2)
    t2q = _matched(out, batch)
    bv = batch["box_valid"] & batch["sample_valid"][:, None]
    sv = batch["sample_valid"].astype(np.float32)
    nb = np.float32(max(bv.sum(), 1))
    j, p = jnp.asarray, _t
    if loss == "labels":
        args = (out["pred_logits"], batch["positive_map"], t2q, bv, sv, 0.1,
                nb)
        want = jcrit.loss_labels(*(j(a) if isinstance(a, np.ndarray) else a
                                   for a in args))
        got = pcrit.loss_labels(p(args[0]), p(args[1]), p(t2q), p(bv), p(sv),
                                0.1, torch.tensor(nb))
    elif loss == "boxes":
        want = jcrit.loss_boxes(j(out["pred_boxes"]), j(batch["boxes"]),
                                j(t2q), j(bv), j(nb))
        got = pcrit.loss_boxes(p(out["pred_boxes"]), p(batch["boxes"]),
                               p(t2q), p(bv), torch.tensor(nb))
    elif loss == "cardinality":
        want = jcrit.loss_cardinality(j(out["pred_logits"]), j(bv),
                                      j(batch["sample_valid"]))
        got = pcrit.loss_cardinality(p(out["pred_logits"]), p(bv),
                                     p(batch["sample_valid"]))
    else:
        args = (out["proj_queries"], out["proj_tokens"],
                batch["positive_map"], t2q, bv, batch["text_mask"],
                batch["sample_valid"])
        want = jcrit.loss_contrastive_align(*map(j, args), 0.07, j(nb))
        got = pcrit.loss_contrastive_align(*map(p, args), 0.07,
                                           torch.tensor(nb))
    for g, w in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                    np.atleast_1d(np.asarray(want, dtype=object))):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_set_criterion_matches_jax():
    out, batch = _outputs_and_batch(3)
    want = jcrit.set_criterion(_jax(out), _jax(batch), LossConfig())
    got = pcrit.set_criterion(_torch(out), _torch(batch),
                              pconfig.LossConfig())
    assert set(got) == set(want)
    for k in want:
        if k.startswith("_"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)


def test_num_boxes_override_and_given_matching():
    out, batch = _outputs_and_batch(4)
    cfg, pcfg = LossConfig(), pconfig.LossConfig()
    base = pcrit.set_criterion(_torch(out), _torch(batch), pcfg)
    nb = float(pcrit.compute_num_boxes(_t(batch["box_valid"]),
                                       _t(batch["sample_valid"])))
    # 3 valid boxes on the valid samples; the padding row's are not counted
    assert nb == float(jcrit.compute_num_boxes(
        jnp.asarray(batch["box_valid"]),
        jnp.asarray(batch["sample_valid"]))) == 3.0
    tb = dict(_torch(batch), num_boxes_override=torch.tensor(2.5))
    want = jcrit.set_criterion(
        _jax(out), dict(_jax(batch), num_boxes_override=jnp.float32(2.5)),
        cfg)
    got = pcrit.set_criterion(_torch(out), tb, pcfg)
    for k in ("loss_ce", "loss_bbox", "loss_giou", "loss_contrastive_align_1"):
        np.testing.assert_allclose(float(got[k]), float(base[k]) * nb / 2.5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    matching = torch.stack([base["_tgt2query_0"], base["_tgt2query_1"],
                            base["_tgt2query"]])
    again = pcrit.set_criterion(_torch(out), _torch(batch), pcfg, matching)
    for k in base:
        assert torch.equal(again[k], base[k]), k


@pytest.mark.parametrize("kw", [{}, {"softkd_loss": True, "cluster": True,
                                     "nsthl2_loss": True}])
def test_weight_dict_and_total_loss_match_jax(kw):
    cfg, pcfg = LossConfig(**kw), pconfig.LossConfig(**kw)
    for masks in (False, True):
        assert pcrit.build_weight_dict(pcfg, masks, 6) == \
            jcrit.build_weight_dict(cfg, masks, 6)
    wd = pcrit.build_weight_dict(pcfg, False, 3)
    out, batch = _outputs_and_batch(5)
    want = jcrit.total_loss(jcrit.set_criterion(_jax(out), _jax(batch),
                                                LossConfig()), wd)
    got = pcrit.total_loss(pcrit.set_criterion(_torch(out), _torch(batch),
                                               pconfig.LossConfig()), wd)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("schedule", ["step", "multistep",
                                      "linear_with_warmup",
                                      "all_linear_with_warmup"])
def test_schedules_match_jax(schedule):
    kw = dict(lr=1e-4, lr_backbone=1e-5, text_encoder_lr=5e-5, epochs=120,
              lr_drop=7, schedule=schedule)
    spe, total = 100, 12000
    want = joptim.make_schedules(OptimConfig(**kw), spe, total)
    got = poptim.make_schedules(pconfig.OptimConfig(**kw), spe, total)
    assert set(got) == {"model", "backbone", "text_encoder"}
    for step in (0, 1, 59, 60, 61, 699, 700, 5700, 5800, 11999, 12000):
        for g in got:
            np.testing.assert_allclose(got[g](step),
                                       float(want[g](jnp.int32(step))),
                                       rtol=1e-6, atol=1e-12,
                                       err_msg=f"{g} {step}")


_TINY_SD = dict(stage_sizes=(1, 1, 1, 1), enc=2, dec=2, d=64,
                dim_feedforward=128, text_layers=2, text_hidden=64,
                text_intermediate=128, num_queries=20, vocab_size=600,
                contrastive_hdim=16, with_masks=False)
# tests/test_torch_model.py's TINY; the JAX side runs its unfused attention.
TINY = ModelConfig(backbone="resnet18-test", hidden_dim=64, nheads=4,
                   dim_feedforward=128, enc_layers=2, dec_layers=2,
                   num_queries=20, compute_dtype="float32",
                   contrastive_align_loss=True, contrastive_hdim=16,
                   text_hidden=64, text_layers=2, text_heads=4,
                   text_intermediate=128, dropout=0.0, resizer_dropout=0.0,
                   fused_attention="off")
PTINY = pconfig.ModelConfig(**dataclasses.asdict(TINY))   # the port's own


@pytest.fixture(scope="module")
def tiny():
    sd = synth_reference_state_dict(seed=5, **_TINY_SD)
    params, frozen = convert_torch_state_dict(
        sd, d_model=64, enc_layers=2, dec_layers=2, stage_sizes=(1, 1, 1, 1))
    return jax_params_to_state_dict(params, frozen), params, frozen


def _tiny_batch(b=4, h=128, w=160, n=6):
    rng = np.random.default_rng(9)
    batch = {"images": rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8),
             "image_mask": np.zeros((b, h, w), bool),
             "text_ids": np.full((b, 16), 1, np.int32),
             "text_mask": np.ones((b, 16), bool),
             "boxes": np.zeros((b, n, 4), np.float32),
             "box_valid": np.zeros((b, n), bool),
             "positive_map": np.zeros((b, n, C), np.float32),
             "sample_valid": np.ones((b,), bool),
             "orig_size": np.full((b, 2), [h, w], np.int32)}
    batch["image_mask"][1, 96:] = True
    batch["sample_valid"][-1] = False
    for i in range(b - 1):
        k = i + 1
        batch["text_ids"][i, :5 + i] = rng.integers(3, 600, 5 + i)
        batch["text_mask"][i, :5 + i] = False
        batch["boxes"][i, :k] = np.concatenate(
            [rng.uniform(0.3, 0.7, (k, 2)), rng.uniform(0.1, 0.4, (k, 2))],
            -1)
        batch["box_valid"][i, :k] = True
        for j in range(k):
            batch["positive_map"][i, j, 1 + j:3 + j] = 0.5
    return batch


def _port_state(sd, cfg):
    model = TOIST.from_state_dict(sd, cfg.model, device="cpu")
    return init_train_state(model, cfg, steps_per_epoch=10, total_steps=100)


def test_label_params_match_jax(tiny):
    sd, params, frozen = tiny
    model = TOIST.from_state_dict(sd, PTINY, device="cpu")
    for kw in ({}, {"freeze_text_encoder": True}, {"frozen_detector": True}):
        got = poptim.label_params(model, **kw)
        jl = jax_params_to_state_dict(params, frozen)
        want = jax.tree_util.tree_leaves(joptim.label_params(params, **kw))
        sizes = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda x: np.size(x), params))
        per_group = {}
        for lab, n in zip(want, sizes):
            per_group[lab] = per_group.get(lab, 0) + n
        mine = {}
        for name, p in model.named_parameters():
            mine[got[name]] = mine.get(got[name], 0) + p.numel()
        assert mine == per_group, kw
        assert set(jl) >= set(got)


def test_adamw_matches_optax():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(4)]
    lrs = [1e-3, 5e-4, 2e-3, 0.0]
    sched = {"count": 0}

    def lr(count):
        return jnp.asarray(lrs)[count]

    tx = optax.adamw(learning_rate=lr, weight_decay=1e-4)
    state, pj = tx.init(jnp.asarray(p0)), jnp.asarray(p0)
    pt = _t(p0.copy())
    opt = poptim.make_optimizer({"model": [pt]}, pconfig.OptimConfig())
    for i, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.param_groups[0]["lr"] = lrs[i]
        pt.grad = _t(g)
        opt.step()
        sched["count"] += 1
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                                   atol=1e-7)


def test_ema_update_and_moment_dtype():
    rng = np.random.default_rng(1)
    e, p = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    want = joptim.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)},
                             0.9998)["w"]
    et = _t(e.copy())
    poptim.ema_update([et], [_t(p)], 0.9998)
    np.testing.assert_allclose(et.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="moment"):
        poptim.make_optimizer({"model": [et]},
                              pconfig.OptimConfig(moment_dtype="bfloat16"))


def _zero_by_construction(name):
    """Gradients that are 0 in exact arithmetic, so that both sides hold
    rounding noise: a separate key bias (RoBERTa's) adds one constant to a
    whole softmax row; the first decoder layer's self-attention sees tgt = 0,
    so every value is b_v and its output is b_v whatever the weights."""
    return (name.endswith(".key.bias") or name ==
            "transformer.decoder.layers.0.self_attn.in_proj_weight")


def _partner(name):
    """The other parameter of the same module (weight <-> bias)."""
    return (name[:-len("weight")] + "bias" if name.endswith("weight")
            else name[:-len("bias")] + "weight")


def test_tiny_train_step_matches_jax(tiny):
    """One training step of the tiny model, port vs JAX: losses, the
    gradient of every trainable parameter, the parameters after AdamW."""
    sd, params, frozen = tiny
    cfg = Config(model=TINY)
    wd = jcrit.build_weight_dict(cfg.loss, False, 2)
    batch = _tiny_batch()
    jmodel = build_model(TINY, text_vocab_size=600, tiny_text=True,
                         backbone_norm="frozen_bn")

    def jloss(p, b):
        p = joptim.stop_frozen_gradients(p)
        out, _ = model_forward(jmodel, p, frozen, b)
        losses = jcrit.set_criterion(out, b, cfg.loss)
        total = jcrit.total_loss(losses, wd)
        return total, {k: v for k, v in losses.items()
                       if not k.startswith("_")}

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, jl), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, jb)
    tx = joptim.make_optimizer(cfg.optim, 10, 100)
    upd, _ = tx.update(jg, tx.init(params), params)
    jnew = jax_params_to_state_dict(optax.apply_updates(params, upd), frozen)
    jgrads = jax_params_to_state_dict(jg, frozen)

    pcfg = pconfig.Config(model=PTINY)
    state = _port_state(sd, pcfg)
    scalars = accumulate_gradients(state, {k: _t(v) for k, v in
                                           batch.items()}, pcfg, wd)
    for k, v in jl.items():
        np.testing.assert_allclose(float(scalars[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(scalars["loss"]), float(jtotal),
                               rtol=1e-4)
    names = dict(state.model.named_parameters())
    trainable = [n for n, p in names.items() if p.requires_grad]
    assert len(trainable) == len(state.masters) > 0
    bad = []
    for n in trainable:
        g, want = names[n].grad.numpy(), jgrads[n].numpy()
        if _zero_by_construction(n):
            # rounding noise on both sides, far below the partner's gradient
            tol = 1e-4 * np.abs(jgrads[_partner(n)].numpy()).max()
            err = max(np.abs(g).max(), np.abs(want).max())
        else:
            tol = 2e-3 * max(np.abs(want).max(), 1e-8)
            err = np.abs(g - want).max()
        if not err <= tol:
            bad.append((n, float(err), float(tol)))
    assert not bad, bad

    state = _port_state(sd, pcfg)
    state, sc = make_train_step(pcfg, wd)(state, batch)
    lr = max(cfg.optim.lr, cfg.optim.lr_backbone, cfg.optim.text_encoder_lr)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jnew[n].numpy(),
                                   atol=2 * lr, err_msg=n)
    assert state.step == 1 and bool(sc["loss_is_finite"])


def test_grad_accumulation_equals_full_batch(tiny):
    """grad_accum_steps=2 over a batch of 4 gives the gradients of one pass
    over the 4 (each microbatch normalised by the global box count / 2)."""
    sd = tiny[0]
    batch = {k: _t(v) for k, v in _tiny_batch().items()}
    cfg = pconfig.Config(model=PTINY)
    wd = pcrit.build_weight_dict(cfg.loss, False, 2)
    full = _port_state(sd, cfg)
    sc_full = accumulate_gradients(full, batch, cfg, wd)
    cfg2 = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, grad_accum_steps=2))
    acc = _port_state(sd, cfg2)
    sc_acc = accumulate_gradients(acc, batch, cfg2, wd)
    np.testing.assert_allclose(float(sc_acc["loss_bbox"]) * 2,
                               float(sc_full["loss_bbox"]) * 2, rtol=1e-5)
    for (_, a), (_, b) in zip(acc.masters, full.masters):
        tol = 1e-5 * max(b.grad.abs().max().item(), 1e-8)
        assert (a.grad - b.grad).abs().max().item() <= tol


def test_eval_step_losses_match_jax(tiny):
    sd, params, frozen = tiny
    cfg = Config(model=TINY)
    wd = jcrit.build_weight_dict(cfg.loss, False, 2)
    batch = _tiny_batch()
    jmodel = build_model(TINY, text_vocab_size=600, tiny_text=True,
                         backbone_norm="frozen_bn")
    want = jax_make_eval_step(jmodel, cfg, wd, frozen)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = TOIST.from_state_dict(sd, PTINY, device="cpu")
    got = make_eval_step(model, pconfig.Config(model=PTINY), wd)(batch)
    assert set(got["scalars"]) == set(want["scalars"])
    for k, v in want["scalars"].items():
        np.testing.assert_allclose(float(got["scalars"][k]), float(v),
                                   rtol=1e-4, err_msg=k)
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(got["post"][k].numpy(),
                                   np.asarray(want["post"][k]), atol=2e-3)


def test_dropout_is_seeded_per_step(tiny):
    cfg = pconfig.Config(model=dataclasses.replace(PTINY, dropout=0.1,
                                                   resizer_dropout=0.1))
    wd = pcrit.build_weight_dict(cfg.loss, False, 2)
    batch = {k: _t(v) for k, v in _tiny_batch().items()}
    model = TOIST.from_state_dict(tiny[0], cfg.model, device="cpu").train()
    losses = [float(forward_losses(model, batch, cfg, wd,
                                   torch.Generator().manual_seed(s))[0])
              for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
    with torch.no_grad():
        model.eval()
        a = forward_losses(model, batch, cfg, wd)[0]
        b = forward_losses(model, batch, cfg, wd)[0]
    assert float(a) == float(b)       # eval mode: no dropout, no generator


def test_train_one_epoch_on_fixture_data(tiny, tmp_path):
    """train_one_epoch over a BatchIterator of fixture images (the port's
    own data pipeline and weights), on the CPU with the tiny model."""
    from toist_tpu_torch.data.batcher import BatchIterator, BucketSpec, \
        train_buckets
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.data.fixtures import generate_fixture
    from toist_tpu_torch.utils.convert import \
        synth_reference_state_dict as port_synth

    root = generate_fixture(str(tmp_path), num_tasks=1, imgs_per_split=4,
                            img_size=(120, 160))
    cfg = pconfig.Config.from_sources(None, {
        "data": {"coco_path": root, "refexp_ann_path": f"{root}/annotations",
                 "tasks": [1], "train_scales": [160], "max_size": 256},
        "model": dataclasses.asdict(dataclasses.replace(
            PTINY, num_queries=30))})
    d = cfg.data
    ds = [build_task_dataset(d, 1, "train", build_tokenizer(cfg))]
    spec = BucketSpec(buckets=train_buckets(d.max_size, d.train_scales))
    it = BatchIterator(ds, spec, batch_size=2, num_workers=1)
    sd = port_synth(seed=5, **dict(_TINY_SD, num_queries=30))
    state = _port_state({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    step = make_train_step(cfg, pcrit.build_weight_dict(cfg.loss, False, 2))
    state, summary = train_one_epoch(step, state, it, epoch=0, print_freq=1)
    assert state.step == len(it) == 2
    assert np.isfinite(summary["loss"]) and summary["grad_norm"] > 0


def test_train_one_epoch_stops_on_non_finite_loss():
    class Iter:
        def __len__(self):
            return 3

        def epoch(self, e):
            return iter([{k: np.zeros(1) for k in TRAIN_KEYS}] * 3)

    def nan_step(state, batch):
        return state, {"loss": torch.tensor(float("nan")),
                       "loss_is_finite": torch.tensor(False)}

    class State:
        masters = [(None, torch.zeros(1))]

    with pytest.raises(SystemExit) as e:
        train_one_epoch(nan_step, State(), Iter(), 0)
    assert e.value.code == 1
