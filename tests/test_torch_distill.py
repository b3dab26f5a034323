"""The port's distillation slice (the softkd / nsthl2 losses and the prefixed
set criterion of toist_tpu_torch.train.criterion, train/distill.py, the
cluster path of train/step.py) against the JAX package on the CPU.

The same numpy inputs, made from seeds, go through both. Tolerances: the
losses 1e-5 relative (f32, the same formulas); a false-positive
re-pairing of equal total cost (1e-5 relative) where the two solvers'
costs differ in the last bits; one whole tiny distillation step (the TINY
model of tests/test_torch_train.py at dropout 0 as student and teacher,
from two seeds of ``synth_reference_state_dict``, the bank carried across)
holds the losses to 1e-4 relative, every gradient of both models to 2e-3
of its tensor's max abs (the two that are 0 by construction to 1e-4 of
their partner's), and the new bank to 1e-5; the cluster eval step holds
scores to 1e-5 and boxes to 1e-3 px.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train import (PTINY, TINY, _TINY_SD, _partner,
                                    _tiny_batch, _zero_by_construction)
from toist_tpu.config import Config, LossConfig, OptimConfig
from toist_tpu.models.toist import build_model
from toist_tpu.ops.lsa import solve_lsa
from toist_tpu.train import cluster as jcl
from toist_tpu.train import criterion as jcrit
from toist_tpu.train import distill as jdistill
from toist_tpu.train import optim as joptim
from toist_tpu.train.state import TrainState as JTrainState
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.train import criterion as pcrit
from toist_tpu_torch.train.distill import (distillation_losses,
                                           make_cluster_eval_step,
                                           make_distillation_train_step)
from toist_tpu_torch.train.state import init_train_state, model_masters
from toist_tpu_torch.train.step import accumulate_gradients, forward_losses
from toist_tpu_torch.utils.convert import (cluster_bank_from_jax,
                                           jax_params_to_state_dict)

RTOL = 1e-5
B, Q, N, LC = 3, 12, 4, 16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _streams(seed, levels=None):
    """Teacher and student logits and boxes ([levels,] B, Q, ...), their
    matchings (distinct queries, -1 on invalid targets), box and sample
    validity (the last sample is batch padding)."""
    rng = np.random.default_rng(seed)
    lead = (B,) if levels is None else (levels, B)

    def boxes():
        return np.concatenate([rng.uniform(0.2, 0.8, lead + (Q, 2)),
                               rng.uniform(0.05, 0.4, lead + (Q, 2))],
                              -1).astype(np.float32)

    bv = np.array([[1, 1, 0, 1], [1, 0, 0, 0], [1, 1, 1, 0]], bool)

    def t2q():
        out = np.full(lead + (N,), -1, np.int32)
        for idx in np.ndindex(lead):
            qs = rng.permutation(Q)[:N]
            out[idx] = np.where(bv[idx[-1]], qs, -1)
        return out

    return {"noun_logits": rng.normal(size=lead + (Q, LC)).astype(np.float32),
            "sth_logits": rng.normal(size=lead + (Q, LC)).astype(np.float32),
            "noun_boxes": boxes(), "sth_boxes": boxes(),
            "t2q_noun": t2q(), "t2q_sth": t2q(), "box_valid": bv,
            "sample_valid": np.array([True, True, False])}


ARGS = ("noun_logits", "sth_logits", "noun_boxes", "sth_boxes", "t2q_noun",
        "t2q_sth", "box_valid", "sample_valid")


def _record_solves(monkeypatch):
    """The port's re-pairing problems and assignments, as solved."""
    solves, solve = [], pcrit.solve_lsa_batch

    def recording(cost, n):
        out = solve(cost, n)
        solves.append((cost.numpy(), n.numpy(), out.numpy()))
        return out

    monkeypatch.setattr(pcrit, "solve_lsa_batch", recording)
    return solves


def _assert_equal_total_cost(solves):
    """JAX's solver on the port's own costs finds an assignment of the same
    total cost."""
    for cost, n, got in solves:
        want = np.asarray(jax.vmap(solve_lsa)(jnp.asarray(cost),
                                              jnp.asarray(n)))
        for b in range(cost.shape[0]):
            rows = np.arange(n[b])
            ours = cost[b, rows, got[b, :n[b]]].sum()
            theirs = cost[b, rows, want[b, :n[b]]].sum()
            np.testing.assert_allclose(ours, theirs, rtol=RTOL)
            assert (got[b, n[b]:] == -1).all()


@pytest.mark.parametrize("fn", ["loss_softkd", "loss_softkd_levels"])
def test_softkd_matches_jax(fn, monkeypatch):
    s = _streams(0, levels=3 if fn == "loss_softkd_levels" else None)
    solves = _record_solves(monkeypatch)
    got = getattr(pcrit, fn)(*(_t(s[k]) for k in ARGS))
    want = jax.jit(getattr(jcrit, fn))(*(jnp.asarray(s[k]) for k in ARGS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    [(cost, n, _)] = solves                    # one solve, all levels
    assert cost.shape == ((3 if fn.endswith("levels") else 1) * B, Q, Q)
    # Q minus the valid boxes of valid samples (the third is padding).
    assert n.tolist()[:B] == [Q - 3, Q - 1, Q]
    _assert_equal_total_cost(solves)


def test_softkd_on_shared_matchings_is_the_levels_loss():
    """``loss_softkd_levels`` equals ``loss_softkd`` level by level."""
    s = _streams(1, levels=2)
    lv = pcrit.loss_softkd_levels(*(_t(s[k]) for k in ARGS))
    for i in range(2):
        one = pcrit.loss_softkd(*(_t(s[k][i]) for k in ARGS[:6]),
                                _t(s["box_valid"]), _t(s["sample_valid"]))
        np.testing.assert_allclose(float(one), float(lv[i]), rtol=RTOL)


def test_softkd_properties():
    """Zero for identical streams; its gradient reaches the student only."""
    s = _streams(2)
    x = {k: _t(v) for k, v in s.items()}
    same = pcrit.loss_softkd(x["noun_logits"], x["noun_logits"],
                             x["noun_boxes"], x["noun_boxes"], x["t2q_noun"],
                             x["t2q_noun"], x["box_valid"], x["sample_valid"])
    assert abs(float(same)) < 1e-6
    ln = x["noun_logits"].clone().requires_grad_()
    ls = x["sth_logits"].clone().requires_grad_()
    loss = pcrit.loss_softkd(ln, ls, *(x[k] for k in ARGS[2:]))
    assert float(loss.detach()) > 1e-4
    loss.backward()
    assert ln.grad is None or float(ln.grad.abs().max()) == 0.0
    assert float(ls.grad.abs().max()) > 0.0
    # Padding samples take no gradient.
    assert float(ls.grad[2].abs().max()) == 0.0


def test_nsthl2_matches_jax():
    rng = np.random.default_rng(3)
    tn, ts = (rng.normal(size=(B, 10, 8)).astype(np.float32)
              for _ in range(2))
    spans_n = np.full((B, N, 2), -1, np.int32)
    spans_s = np.full((B, N, 2), -1, np.int32)
    spans_n[0, :2], spans_n[1, 0], spans_n[2, :3] = [2, 3], [1, 4], [5, 5]
    spans_s[..., 0] = spans_s[..., 1] = 6
    bv = np.array([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0]], bool)
    sv = np.array([True, True, False])
    args = (tn, ts, spans_n, spans_s, bv, sv)
    want = jax.jit(jcrit.loss_nsthl2)(*map(jnp.asarray, args))
    tn_t, ts_t = _t(tn).requires_grad_(), _t(ts).requires_grad_()
    got = pcrit.loss_nsthl2(tn_t, ts_t, *map(_t, args[2:]))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    got.backward()
    assert tn_t.grad is None            # the teacher's feature is detached
    assert float(ts_t.grad.abs().max()) > 0.0
    same = pcrit.loss_nsthl2(_t(tn), _t(tn), _t(spans_n), _t(spans_n),
                             _t(bv), _t(sv))
    assert float(same) == 0.0


def _outputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(3, B, Q, 32)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (3, B, Q, 2)),
                            rng.uniform(0.05, 0.4, (3, B, Q, 2))],
                           -1).astype(np.float32)
    return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
            "aux_pred_logits": logits[:-1], "aux_pred_boxes": boxes[:-1]}


def _targets(seed):
    rng = np.random.default_rng(seed)
    bv = np.array([[1, 1, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0]], bool)
    tb = np.concatenate([rng.uniform(0.2, 0.8, (B, N, 2)),
                         rng.uniform(0.05, 0.4, (B, N, 2))], -1)
    pm = np.zeros((B, N, 32), np.float32)
    pm[:, :, 3:5] = 0.5
    return {"boxes": (tb * bv[..., None]).astype(np.float32),
            "positive_map": pm, "box_valid": bv,
            "sample_valid": np.array([True, True, True]),
            "text_mask": np.zeros((B, 8), bool)}


def test_prefixed_set_criterion_and_total_loss_match_jax():
    out, batch = _outputs(4), _targets(5)
    cfg, pcfg = LossConfig(), pconfig.LossConfig()
    losses, plosses = {}, {}
    for prefix, seed in (("noun_", 4), ("sth_", 6)):
        out = _outputs(seed)
        losses.update(jcrit.set_criterion(
            {k: jnp.asarray(v) for k, v in out.items()},
            {k: jnp.asarray(v) for k, v in batch.items()}, cfg,
            prefix=prefix))
        plosses.update(pcrit.set_criterion(
            {k: _t(v) for k, v in out.items()},
            {k: _t(v) for k, v in batch.items()}, pcfg, prefix=prefix))
    assert set(plosses) == set(losses)
    assert {"_noun_tgt2query", "_sth_tgt2query_1", "noun_loss_ce",
            "sth_loss_giou_0"} <= set(plosses)
    for k in losses:
        if k.startswith("_"):
            np.testing.assert_array_equal(plosses[k].numpy(),
                                          np.asarray(losses[k]), err_msg=k)
        else:
            np.testing.assert_allclose(float(plosses[k]), float(losses[k]),
                                       rtol=RTOL, err_msg=k)
    kw = dict(softkd_loss=True, nsthl2_loss=True, cluster=True)
    wd = pcrit.build_weight_dict(pconfig.LossConfig(**kw), False, 3)
    extra = {"loss_softkd": 0.25, "loss_softkd_1": 0.5, "loss_nsthl2": 1e-4,
             "loss_cluster_feature": 2e-4, "loss_cluster_choice": 0.0,
             # A matching key without the leading "_" is no loss either.
             "noun_tgt2query": 7.0}
    losses.update({k: jnp.float32(v) for k, v in extra.items()})
    plosses.update({k: torch.tensor(v) for k, v in extra.items()})
    want = jcrit.total_loss(losses, wd)
    got = pcrit.total_loss(plosses, wd)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    # Every prefixed loss is weighed by its unprefixed name.
    by_hand = sum(wd[k.split("_", 1)[1]] * float(v)
                  for k, v in plosses.items()
                  if k.startswith(("noun_loss", "sth_loss")))
    by_hand += sum(wd[k] * v for k, v in extra.items() if k in wd)
    np.testing.assert_allclose(float(got), by_hand, rtol=1e-4)


# ---------------------------------------------------------------------------
# The tiny distillation step against make_distillation_train_step.
# ---------------------------------------------------------------------------
DIS_LOSS = dict(aux_loss=True, distillation=True, softkd_loss=True,
                softkd_coef=50.0, nsthl2_loss=True, nsthl2_coef=1.0,
                cluster=True, cluster_memory_size=16, cluster_num=2,
                kmeans_max_iters=8)
OPT = dict(lr=1e-3, lr_backbone=1e-3, text_encoder_lr=1e-3, ema=False,
           schedule="step", lr_drop=1000, clip_max_norm=0.5)


def _paired_batch():
    """The TINY test batch as the teacher's noun stream and, with other
    caption tokens and the "something" span, the student's."""
    noun = _tiny_batch()
    b, n = noun["box_valid"].shape
    sth = {k: v.copy() for k, v in noun.items()}
    spans = np.full((b, n, 2), -1, np.int32)
    spans[:, :2] = [1, 2]
    noun["noun_token_spans"] = spans
    sth_spans = np.full((b, n, 2), -1, np.int32)
    sth_spans[..., :] = 3
    sth["noun_token_spans"] = sth_spans
    sth["text_ids"] = np.where(sth["text_mask"], 1,
                               (noun["text_ids"] * 7) % 590 + 3)
    for x in (noun, sth):
        x["caption_noun_span"] = np.array([[1, 2], [3, 3], [2, 4], [1, 1]],
                                          np.int32)
        x["task_id"] = np.array([1, 2, 1, 0], np.int32)   # 0: padding
    return {"noun": noun, "sth": sth}


def _bank(seed=7, T=14, M=16, K=2, D=64):
    """A half-filled bank: tasks 0 and 2 full."""
    rng = np.random.default_rng(seed)
    return jcl.ClusterBank(
        feature_bank=jnp.asarray(rng.normal(size=(T, M, D)), jnp.float32),
        cluster_centers=jnp.asarray(rng.normal(size=(T, K, D)), jnp.float32),
        update_count=jnp.asarray([20, 3, 17] + [0] * (T - 3), jnp.int32),
        full=jnp.asarray([True, False, True] + [False] * (T - 3)))


@pytest.fixture(scope="module")
def dual():
    """Student (seed 5) and teacher (seed 7) reference-layout weights, as
    the port's state dicts and the JAX package's params."""
    out = {}
    for who, seed in (("student", 5), ("teacher", 7)):
        sd = synth_reference_state_dict(seed=seed, **_TINY_SD)
        params, frozen = convert_torch_state_dict(
            sd, d_model=64, enc_layers=2, dec_layers=2,
            stage_sizes=(1, 1, 1, 1))
        out[who] = (jax_params_to_state_dict(params, frozen), params, frozen)
    return out


def _grad_tracker():
    """An optax transformation that applies no update and keeps the
    gradients it was given as its state: the JAX step's gradients, exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _port_dual_state(dual, cfg, bank):
    student = TOIST.from_state_dict(dual["student"][0], cfg.model,
                                    device="cpu")
    teacher = TOIST.from_state_dict(dual["teacher"][0], cfg.model,
                                    device="cpu")
    return init_train_state(student, cfg, 10, 100, teacher=teacher,
                            cluster_bank=bank)


def test_tiny_distillation_step_matches_jax(dual):
    cfg = Config(model=TINY, loss=LossConfig(**DIS_LOSS),
                 optim=OptimConfig(**OPT))
    wd = jcrit.build_weight_dict(cfg.loss, False, 2)
    batches = _paired_batch()
    jmodel = build_model(TINY, text_vocab_size=600, tiny_text=True,
                         backbone_norm="frozen_bn")
    (_, sp, sf), (_, tp, tf) = dual["student"], dual["teacher"]
    tx = _grad_tracker()
    jstate = JTrainState(params=sp, opt_state=tx.init({"student": sp,
                                                       "teacher": tp}),
                         ema_params=None, step=jnp.int32(0),
                         teacher_params=tp, teacher_ema_params=None,
                         cluster_bank=_bank())
    step = jdistill.make_distillation_train_step(jmodel, cfg, wd, tx, sf, tf)
    jnew, jsc = step(jstate, {s: {k: jnp.asarray(v) for k, v in b.items()}
                              for s, b in batches.items()},
                     jax.random.PRNGKey(0))
    jgrads = {w: jax_params_to_state_dict(jnew.opt_state[w], f)
              for w, f in (("student", sf), ("teacher", tf))}

    pcfg = pconfig.Config(model=PTINY, loss=pconfig.LossConfig(**DIS_LOSS),
                          optim=pconfig.OptimConfig(**OPT))
    state = _port_dual_state(dual, pcfg, cluster_bank_from_jax(_bank()))
    sc = accumulate_gradients(
        state, {s: {k: _t(v) for k, v in b.items()}
                for s, b in batches.items()}, pcfg, wd, distillation_losses)
    assert {"loss_softkd", "loss_softkd_0", "loss_nsthl2",
            "loss_cluster_feature", "noun_loss_ce", "sth_loss_giou_0"} \
        <= set(sc)
    for k, v in jsc.items():
        if k in sc:
            np.testing.assert_allclose(float(sc[k]), float(v), rtol=1e-4,
                                       err_msg=k)
    assert set(jsc) - set(sc) == {"grad_norm", "loss_is_finite",
                                  "bank_update_count", "bank_full"}
    bad = []
    for who, teacher in (("student", False), ("teacher", True)):
        masters = model_masters(state, teacher)
        assert len(masters) > 0
        for n, p, _ in masters:
            g, want = p.grad.numpy(), jgrads[who][n].numpy()
            if _zero_by_construction(n):
                tol = 1e-4 * np.abs(jgrads[who][_partner(n)].numpy()).max()
                err = max(np.abs(g).max(), np.abs(want).max())
            else:
                tol = 2e-3 * max(np.abs(want).max(), 1e-8)
                err = np.abs(g - want).max()
            if not err <= tol:
                bad.append((who, n, float(err), float(tol)))
    assert not bad, bad
    for f in dataclasses.fields(jcl.ClusterBank):
        np.testing.assert_allclose(
            getattr(state.cluster_bank, f.name).numpy(),
            np.asarray(getattr(jnew.cluster_bank, f.name)), atol=1e-5,
            rtol=1e-5, err_msg=f.name)
    # The valid noun samples went into the bank: 3 (the fourth is padding).
    assert int(state.cluster_bank.update_count.sum()) == 40 + 3


def test_distillation_train_step_updates_both_models(dual):
    pcfg = pconfig.Config(model=PTINY, loss=pconfig.LossConfig(**DIS_LOSS),
                          optim=pconfig.OptimConfig(**dict(OPT, ema=True)))
    wd = pcrit.build_weight_dict(pcfg.loss, False, 2)
    state = _port_dual_state(dual, pcfg, cluster_bank_from_jax(_bank()))
    before = {n: m.detach().clone() for n, m in
              ((f"{w}.{n}", m) for w, t in (("s", False), ("t", True))
               for n, _, m in model_masters(state, t))}
    tema0 = {n: v.clone() for n, v in state.teacher_ema.items()}
    state, sc = make_distillation_train_step(pcfg, wd)(state,
                                                       _paired_batch())
    after = {f"{w}.{n}": m for w, t in (("s", False), ("t", True))
             for n, _, m in model_masters(state, t)}
    moved = [n for n in before if not torch.equal(before[n], after[n])]
    assert len(moved) == len(before) > 0
    assert any(not torch.equal(tema0[n], state.teacher_ema[n])
               for n in tema0)
    frozen = [p for p in state.teacher.parameters() if not p.requires_grad]
    assert frozen and all(p.grad is None for p in frozen)
    assert state.step == 1 and bool(sc["loss_is_finite"])
    # Tasks [1, 2, 1] from counts [20, 3, 17, 0]; the fourth sample is
    # padding.
    assert sc["bank_update_count"].tolist()[:4] == [22, 4, 17, 0]
    assert sc["bank_full"].dtype == torch.int32


@pytest.mark.parametrize("distill", [True, False])
def test_accumulation_equals_full_batch_without_cluster(dual, distill):
    """grad_accum_steps=2 over a batch (paired for distillation) gives the
    gradients of one pass over it, cluster off (with the cluster on, the
    bank threads through the microbatches: a known deviation). softkd,
    nsthl2 and the cluster loss are means over a microbatch's images, as
    over a rank's in the reference, so the batch gives each microbatch as
    many valid images (the padding row gets a box and becomes valid)."""
    loss = dict(DIS_LOSS, cluster=False) if distill else {}
    batches = _paired_batch()
    for b in batches.values():
        b["sample_valid"][:] = True
        b["box_valid"][3, 0] = True
        b["boxes"][3, 0] = b["boxes"][2, 0]
        b["positive_map"][3, 0] = b["positive_map"][2, 0]
    if not distill:
        batches = batches["noun"]
    cfgs, grads = [], []
    for accum in (1, 2):
        cfg = pconfig.Config(model=PTINY, loss=pconfig.LossConfig(**loss),
                             optim=pconfig.OptimConfig(
                                 **dict(OPT, grad_accum_steps=accum)))
        wd = pcrit.build_weight_dict(cfg.loss, False, 2)
        if distill:
            state = _port_dual_state(dual, cfg, None)
            x = {s: {k: _t(v) for k, v in b.items()}
                 for s, b in batches.items()}
            sc = accumulate_gradients(state, x, cfg, wd, distillation_losses)
        else:
            model = TOIST.from_state_dict(dual["student"][0], cfg.model,
                                          device="cpu")
            state = init_train_state(model, cfg, 10, 100)
            sc = accumulate_gradients(state, {k: _t(v) for k, v in
                                              batches.items()}, cfg, wd)
        cfgs.append(sc)
        grads.append([m.grad for _, m in state.masters])
    for a, b in zip(grads[1], grads[0]):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-8)
    key = "loss_softkd" if distill else "loss_bbox"
    assert float(cfgs[0][key]) > 0


def test_plain_step_with_cluster_snaps_the_span(dual):
    """``loss.cluster`` without distillation: the "something" span is
    snapped between encode and decode (no cluster loss), and the bank's
    centers move on; JAX's plain step does the same."""
    pcfg = pconfig.Config(model=PTINY, loss=pconfig.LossConfig(
        cluster=True, cluster_memory_size=16, cluster_num=2,
        kmeans_max_iters=8))
    wd = pcrit.build_weight_dict(pcfg.loss, False, 2)
    batch = {k: _t(v) for k, v in _paired_batch()["sth"].items()}
    model = TOIST.from_state_dict(dual["student"][0], pcfg.model,
                                  device="cpu").train()
    bank = cluster_bank_from_jax(_bank())
    with torch.no_grad():
        snapped, losses, new_bank = forward_losses(model, batch, pcfg, wd,
                                                   bank=bank)
        plain = forward_losses(model, batch, pcfg, wd)[0]
    assert "loss_cluster_feature" not in losses
    assert float(snapped) != float(plain)
    assert not torch.equal(new_bank.cluster_centers, bank.cluster_centers)
    assert torch.equal(new_bank.feature_bank, bank.feature_bank)

    from toist_tpu.train.step import model_forward  # noqa: F401
    cfg = Config(model=TINY, loss=LossConfig(
        cluster=True, cluster_memory_size=16, cluster_num=2,
        kmeans_max_iters=8))
    jmodel = build_model(TINY, text_vocab_size=600, tiny_text=True,
                         backbone_norm="frozen_bn")
    _, sp, sf = dual["student"]
    jb = {k: jnp.asarray(v) for k, v in _paired_batch()["sth"].items()}

    @jax.jit
    def jloss(p, b, bank):
        cache = jmodel.apply({"params": p, **sf}, b["images"],
                             b["image_mask"], b["text_ids"], b["text_mask"],
                             deterministic=True, method=jmodel.encode)
        bank, mod, _ = jcl.student_cluster(bank, cache, b, 8, 1e-4,
                                           train=False)
        cache = dict(cache, img_memory_mod=mod)
        out = jmodel.apply({"params": p, **sf}, cache, deterministic=True,
                           use_modified_memory=True, method=jmodel.decode)
        return jcrit.total_loss(jcrit.set_criterion(out, b, cfg.loss),
                                wd), bank

    want, jbank = jloss(sp, jb, _bank())
    np.testing.assert_allclose(float(snapped), float(want), rtol=1e-4)
    np.testing.assert_allclose(new_bank.cluster_centers.numpy(),
                               np.asarray(jbank.cluster_centers), atol=1e-5)


@pytest.mark.parametrize("eval_losses", [True, False])
def test_cluster_eval_step_matches_jax(dual, eval_losses):
    cfg = Config(model=TINY, loss=LossConfig(**DIS_LOSS))
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, compute_eval_losses=eval_losses))
    wd = jcrit.build_weight_dict(cfg.loss, False, 2)
    batch = _paired_batch()["sth"]
    jmodel = build_model(TINY, text_vocab_size=600, tiny_text=True,
                         backbone_norm="frozen_bn")
    sd, sp, sf = dual["student"]
    want = jdistill.make_cluster_eval_step(jmodel, cfg, wd, sf)(
        sp, _bank(), {k: jnp.asarray(v) for k, v in batch.items()})
    pcfg = pconfig.Config(model=PTINY, loss=pconfig.LossConfig(**DIS_LOSS),
                          run=pconfig.RunConfig(
                              compute_eval_losses=eval_losses))
    model = TOIST.from_state_dict(sd, pcfg.model, device="cpu")
    bank = cluster_bank_from_jax(_bank())
    centers = bank.cluster_centers.clone()
    got = make_cluster_eval_step(model, pcfg, wd)(bank, batch)
    assert torch.equal(bank.cluster_centers, centers)     # read only
    np.testing.assert_allclose(got["post"]["scores"].numpy(),
                               np.asarray(want["post"]["scores"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["post"]["boxes"].numpy(),
                               np.asarray(want["post"]["boxes"]), atol=1e-3)
    assert set(got["scalars"]) == set(want["scalars"])
    for k, v in want["scalars"].items():
        np.testing.assert_allclose(float(got["scalars"][k]), float(v),
                                   rtol=1e-4, err_msg=k)


def _fixture_pairs(root, n=5):
    """``n`` paired batches of 2 from the port's own fixture pipeline, as
    ``main`` builds them for distillation (noun and sth captions of the
    same images), on the 128x128 canvas of the fixture ablation."""
    from toist_tpu_torch.data.batcher import BatchIterator, BucketSpec
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.data.fixtures import generate_fixture

    generate_fixture(root, num_tasks=2, imgs_per_split=n, img_size=(96, 128),
                     seed=11)
    cfg = pconfig.Config.from_sources(None, {"data": {
        "coco_path": root, "refexp_ann_path": f"{root}/annotations",
        "tasks": [1, 2], "image_buckets": [[128, 128]], "max_text_len": 48,
        "max_boxes": 8, "train_scales": [96], "max_size": 128}})
    tok = build_tokenizer(cfg)
    assert tok.vocab_size <= 600                    # TINY's embeddings
    sets = [build_task_dataset(cfg.data, t, "train", tok, distillation=True)
            for t in (1, 2)]
    spec = BucketSpec(buckets=[[128, 128]], max_text_len=48, max_boxes=8,
                      num_logit_cols=cfg.data.num_logit_cols)
    it = BatchIterator(sets, spec, batch_size=2, seed=1, paired=True,
                       num_workers=1)
    batches = list(it.epoch(0))
    assert len(batches) == n
    return batches


def test_distillation_steps_track_jax(dual, tmp_path):
    """Five distillation steps in a row, port vs JAX, from the same weights
    (``synth_reference_state_dict``), the same five paired fixture batches
    and the same bank, f32 at dropout 0, each side with its own AdamW at
    the config's defaults (the reference's learning rates and clip, over
    both models): after every step the total and per-term
    losses within 1e-4 relative, both models' parameters within 2e-3 of
    each tensor's max abs, and the bank (counts and flags exactly). One
    step cannot show a fault that only compounds, such as a moment or a
    bank update that drifts.

    The teacher's no-object logit bias is raised by 4, the prior a trained
    detector learns: between two random models the softkd KL is about
    2e-5, a difference of near-equal probabilities in which f32 rounding
    alone moves the value by 1e-3 relative."""
    cfg = Config(model=TINY, loss=LossConfig(**DIS_LOSS),
                 optim=OptimConfig(ema=False))
    wd = jcrit.build_weight_dict(cfg.loss, False, 2)
    batches = _fixture_pairs(str(tmp_path / "fixture"))
    jmodel = build_model(TINY, text_vocab_size=600, tiny_text=True,
                         backbone_norm="frozen_bn")
    tsd = synth_reference_state_dict(seed=7, **_TINY_SD)
    tsd["class_embed.bias"][-1] += 4.0
    tp, tf = convert_torch_state_dict(tsd, d_model=64, enc_layers=2,
                                      dec_layers=2, stage_sizes=(1, 1, 1, 1))
    dual = dict(dual, teacher=(jax_params_to_state_dict(tp, tf), tp, tf))
    _, sp, sf = dual["student"]
    tx = joptim.make_optimizer(cfg.optim, 10, 100)
    jstate = JTrainState(params=sp, opt_state=tx.init({"student": sp,
                                                       "teacher": tp}),
                         ema_params=None, step=jnp.int32(0),
                         teacher_params=tp, teacher_ema_params=None,
                         cluster_bank=_bank())
    jstep = jdistill.make_distillation_train_step(jmodel, cfg, wd, tx, sf, tf)

    pcfg = pconfig.Config(model=PTINY, loss=pconfig.LossConfig(**DIS_LOSS),
                          optim=pconfig.OptimConfig(ema=False))
    state = _port_dual_state(dual, pcfg, cluster_bank_from_jax(_bank()))
    pstep = make_distillation_train_step(pcfg, wd)
    terms = ("loss", "loss_softkd", "loss_nsthl2", "loss_cluster_feature",
             "noun_loss_ce", "sth_loss_ce", "sth_loss_bbox")
    for i, batch in enumerate(batches):
        jstate, jsc = jstep(jstate, {s: {k: jnp.asarray(v) for k, v in
                                         b.items()}
                                     for s, b in batch.items()},
                            jax.random.PRNGKey(i))
        state, sc = pstep(state, batch)
        for k in terms:
            np.testing.assert_allclose(float(sc[k]), float(jsc[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
        bad = []
        for who, teacher, params, frozen in (
                ("student", False, jstate.params, sf),
                ("teacher", True, jstate.teacher_params, tf)):
            want = jax_params_to_state_dict(params, frozen)
            for n, _, m in model_masters(state, teacher):
                w = want[n].numpy()
                err = np.abs(m.detach().numpy() - w).max()
                if not err <= 2e-3 * max(np.abs(w).max(), 1e-8):
                    bad.append((i, who, n, float(err)))
        assert not bad, bad
        bank, jbank = state.cluster_bank, jstate.cluster_bank
        for f in ("update_count", "full"):
            np.testing.assert_array_equal(getattr(bank, f).numpy(),
                                          np.asarray(getattr(jbank, f)))
        for f in ("feature_bank", "cluster_centers"):
            w = np.asarray(getattr(jbank, f))
            np.testing.assert_allclose(getattr(bank, f).numpy(), w,
                                       atol=2e-3 * np.abs(w).max(),
                                       err_msg=f"step {i} {f}")
    assert state.step == 5 and int(jstate.step) == 5
