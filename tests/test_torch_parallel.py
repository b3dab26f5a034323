"""Data parallelism of the port on two CPU ranks (gloo) against the JAX
package's single-device steps on the whole batch.

The two ranks (``tests/torch_ranks.py``, case "steps") start first, with
torchrun's environment, and the JAX references are computed while they
run. The global batch is the TINY test batch of 4 rows, whose last row is
padding: rank 0 holds rows 0-1 and rank 1 rows 2-3, so the padded row sits
on rank 1 only. The model is 1 + 1 layers, hidden 64, 8 queries, f32,
dropout 0.

Tolerances: loss and grad norm within 1e-4 relative of JAX's; the f32
masters after one AdamW step within 2.5 * lr of JAX's (a first AdamW step
is about lr * sign(g): ``tests/test_parallel.py``); across ranks, and
ZeRO-1 on against off, everything bit for bit; the bank after a
distillation step bit for bit across ranks and within 1e-5 of JAX's (as
``tests/test_torch_distill.py`` holds the one-process bank).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_distill import (DIS_LOSS, _bank, _grad_tracker,
                                      _paired_batch)
from tests.test_torch_train import _tiny_batch
from tests.torch_ranks import Ranks, rows_iterator
from toist_tpu.config import Config, LossConfig, ModelConfig, OptimConfig
from toist_tpu.data import batcher as jbatcher
from toist_tpu.models.toist import build_model
from toist_tpu.train import criterion as jcrit
from toist_tpu.train import distill as jdistill
from toist_tpu.train import optim as joptim
from toist_tpu.train.state import TrainState as JTrainState
from toist_tpu.train.step import accumulate_gradients as jaccumulate
from toist_tpu.train.step import model_forward
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.ops.flash_attention import random_keep
from toist_tpu_torch.parallel import data as dp
from toist_tpu_torch.train import criterion as pcrit
from toist_tpu_torch.train.state import init_train_state
from toist_tpu_torch.train.step import dropout_generator, make_train_step
from toist_tpu_torch.utils import dist
from toist_tpu_torch.utils.convert import jax_params_to_state_dict

TINY1 = ModelConfig(backbone="resnet18-test", hidden_dim=64, nheads=4,
                    dim_feedforward=128, enc_layers=1, dec_layers=1,
                    num_queries=8, compute_dtype="float32",
                    contrastive_align_loss=True, contrastive_hdim=16,
                    text_hidden=64, text_layers=1, text_heads=4,
                    text_intermediate=128, dropout=0.0, resizer_dropout=0.0,
                    fused_attention="off")
PTINY1 = pconfig.ModelConfig(**dataclasses.asdict(TINY1))
SD_KW = dict(stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=64,
             dim_feedforward=128, text_layers=1, text_hidden=64,
             text_intermediate=128, num_queries=8, vocab_size=600,
             contrastive_hdim=16, with_masks=False)
LR = 1e-3
OPT = dict(lr=LR, lr_backbone=LR, text_encoder_lr=LR, ema=False,
           schedule="step", lr_drop=1000)


def _weights(seed):
    sd = synth_reference_state_dict(seed=seed, **SD_KW)
    params, frozen = convert_torch_state_dict(
        sd, d_model=64, enc_layers=1, dec_layers=1, stage_sizes=(1, 1, 1, 1))
    port = {k: v.numpy() for k, v in
            jax_params_to_state_dict(params, frozen).items()}
    return port, params, frozen


def _jax_plain(params, frozen, batch):
    """JAX's one step on the whole batch (value_and_grad, its optimizer:
    clip then AdamW), and its accumulation of 2 microbatches."""
    cfg = Config(model=TINY1, optim=OptimConfig(**OPT))
    wd = jcrit.build_weight_dict(cfg.loss, False, 1)
    jmodel = build_model(TINY1, text_vocab_size=600,
                         backbone_norm="frozen_bn")

    def loss(p, b):
        p = joptim.stop_frozen_gradients(p)
        out, _ = model_forward(jmodel, p, frozen, b)
        losses = jcrit.set_criterion(out, b, cfg.loss)
        return jcrit.total_loss(losses, wd), {
            k: v for k, v in losses.items() if not k.startswith("_")}

    vg = jax.value_and_grad(loss, has_aux=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, scalars), grads = jax.jit(vg)(params, jb)
    tx = joptim.make_optimizer(cfg.optim, 10, 100)
    upd, _ = tx.update(grads, tx.init(params), params)
    new = jax_params_to_state_dict(optax.apply_updates(params, upd), frozen)

    def vg_fn(bank, b, rng):
        (lv, sc), g = vg(params, b)
        return (lv, (sc, bank)), g

    (acc_total, (acc_scalars, _)), acc_grads = jax.jit(
        lambda b: jaccumulate(vg_fn, None, b, jax.random.PRNGKey(0), 2))(jb)
    return {"loss": float(total), "grad_norm": float(optax.global_norm(grads)),
            "scalars": {k: float(v) for k, v in scalars.items()},
            "masters": {k: v.numpy() for k, v in new.items()},
            "accum": {"loss": float(acc_total),
                      "grad_norm": float(optax.global_norm(acc_grads))}}


def _jax_distill(student, teacher, pairs):
    """JAX's distillation step on the whole paired batch: its bank."""
    cfg = Config(model=TINY1, loss=LossConfig(**DIS_LOSS),
                 optim=OptimConfig(**OPT))
    wd = jcrit.build_weight_dict(cfg.loss, False, 1)
    jmodel = build_model(TINY1, text_vocab_size=600,
                         backbone_norm="frozen_bn")
    (_, sp, sf), (_, tp, tf) = student, teacher
    tx = _grad_tracker()
    state = JTrainState(params=sp, opt_state=tx.init({"student": sp,
                                                      "teacher": tp}),
                        ema_params=None, step=jnp.int32(0), teacher_params=tp,
                        teacher_ema_params=None, cluster_bank=_bank())
    step = jdistill.make_distillation_train_step(jmodel, cfg, wd, tx, sf, tf)
    new, scalars = step(state, {s: {k: jnp.asarray(v) for k, v in b.items()}
                                for s, b in pairs.items()},
                        jax.random.PRNGKey(0))
    return {"bank": {f.name: np.asarray(getattr(new.cluster_bank, f.name))
                     for f in dataclasses.fields(new.cluster_bank)},
            "scalars": {k: float(v) for k, v in scalars.items()
                        if np.ndim(v) == 0}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    sd, params, frozen = _weights(5)
    teacher = _weights(7)
    batch, pairs = _tiny_batch(), _paired_batch()
    cfg = pconfig.Config(model=PTINY1, optim=pconfig.OptimConfig(**OPT))
    dis_cfg = pconfig.Config(model=PTINY1,
                             loss=pconfig.LossConfig(**DIS_LOSS),
                             optim=pconfig.OptimConfig(**OPT))
    inputs = {
        "cfg": cfg, "wd": pcrit.build_weight_dict(cfg.loss, False, 1),
        "sd": sd, "batch": batch, "pairs": pairs, "dis_cfg": dis_cfg,
        "dis_wd": pcrit.build_weight_dict(dis_cfg.loss, False, 1),
        "dis_sd": sd, "dis_teacher_sd": teacher[0],
        "bank": {k: np.asarray(v) for k, v in _bank().__dict__.items()}}
    ranks = Ranks("steps", tmp_path_factory.mktemp("ranks"), inputs,
                  timeout=600)
    ref = _jax_plain(params, frozen, batch)
    ref["distill"] = _jax_distill((sd, params, frozen), teacher, pairs)
    return types.SimpleNamespace(ranks=ranks.wait(), ref=ref, inputs=inputs)


def test_two_rank_step_matches_jax(world):
    """2 ranks x 2 rows, ZeRO-1 on, against JAX's step on the 4 rows and
    the port's one-process step on the 4."""
    r0, r1 = (r["step"] for r in world.ranks)
    assert r0["zero1"] and r1["zero1"]
    for k in r0["scalars"]:
        assert r0["scalars"][k] == r1["scalars"][k], k
        assert set(r0["masters"]) == set(r1["masters"])
    for n in r0["masters"]:
        np.testing.assert_array_equal(r1["masters"][n], r0["masters"][n])
    ref = world.ref
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(r0["scalars"][k], ref[k], rtol=1e-4,
                                   err_msg=k)
    for k, v in ref["scalars"].items():
        np.testing.assert_allclose(r0["scalars"][k], v, rtol=1e-4,
                                   err_msg=k)
    for n, m in r0["masters"].items():
        np.testing.assert_allclose(m, ref["masters"][n], atol=2.5 * LR,
                                   rtol=0, err_msg=n)

    inp = world.inputs
    state = init_train_state(
        TOIST.from_state_dict({k: torch.from_numpy(v) for k, v in
                               inp["sd"].items()}, PTINY1, device="cpu"),
        inp["cfg"], 10, 100)
    _, one = make_train_step(inp["cfg"], inp["wd"])(state, inp["batch"])
    np.testing.assert_allclose(r0["scalars"]["loss"], float(one["loss"]),
                               rtol=1e-6)


def test_two_rank_accumulation_matches_jax(world):
    """2 microbatches x 2 ranks (one row each) against JAX's accumulation
    of 2 microbatches on the 4 rows."""
    a0, a1 = (r["accum"] for r in world.ranks)
    assert a0 == a1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(a0[k], world.ref["accum"][k], rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_zero1_equals_replicated(world, moments):
    """Two steps with ZeRO-1 on and off give the same masters and, once
    gathered (``parallel.data.zero1_state_dict``, what a checkpoint
    saves), the same optimizer state; each rank keeps about half of the
    moments' bytes."""
    on = [r["zero"][moments, True] for r in world.ranks]
    off = [r["zero"][moments, False] for r in world.ranks]
    for z, o in zip(on, off):
        for n in o["masters"]:
            np.testing.assert_array_equal(z["masters"][n], o["masters"][n])
    for r in on:                 # every rank gathers the whole state
        assert r["opt"]["param_groups"] == off[0]["opt"]["param_groups"]
    zopt, opt = on[0]["opt"]["state"], off[0]["opt"]["state"]
    assert set(zopt) == set(opt) and len(opt) > 0
    assert on[1]["opt"]["state"].keys() == opt.keys()
    for i in opt:
        assert set(zopt[i]) == set(opt[i]) == {"step", "exp_avg",
                                               "exp_avg_sq"}
        for k, (dtype, v) in opt[i].items():
            assert zopt[i][k][0] == dtype
            np.testing.assert_array_equal(zopt[i][k][1], v, err_msg=(i, k))
        assert (opt[i]["exp_avg"][0], opt[i]["exp_avg_sq"][0]) == (
            f"torch.{moments}", "torch.float32")
    total = off[0]["bytes"]
    assert off[1]["bytes"] == total
    assert on[0]["bytes"] + on[1]["bytes"] == total
    for z in on:
        assert 0.4 < z["bytes"] / total < 0.6, (z["bytes"], total)


def test_cluster_bank_identical_across_ranks_and_equal_to_jax(world):
    """After one distillation step at 2 ranks (2 pairs each, the padded
    pair on rank 1) the bank is the same on both ranks, bit for bit, and
    JAX's single-device bank for the 4 pairs."""
    b0, b1 = (r["bank"] for r in world.ranks)
    want = world.ref["distill"]["bank"]
    assert set(b0) == set(want)
    for k in b0:
        np.testing.assert_array_equal(b1[k], b0[k], err_msg=k)
        np.testing.assert_allclose(b0[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    assert int(b0["update_count"].sum()) == 40 + 3      # 3 valid nouns
    s0 = world.ranks[0]["dis_scalars"]
    np.testing.assert_allclose(s0["loss"],
                               world.ref["distill"]["scalars"]["loss"],
                               rtol=1e-4)


def test_dropout_streams_differ_per_rank(world):
    """At rate 0.1 (q = 26 of 256) the ranks' dropout masks of their local
    sample 0 differ; rank 0's is the one-process mask."""
    m0, m1 = (r["dropout_sample0"] for r in world.ranks)
    assert m0.shape == m1.shape and (m0 != m1).any()
    seed = world.inputs["cfg"].run.seed
    one = random_keep((2, 4, 24, 24), 26,
                      dropout_generator(torch.device("cpu"), seed, 0))[0]
    np.testing.assert_array_equal(m0, one.numpy())


def test_uneven_shards_end_together(world):
    """5 samples at batch 2: rank 0's shard yields 2 batches, rank 1's 1;
    both ranks run 2 steps (rank 1's second all-invalid) and end with the
    same masters."""
    u0, u1 = (r["uneven"] for r in world.ranks)
    assert (u0["batches"], u1["batches"]) == (2, 1)
    assert u0["steps"] == u1["steps"] == 2
    for n in u0["masters"]:
        np.testing.assert_array_equal(u1["masters"][n], u0["masters"][n])


def test_jax_shards_yield_uneven_batch_counts():
    """The JAX package's BatchIterator gives the same shards 2 and 1
    batches, and its train_one_epoch runs one global step per batch with
    no agreement on the count (``toist_tpu/train/engine.py:20-33``): rank
    0's second step would wait for a rank that has left the epoch."""
    batch = _tiny_batch()
    counts = [sum(1 for _ in rows_iterator(
        batch, 5, 2, r, 2, jbatcher.BatchIterator,
        jbatcher.BucketSpec).epoch(0)) for r in range(2)]
    assert counts == [2, 1]
    assert len(rows_iterator(batch, 5, 2, 0, 2, jbatcher.BatchIterator,
                             jbatcher.BucketSpec)) == 1


def test_make_mesh_in_one_process():
    """One process: ('data',) and ('data', 'model') grids of (1, 1); a
    shape that needs 2 devices raises ValueError on either axis."""
    for shape, axes in (((-1,), ("data",)), ((1,), ("data",)),
                        ((-1, 1), ("data", "model")),
                        ((1, 1), ("data", "model"))):
        g = dp.make_mesh(shape, axes)
        assert (g.dp, g.tp, g.data_index, g.model_index) == (1, 1, 0, 0)
        assert g == dist.grid()
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        dp.make_mesh((2,))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        dp.make_mesh((-1, 2), ("data", "model"))
