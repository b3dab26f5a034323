"""The port's k-means and cluster bank (toist_tpu_torch.ops.kmeans,
toist_tpu_torch.train.cluster) against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both; a bank crosses
from JAX to the port by ``utils/convert.cluster_bank_from_jax``.
Tolerances: k-means centers 1e-5 (f32 sums in another order), labels and
choices equal; the bank updates bit for bit (they move rows, and compare
and count); pooled features and snapped memories 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toist_tpu.ops import kmeans as jkm
from toist_tpu.train import cluster as jcl
from toist_tpu_torch.ops import kmeans as pkm
from toist_tpu_torch.train import cluster as pcl
from toist_tpu_torch.utils.convert import cluster_bank_from_jax

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _kmeans_case(case, seed=0):
    """(x [N, D], init [K, D], max_iters) of one k-means case."""
    rng = np.random.default_rng(seed)
    if case == "separated":
        x = np.concatenate([rng.normal(0, 0.1, (50, 8)),
                            rng.normal(5, 0.1, (50, 8)),
                            rng.normal(-5, 0.1, (30, 8))])
        init = x[[0, 60, 120]]
    elif case == "random_warm_start":
        x = rng.normal(size=(64, 16))
        init = rng.normal(size=(3, 16))
    else:                      # iteration_capped: stops on max_iters
        x = rng.normal(size=(200, 4))
        init = x[:5] + 3.0
    return (x.astype(np.float32), init.astype(np.float32),
            2 if case == "iteration_capped" else 32)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
@pytest.mark.parametrize("case", ["separated", "random_warm_start",
                                  "iteration_capped"])
def test_kmeans_matches_jax(case, distance):
    x, init, iters = _kmeans_case(case)
    jl, jc = jax.jit(lambda a, b: jkm.kmeans(a, b, iters, 1e-4, distance))(
        jnp.asarray(x), jnp.asarray(init))
    pl, pc = pkm.kmeans(_t(x), _t(init), iters, 1e-4, distance)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    q = np.random.default_rng(1).normal(size=(17, x.shape[1])) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        pkm.kmeans_predict(_t(q), pc, distance).numpy(),
        np.asarray(jkm.kmeans_predict(jnp.asarray(q), jc, distance)))
    if case == "iteration_capped":
        # Two iterations are not convergence: three would move the centers.
        more = pkm.kmeans(_t(x), _t(init), 3, 1e-4, distance)[1]
        assert (more - pc).abs().max() > 1e-4


def test_kmeans_argmin_takes_the_first_of_equal_distances():
    x = np.array([[0.0, 0.0], [2.0, 0.0], [1.0, 0.0]], np.float32)
    c = np.array([[0.0, 0.0], [2.0, 0.0]], np.float32)
    # The third point is equally far from both centers.
    got = pkm.kmeans_predict(_t(x), _t(c)).tolist()
    assert got == np.asarray(jkm.kmeans_predict(jnp.asarray(x),
                                                jnp.asarray(c))).tolist()
    assert got == [0, 1, 0]


def test_init_centers_from_bank_matches_jax():
    bank = np.random.default_rng(2).normal(size=(10, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        pkm.init_centers_from_bank(_t(bank), 3).numpy(),
        np.asarray(jkm.init_centers_from_bank(jnp.asarray(bank), 3)))


def _jax_bank(T=3, M=4, K=2, D=6, seed=0, **fields):
    bank = jcl.init_bank(T, M, K, D, seed=seed)
    return bank.replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def _assert_banks_equal(got, want, atol=0.0):
    for f in dataclasses.fields(pcl.ClusterBank):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want,
                                                                f.name))
        assert g.dtype == w.dtype, f.name
        if atol:
            np.testing.assert_allclose(g, w, atol=atol, rtol=atol,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_init_bank_shapes_and_dtypes():
    g = torch.Generator().manual_seed(0)
    bank = pcl.init_bank(14, 16, 3, 8, g)
    want = jcl.init_bank(14, 16, 3, 8)
    for f in dataclasses.fields(pcl.ClusterBank):
        a, b = getattr(bank, f.name), np.asarray(getattr(want, f.name))
        assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype
    again = pcl.init_bank(14, 16, 3, 8, torch.Generator().manual_seed(0))
    assert torch.equal(bank.feature_bank, again.feature_bank)
    assert not bank.full.any() and not bank.update_count.any()


@pytest.mark.parametrize("mode", ["fifo_fill", "full_flag_quirk",
                                  "replace_nearest", "fifo_memory"])
def test_update_bank_matches_jax(mode):
    rng = np.random.default_rng(3)
    T, M, D = 3, 4, 6
    bank = _jax_bank(T, M, 2, D)
    rounds = 1 if mode == "fifo_fill" else 4
    if mode in ("replace_nearest", "fifo_memory"):
        bank = bank.replace(full=jnp.asarray([True, False, True]),
                            update_count=jnp.asarray([5, 1, 9], jnp.int32))
    fifo = mode == "fifo_memory"
    pbank = cluster_bank_from_jax(bank)
    for r in range(rounds):
        feats = rng.normal(size=(3, D)).astype(np.float32)
        # -1: a padding row's task (task id 0), never valid.
        tasks = np.array([1, 1, 0] if mode != "replace_nearest"
                         else [0, 2, -1], np.int32)
        valid = np.array([True, r % 2 == 0, mode != "replace_nearest"])
        bank = jax.jit(lambda b, f, t, v: jcl.update_bank(b, f, t, v, fifo))(
            bank, jnp.asarray(feats), jnp.asarray(tasks), jnp.asarray(valid))
        pbank = pcl.update_bank(pbank, _t(feats), _t(tasks), _t(valid), fifo)
        _assert_banks_equal(pbank, bank)
    if mode == "full_flag_quirk":
        # 10 inserts into task 1 of 4 rows: full only once the count passed
        # memory_size before an insert.
        assert int(pbank.update_count[1]) == 6 and bool(pbank.full[1])


def test_pool_span_features_matches_jax():
    rng = np.random.default_rng(4)
    tm = rng.normal(size=(3, 9, 8)).astype(np.float32)
    spans = np.array([[[1, 2], [-1, -1], [4, 6]],
                      [[0, 0], [3, 5], [3, 5]],
                      [[-1, -1], [-1, -1], [-1, -1]]], np.int32)
    bv = np.array([[True, True, True], [True, False, True],
                   [True, True, True]])
    want = jcl.pool_span_features(*map(jnp.asarray, (tm, spans, bv)))
    got = pcl.pool_span_features(*map(_t, (tm, spans, bv)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].tolist() == [True, True, False]


def test_snap_text_memory_matches_jax():
    rng = np.random.default_rng(5)
    mem = rng.normal(size=(2, 7, 4)).astype(np.float32)
    union = np.zeros((2, 3), bool)
    union[0, 1:] = True
    union[1, 0] = True
    centers = rng.normal(size=(2, 4)).astype(np.float32)
    valid = np.array([True, False])
    want = jcl.snap_text_memory(jnp.asarray(mem), 3, jnp.asarray(union),
                                jnp.asarray(centers), jnp.asarray(valid))
    got = pcl.snap_text_memory(_t(mem), 3, _t(union), _t(centers),
                               _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bf = pcl.snap_text_memory(_t(mem).bfloat16(), 3, _t(union), _t(centers),
                              _t(valid))
    assert bf.dtype == torch.bfloat16


def _cluster_inputs(seed=6, B=4, S_img=5, T=8, D=16, N=3):
    """A joint memory, spans, boxes and tasks; sample 2 has no boxes (its
    caption span still snaps the student), sample 3 is batch padding (task
    id 0, as the batcher pads)."""
    rng = np.random.default_rng(seed)
    tm = rng.normal(size=(B, T, D)).astype(np.float32)
    mem = np.concatenate([rng.normal(size=(B, S_img, D)).astype(np.float32),
                          tm], 1)
    spans = np.full((B, N, 2), -1, np.int32)
    spans[0, :2] = [2, 3]
    spans[1, 0] = [4, 4]
    spans[3, 0] = [1, 2]
    bv = np.zeros((B, N), bool)
    bv[0, :2] = bv[1, 0] = bv[3, 0] = True
    batch = {"noun_token_spans": spans, "box_valid": bv,
             "caption_noun_span": np.array([[2, 3], [4, 4], [1, 5], [2, 2]],
                                           np.int32),
             "sample_valid": np.array([True, True, True, False]),
             "task_id": np.array([1, 3, 1, 0], np.int32)}
    return {"text_memory": tm, "img_memory": mem}, batch


def _bank_np(T=14, M=8, K=3, D=16, seed=7):
    rng = np.random.default_rng(seed)
    return jcl.ClusterBank(
        feature_bank=jnp.asarray(rng.normal(size=(T, M, D)), jnp.float32),
        cluster_centers=jnp.asarray(rng.normal(size=(T, K, D)), jnp.float32),
        update_count=jnp.asarray(rng.integers(0, 12, T), jnp.int32),
        full=jnp.asarray(rng.random(T) < 0.5))


def _check_snap(got, want):
    pbank, pmod, paux = got
    jbank, jmod, jaux = want
    _assert_banks_equal(pbank, jbank, atol=TOL)
    np.testing.assert_allclose(pmod.detach().numpy(), np.asarray(jmod),
                               atol=TOL)
    np.testing.assert_array_equal(paux["choices"].numpy(),
                                  np.asarray(jaux["choices"]))
    np.testing.assert_array_equal(paux["valid"].numpy(),
                                  np.asarray(jaux["valid"]))


def test_teacher_update_and_snap_matches_jax():
    cache, batch = _cluster_inputs()
    jbank = _bank_np()
    want = jax.jit(lambda b, c, x: jcl.teacher_update_and_snap(
        b, c, x, 8, 1e-4))(jbank, {k: jnp.asarray(v) for k, v in
                                   cache.items()},
                           {k: jnp.asarray(v) for k, v in batch.items()})
    got = pcl.teacher_update_and_snap(
        cluster_bank_from_jax(jbank), {k: _t(v) for k, v in cache.items()},
        {k: _t(v) for k, v in batch.items()}, 8, 1e-4)
    _check_snap(got, want)
    np.testing.assert_allclose(got[2]["pooled"].numpy(),
                               np.asarray(want[2]["pooled"]), atol=TOL)
    assert got[0].update_count.sum() - int(jbank.update_count.sum()) == 2


@pytest.mark.parametrize("train", [True, False])
def test_student_cluster_matches_jax(train):
    cache, batch = _cluster_inputs(seed=8)
    jbank = _bank_np(seed=9)
    want = jax.jit(lambda b, c, x: jcl.student_cluster(
        b, c, x, 8, 1e-4, train=train))(
            jbank, {k: jnp.asarray(v) for k, v in cache.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})
    pcache = {k: _t(v).requires_grad_() for k, v in cache.items()}
    got = pcl.student_cluster(cluster_bank_from_jax(jbank), pcache,
                              {k: _t(v) for k, v in batch.items()}, 8, 1e-4,
                              train=train)
    _check_snap(got, want)
    assert got[2]["valid"].tolist() == [True, True, True, False]
    if train:
        for k in ("loss_cluster_feature", "loss_cluster_choice"):
            np.testing.assert_allclose(float(got[2][k]),
                                       float(want[2][k]), rtol=TOL)
        # Its gradient reaches the text memory through the pooled feature
        # only: the bank and the centers are constants.
        got[2]["loss_cluster_feature"].backward()
        g = pcache["text_memory"].grad
        jg = jax.grad(lambda tm: jcl.student_cluster(
            jbank, {"text_memory": tm,
                    "img_memory": jnp.asarray(cache["img_memory"])},
            {k: jnp.asarray(v) for k, v in batch.items()}, 8, 1e-4,
            train=True)[2]["loss_cluster_feature"])(
                jnp.asarray(cache["text_memory"]))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=TOL)
        assert not got[0].feature_bank.requires_grad
