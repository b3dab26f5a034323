"""The port's LSA solver (toist_tpu_torch.ops.lsa) against the JAX package.

On CPU tensors ``solve_lsa_batch`` is its plain version, which runs the JAX
solver's algorithm (``toist_tpu/ops/lsa.py``) in the same f32 order, so the
assignments must equal ``solve_lsa`` exactly, ties and non-finite entries
included. scipy, the C++ ``lsa_solve`` of ``toist_tpu/native`` and the
Pallas kernel (interpret mode) are further oracles: equal assignments on
continuous costs, equal total cost (rtol 1e-5, as tests/test_lsa.py) where
ties allow several optima. The cases are those of tests/test_lsa.py and
tests/test_lsa_pallas.py, plus problems shaped like distillation's softkd
re-pairing ([B, 100, 100], n_fp 90-99, 1e6 columns, near-ties). The step
counter ``lsa_scan_steps`` is held to hand-counted problems.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from toist_tpu import native
from toist_tpu.ops.lsa import solve_lsa, solve_lsa_batch as jax_batch
from toist_tpu.ops.lsa_pallas import solve_lsa_batch_pallas
from toist_tpu_torch.ops.lsa import (lsa_scan_steps, softkd_like_costs,
                                     solve_lsa_batch)


def _port(cost, n):
    return solve_lsa_batch(torch.from_numpy(np.asarray(cost, np.float32)),
                           torch.from_numpy(np.asarray(n, np.int32))).numpy()


def _jax(cost, n):
    return np.asarray(jax_batch(jnp.asarray(cost, jnp.float32),
                                jnp.asarray(n, jnp.int32)))


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (5, 5), (20, 100),
                                   (25, 100), (100, 100)])
def test_random_matrices_equal_jax_and_scipy(shape):
    rng = np.random.default_rng(42)
    cost = rng.normal(size=(8,) + shape).astype(np.float32)
    n = np.full(8, shape[0], np.int32)
    got = _port(cost, n)
    np.testing.assert_array_equal(got, _jax(cost, n))
    for b in range(8):
        _, cols = linear_sum_assignment(cost[b])
        np.testing.assert_array_equal(got[b], cols)


def test_continuous_costs_equal_scipy_exactly():
    rng = np.random.default_rng(7)
    cost = rng.uniform(size=(20, 15, 60)).astype(np.float32)
    got = _port(cost, np.full(20, 15))
    for b in range(20):
        np.testing.assert_array_equal(got[b],
                                      linear_sum_assignment(cost[b])[1])


@pytest.mark.parametrize("kind", ["all_equal", "blocks", "rounded"])
def test_ties_equal_jax_and_optimal(kind):
    rng = np.random.default_rng(3)
    if kind == "all_equal":
        cost = np.ones((2, 8, 12), np.float32)
    elif kind == "blocks":
        cost = np.broadcast_to(np.repeat(np.arange(4, dtype=np.float32), 3),
                               (2, 6, 12)).copy()
    else:
        cost = np.round(rng.uniform(size=(6, 12, 50)) * 3).astype(np.float32)
    n = np.full(cost.shape[0], cost.shape[1], np.int32)
    got = _port(cost, n)
    np.testing.assert_array_equal(got, _jax(cost, n))
    for b in range(cost.shape[0]):
        assert len(set(got[b].tolist())) == cost.shape[1]
        rows, cols = linear_sum_assignment(cost[b])
        np.testing.assert_allclose(cost[b, rows, got[b]].sum(),
                                   cost[b, rows, cols].sum(), rtol=1e-5)


def test_adversarial_values():
    rng = np.random.default_rng(3)
    cost = rng.choice([0.0, 1e6, -1e6, 1.0], size=(4, 10, 40)) \
        .astype(np.float32)
    n = np.full(4, 10, np.int32)
    got = _port(cost, n)
    np.testing.assert_array_equal(got, _jax(cost, n))
    for b in range(4):
        rows, cols = linear_sum_assignment(cost[b])
        np.testing.assert_allclose(cost[b, rows, got[b]].sum(),
                                   cost[b, rows, cols].sum(), rtol=1e-5)


@pytest.mark.parametrize("n", [0, 1, 7, 25])
def test_padded_rows(n):
    rng = np.random.default_rng(5)
    cost = rng.normal(size=(1, 25, 100)).astype(np.float32)
    got = _port(cost, [n])[0]
    assert (got[n:] == -1).all()
    np.testing.assert_array_equal(
        got, np.asarray(solve_lsa(jnp.asarray(cost[0]), jnp.int32(n))))
    if n:
        np.testing.assert_array_equal(got[:n],
                                      linear_sum_assignment(cost[0, :n])[1])


def test_non_finite_costs_terminate_and_equal_jax():
    rng = np.random.default_rng(17)
    cost = rng.normal(size=(25, 5, 9)).astype(np.float32)
    for b, bad in enumerate([np.nan, np.inf, -np.inf] * 8):
        cost[b][rng.random((5, 9)) < 0.3] = bad
    cost[24] = np.nan                               # every entry non-finite
    n = np.full(25, 5, np.int32)
    got = _port(cost, n)
    np.testing.assert_array_equal(got, _jax(cost, n))
    assert len(set(got[24].tolist())) == 5 and (got[24] >= 0).all()
    for b in range(24):
        m = cost[b]
        finite = np.isfinite(m)
        san = np.where(finite, m, (np.abs(m[finite]).max() + 1.0) * 6)
        rows, cols = linear_sum_assignment(san)
        np.testing.assert_allclose(san[rows, got[b]].sum(),
                                   san[rows, cols].sum(), rtol=1e-5)


def test_matches_native_cpp_solver():
    lib = native.load()
    rng = np.random.default_rng(0)
    for shape in [(5, 9), (25, 100), (60, 60)]:
        cost = rng.normal(size=(3,) + shape).astype(np.float32)
        got = _port(cost, np.full(3, shape[0]))
        for b in range(3):
            c64 = cost[b].astype(np.float64)
            out = np.empty(shape[0], np.int32)
            assert lib.lsa_solve(
                c64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                shape[0], shape[1],
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) == 0
            np.testing.assert_array_equal(got[b], out)


def test_matches_pallas_kernel():
    rng = np.random.default_rng(1)
    cost = rng.uniform(size=(5, 20, 100)).astype(np.float32)
    n = np.array([20, 5, 0, 13, 20], np.int32)
    want = np.asarray(solve_lsa_batch_pallas(jnp.asarray(cost),
                                             jnp.asarray(n), interpret=True))
    np.testing.assert_array_equal(_port(cost, n), want)


def test_wrapper_checks_and_counts():
    with pytest.raises(ValueError, match="R <= C"):
        solve_lsa_batch(torch.zeros(2, 5, 4), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="n_rows"):
        solve_lsa_batch(torch.zeros(2, 3, 4), torch.ones(3, dtype=torch.int32))
    before = solve_lsa_batch.launches
    solve_lsa_batch(torch.zeros(2, 3, 4), torch.ones(2, dtype=torch.int32))
    assert solve_lsa_batch.launches == before == 0   # no kernel on the CPU


def test_softkd_shaped_costs_equal_jax_and_scipy():
    cost, n = softkd_like_costs(11, 4)
    assert cost.shape == (4, 100, 100) and ((90 <= n) & (n < 100)).all()
    past = np.arange(100)[None, None, :] >= n[:, None, None]
    assert (cost[np.broadcast_to(past, cost.shape)] == 1e6).all()
    got = _port(cost, n)
    np.testing.assert_array_equal(got, _jax(cost, n))
    for b in range(4):
        assert (got[b, n[b]:] == -1).all() and (got[b, :n[b]] < n[b]).all()
        rows, cols = linear_sum_assignment(cost[b, :n[b]])
        np.testing.assert_allclose(cost[b, rows, got[b, :n[b]]].sum(),
                                   cost[b, rows, cols].sum(), rtol=1e-5)


def _steps(cost, n):
    return lsa_scan_steps(torch.from_numpy(np.asarray(cost, np.float32)),
                          torch.from_numpy(np.asarray(n, np.int32)))


def test_scan_steps_of_hand_counted_problems():
    # Every row's arg-min is its own column: the warm start matches all.
    diag = (1 - np.eye(6, dtype=np.float32))[None]
    np.testing.assert_array_equal(_steps(diag, [6]), [0])
    # Both rows claim column 0 and row 0 keeps it. Row 1's scan reaches
    # column 0 (owned by row 0), then from row 0 the free column 1: two
    # scan steps; the walk flips both columns: two hops.
    two = np.array([[[0, 1], [0, 2]]], np.float32)
    np.testing.assert_array_equal(_port(two, [2]), [[1, 0]])
    np.testing.assert_array_equal(_steps(two, [2]), [4])
    # Padded rows take no steps.
    np.testing.assert_array_equal(_steps(np.concatenate([two, two]),
                                         [2, 1]), [4, 0])


def test_scan_steps_follow_the_problem_not_its_place_in_the_batch():
    rng = np.random.default_rng(9)
    cost = rng.normal(size=(10, 25, 100)).astype(np.float32)
    n = rng.integers(0, 26, 10).astype(np.int32)
    steps = _steps(cost, n)
    assert steps.max() > 0
    perm = rng.permutation(10)
    np.testing.assert_array_equal(_steps(cost[perm], n[perm]), steps[perm])
