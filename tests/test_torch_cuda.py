"""The CUDA kernels on the card, against their plain versions.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip
elsewhere. On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerances: forward f32 with TF32 off 2e-5 (only the order of the sums
differs), bf16 3e-2 (as tests/test_flash_attention.py). Forward and
gradients against the plain version in f32 on the same inputs, as the
largest error over the tensor's max abs value: f32 5e-5 (sums over up to
300 rows in another order); bf16 (the tensor-core route) 1.5e-2, where the
kernels accumulate in f32 and round P~, dS and the outputs to bf16 as
FlashAttention-2 does, so a kernel that is 5% off fails. The same seed
reproduces them bit for bit. LSA: exact assignments on continuous costs and
ties (the kernel and the plain version run the same algorithm in the same f32
order), at the matcher and softkd shapes and at the edges of the kernel's
layout (many problems per CTA, C not a multiple of 4 or 32, R = 1, signed
zeros, more than 128 columns).
"""
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from toist_tpu_torch.models.layers import MultiheadAttention
from toist_tpu_torch.ops.flash_attention import (FlashAttention,
                                                 attention_plain,
                                                 drop_threshold,
                                                 dropout_keep_mask,
                                                 dropout_keep_mask_plain,
                                                 flash_attention)
from toist_tpu_torch.ops.lsa import (softkd_like_costs, solve_lsa_batch,
                                     solve_lsa_batch_plain)

pytestmark = pytest.mark.cuda
REL = {torch.float32: 5e-5, torch.bfloat16: 1.5e-2}   # x max abs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(sq, s, d, dtype, mask_kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, n, d, generator=g) for n in (sq, s, s))
    mask = {"random": torch.rand(2, s, generator=g) < 0.2,
            "full": torch.ones(2, s, dtype=torch.bool), "none": None}[
                mask_kind]
    out = [t.to("cuda", dtype) for t in (q, k, v)]
    return out + [None if mask is None else mask.cuda()]


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 0.0),
                                             (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("sq,s", [(300, 300), (100, 300), (37, 70)])
@pytest.mark.parametrize("heads,d", [(8, 256), (4, 64)])
@pytest.mark.parametrize("mask_kind", ["random", "full", "none"])
def test_kernel_matches_plain(cuda, dtype, atol, rtol, sq, s, heads, d,
                              mask_kind):
    q, k, v, mask = _inputs(sq, s, d, dtype, mask_kind)
    before = flash_attention.launches
    before_tc = flash_attention.fwd_tc_launches
    o, lse = flash_attention(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    # bf16 runs the tensor-core forward, f32 the scalar one.
    assert flash_attention.fwd_tc_launches == before_tc + (
        dtype == torch.bfloat16)
    ro, rlse = attention_plain(q, k, v, mask, heads)
    assert o.dtype == dtype and torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    _close(o, attention_plain(q.float(), k.float(), v.float(), mask,
                              heads)[0], REL[dtype])


def test_module_launches_only_for_long_keys(cuda):
    mha = MultiheadAttention(256, 8).to(cuda).eval()
    x = torch.randn(2, 100, 256, device=cuda)
    for s, launched in ((100, 0), (255, 0), (256, 1), (300, 1)):
        mem = torch.randn(2, s, 256, device=cuda)
        before = flash_attention.launches
        with torch.inference_mode():
            mha(x, mem, mem)
        assert flash_attention.launches - before == launched


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, mask = _inputs(64, 64, 256, torch.float32, "random")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v, mask, 4)                     # hd 64
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), mask, 8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                        k, v, mask, 8)
    with pytest.raises(ValueError, match="generator"):
        flash_attention(q, k, v, mask, 8, dropout_rate=0.1)


def _grads(fn, q, k, v, w):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    dq, dk, dv = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
    return o.detach(), dq, dk, dv


def _close(got, want, rel):
    """Largest error within rel of want's max abs (exact where want is 0)."""
    scale = want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,s", [(300, 300), (100, 300), (37, 70)])
@pytest.mark.parametrize("heads,d", [(8, 256), (4, 64)])
@pytest.mark.parametrize("mask_kind", ["random", "full", "none"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernels_with_gradients_match_plain(cuda, dtype, sq, s, heads, d,
                                            mask_kind, rate):
    """Forward and dQ/dK/dV of the kernels against autograd through the plain
    version given the kernels' own dropout mask; "random" masks hold a fully
    masked row (batch element 1), whose dQ and dK must be 0."""
    q, k, v, mask = _inputs(sq, s, d, dtype, mask_kind, seed=3)
    if mask_kind == "random":
        mask[1] = True
    w = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    seed = torch.tensor([1234567], dtype=torch.int64, device=cuda)
    dq_ = drop_threshold(rate)
    keep = (dropout_keep_mask(seed, 2, heads, sq, s, rate) if dq_ else None)
    mask_u8 = None if mask is None else mask.view(torch.uint8)
    names = ("launches", "dkv_launches", "dq_launches", "fwd_tc_launches",
             "dkv_tc_launches", "dq_tc_launches")
    counts = [getattr(flash_attention, n) for n in names]

    def kernels(a, b, c):
        return FlashAttention.apply(a, b, c, mask_u8, heads, dq_,
                                    seed if dq_ else None)[0]

    got = _grads(kernels, q, k, v, w)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)      # the tensor-core route is bf16's
    assert [getattr(flash_attention, n) - c for n, c in
            zip(names, counts)] == [1, 1, 1, tc, tc, tc]
    again = _grads(kernels, q, k, v, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _grads(lambda a, b, c: attention_plain(
        a.float(), b.float(), c.float(), mask, heads, keep, rate)[0],
        q, k, v, w)
    for g, r in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        _close(g, r, REL[dtype])
    if mask_kind != "none":
        full = mask.all(dim=1)
        assert (got[1][full] == 0).all() and (got[2][full] == 0).all()


def test_dropout_bits_reproduce_and_keep_rate(cuda):
    seed = torch.tensor([99], dtype=torch.int64, device=cuda)
    a = dropout_keep_mask(seed, 6, 8, 1156, 1156, 0.1)
    b = dropout_keep_mask(seed, 6, 8, 1156, 1156, 0.1)
    c = dropout_keep_mask(seed + 1, 6, 8, 1156, 1156, 0.1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    keep = a.float().mean().item()
    assert abs(keep - (1 - 26 / 256)) < 1e-3, keep
    # Rows and columns are not correlated: per-row shares stay near the mean.
    assert a.float().mean(-1).std().item() < 0.02
    q, k, v, mask = _inputs(300, 300, 256, torch.float32, "random")
    o1, _ = FlashAttention.apply(q, k, v, mask.view(torch.uint8), 8, 26, seed)
    o2, _ = FlashAttention.apply(q, k, v, mask.view(torch.uint8), 8, 26, seed)
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("b,h,sq,s,rate", [(6, 8, 1156, 1156, 0.1),
                                            (6, 8, 100, 1156, 0.1),
                                            (2, 4, 37, 70, 0.5)])
def test_dropout_mask_equals_plain_bit_for_bit(cuda, b, h, sq, s, rate):
    """The kernels' bit function (attn_dropout.cuh, through the mask kernel)
    against its numpy version, for a seed with high bits set."""
    value = 0x5DEECE66D1234567
    seed = torch.tensor([value], dtype=torch.int64, device=cuda)
    got = dropout_keep_mask(seed, b, h, sq, s, rate).cpu()
    assert torch.equal(got, dropout_keep_mask_plain(value, b, h, sq, s, rate))


def test_module_dropout_draws_from_the_generator(cuda):
    mha = MultiheadAttention(256, 8, dropout=0.1).to(cuda).train()
    x = torch.randn(2, 100, 256, device=cuda)
    mem = torch.randn(2, 300, 256, device=cuda)
    outs = []
    for s in (1, 1, 2):
        g = torch.Generator(cuda).manual_seed(s)
        outs.append(mha(x, mem, mem, generator=g))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


LSA_CASES = ("continuous", "padded", "ties", "non_finite", "100x100",
             "softkd", "b300", "128x128", "40x25x37", "r1", "signed_zero_ties",
             "c200")


def _lsa_case(name):
    """(cost, n_rows) of one LSA case. b300: more problems than SMs, so
    several per CTA and more than one wave; 40x25x37: C neither a multiple
    of 32 nor of 4 (scalar loads); signed_zero_ties: -0.0 and +0.0 tie;
    c200: more than 128 columns (column state in shared memory)."""
    rng = np.random.default_rng(0)
    cont = rng.normal(size=(36, 25, 100)).astype(np.float32)
    ties = np.round(rng.uniform(size=(36, 25, 100)) * 3).astype(np.float32)
    nan = cont.copy()
    nan[0, 3] = np.nan
    nan[1] = np.inf
    big = rng.normal(size=(36, 100, 100)).astype(np.float32)
    n25 = rng.integers(0, 26, 36).astype(np.int32)
    if name in ("continuous", "padded", "ties", "non_finite", "100x100"):
        return {"continuous": (cont, np.full(36, 25, np.int32)),
                "padded": (cont, n25), "ties": (ties, n25),
                "non_finite": (nan, np.full(36, 25, np.int32)),
                "100x100": (big, rng.integers(60, 101, 36).astype(np.int32))
                }[name]
    if name == "softkd":
        return softkd_like_costs(5, 36)
    shape, n_range = {"b300": ((300, 25, 100), (0, 26)),
                      "128x128": ((16, 128, 128), (100, 129)),
                      "40x25x37": ((40, 25, 37), (0, 26)),
                      "r1": ((16, 1, 50), (0, 2)),
                      "signed_zero_ties": ((36, 20, 40), (10, 21)),
                      "c200": ((8, 60, 200), (40, 61))}[name]
    if name == "signed_zero_ties":
        cost = rng.choice(np.array([0.0, -0.0, 1.0], np.float32), shape)
    else:
        cost = rng.normal(size=shape).astype(np.float32)
    return cost, rng.integers(*n_range, shape[0]).astype(np.int32)


@pytest.mark.parametrize("name", LSA_CASES)
def test_lsa_kernel_matches_plain(cuda, name):
    cost, n = _lsa_case(name)
    before = solve_lsa_batch.launches
    got = solve_lsa_batch(torch.from_numpy(cost).to(cuda),
                          torch.from_numpy(n).to(cuda))
    torch.cuda.synchronize()
    assert solve_lsa_batch.launches == before + 1
    want = solve_lsa_batch_plain(torch.from_numpy(cost), torch.from_numpy(n))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                  err_msg=name)
    if name in ("continuous", "padded", "100x100", "b300", "128x128",
                "40x25x37", "r1", "c200"):
        for b in range(cost.shape[0]):
            rows, cols = linear_sum_assignment(cost[b, :n[b]])
            np.testing.assert_array_equal(got[b, :n[b]].cpu().numpy(), cols)


def test_lsa_wrapper_raises(cuda):
    with pytest.raises(ValueError, match="R <= C"):
        solve_lsa_batch(torch.zeros(2, 5, 4, device=cuda),
                        torch.ones(2, dtype=torch.int32, device=cuda))
