"""Port attention (toist_tpu_torch) against the JAX package on the CPU.

The port's ``flash_attention`` on CPU tensors is its plain version; it is
held against the JAX Pallas kernel in interpret mode at the contract shapes
of tests/test_flash_attention.py, with that file's tolerances (2e-6 masked,
2e-5 fully masked rows, 3e-2 bf16). ``MultiheadAttention`` is held against
the JAX module with the same packed weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toist_tpu.models.layers import MultiheadAttention as JaxMHA
from toist_tpu.ops.flash_attention import fused_attention
from toist_tpu_torch.models import layers as port_layers
from toist_tpu_torch.models.layers import FUSED_MIN_KV, MultiheadAttention
from toist_tpu_torch.ops.flash_attention import (attention_plain,
                                                 flash_attention)

B, D, H = 2, 64, 4


def _qkv(seed, sq, s):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, sq, D)).astype(np.float32),
            rng.standard_normal((B, s, D)).astype(np.float32),
            rng.standard_normal((B, s, D)).astype(np.float32), rng)


@pytest.mark.parametrize("sq,s,mask_kind,atol", [
    (300, 300, "random", 2e-6),
    (100, 300, "random", 2e-6),
    (300, 300, "none", 2e-6),
    (300, 300, "full", 2e-5),
])
def test_forward_matches_jax_kernel(sq, s, mask_kind, atol):
    q, k, v, rng = _qkv(0, sq, s)
    mask = {"random": rng.random((B, s)) < 0.2,
            "full": np.ones((B, s), bool), "none": None}[mask_kind]
    want = fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           None if mask is None else jnp.asarray(mask), H,
                           interpret=True)
    got, lse = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), H)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    assert lse.shape == (B, H, sq)


def test_bf16_matches_jax_kernel():
    q, k, v, rng = _qkv(4, 300, 300)
    mask = rng.random((B, 300)) < 0.2
    want = fused_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                           jnp.asarray(mask), H, interpret=True)
    got, _ = flash_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(mask), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


def test_lse_is_base2_logsumexp():
    """lse = log2(sum exp2(scores * log2 e)), the kernels' convention."""
    q, k, v, rng = _qkv(5, 37, 70)
    mask = torch.from_numpy(rng.random((B, 70)) < 0.3)
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    _, lse = attention_plain(qt, kt, torch.from_numpy(v), mask, H)
    hd = D // H
    qh = qt.reshape(B, 37, H, hd).transpose(1, 2).double()
    kh = kt.reshape(B, 70, H, hd).transpose(1, 2).double()
    s = (qh @ kh.transpose(-1, -2)) / np.sqrt(hd)
    s = s.masked_fill(mask[:, None, None, :], -1e9)
    want = torch.logsumexp(s, -1) / np.log(2.0)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


def _shared_mha(seed, s):
    """Port and JAX MultiheadAttention with one set of packed weights."""
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=D ** -0.5, size=(3 * D, D)).astype(np.float32)
    b = rng.normal(scale=0.02, size=(3 * D,)).astype(np.float32)
    wo = rng.normal(scale=D ** -0.5, size=(D, D)).astype(np.float32)
    bo = rng.normal(scale=0.02, size=(D,)).astype(np.float32)
    port = MultiheadAttention(D, H, dropout=0.1).eval()
    port.load_state_dict({
        "in_proj_weight": torch.from_numpy(w),
        "in_proj_bias": torch.from_numpy(b),
        "out_proj.weight": torch.from_numpy(wo),
        "out_proj.bias": torch.from_numpy(bo)})
    params = {"params": {
        "q_proj": {"kernel": w[:D].T, "bias": b[:D]},
        "k_proj": {"kernel": w[D:2 * D].T, "bias": b[D:2 * D]},
        "v_proj": {"kernel": w[2 * D:].T, "bias": b[2 * D:]},
        "out_proj": {"kernel": wo.T, "bias": bo}}}
    x = rng.standard_normal((B, 100, D)).astype(np.float32)
    mem = rng.standard_normal((B, s, D)).astype(np.float32)
    mask = rng.random((B, s)) < 0.2
    return port, params, x, mem, mask


@pytest.mark.parametrize("s", [300, 100])
def test_module_matches_jax_unfused(s):
    port, params, x, mem, mask = _shared_mha(6, s)
    jm = JaxMHA(D, H, 0.1, jnp.float32, "off")
    want = jax.jit(lambda p, a, m, km: jm.apply(p, a, m, m, key_padding_mask=km))(
        params, x, mem, mask)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(mem),
                   torch.from_numpy(mem), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("s,routed", [(FUSED_MIN_KV - 1, False),
                                      (100, False), (FUSED_MIN_KV, True),
                                      (300, True)])
def test_kernel_routing_by_key_length(monkeypatch, s, routed):
    """Keys below FUSED_MIN_KV stay on the plain path; at or above it the
    module calls the kernel wrapper, and the oracle switch turns that off."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return flash_attention(*args, **kw)

    monkeypatch.setattr(port_layers, "flash_attention", spy)
    port, _, x, mem, mask = _shared_mha(7, s)
    with torch.inference_mode():
        port(torch.from_numpy(x), torch.from_numpy(mem),
             torch.from_numpy(mem), torch.from_numpy(mask))
        assert bool(calls) == routed
        calls.clear()
        port_layers.set_fused_attention(port, False)
        port(torch.from_numpy(x), torch.from_numpy(mem),
             torch.from_numpy(mem), torch.from_numpy(mask))
        assert not calls


def test_launch_counter_stays_zero_on_cpu():
    before = flash_attention.launches
    q, k, v, rng = _qkv(8, 300, 300)
    flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), None, H)
    port, _, x, mem, mask = _shared_mha(9, 300)
    with torch.inference_mode():
        port(torch.from_numpy(x), torch.from_numpy(mem),
             torch.from_numpy(mem), torch.from_numpy(mask))
    assert flash_attention.launches == before == 0


def test_routes_by_dtype():
    """bf16 runs the tensor-core kernels, f32 the scalar ones: a dispatch by
    dtype, so one name per dtype and no fallback between them."""
    from toist_tpu_torch.ops import flash_attention as fa

    assert fa._fwd_route(torch.bfloat16) == (fa.FWD_TC_SOURCE, "_tc")
    assert fa._fwd_route(torch.float32) == (fa.FWD_SOURCE, "")
    assert fa._bwd_route(torch.bfloat16) == (fa.BWD_TC_SOURCE, "_tc")
    assert fa._bwd_route(torch.float32) == (fa.BWD_SOURCE, "")
    assert fa.FWD_TC_SOURCE == "flash_attn_fwd_tc.cu"


def test_kernel_sources_are_listed_and_present():
    import os

    from toist_tpu_torch.ops import _build
    from toist_tpu_torch.ops import flash_attention as fa
    from toist_tpu_torch.ops import frozen_norm
    from toist_tpu_torch.ops.lsa import KERNEL_SOURCE

    assert fa.FWD_TC_SOURCE in fa.KERNEL_SOURCES
    on_disk = {f for f in os.listdir(_build.CSRC) if f.endswith(".cu")}
    assert on_disk == set(fa.KERNEL_SOURCES) | {KERNEL_SOURCE,
                                                frozen_norm.SOURCE}
    # The two tensor-core sources share one header of building blocks.
    for src in (fa.FWD_TC_SOURCE, fa.BWD_TC_SOURCE):
        with open(os.path.join(_build.CSRC, src)) as f:
            assert '#include "flash_attn_tc.cuh"' in f.read()


def test_tc_forward_counter_stays_zero_on_cpu():
    """bf16 CPU tensors take the plain version: no kernel, no count."""
    before = flash_attention.fwd_tc_launches
    q, k, v, rng = _qkv(15, 100, 300)
    args = [torch.from_numpy(a).bfloat16().requires_grad_()
            for a in (q, k, v)]
    mask = torch.from_numpy(rng.random((B, 300)) < 0.2)
    o, _ = flash_attention(*args, mask, H, 0.1,
                           torch.Generator().manual_seed(0))
    o.float().sum().backward()
    assert o.dtype == torch.bfloat16
    assert flash_attention.fwd_tc_launches == before == 0
    assert flash_attention.launches == 0


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(B, 10, D)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(B, 12, D), torch.zeros(B, 11, D),
                        None, H)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, torch.zeros(B, 10), H)   # mask not bool
    with pytest.raises(ValueError, match="generator"):
        flash_attention(q, q, q, None, H, dropout_rate=0.1)


def test_train_mode_dropout_raises():
    """Training-mode dropout needs the step's generator."""
    port, _, x, mem, mask = _shared_mha(10, 300)
    port.train()
    with pytest.raises(ValueError, match="generator"):
        port(torch.from_numpy(x), torch.from_numpy(mem),
             torch.from_numpy(mem))


# --- dropout and gradients (training) ---------------------------------------
# Dropout bits cannot match across frameworks (jax.random vs torch.Generator),
# so _dropout_u8 is held by its properties, as test_dropout_semantics does
# for the kernel: determinism per seed, keep share 1 - q/256 (within 5
# binomial standard deviations), unbiasedness, the 8-bit clamp at q = 255.

@pytest.mark.parametrize("rate,q", [(0.1, 26), (0.5, 128), (0.999, 255)])
def test_dropout_u8_properties(rate, q):
    from toist_tpu_torch.models.layers import dropout_u8
    from toist_tpu_torch.ops.flash_attention import drop_scale, drop_threshold

    assert drop_threshold(rate) == q
    x = torch.full((400, 500), 2.0)
    a = dropout_u8(x, rate, torch.Generator().manual_seed(1))
    b = dropout_u8(x, rate, torch.Generator().manual_seed(1))
    c = dropout_u8(x, rate, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert set(a.unique().tolist()) <= {
        0.0, float(torch.tensor(2.0) * drop_scale(q))}
    p = 1 - q / 256
    sd = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - p) < 5 * sd
    # E[dropout(x)] = x: the rescale folds in the quantized keep probability.
    assert abs(a.mean().item() - 2.0) < 5 * 2.0 * drop_scale(q) * sd
    assert dropout_u8(x, 0.0, None) is x


def test_attention_plain_explicit_keep_mask():
    from toist_tpu_torch.ops.flash_attention import drop_scale

    q, k, v, rng = _qkv(11, 37, 70)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    mask = torch.from_numpy(rng.random((B, 70)) < 0.3)
    base, lse = attention_plain(qt, kt, vt, mask, H)
    ones = torch.ones(B, H, 37, 70, dtype=torch.bool)
    out, lse1 = attention_plain(qt, kt, vt, mask, H, ones, 0.1)
    torch.testing.assert_close(out, base * drop_scale(26), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(lse, lse1)        # dropout leaves the LSE alone
    keep = torch.from_numpy(rng.random((B, H, 37, 70)) < 0.7)
    out, _ = attention_plain(qt, kt, vt, mask, H, keep, 0.1)
    hd = D // H
    qh = qt.reshape(B, 37, H, hd).transpose(1, 2)
    kh = kt.reshape(B, 70, H, hd).transpose(1, 2)
    vh = vt.reshape(B, 70, H, hd).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2) / hd ** 0.5).masked_fill(
        mask[:, None, None, :], -1e9)
    p = torch.softmax(s, -1) * keep * drop_scale(26)
    want = (p @ vh).transpose(1, 2).reshape(B, 37, D)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


def test_cpu_attention_dropout_draws_from_the_generator():
    q, k, v, _ = _qkv(12, 300, 300)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    runs = [flash_attention(*args, None, H, 0.1,
                            torch.Generator().manual_seed(s))[0]
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def _grads_port(fn, q, k, v, w):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (fn(*ts) * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("sq,s", [(300, 300), (100, 300)])
def test_attention_gradients_match_jax(sq, s):
    """Autograd through the port's attention against jax.grad of the JAX
    Pallas kernel (interpret mode) and of the unfused JAX math, atol 5e-6
    (tests/test_flash_attention.py test_gradient_parity). Batch element 1
    has every key masked. There the JAX kernel deviates: its additive bias
    lets dQ/dK flow through the masked keys, and its saved LSE (-1e9*log2 e
    + log2 S, which rounds to -1e9*log2 e in f32) makes it recompute P = 1
    instead of 1/S, so its dV is S times the unfused value. The port
    follows the unfused semantics (masked_fill): dQ = dK = 0 there and dV
    as the unfused math gives it."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((3, s, D)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((3, sq, D)).astype(np.float32)
    mask = rng.random((3, s)) < 0.2
    mask[1] = True
    mt = torch.from_numpy(mask)
    got = _grads_port(lambda a, b, c: flash_attention(a, b, c, mt, H)[0],
                      q, k, v, w)

    def jgrads(fn):
        g = jax.grad(lambda *a: jnp.sum(fn(*a) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(x) for x in g]

    jm = jnp.asarray(mask)
    kernel = jgrads(lambda a, b, c: fused_attention(a, b, c, jm, H,
                                                    interpret=True))
    unfused = jgrads(lambda a, b, c: _unfused_jax(a, b, c, jm))
    for g, kg, ug in zip(got, kernel, unfused):
        np.testing.assert_allclose(g[[0, 2]], kg[[0, 2]], atol=5e-6)
        np.testing.assert_allclose(g, ug, atol=5e-6)
    assert (got[0][1] == 0).all() and (got[1][1] == 0).all()
    assert np.abs(kernel[0][1]).max() > 1e-3          # the JAX deviation


def _unfused_jax(q, k, v, mask):
    b, sq, _ = q.shape
    s = k.shape[1]
    hd = D // H
    qh = q.reshape(b, sq, H, hd).transpose(0, 2, 1, 3)
    kh = k.reshape(b, s, H, hd).transpose(0, 2, 1, 3)
    vh = v.reshape(b, s, H, hd).transpose(0, 2, 1, 3)
    logits = jnp.einsum("bhqd,bhsd->bhqs", qh, kh) / jnp.sqrt(jnp.float32(hd))
    logits = jnp.where(mask[:, None, None, :], -1e9, logits)
    out = jnp.einsum("bhqs,bhsd->bhqd", jax.nn.softmax(logits, -1), vh)
    return out.transpose(0, 2, 1, 3).reshape(b, sq, D)


@pytest.mark.parametrize("s", [300, 100])
def test_module_gradients_match_jax(s):
    """MultiheadAttention's gradients (inputs and packed weights) against
    jax.grad of the JAX module, unfused (the semantics oracle), with a
    fully masked batch element; atol 2e-5 as the module forward test."""
    port, params, x, mem, mask = _shared_mha(13, s)
    mask[1] = True
    w = np.random.default_rng(14).standard_normal((B, 100, D)) \
        .astype(np.float32)
    jm = JaxMHA(D, H, 0.1, jnp.float32, "off")

    def jloss(p, a, m):
        return jnp.sum(jm.apply(p, a, m, m, key_padding_mask=mask) * w)

    jgp, jga, jgm = jax.grad(jloss, argnums=(0, 1, 2))(params, x, mem)
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(mem).requires_grad_()
    (port(xt, mt, mt, torch.from_numpy(mask)) * torch.from_numpy(w)) \
        .sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jga), atol=2e-5)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(jgm), atol=2e-5)
    p = jgp["params"]
    w_in = np.concatenate([np.asarray(p[n]["kernel"]).T
                           for n in ("q_proj", "k_proj", "v_proj")])
    np.testing.assert_allclose(port.in_proj_weight.grad.numpy(), w_in,
                               atol=2e-5)
    np.testing.assert_allclose(port.out_proj.weight.grad.numpy(),
                               np.asarray(p["out_proj"]["kernel"]).T,
                               atol=2e-5)
