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


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(B, 10, D)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(B, 12, D), torch.zeros(B, 11, D),
                        None, H)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, torch.zeros(B, 10), H)   # mask not bool
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, None, H, dropout_rate=0.1)


def test_train_mode_dropout_raises():
    port, _, x, mem, mask = _shared_mha(10, 300)
    port.train()
    with pytest.raises(NotImplementedError):
        port(torch.from_numpy(x), torch.from_numpy(mem),
             torch.from_numpy(mem))
