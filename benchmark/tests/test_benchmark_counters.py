"""The yardstick's arithmetic against hand counts and against torch's own
operation counter at a tiny size."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counters, serve, traffic, train, weights
from benchmark.reference import toist as ref
from benchmark.tests.tiny import tiny_cell


def test_attention_bound_by_hand():
    # B 2, H 2, Sq 3, keys 5 and 4 of S 5, d 8, bf16.
    fwd = counters.attention_bound_s("fwd", 2, 2, 3, [5, 4], 8)
    flops = 2 * 2 * 3 * 8 * (5 + 4)
    q, kv, lse, mask = 2 * 3 * 8 * 2, 2 * 5 * 8 * 2, 2 * 2 * 3 * 4, 2 * 5
    nbytes = q + 2 * kv + mask + q + lse
    assert fwd == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))
    bwd = counters.attention_bound_s("bwd", 2, 2, 3, [5, 4], 8)
    nbytes = 3 * q + 2 * kv + lse + mask + q + 2 * kv
    assert bwd == pytest.approx(max(5 * flops / 2 / 989e12,
                                    nbytes / 3.35e12))
    # At the serving encoder's shapes the products bound it.
    big = counters.attention_bound_s("fwd", 8, 8, 1114, [1114] * 8, 256)
    assert big == pytest.approx(2 * 2 * 1114 * 256 * 1114 * 8 / 989e12)


def test_resnet101_forward_by_hand():
    r = counters.resnet_flops(800, 1344)
    assert r["feature_hw"] == (25, 42) and r["channels"] == 2048
    total = r["frozen"] + r["trained"]
    # ResNet-101 at 224 x 224 is 7.8 GMAC: 15.6 GFLOP (published).
    r224 = counters.resnet_flops(224, 224)
    assert (r224["frozen"] + r224["trained"]) / 1e9 == pytest.approx(
        15.6, rel=0.02)
    assert total / 1e9 == pytest.approx(
        15.6 * 800 * 1344 / 224 ** 2, rel=0.02)


def _tiny(dtype="float32"):
    cell = tiny_cell("r101-train-b6", dtype)
    m = serve.model_sizes(cell.config)
    W = weights.make_weights(ref.param_spec(m), 5, "cpu")
    b = traffic.train_pool(cell.traffic, m["vocab_size"], 64, 8, 256, 5)[0]
    b["image_mask"][:] = False          # every key valid: counts compare
    b["text_mask"][:] = False
    b["text_ids"][b["text_ids"] == 1] = 7
    return cell, m, W, b


def test_forward_count_matches_torch_counter():
    cell, m, W, b = _tiny()
    x = train.to_device(b, "cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.Reference(W, m).forward(x["images"], x["image_mask"],
                                    x["text_ids"].long(), x["text_mask"])
    H, Wd = b["images"].shape[1:3]
    keys = (H // 32) * (Wd // 32) + b["text_ids"].shape[1]
    ours = counters.forward_flops(m, H, Wd, keys, b["text_ids"].shape[1])
    assert ours * b["images"].shape[0] == pytest.approx(
        fc.get_total_flops(), rel=0.01)


def test_train_count_matches_torch_counter():
    cell, m, W, b = _tiny()
    names = [k for k, _, kind in ref.param_spec(m)
             if train.trainable(k, kind)]
    P = {k: W[k].clone().requires_grad_(k in names) for k in W}
    x = train.to_device(b, "cpu")
    with FlopCounterMode(display=False) as fc:
        out = ref.Reference(P, m).forward(x["images"], x["image_mask"],
                                          x["text_ids"].long(),
                                          x["text_mask"])
        loss = sum(v.float().sum() for v in out.values())
        loss.backward()
    H, Wd = b["images"].shape[1:3]
    keys = (H // 32) * (Wd // 32) + b["text_ids"].shape[1]
    ours = counters.train_flops(m, H, Wd, keys, b["text_ids"].shape[1])
    assert ours * b["images"].shape[0] == pytest.approx(
        fc.get_total_flops(), rel=0.02)
