"""The yardstick's arithmetic: the card's peaks, the operations and bytes
that attention needs, and the model's operations per image.

Counts are what the algorithm needs at the shapes fed, never what one
implementation happens to compute: attention over the keys its mask
leaves; the backward of attention as its five products (S recomputed,
dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q); each input byte read
once and each output byte written once.
"""
from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, HBM3 rate.
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_S = 3.35e12

STAGE_SIZES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
               "resnet18-test": (1, 1, 1, 1)}
WIDTHS = (64, 128, 256, 512)


def attention_bound_s(kind: str, batch: int, heads: int, sq: int,
                      keys: Sequence[int], d: int, elem: int = 2) -> float:
    """Least seconds the card needs for one attention call: max(FLOP /
    peak, bytes / HBM rate). ``kind`` "fwd" (2 products) or "bwd" (5);
    ``keys`` the unmasked keys of each batch row; ``sq`` query rows; ``d``
    the model width (heads x head dim); ``elem`` bytes per element of q, k,
    v, o and their gradients. The forward reads q, k, v and the key mask
    and writes o and the row log-sum-exp; the backward reads q, k, v, o,
    dO, the log-sum-exp and the mask and writes dQ, dK, dV."""
    products = {"fwd": 2, "bwd": 5}[kind]
    s_all = max(keys) if len(keys) else 0
    flops = products * 2.0 * sq * d * float(sum(keys))
    q_b = batch * sq * d * elem
    kv_b = batch * s_all * d * elem
    lse_b = batch * heads * sq * 4
    mask_b = batch * s_all
    if kind == "fwd":
        nbytes = q_b + 2 * kv_b + mask_b + q_b + lse_b
    else:
        nbytes = 3 * q_b + 2 * kv_b + lse_b + mask_b + q_b + 2 * kv_b
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_S)


def _conv(cin, cout, k, h, w):
    return 2.0 * cin * cout * k * k * h * w


def resnet_flops(H: int, W: int, stages=STAGE_SIZES["resnet101"]
                 ) -> Dict[str, float]:
    """Forward FLOP of ResNet-101 on one H x W canvas, split into the
    frozen part (stem and layer1) and the trained stages; each entry also
    says how much of the trained part's input gradient is needed."""
    h, w = (H + 1) // 2, (W + 1) // 2          # stem conv, stride 2
    frozen = _conv(3, 64, 7, h, w)
    h, w = (h + 1) // 2, (w + 1) // 2          # max-pool, stride 2
    cin = 64
    trained, first_dgrad_free = 0.0, 0.0
    for s, (blocks, wd) in enumerate(zip(stages, WIDTHS)):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            ho, wo = (h + stride - 1) // stride, (w + stride - 1) // stride
            f = (_conv(cin, wd, 1, h, w) + _conv(wd, wd, 3, ho, wo)
                 + _conv(wd, 4 * wd, 1, ho, wo))
            if b == 0:
                down = _conv(cin, 4 * wd, 1, ho, wo)
                f += down
            if s == 0:
                frozen += f
            else:
                trained += f
                if s == 1 and b == 0:
                    # Its input (layer1's output) needs no gradient.
                    first_dgrad_free = _conv(cin, wd, 1, h, w) + down
            h, w, cin = ho, wo, 4 * wd
    return {"frozen": frozen, "trained": trained,
            "no_input_grad": first_dgrad_free, "feature_hw": (h, w),
            "channels": cin}


def transformer_flops(m: dict, tokens: int, keys: Sequence[int],
                      text_len: int) -> Dict[str, float]:
    """Forward FLOP of one image's text encoder (over ``text_len``
    positions), resizer, input projection, joint encoder (``tokens``
    image + text tokens, attention over the unmasked ``keys``[0]), decoder
    and heads."""
    d, ff, Q = m["hidden_dim"], m["dim_feedforward"], m["num_queries"]
    th, ti = m["text_hidden"], m["text_intermediate"]
    T, S, kv = text_len, tokens, keys[0]
    text = m["text_layers"] * (2.0 * T * th * th * 4 + 2.0 * T * th * ti * 2
                               + 2.0 * 2 * T * T * th)
    text += 2.0 * T * th * d                              # resizer
    enc = m["enc_layers"] * (2.0 * S * d * d * 4 + 2.0 * S * d * ff * 2
                             + 2.0 * 2 * S * kv * d)
    dec = m["dec_layers"] * (
        2.0 * Q * d * d * 4 + 2.0 * 2 * Q * Q * d          # self
        + 2.0 * Q * d * d * 2 + 2.0 * S * d * d * 2        # cross q, o; k, v
        + 2.0 * 2 * Q * kv * d                             # cross attention
        + 2.0 * Q * d * ff * 2)
    L, C, h = m["dec_layers"], m["num_classes"] + 1, m["contrastive_hdim"]
    heads = L * 2.0 * Q * (d * C + 2 * d * d + d * 4 + d * h) + 2.0 * T * d * h
    return {"text": text, "encoder": enc, "decoder": dec, "heads": heads}


def forward_flops(m: dict, H: int, W: int, valid_keys: int,
                  text_len: int) -> float:
    """Forward FLOP of the whole model for one image on an H x W canvas
    whose joint sequence leaves ``valid_keys`` keys unmasked."""
    r = resnet_flops(H, W, STAGE_SIZES[m["backbone"]])
    fh, fw = r["feature_hw"]
    proj = 2.0 * r["channels"] * m["hidden_dim"] * fh * fw
    t = transformer_flops(m, fh * fw + text_len, [valid_keys], text_len)
    return r["frozen"] + r["trained"] + proj + sum(t.values())


def train_flops(m: dict, H: int, W: int, valid_keys: int,
                text_len: int) -> float:
    """Forward plus backward FLOP of one training image: every trained
    layer's backward is its input gradient and its weight gradient, twice
    its forward; the frozen stem and layer1 have none, and the first
    trained blocks need no input gradient."""
    r = resnet_flops(H, W, STAGE_SIZES[m["backbone"]])
    fwd = forward_flops(m, H, W, valid_keys, text_len)
    trained = fwd - r["frozen"]
    return fwd + 2.0 * trained - r["no_input_grad"]
