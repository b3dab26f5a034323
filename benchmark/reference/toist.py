"""Plain PyTorch reference of the TOIST detector (MDETR with ResNet-101 and
RoBERTa-base), written from the published architecture for the benchmark's
output check.

It imports nothing of the program under test. Weights come as one dict of
f32 tensors in the reference checkpoint's layout (``param_spec`` lists the
keys), the same dict the benchmark hands the program. Everything runs in
f32 with TF32 off (``f32_mode``), on plain ``torch`` operations: no kernel,
no cache, no batching trick.

Equations, as published (MDETR, Kamath et al. 2021; TOIST, Li et al. 2022):
ResNet-101 with frozen BatchNorm (eps 1e-5), the padded canvas zeroed after
the stem's max-pool and after every stage; a 2-D sine position embedding
over the stride-32 mask; RoBERTa-base (post-norm, exact GELU, LayerNorm eps
1e-5, padding-offset position ids); a linear + LayerNorm (eps 1e-12) text
resizer; 6 post-norm joint encoder layers over image and text tokens; 6
post-norm decoder layers over 100 learned queries with a shared final norm;
a linear class head, a 3-layer box MLP with a sigmoid, and the contrastive
alignment projections. Departures from the torch reference code, kept
because they are the configuration the program states: the joint
transformer's LayerNorms use eps 1e-6; masked logits take -1e9.

``prec`` rounds every tensor the model computes as it is stored: the
operands and results of every convolution and linear layer, every norm's
result, every residual sum, the attention probabilities and outputs. The
check runs it as the identity; the control runs it as float8 (e4m3, one
scale per tensor; gradients e5m2), the precision below the
configuration's bf16, with sums still accumulated in f32.

Training mode draws dropout in the order, shapes and kinds of the program's
documented dropout streams (``Dropout``), so that with the same generator
seed both sides drop the same elements.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e9
# Bottleneck blocks per stage of each backbone name the configurations use
# ("resnet18-test" is the program's one-block test trunk, for CPU tests).
STAGE_SIZES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
               "resnet18-test": (1, 1, 1, 1)}
WIDTHS = (64, 128, 256, 512)
FUSED_MIN_KEYS = 256   # attentions over this many keys take a hashed mask
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextmanager
def f32_mode():
    """True f32 products: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _scaled_round(x: torch.Tensor, dtype: torch.dtype,
                  top: float) -> torch.Tensor:
    """x rounded to the float8 ``dtype`` with one scale per tensor that
    maps its largest magnitude to ``top``."""
    s = x.abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


class _FP8(torch.autograd.Function):
    """Values stored as float8 e4m3 (amax to 448); their gradients as
    float8 e5m2 (amax to 57344), as float8 training keeps them."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, 57344.0)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


PRECISIONS: Dict[str, Callable] = {"f32": identity, "fp8": fp8_round}


# --------------------------------------------------------------------------
# The parameter layout.

def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of the model whose sizes are
    ``m`` (the configuration's "model" section plus "vocab_size"). kind
    says how the benchmark draws it: "w" fan-in scaled normal, "b" small
    bias, "bn_w" / "bn_b" / "bn_mean" / "bn_var", "bn_branch" (the gain
    that ends a bottleneck's residual branch), "ln_w" / "ln_b", "emb"
    (normal / sqrt(width)), "query" (standard normal)."""
    d, ff = m["hidden_dim"], m["dim_feedforward"]
    th, ti = m["text_hidden"], m["text_intermediate"]
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(k, din, dout, bias=True):
        spec.append((f"{k}.weight", (dout, din), "w"))
        if bias:
            spec.append((f"{k}.bias", (dout,), "b"))

    def conv(k, cin, cout, ks, bias=False):
        spec.append((f"{k}.weight", (cout, cin, ks, ks), "w"))
        if bias:
            spec.append((f"{k}.bias", (cout,), "b"))

    def bn(k, c, gain="bn_w"):
        for n in ("weight", "bias", "running_mean", "running_var"):
            kind = {"weight": gain, "bias": "bn_b", "running_mean":
                    "bn_mean", "running_var": "bn_var"}[n]
            spec.append((f"{k}.{n}", (c,), kind))

    def ln(k, c):
        spec.append((f"{k}.weight", (c,), "ln_w"))
        spec.append((f"{k}.bias", (c,), "ln_b"))

    def mha(k, dm):
        spec.append((f"{k}.in_proj_weight", (3 * dm, dm), "w"))
        spec.append((f"{k}.in_proj_bias", (3 * dm,), "b"))
        lin(f"{k}.out_proj", dm, dm)

    body = "backbone.0.body"
    conv(f"{body}.conv1", 3, 64, 7)
    bn(f"{body}.bn1", 64)
    cin = 64
    for s, (blocks, w) in enumerate(zip(STAGE_SIZES[m["backbone"]], WIDTHS),
                                    start=1):
        for b in range(blocks):
            t = f"{body}.layer{s}.{b}"
            conv(f"{t}.conv1", cin, w, 1)
            bn(f"{t}.bn1", w)
            conv(f"{t}.conv2", w, w, 3)
            bn(f"{t}.bn2", w)
            conv(f"{t}.conv3", w, 4 * w, 1)
            bn(f"{t}.bn3", 4 * w, "bn_branch")
            if b == 0:
                conv(f"{t}.downsample.0", cin, 4 * w, 1)
                bn(f"{t}.downsample.1", 4 * w)
            cin = 4 * w
    conv("input_proj", cin, d, 1, bias=True)
    tr = "transformer"
    for i in range(m["enc_layers"]):
        t = f"{tr}.encoder.layers.{i}"
        mha(f"{t}.self_attn", d)
        lin(f"{t}.linear1", d, ff)
        lin(f"{t}.linear2", ff, d)
        ln(f"{t}.norm1", d)
        ln(f"{t}.norm2", d)
    for i in range(m["dec_layers"]):
        t = f"{tr}.decoder.layers.{i}"
        mha(f"{t}.self_attn", d)
        mha(f"{t}.cross_attn_image", d)
        lin(f"{t}.linear1", d, ff)
        lin(f"{t}.linear2", ff, d)
        for n in ("norm1", "norm3", "norm4"):
            ln(f"{t}.{n}", d)
    ln(f"{tr}.decoder.norm", d)
    lin(f"{tr}.resizer.fc", th, d)
    ln(f"{tr}.resizer.layer_norm", d)
    te = f"{tr}.text_encoder"
    spec.append((f"{te}.embeddings.word_embeddings.weight",
                 (m["vocab_size"], th), "emb"))
    spec.append((f"{te}.embeddings.position_embeddings.weight",
                 (m["text_max_position"], th), "emb"))
    spec.append((f"{te}.embeddings.token_type_embeddings.weight", (1, th),
                 "emb"))
    ln(f"{te}.embeddings.LayerNorm", th)
    for i in range(m["text_layers"]):
        t = f"{te}.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{t}.attention.self.{n}", th, th)
        lin(f"{t}.attention.output.dense", th, th)
        ln(f"{t}.attention.output.LayerNorm", th)
        lin(f"{t}.intermediate.dense", th, ti)
        lin(f"{t}.output.dense", ti, th)
        ln(f"{t}.output.LayerNorm", th)
    spec.append(("query_embed.weight", (m["num_queries"], d), "query"))
    lin("class_embed", d, m["num_classes"] + 1)
    for i, (a, b) in enumerate(((d, d), (d, d), (d, 4))):
        lin(f"bbox_embed.layers.{i}", a, b)
    lin("contrastive_align_projection_image", d, m["contrastive_hdim"])
    lin("contrastive_align_projection_text", d, m["contrastive_hdim"])
    return spec


# --------------------------------------------------------------------------
# Dropout streams.

_G64 = 0x9E3779B97F4A7C15
_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB
_M32 = 0xFFFFFFFF


def _s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _shr(z, 30)) * _s64(_C1)
    z = (z ^ _shr(z, 27)) * _s64(_C2)
    return z ^ _shr(z, 31)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & _M32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def hashed_keep(seed: torch.Tensor, batch: int, heads: int, sq: int, s: int,
                q: int) -> torch.Tensor:
    """Keep mask [B, H, Sq, S] of the counter-based dropout of fused
    attention: per (batch*head, query-row pair) a 64-bit key
    mix64(mix64(seed + G64 (bh + 1)) + row pair); per 2x2 block one word
    mix32(low32(key) ^ key pair * 0x9E3779B9); an element keeps iff its
    byte of the word ((row & 1) * 2 + (col & 1)) is >= q. int64 arithmetic
    wraps as the unsigned arithmetic does."""
    dev = seed.device
    bh = torch.arange(batch * heads, device=dev, dtype=torch.int64)
    base = _mix64(seed.reshape(()) + _s64(_G64) * (bh + 1))
    rp = torch.arange((sq + 1) // 2, device=dev, dtype=torch.int64)
    key = _mix64(base[:, None] + rp[None, :]) & _M32        # [BH, Sq/2]
    cp = torch.arange((s + 1) // 2, device=dev, dtype=torch.int64)
    word = _mix32(key[:, :, None] ^ ((cp * 0x9E3779B9) & _M32)[None, None])
    keep = torch.empty(batch * heads, sq, s, dtype=torch.bool, device=dev)
    for ro in (0, 1):
        for co in (0, 1):
            byte = (word >> ((ro * 2 + co) * 8)) & 0xFF
            rows = keep[:, ro::2, co::2]
            rows.copy_(byte[:, :rows.shape[1], :rows.shape[2]] >= q)
    return keep.reshape(batch, heads, sq, s)


class Dropout:
    """The training-mode dropout streams, drawn from one generator in the
    program's order. ``u8``: 8 random bits per element, keep iff bits >= q
    = min(round(rate * 256), 255), kept values scaled by 1 / (1 - q/256)
    (the joint transformer, the resizer and every attention's
    probabilities). ``exact``: keep iff a uniform draw is >= rate, scaled by
    1 / (1 - rate) (RoBERTa's embeddings and residual branches). An
    attention over ``FUSED_MIN_KEYS`` keys or more on a CUDA device draws
    one int64 seed and the counter-based mask of ``hashed_keep``. None (the
    default) is eval mode: no dropout."""

    def __init__(self, generator: torch.Generator, rate: float,
                 resizer_rate: float):
        self.g = generator
        self.rate = rate
        self.resizer_rate = resizer_rate

    @staticmethod
    def threshold(rate: float) -> int:
        return min(int(round(rate * 256.0)), 255) if rate > 0 else 0

    def u8(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        q = self.threshold(rate)
        if q == 0:
            return x
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             generator=self.g, device=self.g.device)
        return torch.where(bits >= q, x * (1.0 / (1.0 - q / 256.0)),
                           x.new_zeros(()))

    def exact(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        u = torch.rand(x.shape, generator=self.g, device=self.g.device)
        return torch.where(u >= rate, x / (1.0 - rate), x.new_zeros(()))

    def attention(self, shape: Tuple[int, int, int, int], fused: bool
                  ) -> Optional[torch.Tensor]:
        q = self.threshold(self.rate)
        if q == 0:
            return None
        if fused and self.g.device.type == "cuda":
            seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64,
                                 generator=self.g, device=self.g.device)
            return hashed_keep(seed, *shape, q)
        bits = torch.randint(0, 256, shape, dtype=torch.uint8,
                             generator=self.g, device=self.g.device)
        return bits >= q


# --------------------------------------------------------------------------
# The forward pass.

class Reference:
    """The detector's forward over weights ``W`` (f32, reference layout) at
    the sizes of ``m``; ``prec`` names the operand precision ("f32" or
    "fp8"); ``drop`` turns training-mode dropout on."""

    def __init__(self, W: Dict[str, torch.Tensor], m: dict,
                 prec: str = "f32", drop: Optional[Dropout] = None):
        self.W, self.m = W, m
        self.q = PRECISIONS[prec]
        self.drop = drop

    # -- primitives --------------------------------------------------------
    def linear(self, x, key, w=None, b=None):
        w = self.W[f"{key}.weight"] if w is None else w
        b = self.W.get(f"{key}.bias") if b is None else b
        return self.q(F.linear(self.q(x), self.q(w), b))

    def conv(self, x, key, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(self.W[f"{key}.weight"]),
                               self.W.get(f"{key}.bias"), stride=stride,
                               padding=padding))

    def layer_norm(self, x, key, eps):
        return self.q(F.layer_norm(x, x.shape[-1:], self.W[f"{key}.weight"],
                                   self.W[f"{key}.bias"], eps))

    def frozen_bn(self, x, key):
        W = self.W
        scale = W[f"{key}.weight"] / torch.sqrt(W[f"{key}.running_var"]
                                                + 1e-5)
        shift = W[f"{key}.bias"] - W[f"{key}.running_mean"] * scale
        return self.q(x * scale[None, :, None, None]
                      + shift[None, :, None, None])

    def u8(self, x, rate=None):
        if self.drop is None:
            return x
        return self.drop.u8(x, self.drop.rate if rate is None else rate)

    def exact(self, x):
        return x if self.drop is None else self.drop.exact(x, self.drop.rate)

    def attention(self, q, k, v, key_pad, heads):
        """Scaled dot-product attention of [B, Sq, D] projections, keys
        masked where ``key_pad`` is True, probabilities dropped in
        training mode."""
        B, Sq, D = q.shape
        S = k.shape[1]
        hd = D // heads
        qh = q.reshape(B, Sq, heads, hd).transpose(1, 2)
        kh = k.reshape(B, S, heads, hd).transpose(1, 2)
        vh = v.reshape(B, S, heads, hd).transpose(1, 2)
        logits = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
        if key_pad is not None:
            logits = logits.masked_fill(key_pad[:, None, None, :], NEG_INF)
        p = self.q(torch.softmax(logits, dim=-1))
        if self.drop is not None:
            keep = self.drop.attention((B, heads, Sq, S),
                                       S >= FUSED_MIN_KEYS)
            if keep is not None:
                qd = Dropout.threshold(self.drop.rate)
                p = torch.where(keep, p * (1.0 / (1.0 - qd / 256.0)),
                                p.new_zeros(()))
        return self.q((p @ vh).transpose(1, 2).reshape(B, Sq, D))

    def mha(self, key, query, k_in, v_in, key_pad):
        W = self.W
        wq, wk, wv = W[f"{key}.in_proj_weight"].chunk(3)
        bq, bk, bv = W[f"{key}.in_proj_bias"].chunk(3)
        q = self.linear(query, None, wq, bq)
        k = self.linear(k_in, None, wk, bk)
        v = self.linear(v_in, None, wv, bv)
        o = self.attention(q, k, v, key_pad, self.m["nheads"])
        return self.linear(o, f"{key}.out_proj")

    # -- the backbone ------------------------------------------------------
    @staticmethod
    def feature_mask(mask, h, w):
        H, W = mask.shape[1:]
        if H % h == 0 and W % w == 0:
            return mask[:, ::H // h, ::W // w]
        ys = (torch.arange(h, device=mask.device) * (H / h)).long()
        xs = (torch.arange(w, device=mask.device) * (W / w)).long()
        return mask[:, ys][:, :, xs]

    def backbone(self, x, pad):
        body = "backbone.0.body"

        def zero_pad(f):
            keep = ~self.feature_mask(pad, f.shape[2], f.shape[3])
            return f * keep[:, None].float()

        x = F.relu(self.frozen_bn(self.conv(x, f"{body}.conv1", 2, 3),
                                  f"{body}.bn1"))
        x = zero_pad(F.max_pool2d(x, 3, stride=2, padding=1))
        for s, blocks in enumerate(STAGE_SIZES[self.m["backbone"]], start=1):
            for b in range(blocks):
                t = f"{body}.layer{s}.{b}"
                stride = 2 if (b == 0 and s > 1) else 1
                y = F.relu(self.frozen_bn(self.conv(x, f"{t}.conv1"),
                                          f"{t}.bn1"))
                y = F.relu(self.frozen_bn(self.conv(y, f"{t}.conv2", stride,
                                                    1), f"{t}.bn2"))
                y = self.frozen_bn(self.conv(y, f"{t}.conv3"), f"{t}.bn3")
                r = x
                if b == 0:
                    r = self.frozen_bn(self.conv(x, f"{t}.downsample.0",
                                                 stride), f"{t}.downsample.1")
                x = self.q(F.relu(y + r))
            x = zero_pad(x)
        return x

    @staticmethod
    def sine_position(fmask, num_feats):
        not_mask = (~fmask).float()
        y = torch.cumsum(not_mask, 1)
        x = torch.cumsum(not_mask, 2)
        eps, scale = 1e-6, 2 * math.pi
        y = y / (y[:, -1:, :] + eps) * scale
        x = x / (x[:, :, -1:] + eps) * scale
        dim_t = torch.arange(num_feats, dtype=torch.float32,
                             device=fmask.device)
        dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
        px, py = x[..., None] / dim_t, y[..., None] / dim_t
        px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()],
                         -1).flatten(-2)
        py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()],
                         -1).flatten(-2)
        return torch.cat([py, px], -1)                    # [B, h, w, D]

    # -- the text encoder --------------------------------------------------
    def roberta(self, ids, pad):
        te = "transformer.text_encoder"
        W = self.W
        nonpad = (ids != 1).long()
        pos_ids = torch.cumsum(nonpad, 1) * nonpad + 1
        x = (W[f"{te}.embeddings.word_embeddings.weight"][ids]
             + W[f"{te}.embeddings.position_embeddings.weight"][pos_ids]
             + W[f"{te}.embeddings.token_type_embeddings.weight"][0])
        x = self.exact(self.layer_norm(x, f"{te}.embeddings.LayerNorm",
                                       1e-5))
        for i in range(self.m["text_layers"]):
            t = f"{te}.encoder.layer.{i}"
            q = self.linear(x, f"{t}.attention.self.query")
            k = self.linear(x, f"{t}.attention.self.key")
            v = self.linear(x, f"{t}.attention.self.value")
            a = self.attention(q, k, v, pad, self.m["text_heads"])
            a = self.linear(a, f"{t}.attention.output.dense")
            x = self.layer_norm(x + self.exact(a),
                                f"{t}.attention.output.LayerNorm", 1e-5)
            h = F.gelu(self.linear(x, f"{t}.intermediate.dense"))
            h = self.linear(h, f"{t}.output.dense")
            x = self.layer_norm(x + self.exact(h), f"{t}.output.LayerNorm",
                                1e-5)
        return x

    # -- the joint transformer ---------------------------------------------
    def ffn(self, x, t):
        h = self.u8(F.relu(self.linear(x, f"{t}.linear1")))
        return self.linear(h, f"{t}.linear2")

    def encoder(self, src, pos, pad):
        for i in range(self.m["enc_layers"]):
            t = f"transformer.encoder.layers.{i}"
            qk = src + pos
            a = self.mha(f"{t}.self_attn", qk, qk, src, pad)
            src = self.layer_norm(src + self.u8(a), f"{t}.norm1", 1e-6)
            src = self.layer_norm(src + self.u8(self.ffn(src, t)),
                                  f"{t}.norm2", 1e-6)
        return src

    def decoder(self, memory, pos, pad):
        B = memory.shape[0]
        qpos = self.W["query_embed.weight"][None].expand(B, -1, -1)
        tgt = torch.zeros_like(qpos)
        levels = []
        for i in range(self.m["dec_layers"]):
            t = f"transformer.decoder.layers.{i}"
            qk = tgt + qpos
            a = self.mha(f"{t}.self_attn", qk, qk, tgt, None)
            tgt = self.layer_norm(tgt + self.u8(a), f"{t}.norm1", 1e-6)
            a = self.mha(f"{t}.cross_attn_image", tgt + qpos, memory + pos,
                         memory, pad)
            tgt = self.layer_norm(tgt + self.u8(a), f"{t}.norm3", 1e-6)
            tgt = self.layer_norm(tgt + self.u8(self.ffn(tgt, t)),
                                  f"{t}.norm4", 1e-6)
            levels.append(self.layer_norm(tgt, "transformer.decoder.norm",
                                          1e-6))
        return torch.stack(levels)                        # [L, B, Q, D]

    # -- the whole model ---------------------------------------------------
    def forward(self, images_u8, image_mask, text_ids, text_mask):
        """images_u8 [B, H, W, 3] uint8, image_mask [B, H, W] (True = pad),
        text_ids [B, T], text_mask [B, T] (True = pad) -> {"pred_logits"
        [B, Q, C+1], "pred_boxes" [B, Q, 4] cxcywh, "aux_pred_logits",
        "aux_pred_boxes" [L-1, ...], "proj_queries" [B, Q, h],
        "aux_proj_queries", "proj_tokens" [B, T, h]}, all f32."""
        m, dev = self.m, images_u8.device
        mean = torch.tensor(IMAGENET_MEAN, device=dev)
        std = torch.tensor(IMAGENET_STD, device=dev)
        x = (images_u8.float() / 255.0 - mean) / std
        x = x * (~image_mask)[..., None].float()
        feat = self.backbone(x.permute(0, 3, 1, 2).contiguous(), image_mask)
        B, _, fh, fw = feat.shape
        fmask = self.feature_mask(image_mask, fh, fw)
        d = m["hidden_dim"]
        pos = self.sine_position(fmask, d // 2).reshape(B, fh * fw, d)
        src = self.conv(feat, "input_proj")
        img = src.permute(0, 2, 3, 1).reshape(B, fh * fw, d)
        text = self.roberta(text_ids, text_mask)
        text = self.u8(self.layer_norm(
            self.linear(text, "transformer.resizer.fc"),
            "transformer.resizer.layer_norm", 1e-12),
            self.drop.resizer_rate if self.drop is not None else None)
        joint = torch.cat([img, text], 1)
        jmask = torch.cat([fmask.reshape(B, fh * fw), text_mask], 1)
        jpos = torch.cat([pos, torch.zeros_like(text)], 1)
        memory = self.encoder(joint, jpos, jmask)
        hs = self.decoder(memory, jpos, jmask)
        logits = self.linear(hs, "class_embed")
        h = hs
        for i in range(3):
            h = self.linear(h, f"bbox_embed.layers.{i}")
            if i < 2:
                h = F.relu(h)
        boxes = torch.sigmoid(h)
        pq = self.linear(hs, "contrastive_align_projection_image")
        pt = self.linear(memory[:, -text_ids.shape[1]:],
                         "contrastive_align_projection_text")
        pq = pq / pq.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        pt = pt / pt.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
                "aux_pred_logits": logits[:-1], "aux_pred_boxes": boxes[:-1],
                "proj_queries": pq[-1], "aux_proj_queries": pq[:-1],
                "proj_tokens": pt}


def postprocess(logits: torch.Tensor, boxes: torch.Tensor,
                orig_sizes: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Scores 1 - P(no object) and boxes as absolute xyxy of the original
    image size (h, w)."""
    scores = 1.0 - torch.softmax(logits, -1)[..., -1]
    cx, cy, w, h = boxes.unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    hw = orig_sizes.float()
    scale = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], 1)
    return scores, xyxy * scale[:, None]
