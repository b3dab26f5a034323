"""JAX parameter tree -> the port's reference-layout state dict.

``jax_params_to_state_dict`` is the exact inverse of
``toist_tpu/utils/convert.py:convert_torch_state_dict``: it transposes Dense
and conv kernels back to torch's [out, in(, kh, kw)] layout, re-packs the
q/k/v projections into ``in_proj_weight`` / ``in_proj_bias``, and restores
the FrozenBN buffers and the Hugging Face RoBERTa names. A reference state
dict taken through both functions comes back bit for bit.

``synth_reference_state_dict`` is the port's copy of the JAX package's
function of that name (numpy only): random weights from a seed in the
reference checkpoint's layout, which ``TOIST.from_state_dict`` loads after
``torch.from_numpy``.

``load_reference_checkpoint`` reads a reference ``.pth`` (or the port's own
checkpoint, which has the same format) into a state dict of that layout:
the port keeps the reference's parameter names, so no conversion is needed.

``cluster_bank_from_jax`` carries a JAX ``ClusterBank`` (its four arrays)
into the port's.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


class _Out:
    """Collects state-dict entries under reference names."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def lin(self, key: str, p: Mapping) -> None:
        self.sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
        self.sd[f"{key}.bias"] = _t(p["bias"])

    def ln(self, key: str, p: Mapping) -> None:
        self.sd[f"{key}.weight"] = _t(p["scale"])
        self.sd[f"{key}.bias"] = _t(p["bias"])

    def conv(self, key: str, p: Mapping) -> None:
        self.sd[f"{key}.weight"] = _t(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self.sd[f"{key}.bias"] = _t(p["bias"])

    def frozen_bn(self, key: str, f: Mapping) -> None:
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.sd[f"{key}.{name}"] = _t(f[name])

    def mha(self, key: str, p: Mapping) -> None:
        parts = [p[n] for n in ("q_proj", "k_proj", "v_proj")]
        self.sd[f"{key}.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(x["kernel"]).T for x in parts], axis=0))
        self.sd[f"{key}.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(x["bias"]) for x in parts], axis=0))
        self.lin(f"{key}.out_proj", p["out_proj"])


def _layer_indices(tree: Mapping, pattern: str):
    """Sorted integer groups of the keys of ``tree`` matching ``pattern``."""
    found = []
    for k in tree:
        m = re.fullmatch(pattern, k)
        if m:
            found.append(tuple(int(g) for g in m.groups()))
    return sorted(found)


def _efficientnet(out: _Out, p: Mapping, f: Mapping) -> None:
    """JAX's EfficientNet (``stage{S}_{B}``, ``se_reduce``, ``se_expand``;
    stage 1's projection ``conv_pwl``) -> timm's names (``blocks.S-1.B``,
    ``se.conv_reduce``, ``se.conv_expand``; a DepthwiseSeparable block's
    projection ``conv_pw``). The norms are FrozenBN statistics in ``f``
    or GroupNorm scales and biases in ``p``."""
    base = "backbone.0.body"

    def norm(key, owner_p, owner_f, name):
        if name in owner_f:
            out.frozen_bn(key, owner_f[name])
        else:
            out.ln(key, owner_p[name])

    out.conv(f"{base}.conv_stem", p["conv_stem"])
    norm(f"{base}.bn1", p, f, "bn1")
    for s, b in _layer_indices(p, r"stage(\d+)_(\d+)"):
        t, name = f"{base}.blocks.{s - 1}.{b}", f"stage{s}_{b}"
        bp, bf = p[name], f.get(name, {})
        out.conv(f"{t}.conv_dw", bp["conv_dw"])
        out.conv(f"{t}.se.conv_reduce", bp["se_reduce"])
        out.conv(f"{t}.se.conv_expand", bp["se_expand"])
        if "conv_pw" in bp:                      # InvertedResidual
            out.conv(f"{t}.conv_pw", bp["conv_pw"])
            out.conv(f"{t}.conv_pwl", bp["conv_pwl"])
            for i in (1, 2, 3):
                norm(f"{t}.bn{i}", bp, bf, f"bn{i}")
        else:                                    # DepthwiseSeparable
            out.conv(f"{t}.conv_pw", bp["conv_pwl"])
            for i in (1, 2):
                norm(f"{t}.bn{i}", bp, bf, f"bn{i}")


def _backbone(out: _Out, params: Mapping, frozen: Mapping) -> None:
    base = "backbone.0.body"
    p, f = params["backbone"], frozen.get("backbone", {})
    if "conv_stem" in p:
        _efficientnet(out, p, f)
        return
    out.conv(f"{base}.conv1", p["conv1"])
    out.frozen_bn(f"{base}.bn1", f["FrozenBN_0"])
    for s, b in _layer_indices(p, r"layer(\d+)_(\d+)"):
        t, name = f"{base}.layer{s}.{b}", f"layer{s}_{b}"
        for i in (1, 2, 3):
            out.conv(f"{t}.conv{i}", p[name][f"conv{i}"])
            out.frozen_bn(f"{t}.bn{i}", f[name][f"FrozenBN_{i - 1}"])
        if "downsample_conv" in p[name]:
            out.conv(f"{t}.downsample.0", p[name]["downsample_conv"])
            out.frozen_bn(f"{t}.downsample.1", f[name]["FrozenBN_3"])


def _roberta(out: _Out, te: Mapping) -> None:
    base = "transformer.text_encoder"
    emb = te["embeddings"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out.sd[f"{base}.embeddings.{name}.weight"] = _t(
            emb[name]["embedding"])
    out.ln(f"{base}.embeddings.LayerNorm", emb["LayerNorm"])
    for (i,) in _layer_indices(te, r"layer_(\d+)"):
        t, p = f"{base}.encoder.layer.{i}", te[f"layer_{i}"]
        att = p["attention"]
        out.lin(f"{t}.attention.self.query", att["q_proj"])
        out.lin(f"{t}.attention.self.key", att["k_proj"])
        out.lin(f"{t}.attention.self.value", att["v_proj"])
        out.lin(f"{t}.attention.output.dense", att["out_proj"])
        out.ln(f"{t}.attention.output.LayerNorm", p["attention_norm"])
        out.lin(f"{t}.intermediate.dense", p["intermediate"])
        out.lin(f"{t}.output.dense", p["output"])
        out.ln(f"{t}.output.LayerNorm", p["output_norm"])
    if "pooler" in te:
        out.lin(f"{base}.pooler.dense", te["pooler"])


def jax_params_to_state_dict(params: Mapping[str, Any],
                             frozen: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """(params, {"frozen": ...}) as ``convert_torch_state_dict`` returns
    them (numpy or JAX arrays) -> reference-layout state dict of CPU
    tensors."""
    frozen = frozen["frozen"]
    out = _Out()
    if "backbone" in params:
        _backbone(out, params, frozen)
    out.conv("input_proj", params["input_proj"])
    out.sd["query_embed.weight"] = _t(params["query_embed"])
    out.lin("class_embed", params["class_embed"])
    for (i,) in _layer_indices(params["bbox_embed"], r"layer(\d+)"):
        out.lin(f"bbox_embed.layers.{i}", params["bbox_embed"][f"layer{i}"])
    for side in ("image", "text"):
        name = f"contrastive_align_projection_{side}"
        if name in params:
            out.lin(name, params[name])
    if "CLS" in params:
        out.sd["transformer.CLS.weight"] = _t(params["CLS"])
    if "learned_pos" in params:
        for name in ("row_embed", "col_embed"):
            out.sd[f"backbone.1.{name}.weight"] = _t(
                params["learned_pos"][name])

    enc = params["encoder"]
    for (i,) in _layer_indices(enc, r"layer_(\d+)"):
        t, p = f"transformer.encoder.layers.{i}", enc[f"layer_{i}"]
        out.mha(f"{t}.self_attn", p["self_attn"])
        out.lin(f"{t}.linear1", p["ffn"]["linear1"])
        out.lin(f"{t}.linear2", p["ffn"]["linear2"])
        out.ln(f"{t}.norm1", p["norm1"])
        out.ln(f"{t}.norm2", p["norm2"])
    dec = params["decoder"]
    out.ln("transformer.decoder.norm", dec["norm"])
    for (i,) in _layer_indices(dec, r"layer_(\d+)"):
        t, p = f"transformer.decoder.layers.{i}", dec[f"layer_{i}"]
        out.mha(f"{t}.self_attn", p["self_attn"])
        out.mha(f"{t}.cross_attn_image", p["cross_attn_image"])
        out.lin(f"{t}.linear1", p["ffn"]["linear1"])
        out.lin(f"{t}.linear2", p["ffn"]["linear2"])
        for n in ("norm1", "norm3", "norm4"):
            out.ln(f"{t}.{n}", p[n])
    out.lin("transformer.resizer.fc", params["resizer"]["fc"])
    out.ln("transformer.resizer.layer_norm", params["resizer"]["layer_norm"])
    _roberta(out, params["text_encoder"])

    if "bbox_attention" in params:
        for n in ("q_linear", "k_linear"):
            out.lin(f"bbox_attention.{n}", params["bbox_attention"][n])
    if "mask_head" in params:
        mh = params["mask_head"]
        for k in sorted(mh):
            if k.startswith("gn"):
                out.ln(f"mask_head.{k}", mh[k])
            else:
                out.conv(f"mask_head.{k}", mh[k])
    return out.sd


def load_reference_checkpoint(path: str, prefer_ema: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's weights as a state dict for
    ``TOIST.from_state_dict`` (``toist_tpu/utils/convert.py:225``):
    ``model_ema`` when asked for and present and non-empty, else ``model``;
    the DDP ``module.`` and DETRsegm ``detr.`` prefixes stripped. Loaded with
    ``weights_only=True``; a reference payload keeps its ``args`` as an
    ``argparse.Namespace``, the one class allowed besides."""
    import argparse

    torch.serialization.add_safe_globals([argparse.Namespace])
    payload = torch.load(path, map_location="cpu", weights_only=True)
    key = "model_ema" if (prefer_ema and payload.get("model_ema")) else "model"
    out = {}
    for k, v in payload[key].items():
        for pre in ("module.", "detr."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def cluster_bank_from_jax(bank: Any, device="cpu"):
    """The port's ``train/cluster.ClusterBank`` on ``device`` from a JAX
    ``toist_tpu.train.cluster.ClusterBank``, or any object with its four
    fields as arrays numpy reads (feature_bank [T, M, D] f32,
    cluster_centers [T, K, D] f32, update_count [T] int32, full [T] bool)."""
    from toist_tpu_torch.train.cluster import ClusterBank

    return ClusterBank(**{
        f.name: torch.from_numpy(np.array(getattr(bank, f.name))).to(device)
        for f in dataclasses.fields(ClusterBank)})


def synth_reference_state_dict(stage_sizes=(1, 1, 1, 1), enc=1, dec=1,
                               d=16, dim_feedforward=None, text_layers=1,
                               text_hidden=24, text_intermediate=None,
                               num_queries=100, vocab_size=50265,
                               num_logit_cols=256, contrastive=True,
                               contrastive_hdim=64, with_masks=True, seed=0):
    """A state_dict with the reference checkpoint's exact key layout, random
    values (reference main.py:641-652 `payload["model"]` keys as produced by
    `MDETR`/`MDETRsegm`, models/mdetr.py).

    Used by the parity pipeline's fixture dry-run (scripts/run_parity.py) and
    the conversion structure tests: everything downstream of the real data /
    checkpoint drop can be exercised hermetically against this layout.

    Values are random but NUMERICALLY PLAUSIBLE — fan-in-scaled weights,
    positive BN running_var, near-identity norm gains — so the dry-run can
    also TRAIN from the converted checkpoint (the distillation leg of
    run_parity.py runs real steps; unscaled N(0,1) weights blew activations
    up and a normal-distributed running_var is negative half the time, which
    is sqrt(<0) = NaN inside FrozenBatchNorm).
    """
    rng = np.random.default_rng(seed)
    ffn = dim_feedforward if dim_feedforward is not None else 4 * d
    tint = text_intermediate if text_intermediate is not None \
        else 4 * text_hidden
    sd = {}

    def add_lin(key, din, dout):
        sd[f"{key}.weight"] = rng.normal(
            scale=din ** -0.5, size=(dout, din)).astype(np.float32)
        sd[f"{key}.bias"] = rng.normal(
            scale=0.02, size=(dout,)).astype(np.float32)

    def add_conv(key, cin, cout, k, bias=False):
        sd[f"{key}.weight"] = rng.normal(
            scale=(cin * k * k) ** -0.5,
            size=(cout, cin, k, k)).astype(np.float32)
        if bias:
            sd[f"{key}.bias"] = rng.normal(
                scale=0.02, size=(cout,)).astype(np.float32)

    def add_bn(key, c):
        sd[f"{key}.weight"] = rng.uniform(0.5, 1.5, size=(c,)) \
            .astype(np.float32)
        sd[f"{key}.bias"] = rng.normal(scale=0.1, size=(c,)) \
            .astype(np.float32)
        sd[f"{key}.running_mean"] = rng.normal(scale=0.1, size=(c,)) \
            .astype(np.float32)
        sd[f"{key}.running_var"] = rng.uniform(0.5, 1.5, size=(c,)) \
            .astype(np.float32)

    def add_ln(key, c):
        sd[f"{key}.weight"] = rng.uniform(0.8, 1.2, size=(c,)) \
            .astype(np.float32)
        sd[f"{key}.bias"] = rng.normal(scale=0.02, size=(c,)) \
            .astype(np.float32)

    def add_mha(key, dm):
        sd[f"{key}.in_proj_weight"] = rng.normal(
            scale=dm ** -0.5, size=(3 * dm, dm)).astype(np.float32)
        sd[f"{key}.in_proj_bias"] = rng.normal(
            scale=0.02, size=(3 * dm,)).astype(np.float32)
        add_lin(f"{key}.out_proj", dm, dm)

    # Backbone (bottleneck ResNet; widths are architecture constants).
    base = "backbone.0.body"
    add_conv(f"{base}.conv1", 3, 64, 7)
    add_bn(f"{base}.bn1", 64)
    widths = (64, 128, 256, 512)
    cin = 64
    for s, blocks in enumerate(stage_sizes, start=1):
        w = widths[s - 1]
        for b in range(blocks):
            t = f"{base}.layer{s}.{b}"
            add_conv(f"{t}.conv1", cin, w, 1)
            add_bn(f"{t}.bn1", w)
            add_conv(f"{t}.conv2", w, w, 3)
            add_bn(f"{t}.bn2", w)
            add_conv(f"{t}.conv3", w, w * 4, 1)
            add_bn(f"{t}.bn3", w * 4)
            if b == 0:
                add_conv(f"{t}.downsample.0", cin, w * 4, 1)
                add_bn(f"{t}.downsample.1", w * 4)
            cin = w * 4

    # Heads.
    add_conv("input_proj", 2048, d, 1, bias=True)
    sd["query_embed.weight"] = rng.normal(
        scale=0.02, size=(num_queries, d)).astype(np.float32)
    add_lin("class_embed", d, num_logit_cols)
    for i in range(3):
        add_lin(f"bbox_embed.layers.{i}", d, 4 if i == 2 else d)
    if contrastive:
        add_lin("contrastive_align_projection_image", d, contrastive_hdim)
        add_lin("contrastive_align_projection_text", d, contrastive_hdim)

    # Joint transformer.
    for i in range(enc):
        t = f"transformer.encoder.layers.{i}"
        add_mha(f"{t}.self_attn", d)
        add_lin(f"{t}.linear1", d, ffn)
        add_lin(f"{t}.linear2", ffn, d)
        add_ln(f"{t}.norm1", d)
        add_ln(f"{t}.norm2", d)
    for i in range(dec):
        t = f"transformer.decoder.layers.{i}"
        add_mha(f"{t}.self_attn", d)
        add_mha(f"{t}.cross_attn_image", d)
        add_lin(f"{t}.linear1", d, ffn)
        add_lin(f"{t}.linear2", ffn, d)
        add_ln(f"{t}.norm1", d)
        add_ln(f"{t}.norm3", d)
        add_ln(f"{t}.norm4", d)
    add_ln("transformer.decoder.norm", d)
    add_lin("transformer.resizer.fc", text_hidden, d)
    add_ln("transformer.resizer.layer_norm", d)

    # RoBERTa text encoder.
    tb = "transformer.text_encoder"
    sd[f"{tb}.embeddings.word_embeddings.weight"] = rng.normal(
        scale=0.02, size=(vocab_size, text_hidden)).astype(np.float32)
    sd[f"{tb}.embeddings.position_embeddings.weight"] = rng.normal(
        scale=0.02, size=(514, text_hidden)).astype(np.float32)
    sd[f"{tb}.embeddings.token_type_embeddings.weight"] = rng.normal(
        scale=0.02, size=(1, text_hidden)).astype(np.float32)
    add_ln(f"{tb}.embeddings.LayerNorm", text_hidden)
    for i in range(text_layers):
        t = f"{tb}.encoder.layer.{i}"
        for part in ("query", "key", "value"):
            add_lin(f"{t}.attention.self.{part}", text_hidden, text_hidden)
        add_lin(f"{t}.attention.output.dense", text_hidden, text_hidden)
        add_ln(f"{t}.attention.output.LayerNorm", text_hidden)
        add_lin(f"{t}.intermediate.dense", text_hidden, tint)
        add_lin(f"{t}.output.dense", tint, text_hidden)
        add_ln(f"{t}.output.LayerNorm", text_hidden)

    if with_masks:
        add_lin("bbox_attention.q_linear", d, d)
        add_lin("bbox_attention.k_linear", d, d)
        # Mask head conv chain (cin/cout per reference MaskHeadSmallConv,
        # models/segmentation.py:30-51; nheads=8 attention maps concatenated).
        chain = [(d + 8, d + 8), (d + 8, d // 2), (d // 2, d // 4),
                 (d // 4, d // 8), (d // 8, d // 16)]
        for i, (ci, co) in enumerate(chain, start=1):
            add_conv(f"mask_head.lay{i}", ci, co, 3, bias=True)
            add_ln(f"mask_head.gn{i}", co)
        add_conv("mask_head.out_lay", d // 16, 1, 3, bias=True)
        for i, fc in enumerate((1024, 512, 256), start=1):
            add_conv(f"mask_head.adapter{i}",
                     fc, [d // 2, d // 4, d // 8][i - 1], 1, bias=True)
    return sd
