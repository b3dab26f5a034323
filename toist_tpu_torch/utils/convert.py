"""JAX parameter tree -> the port's reference-layout state dict.

``jax_params_to_state_dict`` is the exact inverse of
``toist_tpu/utils/convert.py:convert_torch_state_dict``: it transposes Dense
and conv kernels back to torch's [out, in(, kh, kw)] layout, re-packs the
q/k/v projections into ``in_proj_weight`` / ``in_proj_bias``, and restores
the FrozenBN buffers and the Hugging Face RoBERTa names. A reference state
dict taken through both functions comes back bit for bit.
"""
from __future__ import annotations

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


def _backbone(out: _Out, params: Mapping, frozen: Mapping) -> None:
    base = "backbone.0.body"
    p, f = params["backbone"], frozen["backbone"]
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
