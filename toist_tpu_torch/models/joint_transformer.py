"""Joint cross-modal encoder and query decoder (batch-first).

Counterpart of ``toist_tpu/models/joint_transformer.py``, with the reference
names (``layers.{i}.self_attn``, ``cross_attn_image``, ``linear1``,
``linear2``, ``norm1..4``, ``decoder.norm``). Post-norm layers; the position
embedding is added to queries and keys only; the decoder returns every
layer's output through the shared final norm. In training mode the
attention probabilities, the FFN hidden layer and every residual branch are
dropped (``dropout_u8``) with randomness from the ``generator`` argument.

The LayerNorms here use eps 1e-6, flax's default, which the JAX package uses
(the reference's torch layers use 1e-5); the port follows the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from toist_tpu_torch.models.layers import (MultiheadAttention, active_rate,
                                           dropout_u8, ffn)

LN_EPS = 1e-6


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, key_padding_mask, generator=None):
        rate = active_rate(self, self.dropout, generator)
        q = k = src + pos
        src2 = self.self_attn(q, k, src, key_padding_mask, generator)
        src = self.norm1(src + dropout_u8(src2, rate, generator))
        src2 = ffn(src, self.linear1, self.linear2, rate, generator)
        return self.norm2(src + dropout_u8(src2, rate, generator))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.cross_attn_image = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, query_pos, pos, memory_key_padding_mask,
                generator=None):
        rate = active_rate(self, self.dropout, generator)
        q = k = tgt + query_pos
        tgt2 = self.self_attn(q, k, tgt, generator=generator)
        tgt = self.norm1(tgt + dropout_u8(tgt2, rate, generator))
        tgt2 = self.cross_attn_image(tgt + query_pos, memory + pos, memory,
                                     memory_key_padding_mask, generator)
        tgt = self.norm3(tgt + dropout_u8(tgt2, rate, generator))
        tgt2 = ffn(tgt, self.linear1, self.linear2, rate, generator)
        return self.norm4(tgt + dropout_u8(tgt2, rate, generator))


class JointEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_layers))

    def forward(self, src, pos, key_padding_mask, generator=None):
        for layer in self.layers:
            src = layer(src, pos, key_padding_mask, generator)
        return src


class QueryDecoder(nn.Module):
    """Returns stacked per-layer outputs [num_layers, B, Q, D], each through
    the shared final LayerNorm."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, query_pos, pos, memory_key_padding_mask,
                generator=None):
        intermediate = []
        for layer in self.layers:
            tgt = layer(tgt, memory, query_pos, pos, memory_key_padding_mask,
                        generator)
            intermediate.append(self.norm(tgt))
        return torch.stack(intermediate, dim=0)
