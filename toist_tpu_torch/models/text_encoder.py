"""RoBERTa text encoder (batch-first), with Hugging Face's parameter names.

Counterpart of ``toist_tpu/models/text_encoder.py``: learned byte-BPE
embeddings, padding-offset position ids (``cumsum(mask) * mask + pad_id``),
post-norm blocks with exact GELU, LayerNorm eps 1e-5. Its attention runs the
plain path: the JAX package leaves RoBERTa's attention unfused. In training
mode the embeddings, the attention output and the FFN output drop as flax's
``nn.Dropout`` does in the JAX module (``dropout_exact``: keep probability
exactly 1 - rate, scale 1 / (1 - rate)); the attention probabilities drop
with ``dropout_u8`` (keep 230/256 at rate 0.1), as JAX's ``_dropout_u8``
does there. Under tensor parallelism (``parallel/tp.py``) a layer's
attention (``tp_attn``) and FFN (``tp_ffn``) run on this rank's shard: q, k,
v and the intermediate dense column-parallel, the two output denses
row-parallel; the probabilities' mask is drawn over all heads and sliced.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from toist_tpu_torch.models.layers import active_rate, dropout_exact
from toist_tpu_torch.ops.flash_attention import (attention_keep,
                                                 attention_plain)
from toist_tpu_torch.parallel import tp


class RobertaEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_position: int = 514,
                 pad_id: int = 1, dropout: float = 0.1):
        super().__init__()
        self.pad_id = pad_id
        self.dropout = dropout
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_position, hidden)
        self.token_type_embeddings = nn.Embedding(1, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-5)

    def forward(self, input_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = (input_ids != self.pad_id).long()
        position_ids = torch.cumsum(mask, dim=1) * mask + self.pad_id
        x = self.word_embeddings(input_ids)
        x = x + self.position_embeddings(position_ids)
        x = x + self.token_type_embeddings(torch.zeros_like(input_ids))
        return dropout_exact(self.LayerNorm(x),
                             active_rate(self, self.dropout, generator),
                             generator)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _Output(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.dense = nn.Linear(din, dout)
        self.LayerNorm = nn.LayerNorm(dout, eps=1e-5)


class _Attention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.self = _SelfAttention(hidden)
        self.output = _Output(hidden, hidden)


class _Intermediate(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.dense = nn.Linear(hidden, intermediate)


class RobertaLayer(nn.Module):
    def __init__(self, hidden: int, num_heads: int, intermediate: int,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.attention = _Attention(hidden)
        self.intermediate = _Intermediate(hidden, intermediate)
        self.output = _Output(intermediate, hidden)
        self.tp_attn: Optional[tp.Shard] = None
        self.tp_ffn: Optional[tp.Shard] = None

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = active_rate(self, self.dropout, generator)
        sa = self.attention.self
        xa = x if self.tp_attn is None else tp.copy_to_model(x)[0]
        q, k = sa.query(xa), sa.key(xa)
        keep = tp.local_keep(attention_keep(q, k, self.num_heads, rate,
                                            generator), self.tp_attn, 1)
        attn, _ = attention_plain(q, k, sa.value(xa), key_padding_mask,
                                  tp.local_heads(self.num_heads,
                                                 self.tp_attn), keep, rate)
        out = self.attention.output
        dense = (out.dense(attn) if self.tp_attn is None
                 else tp.row_linear(attn, out.dense))
        x = out.LayerNorm(x + dropout_exact(dense, rate, generator))
        xf = x if self.tp_ffn is None else tp.copy_to_model(x)[0]
        h = F.gelu(self.intermediate.dense(xf))
        dense = (self.output.dense(h) if self.tp_ffn is None
                 else tp.row_linear(h, self.output.dense))
        return self.output.LayerNorm(x + dropout_exact(dense, rate,
                                                       generator))


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class _Pooler(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)


class RobertaEncoder(nn.Module):
    """input_ids [B, T] (+ pad mask, True = pad) -> last hidden state
    [B, T, hidden]; with ``add_pooler`` also tanh(dense(hidden[:, 0]))."""

    def __init__(self, vocab_size: int = 50265, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position: int = 514,
                 pad_id: int = 1, dropout: float = 0.1,
                 add_pooler: bool = False):
        super().__init__()
        self.pad_id = pad_id
        self.embeddings = RobertaEmbeddings(vocab_size, hidden_size,
                                            max_position, pad_id, dropout)
        self.encoder = _Encoder(
            RobertaLayer(hidden_size, num_heads, intermediate_size, dropout)
            for _ in range(num_layers))
        self.pooler = _Pooler(hidden_size) if add_pooler else None

    def forward(self, input_ids: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        if key_padding_mask is None:
            key_padding_mask = input_ids == self.pad_id
        x = self.embeddings(input_ids, generator)
        for layer in self.encoder.layer:
            x = layer(x, key_padding_mask, generator)
        if self.pooler is not None:
            return x, torch.tanh(self.pooler.dense(x[:, 0]))
        return x
