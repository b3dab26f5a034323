"""Shared transformer building blocks (batch-first [B, S, D]).

Counterpart of ``toist_tpu/models/layers.py``, with the reference
checkpoint's parameter layout: ``MultiheadAttention`` keeps torch's packed
``in_proj_weight`` / ``in_proj_bias`` and ``out_proj``.

Dropout is ``dropout_u8``, the JAX package's ``_dropout_u8``: it acts only in
``.train()`` mode, and there it takes its randomness from the
``torch.Generator`` that the training step seeds per step (the counterpart of
``make_dropout_rng``) and passes down every forward as ``generator``.

``remat`` is ``nn.remat``: a block's activations are recomputed in the
backward (``torch.utils.checkpoint``), with the generator put back to its
state before the block, so that the recomputation draws the same dropout
bits. Under tensor parallelism (``parallel/tp.py``) a module whose
``tp_shard`` is set holds its shard of the weights and calls the model
group's collectives.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from toist_tpu_torch.ops.flash_attention import (attention_keep,
                                                 attention_plain, drop_scale,
                                                 drop_threshold,
                                                 flash_attention, random_keep)
from toist_tpu_torch.parallel import tp

# Minimum key length for the fused kernel (toist_tpu/models/layers.py): the
# decoder's 100-key self-attention stays on the plain path.
FUSED_MIN_KV = 256


def active_rate(module: nn.Module, rate: float,
                generator: Optional[torch.Generator]) -> float:
    """The dropout rate ``module`` applies now: ``rate`` in training mode
    (which then needs a generator), 0 in eval mode."""
    if not module.training or drop_threshold(rate) == 0:
        return 0.0
    if generator is None:
        raise ValueError(f"{type(module).__name__}: training-mode dropout "
                         f"(rate {rate}) needs a generator")
    return rate


def dropout_u8(x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator],
               shard: Optional[tp.Shard] = None) -> torch.Tensor:
    """``_dropout_u8`` (toist_tpu/models/layers.py:20-43): 8 random bits per
    element from ``generator``, keep iff bits >= q = min(round(rate * 256),
    255), kept values scaled by 1 / (1 - q/256). Rate 0 is the identity.
    ``shard``: x is this rank's slice of the last dim; the bits are drawn
    for the whole tensor and sliced (``tp.local_keep``)."""
    q = drop_threshold(rate)
    if q == 0:
        return x
    shape = x.shape if shard is None else (*x.shape[:-1],
                                           x.shape[-1] * shard[1])
    keep = tp.local_keep(random_keep(shape, q, generator), shard, -1)
    return torch.where(keep, x * drop_scale(q), x.new_zeros(()))


def remat(block: Callable, generator: Optional[torch.Generator], *args):
    """``block(*args)`` whose activations are recomputed in the backward
    (flax ``nn.remat``): ``torch.utils.checkpoint`` restores the global RNGs
    only, so the ``generator`` (which the block's dropout and the
    attention kernels' seeds draw from) is put back to its state before the
    block for the recomputation, and to its later state after it."""
    from torch.utils.checkpoint import checkpoint

    if generator is None:
        return checkpoint(block, *args, use_reentrant=False)
    before = generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:                        # the forward
            return block(*a)
        after = generator.get_state()            # the recomputation
        generator.set_state(before)
        try:
            return block(*a)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)


def remat_active(module: nn.Module, on: bool) -> bool:
    """Whether ``module`` recomputes now: remat on, training, and a graph
    being built."""
    return on and module.training and torch.is_grad_enabled()


def dropout_exact(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep iff a uniform draw from ``generator`` is >=
    ``rate`` (keep probability exactly 1 - rate), kept values scaled by
    1 / (1 - rate). Rate 0 is the identity."""
    if rate == 0.0:
        return x
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    return torch.where(u >= rate, x / (1.0 - rate), x.new_zeros(()))


class MultiheadAttention(nn.Module):
    """q/k/v projections -> scaled dot-product -> out projection, with a key
    padding mask (True = pad).

    With ``fused`` True (the default) and at least ``FUSED_MIN_KV`` keys, the
    core goes through ``flash_attention``: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. ``fused = False`` is the oracle
    switch: it forces the plain version on any device (see
    ``set_fused_attention``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.fused = True
        self.tp_shard: Optional[tp.Shard] = None
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """query [B,Q,D], key/value [B,S,D], key_padding_mask [B,S]; in
        training mode the probabilities are dropped with randomness from
        ``generator``."""
        rate = active_rate(self, self.dropout, generator)
        shard = self.tp_shard
        heads = tp.local_heads(self.num_heads, shard)
        if shard is not None:
            query, key, value = tp.copy_to_model(query, key, value)
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        q = F.linear(query, w_q, b_q)
        k = F.linear(key, w_k, b_k)
        v = F.linear(value, w_v, b_v)
        if self.fused and k.shape[1] >= FUSED_MIN_KV:
            out, _ = flash_attention(q, k, v, key_padding_mask, heads, rate,
                                     generator, shard)
        else:
            keep = tp.local_keep(attention_keep(q, k, self.num_heads, rate,
                                                generator), shard, 1)
            out, _ = attention_plain(q, k, v, key_padding_mask, heads, keep,
                                     rate)
        if shard is not None:
            return tp.row_linear(out, self.out_proj)
        return self.out_proj(out)


def set_fused_attention(model: nn.Module, fused: bool) -> None:
    """Route every MultiheadAttention of ``model`` through the kernel
    wrapper (True) or force the plain version (False)."""
    for m in model.modules():
        if isinstance(m, MultiheadAttention):
            m.fused = fused


def ffn(x: torch.Tensor, linear1: nn.Linear, linear2: nn.Linear,
        rate: float = 0.0, generator: Optional[torch.Generator] = None,
        shard: Optional[tp.Shard] = None) -> torch.Tensor:
    """linear1 -> relu -> dropout -> linear2 (toist_tpu FFN). The reference
    keeps the two linears directly on each transformer layer, so in the port
    the FFN is this function over the layer's own ``linear1`` / ``linear2``;
    ``rate`` is the layer's active rate (``active_rate``). With ``shard``
    linear1 is column- and linear2 row-parallel."""
    if shard is None:
        return linear2(dropout_u8(F.relu(linear1(x)), rate, generator))
    (x,) = tp.copy_to_model(x)
    h = dropout_u8(F.relu(linear1(x)), rate, generator, shard)
    return tp.row_linear(h, linear2)


class MLP(nn.Module):
    """Simple multi-layer perceptron (reference mdetr.py MLP head)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims_in, dims_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FeatureResizer(nn.Module):
    """Linear + LayerNorm(eps 1e-12) + dropout (reference
    transformer.py:473-492)."""

    def __init__(self, input_dim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.fc = nn.Linear(input_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout_u8(self.layer_norm(self.fc(x)),
                          active_rate(self, self.dropout, generator),
                          generator)
