"""Fresh initialisation with the JAX package's distributions.

``init_like_jax`` gives every parameter of a ``TOIST`` the distribution that
flax gives its counterpart in ``toist_tpu`` (a from-scratch run starts from
it; the values themselves cannot match JAX's random streams):

- every ``nn.Dense`` / ``nn.Conv`` kernel (here ``nn.Linear``, ``nn.Conv2d``,
  the packed q/k/v ``in_proj_weight``): ``lecun_normal``, a normal truncated
  at two standard deviations and rescaled so that its std is
  1 / sqrt(fan_in); biases zero (``toist_tpu/models/layers.py``,
  ``resnet.py``);
- ``CLS`` and ``query_embed``: ``normal(1.0)`` (``models/toist.py:84,119``);
- RoBERTa's embedding tables: flax ``Embed``'s default, a normal of std
  1 / sqrt(features);
- the learned position tables: ``uniform`` on [0, 1)
  (``models/position_encoding.py:54``);
- LayerNorm / GroupNorm: scale ones, bias zeros; FrozenBN statistics: weight
  and running_var ones, bias and running_mean zeros (``resnet.py:36-37``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from toist_tpu_torch.models.layers import MultiheadAttention
from toist_tpu_torch.models.position_encoding import LearnedPositionEmbedding2D
from toist_tpu_torch.models.resnet import FrozenBatchNorm2d
from toist_tpu_torch.models.text_encoder import RobertaEmbeddings

# std of a standard normal truncated to (-2, 2) (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_like_jax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise ``model`` in place (f32 parameters on the generator's
    device) with flax's distributions; returns it."""
    g = generator
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            # q, k and v are three Dense layers of fan_in embed_dim in JAX.
            lecun_normal_(m.in_proj_weight, m.embed_dim, g)
            m.in_proj_bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, RobertaEmbeddings):
            for e in (m.word_embeddings, m.position_embeddings,
                      m.token_type_embeddings):
                e.weight.normal_(0.0, 1.0 / math.sqrt(e.weight.shape[1]),
                                 generator=g)
        elif isinstance(m, LearnedPositionEmbedding2D):
            m.row_embed.weight.uniform_(0.0, 1.0, generator=g)
            m.col_embed.weight.uniform_(0.0, 1.0, generator=g)
    model.query_embed.weight.normal_(0.0, 1.0, generator=g)
    if model.transformer.CLS is not None:
        model.transformer.CLS.weight.normal_(0.0, 1.0, generator=g)
    return model
