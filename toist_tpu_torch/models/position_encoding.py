"""2-D position embeddings: sine (default) and learned.

Counterpart of ``toist_tpu/models/position_encoding.py``. Both return
channels-last [B, H, W, D], the JAX layout.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def sine_position_embedding(pad_mask: torch.Tensor, num_pos_feats: int = 128,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: float = 2 * math.pi,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """pad_mask: [B, H, W] bool, True on PADDING. Output
    [B, H, W, 2*num_pos_feats]: cumulative sums of the valid-pixel mask per
    axis, normalized to [0, scale], sin/cos interleaved, [y; x] channels."""
    not_mask = (~pad_mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=pad_mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)

    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


class SinePositionEmbedding(nn.Module):
    """Parameter-free module slot ``backbone.1`` for the sine variant."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.num_pos_feats = num_pos_feats

    def forward(self, fmask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return sine_position_embedding(fmask, self.num_pos_feats, dtype=dtype)


class LearnedPositionEmbedding2D(nn.Module):
    """50x50 row/col tables; pos[h, w] = [col_embed[w]; row_embed[h]] (x
    features first, unlike the sine variant). Reference names
    ``backbone.1.row_embed.weight`` / ``backbone.1.col_embed.weight``."""

    def __init__(self, num_pos_feats: int = 128, table_size: int = 50):
        super().__init__()
        self.row_embed = nn.Embedding(table_size, num_pos_feats)
        self.col_embed = nn.Embedding(table_size, num_pos_feats)
        nn.init.uniform_(self.row_embed.weight)
        nn.init.uniform_(self.col_embed.weight)

    def forward(self, fmask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, h, w = fmask.shape
        F = self.row_embed.weight.shape[1]
        x_emb = self.col_embed.weight[:w][None, :, :].expand(h, w, F)
        y_emb = self.row_embed.weight[:h][:, None, :].expand(h, w, F)
        pos = torch.cat([x_emb, y_emb], dim=-1)
        return pos[None].expand(B, h, w, 2 * F).to(dtype)
