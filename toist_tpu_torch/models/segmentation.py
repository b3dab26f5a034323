"""Segmentation head: per-query attention maps and the FPN conv mask head.

Counterpart of ``toist_tpu/models/segmentation.py`` (reference
models/segmentation.py):

- ``MHAttentionMap``: the multi-head attention *weights* (no value product)
  of the decoder outputs over the post-encoder image memory, softmax over
  the pixels;
- ``MaskHeadSmallConv``: conv / GroupNorm / ReLU stages fusing the C4/C3/C2
  backbone features with nearest upsampling, one stride-4 logit map per
  query. NCHW here (the JAX package's is NHWC).

The upsampling is the reference's ``F.interpolate(mode="nearest")`` to the
finer grid's size. On the canvases whose sides are multiples of 32 that is
the JAX package's integer-factor repeat; on the (608, 1008) training rung
of ``batcher.train_buckets`` (stride 16: 63 columns, stride 32: 32) the JAX
package's repeat cannot reach 63 and fails, where this one follows the
reference.

The JAX package also keeps "folded" variants of the head (queries folded
into channels, ``model.mask_head_layout`` folded / folded_shifts). They
compute the same function on the same parameter tree
(``tests/test_segmentation.py``), so the port builds this flat head for
every layout: a folded checkpoint loads into it unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Fill for padded pixels (toist_tpu/models/layers.py NEG_INF): finite, so a
# fully padded sample's softmax stays uniform rather than NaN.
NEG_INF = -1e9
GN_GROUPS = 8
GN_EPS = 1e-6            # flax GroupNorm's default (torch's reference: 1e-5)


class MHAttentionMap(nn.Module):
    """q [B,N,D], k [B,H,W,D] -> softmax attention maps [B,N,heads,H,W].

    q_linear / k_linear run in the parameters' dtype (the compute dtype
    after ``TOIST.to_compute_dtype``), q is scaled by hd^-0.5 there; the
    logits and the softmax are f32, the maps are cast back."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = nn.Linear(hidden_dim, hidden_dim)
        self.k_linear = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.q_linear.weight.dtype
        q = self.q_linear(q.to(dt))
        k = self.k_linear(k.to(dt))
        B, N, D = q.shape
        H, W = k.shape[1], k.shape[2]
        nh = self.num_heads
        hd = D // nh
        qh = q.reshape(B, N, nh, hd) * (hd ** -0.5)
        kh = k.reshape(B, H, W, nh, hd)
        w = torch.einsum("bnhc,byxhc->bnhyx", qh.float(), kh.float())
        if pad_mask is not None:
            w = w.masked_fill(pad_mask[:, None, None, :, :], NEG_INF)
        w = torch.softmax(w.reshape(B, N, nh, H * W), dim=-1)
        return w.reshape(B, N, nh, H, W).to(dt)


class MaskHeadSmallConv(nn.Module):
    """FPN-style conv head (reference segmentation.py:170-241), NCHW.

    Input: the per-query stack [B*N, dim, h32, w32] (b-major blocks of N
    queries) and the backbone features C4/C3/C2 [B, c, h, w] (strides
    16/8/4). Output [B*N, 1, h4, w4] f32 logits: ``out_lay`` stays f32 when
    the rest of the head is cast to the compute dtype."""

    def __init__(self, dim: int, context_dim: int,
                 fpn_dims: Sequence[int] = (1024, 512, 256)):
        super().__init__()
        cd = context_dim
        inter = [dim, cd // 2, cd // 4, cd // 8, cd // 16]
        cins = [dim] + inter[:4]
        for i, (ci, co) in enumerate(zip(cins, inter), start=1):
            setattr(self, f"lay{i}", nn.Conv2d(ci, co, 3, padding=1))
            setattr(self, f"gn{i}", nn.GroupNorm(GN_GROUPS, co, eps=GN_EPS))
        self.out_lay = nn.Conv2d(inter[4], 1, 3, padding=1)
        # C4 / C3 / C2: the backbone's layer3 / layer2 / layer1 (ResNet:
        # 1024, 512, 256; EfficientNet-B3: 136, 48, 32), whose widths flax
        # infers in JAX.
        self.adapter1 = nn.Conv2d(fpn_dims[0], inter[1], 1)
        self.adapter2 = nn.Conv2d(fpn_dims[1], inter[2], 1)
        self.adapter3 = nn.Conv2d(fpn_dims[2], inter[3], 1)

    def _stage(self, x: torch.Tensor, i: int) -> torch.Tensor:
        x = getattr(self, f"lay{i}")(x)
        return F.relu(getattr(self, f"gn{i}")(x))

    @staticmethod
    def _fuse(x: torch.Tensor, adapter: nn.Module, feat: torch.Tensor,
              num_queries: int) -> torch.Tensor:
        """adapter(feat) expanded to the queries (``jnp.repeat``: b-major
        blocks) plus x upsampled (nearest) to its grid."""
        a = adapter(feat.to(adapter.weight.dtype)).repeat_interleave(
            num_queries, dim=0)
        return a + F.interpolate(x, size=a.shape[2:], mode="nearest")

    def forward(self, x: torch.Tensor, fpn_c4: torch.Tensor,
                fpn_c3: torch.Tensor, fpn_c2: torch.Tensor,
                num_queries: int) -> torch.Tensor:
        x = x.to(self.lay1.weight.dtype)
        x = self._stage(self._stage(x, 1), 2)
        x = self._stage(self._fuse(x, self.adapter1, fpn_c4, num_queries), 3)
        x = self._stage(self._fuse(x, self.adapter2, fpn_c3, num_queries), 4)
        x = self._stage(self._fuse(x, self.adapter3, fpn_c2, num_queries), 5)
        return self.out_lay(x.to(self.out_lay.weight.dtype))
