"""ResNet backbone with frozen BatchNorm, NCHW weights in channels_last.

Counterpart of ``toist_tpu/models/resnet.py`` with the reference checkpoint's
names (``conv1``, ``bn1``, ``layer{s}.{b}.conv{1,2,3}``, ``bn{1,2,3}``,
``downsample.{0,1}``). Only the frozen-BN variant is ported.

The JAX stem computes its 7x7 stride-2 conv through a 2x2 space-to-depth
rewrite, a TPU layout device with the same arithmetic; here it is the plain
conv. As in the JAX package (and unlike torchvision), the padded canvas
region is zeroed after the stem + max-pool and after every stage, which makes
the features invariant to how far a canvas is padded.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

STAGE_SIZES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
               "resnet18-test": (1, 1, 1, 1)}


class FrozenBatchNorm2d(nn.Module):
    """y = x * scale + shift from fixed statistics; scale = weight /
    sqrt(var + eps) with eps inside the root (reference backbone.py:52-58).
    scale and shift are computed in f32 and cast to x's dtype."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight.float() / torch.sqrt(self.running_var.float()
                                                 + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return (x * scale.to(x.dtype)[None, :, None, None]
                + shift.to(x.dtype)[None, :, None, None])


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride and dilation here) -> 1x1, x4 expansion."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, dilation, dilation)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = None
        if cin != width * 4 or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, width * 4, 1, stride),
                                            FrozenBatchNorm2d(width * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def downsample_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Image pad mask [B, H, W] bool -> feature-level mask [B, h, w] by
    nearest sampling at cell top-left corners; a strided slice on exact-
    stride canvases (all /32 buckets)."""
    B, H, W = mask.shape
    if H % h == 0 and W % w == 0:
        return mask[:, ::H // h, ::W // w]
    ys = (torch.arange(h, device=mask.device) * (H / h)).long()
    xs = (torch.arange(w, device=mask.device) * (W / w)).long()
    return mask[:, ys][:, :, xs]


class ResNet(nn.Module):
    """ResNet trunk returning {layer1..layer4} NCHW feature maps."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 23, 3),
                 dilation: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        widths = (64, 128, 256, 512)
        cin = 64
        for si, (blocks, width) in enumerate(zip(stage_sizes, widths)):
            last = si == len(stage_sizes) - 1
            stride = 1 if si == 0 or (last and dilation) else 2
            dil = 2 if (last and dilation) else 1
            layers = []
            for bi in range(blocks):
                layers.append(Bottleneck(cin, width,
                                         stride if bi == 0 else 1, dil))
                cin = width * 4
            self.add_module(f"layer{si + 1}", nn.Sequential(*layers))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x [B, 3, H, W]; pad_mask [B, H, W] bool (True = pad)."""
        def apply_mask(feat):
            if pad_mask is None:
                return feat
            keep = ~downsample_mask(pad_mask, feat.shape[2], feat.shape[3])
            return feat * keep[:, None].to(feat.dtype)

        x = F.relu(self.bn1(self.conv1(x)))
        x = apply_mask(F.max_pool2d(x, 3, stride=2, padding=1))
        feats = {}
        for si in range(self.num_stages):
            x = apply_mask(getattr(self, f"layer{si + 1}")(x))
            feats[f"layer{si + 1}"] = x
        return feats


class Backbone(nn.Module):
    """The reference's ``backbone.0``: a ResNet trunk under ``body``."""

    def __init__(self, name: str = "resnet101", dilation: bool = False,
                 norm: str = "frozen_bn"):
        super().__init__()
        if name not in STAGE_SIZES:
            raise ValueError(f"backbone {name!r} is not ported; supported: "
                             f"{sorted(STAGE_SIZES)}")
        if norm != "frozen_bn":
            raise NotImplementedError(
                f"backbone norm {norm!r} is not ported; only frozen_bn")
        self.body = ResNet(STAGE_SIZES[name], dilation)

    def forward(self, x, pad_mask=None):
        return self.body(x, pad_mask)
