"""EfficientNet-B0..B5 backbones (the reference's ``timm_*`` TimmBackbone).

Counterpart of ``toist_tpu/models/efficientnet.py``: the trunk with frozen
BatchNorm (or GroupNorm with gcd(C, 32) groups, eps 1e-6), emitting
{layer1..layer4} at strides 4/8/16/32 under ``models/resnet.ResNet``'s
contract (per-stage pad masking, so the features do not depend on how far
a canvas is padded). NCHW here, NHWC in JAX.

Parameter names are timm's, under ``backbone.0.body.`` as the reference's
TimmBackbone names them: ``conv_stem``, ``bn1``, and per block
``blocks.S.B``: an InvertedResidual (expansion > 1) holds ``conv_pw`` (the
expansion), ``bn1``, ``conv_dw``, ``bn2``, ``se.conv_reduce``,
``se.conv_expand``, ``conv_pwl`` (the projection), ``bn3``; stage 0's
DepthwiseSeparable blocks hold ``conv_dw``, ``bn1``, ``se.*``, ``conv_pw``
(the projection), ``bn2``. So a timm state dict loads by a prefix alone
(``utils/pretrained.py``); the JAX package names stage 0's projection
``conv_pwl``.

As in JAX: the depthwise conv pads symmetrically by k // 2 (timm's ``tf_``
variants pad TF-"same" and use BN eps 1e-3; ROADMAP queue C), the padded
region is zeroed before each depthwise conv, and squeeze-excite pools over
the valid pixels (the keep mask strided as JAX's ``valid[:, ::s, ::s]``,
cropped). The pooled sums and the pixel counts are f32 here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from toist_tpu_torch.models.layers import remat, remat_active
from toist_tpu_torch.models.resnet import FrozenBatchNorm2d, downsample_mask

# Base (B0) stage table: (expand_ratio, kernel, stride, out_channels,
# repeats), the EfficientNet paper's table 1 / timm's efficientnet_b0.
_B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

# (width_mult, depth_mult) per variant (compound scaling).
_VARIANTS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
    "b3": (1.2, 1.4), "b4": (1.4, 1.8), "b5": (1.6, 2.2),
}

# The stage after which each feature level is tapped (timm features_only,
# out_indices=(1, 2, 3, 4)): the last stage at each stride 4/8/16/32.
_TAPS = {2: "layer1", 3: "layer2", 5: "layer3", 7: "layer4"}


def _round_filters(f: int, width_mult: float, divisor: int = 8) -> int:
    f = f * width_mult
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def _norm(norm: str, n: int) -> nn.Module:
    """FrozenBN, or GroupNorm with the largest power-of-two group count
    that divides n (gcd with 32), flax's eps."""
    if norm == "frozen_bn":
        return FrozenBatchNorm2d(n)
    if norm == "group_norm":
        return nn.GroupNorm(math.gcd(n, 32), n, eps=1e-6)
    raise ValueError(f"backbone norm {norm!r}; supported: frozen_bn, "
                     f"group_norm")


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, channels, 1)

    def forward(self, h: torch.Tensor, valid: Optional[torch.Tensor],
                stride: int) -> torch.Tensor:
        """h [B, C, H, W]; valid: the block input's keep mask [B, 1, h, w]
        (1 = real pixel) or None."""
        if valid is None:
            pooled = h.float().mean(dim=(2, 3), keepdim=True)
        else:
            vh = valid[:, :, ::stride, ::stride][:, :, :h.shape[2],
                                                 :h.shape[3]].float()
            denom = vh.sum(dim=(2, 3), keepdim=True).clamp(min=1.0)
            pooled = (h.float() * vh).sum(dim=(2, 3), keepdim=True) / denom
        se = F.silu(self.conv_reduce(pooled.to(h.dtype)))
        return h * torch.sigmoid(self.conv_expand(se))


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite: expand 1x1 (when the
    ratio is not 1) -> depthwise kxk (the stride) -> SE over in_ch // 4 ->
    project 1x1; the residual when the shapes match."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int,
                 stride: int, norm: str = "frozen_bn"):
        super().__init__()
        mid = in_ch * expand
        self.stride = stride
        self.residual = stride == 1 and in_ch == out_ch
        dw = nn.Conv2d(mid, mid, kernel, stride=stride, padding=kernel // 2,
                       groups=mid, bias=False)
        se = SqueezeExcite(mid, max(1, in_ch // 4))
        proj = nn.Conv2d(mid, out_ch, 1, bias=False)
        if expand != 1:                          # timm's InvertedResidual
            self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
            self.bn1 = _norm(norm, mid)
            self.conv_dw, self.bn2, self.se = dw, _norm(norm, mid), se
            self.conv_pwl, self.bn3 = proj, _norm(norm, out_ch)
            self._names = ("conv_pw", "bn1", "conv_dw", "bn2", "conv_pwl",
                           "bn3")
        else:                                    # timm's DepthwiseSeparable
            self.conv_dw, self.bn1, self.se = dw, _norm(norm, mid), se
            self.conv_pw, self.bn2 = proj, _norm(norm, out_ch)
            self._names = (None, None, "conv_dw", "bn1", "conv_pw", "bn2")

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, H, W]; valid [B, 1, H, W] in x's dtype (1 = real)."""
        pw, bn_pw, dw, bn_dw, proj, bn_proj = (
            getattr(self, n) if n else None for n in self._names)
        h = x
        if pw is not None:
            h = F.silu(bn_pw(pw(h)))
        # The depthwise conv is the only op with a spatial receptive field:
        # zero the padded region first (exact canvas invariance).
        if valid is not None:
            h = h * valid
        h = F.silu(bn_dw(dw(h)))
        h = self.se(h, valid, self.stride)
        h = bn_proj(proj(h))
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    """The trunk, {layer1..layer4} NCHW; ``pad_mask`` [B, H, W] bool (True
    = pad) zeroes the padded region after the stem and after every tap."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 norm: str = "frozen_bn", remat: bool = False):
        super().__init__()
        self.remat = remat
        stem = _round_filters(32, width_mult)
        self.conv_stem = nn.Conv2d(3, stem, 3, stride=2, padding=1,
                                   bias=False)
        self.bn1 = _norm(norm, stem)
        in_ch, stages, self.channels = stem, [], {}
        for si, (exp, k, s, ch, reps) in enumerate(_B0_STAGES, start=1):
            out_ch = _round_filters(ch, width_mult)
            blocks = []
            for bi in range(_round_repeats(reps, depth_mult)):
                blocks.append(MBConv(in_ch, out_ch, exp, k,
                                     s if bi == 0 else 1, norm))
                in_ch = out_ch
            stages.append(nn.Sequential(*blocks))
            if si in _TAPS:
                self.channels[_TAPS[si]] = out_ch
        self.blocks = nn.Sequential(*stages)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        def keep(feat):
            if pad_mask is None:
                return None
            k = ~downsample_mask(pad_mask, feat.shape[2], feat.shape[3])
            return k[:, None].to(feat.dtype)

        def apply_mask(feat):
            k = keep(feat)
            return feat if k is None else feat * k

        x = apply_mask(F.silu(self.bn1(self.conv_stem(x))))
        feats = {}
        for si, stage in enumerate(self.blocks, start=1):
            for block in stage:
                if remat_active(self, self.remat):
                    x = remat(block, None, x, keep(x))
                else:
                    x = block(x, keep(x))
            if si in _TAPS:
                x = apply_mask(x)
                feats[_TAPS[si]] = x
        return feats


def efficientnet_num_channels(variant: str) -> int:
    """Channels of the stride-32 feature (timm feature_info.channels()[-1])."""
    w, _ = _VARIANTS[variant]
    return _round_filters(320, w)


def parse_timm_efficientnet(name: str) -> Optional[str]:
    """'timm_tf_efficientnet_b3_ns' / 'timm_efficientnet_b0' -> 'b3' / 'b0';
    None if the name is not an EfficientNet this module covers."""
    base = name[len("timm_"):] if name.startswith("timm_") else name
    for tok in base.split("_"):
        if tok in _VARIANTS:
            return tok
    return None


def make_efficientnet(variant: str, norm: str = "frozen_bn",
                      remat: bool = False) -> EfficientNet:
    w, d = _VARIANTS[variant]
    return EfficientNet(width_mult=w, depth_mult=d, norm=norm, remat=remat)
