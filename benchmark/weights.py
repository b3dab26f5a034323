"""Random weights from the seed, made on the device in the reference layout.

Two draws over the whole model (one normal, one uniform) from one
``torch.Generator`` on the card, then one affine per tensor by its kind
(``reference.toist.param_spec``): fan-in scaled normal kernels, small
biases, frozen-BatchNorm statistics near the identity (gains and variances
uniform on [0.5, 1.5]), LayerNorm gains on [0.8, 1.2], embedding tables of
std 1 / sqrt(width), standard normal queries. The gain that closes each
bottleneck's residual branch is uniform on [0, 0.2], as residual branches
start small in a trained or zero-initialised ResNet: with gains near 1 the
33 blocks of ResNet-101 amplify rounding so far that bf16 and float8
answers differ from f32 by nearly as much (measured on the H100, PERF.md).
The same dict goes to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# kind -> (source, scale, shift) with value = source * scale + shift;
# scale None means fan-in scaling, "emb" one over the root of the width.
_KINDS = {
    "w": ("n", None, 0.0), "b": ("n", 0.02, 0.0),
    "bn_w": ("u", 1.0, 0.5), "bn_branch": ("u", 0.2, 0.0),
    "bn_b": ("n", 0.1, 0.0),
    "bn_mean": ("n", 0.1, 0.0), "bn_var": ("u", 1.0, 0.5),
    "ln_w": ("u", 0.4, 0.8), "ln_b": ("n", 0.02, 0.0),
    "emb": ("n", "emb", 0.0), "query": ("n", 1.0, 0.0),
}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


@torch.no_grad()
def make_weights(spec: List[Tuple[str, Tuple[int, ...], str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{key: f32 tensor on ``device``} for every (key, shape, kind) of
    ``spec``, drawn from ``seed``; the tensors are views of one buffer."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    total = sum(sizes)
    g = generator(seed, device)
    buf = torch.randn(total, generator=g, device=device)
    uni = torch.rand(total, generator=g, device=device)
    out, off = {}, 0
    for (key, shape, kind), n in zip(spec, sizes):
        source, scale, shift = _KINDS[kind]
        if scale is None:
            scale = 1.0 / math.sqrt(math.prod(shape[1:]))
        elif scale == "emb":
            scale = 1.0 / math.sqrt(shape[-1])
        dst = buf[off:off + n]
        if source == "u":
            dst.copy_(uni[off:off + n])
        dst.mul_(scale).add_(shift)
        out[key] = dst.view(shape)
        off += n
    return out
