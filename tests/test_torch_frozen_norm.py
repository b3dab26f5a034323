"""The frozen-norm epilogue op (``ops/frozen_norm.py``) on the CPU.

Its plain route must be the trunk's former module composition bit for bit:
``relu(bn(z))``, ``relu(bn3(z) + residual)`` with the residual an identity
or the downsample convolution's norm, then the stage's pad mask as a
multiply, forward and gradients, in f32 and bf16. The whole frozen-norm
ResNet is held to that composition too (with and without ``remat``), its
``state_dict`` names are the reference checkpoint's, and the kernel's pad
mask index rule (``mask_scale``) picks the pixels ``downsample_mask`` picks.
The kernel itself is tested on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from toist_tpu_torch.models.resnet import (Backbone, FrozenBatchNorm2d,
                                           downsample_mask)
from toist_tpu_torch.ops.frozen_norm import (frozen_norm, frozen_norm_plain,
                                             mask_scale)

DTYPES = [torch.float32, torch.bfloat16]


def _norm(c, g, dtype):
    """A FrozenBatchNorm2d with random buffers (variance positive)."""
    n = FrozenBatchNorm2d(c)
    n.weight.copy_(torch.rand(c, generator=g) + 0.5)
    n.bias.copy_(torch.randn(c, generator=g) * 0.3)
    n.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
    n.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.1)
    return n.to(dtype)


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


def _before(z, bn, residual=None, ds=None, pad_mask=None):
    """The trunk's composition before the op: Bottleneck.forward's
    ``F.relu(self.bnX(...))`` / ``F.relu(out + residual)`` and
    ResNet.forward's ``apply_mask``."""
    out = bn(z)
    if ds is not None:
        residual = ds[1](ds[0])
    out = F.relu(out if residual is None else out + residual)
    if pad_mask is not None:
        keep = ~downsample_mask(pad_mask, out.shape[2], out.shape[3])
        out = out * keep[:, None].to(out.dtype)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["relu", "residual", "residual_mask",
                                  "downsample_mask"])
def test_plain_route_equals_the_module_composition(form, dtype):
    g = torch.Generator().manual_seed(0)
    c = 64 if form == "relu" else 256
    z = _channels_last(torch.randn(2, c, 13, 11, generator=g)).to(dtype)
    other = _channels_last(torch.randn(2, c, 13, 11, generator=g)).to(dtype)
    bn, bn_ds = _norm(c, g, dtype), _norm(c, g, dtype)
    mask = None
    if form.endswith("mask"):
        # An inexact stride: 50 / 13 and 41 / 11 take downsample_mask's
        # arange path.
        mask = torch.zeros(2, 50, 41, dtype=torch.bool)
        mask[1, 30:] = True
        mask[1, :, 25:] = True
    residual = other if form.startswith("residual") else None
    ds = (other, bn_ds) if form.startswith("downsample") else None

    def run(fn, z, other):
        z = z.detach().requires_grad_()
        other = other.detach().requires_grad_()
        r = other if residual is not None else None
        d = (other, bn_ds) if ds is not None else None
        if fn is frozen_norm:
            y = fn(z, bn, residual=r, downsample=d, pad_mask=mask)
        else:
            y = fn(z, bn, r, d, mask)
        w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        grads = torch.autograd.grad((y.float() * w).sum(), (z, other),
                                    allow_unused=True)
        return y.detach(), grads

    before = (frozen_norm.plain, frozen_norm.launches)
    got, got_g = run(frozen_norm, z, other)
    assert (frozen_norm.plain, frozen_norm.launches) == (before[0] + 1,
                                                         before[1])
    want, want_g = run(_before, z, other)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    # frozen_norm_plain is the route itself.
    assert torch.equal(frozen_norm_plain(z, bn, residual, ds, mask), want)
    if mask is not None:
        assert (got[1][:, 8:] == 0).all() and (got[1][:, :, 7:] == 0).all()


def _before_resnet(body, x, pad_mask):
    """ResNet.forward and Bottleneck.forward as the trunk ran them before
    the op: modules, F.relu, the residual add and apply_mask per stage."""
    def apply_mask(feat):
        keep = ~downsample_mask(pad_mask, feat.shape[2], feat.shape[3])
        return feat * keep[:, None].to(feat.dtype)

    def block(m, x):
        out = F.relu(m.bn1(m.conv1(x)))
        out = F.relu(m.bn2(m.conv2(out)))
        out = m.bn3(m.conv3(out))
        residual = x if m.downsample is None else m.downsample(x)
        return F.relu(out + residual)

    x = F.relu(body.bn1(body.conv1(x)))
    x = apply_mask(F.max_pool2d(x, 3, stride=2, padding=1))
    feats = {}
    for si in range(body.num_stages):
        for m in getattr(body, f"layer{si + 1}"):
            x = block(m, x)
        x = apply_mask(x)
        feats[f"layer{si + 1}"] = x
    return feats


@pytest.mark.parametrize("dtype,remat", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.float32, True)])
def test_frozen_resnet_equals_the_former_composition(dtype, remat):
    g = torch.Generator().manual_seed(1)
    torch.manual_seed(1)
    net = Backbone("resnet18-test", remat=remat)
    for m in net.modules():
        if isinstance(m, FrozenBatchNorm2d):
            fresh = _norm(m.weight.numel(), g, torch.float32)
            m.load_state_dict(fresh.state_dict())
    net = net.to(dtype=dtype, memory_format=torch.channels_last).train()
    x = _channels_last(torch.randn(2, 3, 96, 72, generator=g)).to(dtype)
    mask = torch.zeros(2, 96, 72, dtype=torch.bool)
    mask[1, 70:] = True
    mask[1, :, 40:] = True

    def run(fn):
        net.zero_grad()
        xg = x.detach().requires_grad_()
        feats = fn(xg)
        loss = sum((f.float() * torch.linspace(-1, 1, f.numel()).reshape(
            f.shape)).sum() for f in feats.values())
        loss.backward()
        grads = {k: p.grad.clone() for k, p in net.named_parameters()}
        return {k: f.detach() for k, f in feats.items()}, xg.grad, grads

    before = frozen_norm.plain
    got, got_x, got_p = run(lambda xg: net(xg, mask))
    # stem 1 + 4 blocks x 3, once more per block under remat's recompute
    assert frozen_norm.plain - before == 13 + 12 * remat
    want, want_x, want_p = run(lambda xg: _before_resnet(net.body, xg, mask))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got_x, want_x)
    assert got_p.keys() == want_p.keys()
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k


def _reference_names(stage_sizes):
    """The reference checkpoint's names of a frozen-norm ResNet trunk."""
    bn = ("weight", "bias", "running_mean", "running_var")
    keys = ["conv1.weight"] + [f"bn1.{b}" for b in bn]
    cin = 64
    for si, (blocks, width) in enumerate(zip(stage_sizes,
                                             (64, 128, 256, 512))):
        for bi in range(blocks):
            t = f"layer{si + 1}.{bi}"
            for i in (1, 2, 3):
                keys.append(f"{t}.conv{i}.weight")
                keys += [f"{t}.bn{i}.{b}" for b in bn]
            if bi == 0 and (cin != width * 4 or si > 0):
                keys.append(f"{t}.downsample.0.weight")
                keys += [f"{t}.downsample.1.{b}" for b in bn]
            cin = width * 4
    return keys


@pytest.mark.parametrize("name,stages", [("resnet18-test", (1, 1, 1, 1)),
                                         ("resnet50", (3, 4, 6, 3))])
def test_frozen_resnet_state_dict_names_are_the_reference_s(name, stages):
    with torch.device("meta"):
        net = Backbone(name)
    assert list(net.body.state_dict()) == _reference_names(stages)


@pytest.mark.parametrize("image,feature", [
    (96, 24), (96, 3), (1344, 336), (1344, 42), (800, 25), (50, 13),
    (41, 11), (440, 28), (440, 14), (100, 13), (100, 7), (833, 27),
    (1333, 42), (481, 16), (17, 5)])
def test_kernel_mask_rule_picks_downsample_mask_s_pixels(image, feature):
    """The kernel reads keep at floor(f32(i) * mask_scale(H, h)); on random
    masks that is the pixel ``downsample_mask`` picks, on exact strides and
    off them."""
    rng = np.random.default_rng(image * 1000 + feature)
    other = 64
    mask = torch.from_numpy(rng.random((2, image, other)) < 0.5)
    scale = np.float32(mask_scale(image, feature))
    rows = (np.arange(feature, dtype=np.float32) * scale).astype(np.int64)
    cols = (np.arange(16, dtype=np.float32)
            * np.float32(mask_scale(other, 16))).astype(np.int64)
    assert rows.max() < image
    want = downsample_mask(mask, feature, 16)
    assert torch.equal(mask[:, rows][:, :, cols], want)
    # The transposed canvas reads the columns by the same rule.
    want_t = downsample_mask(mask.transpose(1, 2).contiguous(), 16, feature)
    assert torch.equal(mask.transpose(1, 2)[:, cols][:, :, rows], want_t)


def test_frozen_norm_routes_by_device():
    g = torch.Generator().manual_seed(2)
    bn = _norm(64, g, torch.float32)
    z = torch.randn(1, 64, 3, 3, generator=g)
    with pytest.raises(ValueError, match="not both"):
        frozen_norm(z, bn, residual=z, downsample=(z, bn))
    with pytest.raises(ValueError, match="no frozen-norm path"):
        frozen_norm(z.to("meta"), bn.to("meta"))
