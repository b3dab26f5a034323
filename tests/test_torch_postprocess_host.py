"""The port's host mask postprocess (``toist_tpu_torch/models/postprocess.py
postprocess_masks_host`` and its interpolation helpers) against the JAX
package's, and ``visualize`` drawing its masks from it.

The host path is the JAX package's PIL bilinear: the port's RLEs equal
JAX's on the same logits, upscales and downscales alike. Against the
device path (``F.interpolate``'s arithmetic, what the eval scores), the
host path's RLEs are equal on the stride-4 upscale to the original; on a
downscale PIL antialiases, and on smooth (blob) logits the masks differ
at no more than 0.5% of their pixels (measured 4 of 8,331, 0.048%).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.seg_cases import postprocess_case
from toist_tpu.models import postprocess as jpost
from toist_tpu_torch.models import postprocess as ppost
from toist_tpu_torch.ops import rle

# Originals smaller than each sample's stride-4 crop (40x48, 37x45, 40x40,
# 25x48): every mask is downscaled.
DOWNSCALED = np.asarray([[30, 36], [20, 40], [33, 21], [12, 17]], np.int32)


@pytest.mark.parametrize("o,s", [(7, 3), (3, 7), (96, 24), (24, 24),
                                 (333, 40), (17, 45)])
def test_interp_helpers_match_jax(o, s):
    for t in (False, True):
        np.testing.assert_array_equal(ppost._interp_matrix(o, s, t),
                                      jpost._interp_matrix(o, s, t))
    m = np.random.default_rng(o * 100 + s).normal(
        size=(3, s, s + 2)).astype(np.float32)
    got = ppost._bilinear_resize_qhw(m, o, o + 1)
    np.testing.assert_allclose(got, jpost._bilinear_resize_qhw(m, o, o + 1),
                               rtol=1e-6, atol=1e-6)
    want = F.interpolate(torch.from_numpy(m)[None], size=(o, o + 1),
                         mode="bilinear", align_corners=False)[0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["blobs", "salt", "mixed", "invalid",
                                  "oversized", "downscaled"])
def test_postprocess_masks_host_matches_jax(case):
    logits, sizes, orig, valid = postprocess_case(
        "blobs" if case == "downscaled" else case)
    if case == "downscaled":
        orig = DOWNSCALED
    want = jpost.postprocess_masks_host(logits, sizes, orig, valid)
    got = ppost.postprocess_masks_host(torch.from_numpy(logits), sizes, orig,
                                       valid)
    assert [g is None for g in got] == [not v for v in valid]
    assert got == want


def _masks(rles):
    return [rle.decode(r) for sample in rles if sample is not None
            for r in sample]


@pytest.mark.parametrize("case", ["blobs", "salt", "mixed"])
def test_host_path_equals_device_path_on_upscales(case):
    logits, sizes, orig, valid = postprocess_case(case)
    host = ppost.postprocess_masks_host(logits, sizes, orig, valid)
    dev = ppost.postprocess_masks_device(torch.from_numpy(logits), sizes,
                                         orig, valid)
    assert host == dev


def test_host_path_on_downscales_differs_at_few_pixels():
    """PIL antialiases a downscale and ``F.interpolate`` does not: on smooth
    logits the masks differ at no more than 0.5% of their pixels, and a
    pixel that differs lies beside one of the device mask's edges."""
    logits, sizes, _, valid = postprocess_case("blobs")
    host = _masks(ppost.postprocess_masks_host(logits, sizes, DOWNSCALED,
                                               valid))
    dev = _masks(ppost.postprocess_masks_device(
        torch.from_numpy(logits), sizes, DOWNSCALED, valid))
    diff = sum(int((h != d).sum()) for h, d in zip(host, dev))
    pixels = sum(d.size for d in dev)
    assert 0 < diff <= 0.005 * pixels, (diff, pixels)
    for h, d in zip(host, dev):
        for y, x in zip(*np.nonzero(h != d)):
            around = d[max(0, y - 1):y + 2, max(0, x - 1):x + 2]
            assert around.min() != around.max(), (y, x)


def test_visualize_draws_masks_from_the_host_path(tmp_path, monkeypatch):
    """``visualize`` gives every kept prediction's logits to
    ``postprocess_masks_host``, and those RLEs equal JAX's host path's on
    the same logits."""
    from tests.test_torch_visualize import _setup
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.visualize import visualize

    calls, host = [], ppost.postprocess_masks_host

    def recording(pred_masks, sizes, orig_sizes, sample_valid):
        out = host(pred_masks, sizes, orig_sizes, sample_valid)
        calls.append((pred_masks.float().cpu().numpy(), np.asarray(sizes),
                      np.asarray(orig_sizes), np.asarray(sample_valid), out))
        return out

    monkeypatch.setattr(ppost, "postprocess_masks_host", recording)
    over, ckpt = _setup(tmp_path)
    over["run"]["resume"] = ckpt
    n = visualize(Config.from_sources(None, over), str(tmp_path / "vis"),
                  score_threshold=0.0, max_images=2, device="cpu")
    assert n == len(calls) == 2
    for logits, sizes, orig, valid, out in calls:
        assert logits.shape[1] > 0 and out[0] is not None
        assert out == jpost.postprocess_masks_host(logits, sizes, orig,
                                                   valid)
