"""The CUDA flash-attention forward on the card, against its plain version.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip
elsewhere. On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerances: f32 with TF32 off 2e-5 (only the order of the sums differs),
bf16 3e-2 (as tests/test_flash_attention.py).
"""
import pytest
import torch

from toist_tpu_torch.models.layers import MultiheadAttention
from toist_tpu_torch.ops.flash_attention import (attention_plain,
                                                 flash_attention)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(sq, s, d, dtype, mask_kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, n, d, generator=g) for n in (sq, s, s))
    mask = {"random": torch.rand(2, s, generator=g) < 0.2,
            "full": torch.ones(2, s, dtype=torch.bool), "none": None}[
                mask_kind]
    out = [t.to("cuda", dtype) for t in (q, k, v)]
    return out + [None if mask is None else mask.cuda()]


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 0.0),
                                             (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("sq,s", [(300, 300), (100, 300), (37, 70)])
@pytest.mark.parametrize("heads,d", [(8, 256), (4, 64)])
@pytest.mark.parametrize("mask_kind", ["random", "full", "none"])
def test_kernel_matches_plain(cuda, dtype, atol, rtol, sq, s, heads, d,
                              mask_kind):
    q, k, v, mask = _inputs(sq, s, d, dtype, mask_kind)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rlse = attention_plain(q, k, v, mask, heads)
    assert o.dtype == dtype and torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)


def test_module_launches_only_for_long_keys(cuda):
    mha = MultiheadAttention(256, 8).to(cuda).eval()
    x = torch.randn(2, 100, 256, device=cuda)
    for s, launched in ((100, 0), (255, 0), (256, 1), (300, 1)):
        mem = torch.randn(2, s, 256, device=cuda)
        before = flash_attention.launches
        with torch.inference_mode():
            mha(x, mem, mem)
        assert flash_attention.launches - before == launched


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, mask = _inputs(64, 64, 256, torch.float32, "random")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v, mask, 4)                     # hd 64
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), mask, 8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                        k, v, mask, 8)
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, mask, 8, dropout_rate=0.1)
