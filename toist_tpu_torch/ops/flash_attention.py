"""Multi-head attention over packed [B, S, D] projections: the hand-written
CUDA flash-attention forward (``csrc/flash_attn_fwd.cu``), its wrapper and its
plain PyTorch version.

Counterpart of ``toist_tpu/ops/flash_attention.py``. The TPU kernel pads the
head dim to 128 lanes and the sequence to 128-key tiles and uses a -2e9
sequence-pad bias; the CUDA kernel reads q, k and v in place and skips keys
past S by bounds checks, so neither padding nor that bias exists here.

``flash_attention`` dispatches on where its inputs lie: CPU tensors go to
``attention_plain`` (the unfused math of ``toist_tpu/models/layers.py``,
which is also the kernel's test oracle); CUDA tensors launch the kernel or
raise. ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9        # masked logits are replaced by this (layers.py NEG_INF)
LOG2E = 1.4426950408889634
KERNEL_SOURCE = "flash_attn_fwd.cu"
HEAD_DIMS = (16, 32)  # head dims the kernel is instantiated for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor], num_heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unfused attention, as ``toist_tpu/models/layers.py:92-104`` computes it.

    q [B, Sq, D], k/v [B, S, D], key_padding_mask [B, S] bool (True = pad).
    Logits and softmax in f32, probabilities cast to q's dtype for PV.
    Returns (o [B, Sq, D] in q's dtype, lse [B, H, Sq] f32 in base 2 over the
    scores times log2(e), the kernel's convention)."""
    B, Sq, D = q.shape
    S = k.shape[1]
    H = num_heads
    hd = D // H
    qh = q.reshape(B, Sq, H, hd).transpose(1, 2)
    kh = k.reshape(B, S, H, hd).transpose(1, 2)
    vh = v.reshape(B, S, H, hd).transpose(1, 2)
    # bf16 products are exact in f32, so upcasting first gives the f32-
    # accumulated logits of JAX's preferred_element_type=float32 einsum.
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                    NEG_INF)
    lse = torch.logsumexp(logits, dim=-1) * LOG2E
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(attn, vh)
    return out.transpose(1, 2).reshape(B, Sq, D), lse


def _check_inputs(q, k, v, key_padding_mask, num_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, S, D]")
    B, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if D % num_heads:
        raise ValueError(f"D={D} is not divisible by num_heads={num_heads}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must have one dtype")
    if key_padding_mask is not None:
        if key_padding_mask.shape != (B, k.shape[1]):
            raise ValueError(f"key_padding_mask must be [B, S] = "
                             f"{(B, k.shape[1])}")
        if key_padding_mask.dtype != torch.bool:
            raise ValueError("key_padding_mask must be bool (True = pad)")
        if key_padding_mask.device != q.device:
            raise ValueError("key_padding_mask must lie on q's device")


def _lib():
    from toist_tpu_torch.ops import _build

    lib = _build.load_library(KERNEL_SOURCE)
    fn = lib.toist_flash_attn_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    return fn


def _launch(q, k, v, key_padding_mask, num_heads):
    B, Sq, D = q.shape
    S = k.shape[1]
    hd = D // num_heads
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dims {HEAD_DIMS}, not {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if B * num_heads > 65535:
        raise ValueError("B * num_heads exceeds the kernel's grid")
    fn = _lib()
    mask = None
    if key_padding_mask is not None:
        mask = key_padding_mask.contiguous().view(torch.uint8)
    o = torch.empty_like(q)
    lse = torch.empty((B, num_heads, Sq), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 o.data_ptr(), lse.data_ptr(), B, num_heads, Sq, S, hd,
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor], num_heads: int,
                    dropout_rate: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention over projected q/k/v in packed [B, S, D] layout.

    Returns (o [B, Sq, D], lse [B, H, Sq] f32, base 2). On CPU tensors this
    is ``attention_plain``; on CUDA tensors it launches the kernel (f32 or
    bf16, head dim 16 or 32) or raises. In-kernel dropout is not written yet:
    a dropout rate above 0 raises."""
    _check_inputs(q, k, v, key_padding_mask, num_heads)
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel attention dropout comes with the backward kernels "
            "(training slice)")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_padding_mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no attention path for device {q.device}")
    return _launch(q, k, v, key_padding_mask, num_heads)


flash_attention.launches = 0
