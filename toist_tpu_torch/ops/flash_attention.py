"""Multi-head attention over packed [B, S, D] projections: the hand-written
CUDA flash-attention kernels (forward and backward on the tensor cores for
bf16, ``csrc/flash_attn_fwd_tc.cu`` and ``csrc/flash_attn_bwd_tc.cu``; on
scalar FMAs for f32, ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu``; in-kernel dropout ``csrc/attn_dropout.cuh``),
their wrappers and their plain PyTorch version.

Counterpart of ``toist_tpu/ops/flash_attention.py``. The TPU kernel pads the
head dim to 128 lanes and the sequence to 128-key tiles and uses a -2e9
sequence-pad bias; the CUDA kernels read q, k and v in place and skip keys
past S by bounds checks, so neither padding nor that bias exists here.

``flash_attention`` dispatches on where its inputs lie: CPU tensors go to
``attention_plain`` (the unfused math of ``toist_tpu/models/layers.py``,
which is also the kernels' test oracle, differentiated by autograd); CUDA
tensors go through ``FlashAttention``, the ``torch.autograd.Function`` whose
forward and backward launch the kernels (the counterpart of ``_make_mha``'s
``custom_vjp``), or raise. The kernels are chosen by dtype (``_fwd_route``,
``_bwd_route``), never as a fallback. Launch counts:
``flash_attention.launches`` (forward), ``.dkv_launches``, ``.dq_launches``
(backward), each on either route; ``.fwd_tc_launches``,
``.dkv_tc_launches``, ``.dq_tc_launches`` (the bf16 tensor-core route
alone); and ``.dropout_launches``, the launches of any of the three with
dropout on.

Dropout follows ``_dropout_u8``: 8 random bits per element, keep iff bits >=
q = min(round(rate * 256), 255), kept values scaled by 1 / (1 - q/256). The
kernels draw the bits from a hash of (seed, batch*head, row, column), so they
cannot equal the plain version's ``torch.randint`` bits; ``dropout_keep_mask``
materialises the kernels' mask so that ``attention_plain`` can be given it,
and ``dropout_keep_mask_plain`` is the same hash in numpy.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e9        # masked logits are replaced by this (layers.py NEG_INF)
LOG2E = 1.4426950408889634
FWD_SOURCE = "flash_attn_fwd.cu"          # f32 forward, dropout mask
FWD_TC_SOURCE = "flash_attn_fwd_tc.cu"    # bf16 forward, tensor cores
BWD_SOURCE = "flash_attn_bwd.cu"          # f32 backward
BWD_TC_SOURCE = "flash_attn_bwd_tc.cu"    # bf16 backward, tensor cores
KERNEL_SOURCES = (FWD_SOURCE, FWD_TC_SOURCE, BWD_SOURCE, BWD_TC_SOURCE)
HEAD_DIMS = (16, 32)  # head dims the kernels are instantiated for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def drop_threshold(rate: float) -> int:
    """q of ``_dropout_u8``: 8-bit threshold, clamped to 255 (q = 256 would
    keep everything and scale by 1/0)."""
    return min(int(round(rate * 256.0)), 255) if rate > 0.0 else 0


def drop_scale(q: int) -> float:
    return 1.0 / (1.0 - q / 256.0)


def random_keep(shape, q: int, generator: torch.Generator) -> torch.Tensor:
    """Keep mask of ``_dropout_u8`` (bool, True = keep) from 8 random bits per
    element, drawn from ``generator`` on its device."""
    bits = torch.randint(0, 256, shape, dtype=torch.uint8,
                         generator=generator, device=generator.device)
    return bits >= q


def attention_keep(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                   rate: float, generator: Optional[torch.Generator]
                   ) -> Optional[torch.Tensor]:
    """The plain version's dropout keep mask [B, H, Sq, S] for ``rate``,
    with bits from ``generator``; None at rate 0."""
    drop_q = drop_threshold(rate)
    if drop_q == 0:
        return None
    return random_keep((q.shape[0], num_heads, q.shape[1], k.shape[1]),
                       drop_q, generator)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor], num_heads: int,
                    dropout_keep: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unfused attention, as ``toist_tpu/models/layers.py:92-104`` computes it.

    q [B, Sq, D], k/v [B, S, D], key_padding_mask [B, S] bool (True = pad).
    Logits and softmax in f32, probabilities cast to q's dtype for PV. With
    ``dropout_keep`` ([B, H, Sq, S] bool, True = keep) the probabilities are
    dropped by that explicit mask at ``dropout_rate``'s q, as the kernels
    and ``_dropout_u8`` do. Returns (o [B, Sq, D] in q's dtype, lse
    [B, H, Sq] f32 in base 2 over the scores times log2(e), the kernels'
    convention)."""
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
    if dropout_keep is not None:
        scale = drop_scale(drop_threshold(dropout_rate))
        attn = torch.where(dropout_keep, attn * scale, attn.new_zeros(()))
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


def _fn(source: str, name: str, n_ptr: int, n_int: int, n_tail: int = 2):
    """A kernel's C entry, declared once: n_ptr pointers, n_int ints, then
    n_tail pointers (seed and stream, or the stream alone)."""
    from toist_tpu_torch.ops import _build

    fn = getattr(_build.load_library(source), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p] * n_tail)
    return fn


def _check_kernel_inputs(q, num_heads, *tensors):
    hd = q.shape[2] // num_heads
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dims {HEAD_DIMS}, not {hd}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.shape[0] * num_heads > 65535:
        raise ValueError("B * num_heads exceeds the kernel's grid")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _fwd_route(dtype: torch.dtype) -> Tuple[str, str]:
    """(source, entry suffix) of the forward kernel for ``dtype``: bf16 runs
    on the tensor cores, f32 on the scalar kernel. A dispatch by dtype,
    never a fallback."""
    if dtype == torch.bfloat16:
        return FWD_TC_SOURCE, "_tc"
    return FWD_SOURCE, ""


def _launch_fwd(q, k, v, mask_u8, num_heads, drop_q, seed):
    B, Sq, D = q.shape
    S = k.shape[1]
    _check_kernel_inputs(q, num_heads, ("q", q), ("k", k), ("v", v))
    source, suffix = _fwd_route(q.dtype)
    fn = _fn(source, "toist_flash_attn_fwd" + suffix, 6, 7)
    o = torch.empty_like(q)
    lse = torch.empty((B, num_heads, Sq), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask_u8),
                 o.data_ptr(), lse.data_ptr(), B, num_heads, Sq, S,
                 D // num_heads, _DTYPE_CODES[q.dtype], drop_q, _ptr(seed),
                 _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd{suffix} launch failed: cudaError "
                           f"{err}")
    flash_attention.launches += 1
    flash_attention.fwd_tc_launches += bool(suffix)
    flash_attention.dropout_launches += drop_q > 0
    return o, lse


def row_dsum(do: torch.Tensor, o: torch.Tensor, num_heads: int
             ) -> torch.Tensor:
    """D = rowsum(dO * O) per head, [B, H, Sq] f32: the backward kernels'
    input, computed before them as the TPU's ``_backward`` does (:273-275).
    """
    B, Sq, D = o.shape
    return (do.float() * o.float()).reshape(B, Sq, num_heads, -1).sum(-1) \
        .transpose(1, 2).contiguous()


def _bwd_route(dtype: torch.dtype) -> Tuple[str, str]:
    """(source, entry suffix) of the backward kernels for ``dtype``: bf16
    runs on the tensor cores, f32 on the scalar kernels. A dispatch by
    dtype, never a fallback."""
    if dtype == torch.bfloat16:
        return BWD_TC_SOURCE, "_tc"
    return BWD_SOURCE, ""


def _launch_dkv(q, k, v, mask_u8, do, lse, dsum, num_heads, drop_q, seed):
    B, Sq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    source, suffix = _bwd_route(q.dtype)
    fn = _fn(source, "toist_flash_attn_bwd_dkv" + suffix, 9, 7)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask_u8),
                 do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), B, num_heads, Sq, k.shape[1],
                 D // num_heads, _DTYPE_CODES[q.dtype], drop_q, _ptr(seed),
                 _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv launch failed: cudaError "
                           f"{err}")
    flash_attention.dkv_launches += 1
    flash_attention.dkv_tc_launches += bool(suffix)
    flash_attention.dropout_launches += drop_q > 0
    return dk, dv


def _launch_dq(q, k, v, mask_u8, do, lse, dsum, num_heads, drop_q, seed):
    B, Sq, D = q.shape
    dq = torch.empty_like(q)
    source, suffix = _bwd_route(q.dtype)
    fn = _fn(source, "toist_flash_attn_bwd_dq" + suffix, 8, 7)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask_u8),
                 do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dq.data_ptr(), B, num_heads, Sq, k.shape[1],
                 D // num_heads, _DTYPE_CODES[q.dtype], drop_q, _ptr(seed),
                 _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dq launch failed: cudaError "
                           f"{err}")
    flash_attention.dq_launches += 1
    flash_attention.dq_tc_launches += bool(suffix)
    flash_attention.dropout_launches += drop_q > 0
    return dq


def _launch_bwd(q, k, v, mask_u8, o, lse, do, num_heads, drop_q, seed):
    """dQ, dK, dV: D, then the dK/dV kernel, then the dQ kernel."""
    do = do.contiguous()
    _check_kernel_inputs(q, num_heads, ("q", q), ("k", k), ("v", v),
                         ("dO", do))
    if do.dtype != q.dtype:
        raise TypeError(f"dO is {do.dtype}, the forward ran in {q.dtype}")
    dsum = row_dsum(do, o, num_heads)
    args = (q, k, v, mask_u8, do, lse, dsum, num_heads, drop_q, seed)
    dk, dv = _launch_dkv(*args)
    return _launch_dq(*args), dk, dv


class FlashAttention(torch.autograd.Function):
    """The CUDA kernels as one differentiable op: (q, k, v) -> (o, lse).

    ``mask_u8`` is the key padding mask as [B, S] uint8 or None; ``seed`` a
    [1] int64 device tensor (read by the kernels, no host sync) or None when
    ``drop_q`` is 0. lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, mask_u8, num_heads, drop_q, seed):
        o, lse = _launch_fwd(q, k, v, mask_u8, num_heads, drop_q, seed)
        ctx.save_for_backward(q, k, v, mask_u8, o, lse, seed)
        ctx.num_heads, ctx.drop_q = num_heads, drop_q
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, mask_u8, o, lse, seed = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, mask_u8, o, lse, do, ctx.num_heads,
                                 ctx.drop_q, seed)
        return dq, dk, dv, None, None, None, None


def dropout_keep_mask(seed: torch.Tensor, batch: int, num_heads: int,
                      sq: int, s: int, rate: float) -> torch.Tensor:
    """The keep mask [B, H, Sq, S] (bool) that the kernels apply for ``seed``
    and ``rate``, from a kernel that calls the kernels' own bit function.
    For tests and chip_smoke.py, which hand it to ``attention_plain``."""
    q = drop_threshold(rate)
    if q == 0 or seed.device.type != "cuda":
        raise ValueError("the kernels' mask exists for rate > 0 on a CUDA "
                         "seed only")
    fn = _fn(FWD_SOURCE, "toist_attn_dropout_mask", 2, 4, 1)
    keep = torch.empty((batch, num_heads, sq, s), dtype=torch.uint8,
                       device=seed.device)
    with torch.cuda.device(seed.device):
        err = fn(seed.data_ptr(), keep.data_ptr(), batch * num_heads, sq, s,
                 q, _stream(seed.device))
    if err != 0:
        raise RuntimeError(f"attn_dropout_mask launch failed: cudaError "
                           f"{err}")
    return keep.bool()


_U64 = np.uint64


def _mix64(z):
    """SplitMix64's finaliser (attn_dropout.cuh attn_mix64) on uint64."""
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


def _mix32(h):
    """MurmurHash3's 32-bit finaliser (attn_mix32) on uint32."""
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def dropout_keep_mask_plain(seed: int, batch: int, num_heads: int, sq: int,
                            s: int, rate: float) -> torch.Tensor:
    """The kernels' keep mask [B, H, Sq, S] (bool) for ``seed`` and ``rate``,
    computed in numpy: the bit function of ``csrc/attn_dropout.cuh`` in
    uint64 / uint32 arithmetic, which wraps as the device's does.

    Per (batch*head bh, query-row pair p) a 64-bit key
    mix64(mix64(seed + G64 (bh + 1)) + p); per 2x2 block (row pair p, key
    pair j) one word mix32(low32(key) ^ j G32); element (row, col) keeps iff
    byte (row & 1) * 2 + (col & 1) of its block's word is >= q."""
    q = drop_threshold(rate)
    if q == 0:
        raise ValueError("the kernels' mask exists for rate > 0 only")
    r, c = np.arange(sq), np.arange(s)
    bh = np.arange(batch * num_heads, dtype=np.uint64)
    with np.errstate(over="ignore"):
        base = _mix64(_U64(seed % 2 ** 64)
                      + _U64(0x9E3779B97F4A7C15) * (bh + _U64(1)))
        key = _mix64(base[:, None] + (r // 2).astype(np.uint64)[None, :])
        word = _mix32(key.astype(np.uint32)[:, :, None]
                      ^ ((c // 2).astype(np.uint32)
                         * np.uint32(0x9E3779B9))[None, None, :])
    shift = ((r & 1)[:, None] * 2 + (c & 1)[None, :]) * 8
    byte = (word >> shift.astype(np.uint32)[None]) & np.uint32(0xFF)
    keep = byte >= q
    return torch.from_numpy(keep.reshape(batch, num_heads, sq, s))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor], num_heads: int,
                    dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention over projected q/k/v in packed [B, S, D] layout.

    Returns (o [B, Sq, D], lse [B, H, Sq] f32, base 2); o is differentiable
    in q, k and v. With ``dropout_rate`` > 0 the probabilities are dropped
    as ``_dropout_u8`` does, with randomness from ``generator`` (one seed per
    call, as the JAX module draws one per call); pass rate 0 outside
    training. On CPU tensors this is ``attention_plain`` under autograd; on
    CUDA tensors it launches the kernels (f32 or bf16, head dim 16 or 32) or
    raises."""
    _check_inputs(q, k, v, key_padding_mask, num_heads)
    drop_q = drop_threshold(dropout_rate)
    if drop_q and generator is None:
        raise ValueError("attention dropout needs a generator")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_padding_mask, num_heads,
                               attention_keep(q, k, num_heads, dropout_rate,
                                              generator), dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"no attention path for device {q.device}")
    seed = None
    if drop_q:
        seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64,
                             generator=generator, device=q.device)
    mask_u8 = None
    if key_padding_mask is not None:
        mask_u8 = key_padding_mask.contiguous().view(torch.uint8)
    return FlashAttention.apply(q, k, v, mask_u8, num_heads, drop_q, seed)


flash_attention.launches = 0
flash_attention.fwd_tc_launches = 0
flash_attention.dkv_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_tc_launches = 0
flash_attention.dq_tc_launches = 0
flash_attention.dropout_launches = 0
