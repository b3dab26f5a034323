"""The ResNet trunk's per-convolution epilogue: frozen BatchNorm, the
residual, ReLU and the stage's pad mask as one op,

    y = relu(norm(z) [+ residual | + norm_ds(z_ds)]) [* keep]

where ``keep`` is the image pad mask [B, Hi, Wi] read at the feature's stride
(``downsample_mask``). ``frozen_norm`` dispatches on what its input shows:
CPU tensors go to ``frozen_norm_plain`` (the modules' own math in today's
order: the norm module's forward, ``+``, ``F.relu``, the mask's multiply;
also the kernel's test oracle); CUDA tensors in channels-last memory, bf16 or
f32, go through ``FrozenNormAct``, whose forward and backward launch the
hand-written kernels of ``csrc/frozen_norm_act.cu``; any other CUDA tensor
raises. The kernel computes scale and shift in f32 from the norm's four
buffers on every call, sums in f32 in the modules' order and rounds once on
store, so its f32 route is the plain route bit for bit; its backward writes
dz = g [y > 0] s and the residual's (or the downsample pair's) gradient in
one pass, and nothing for the frozen buffers.

Counters: ``frozen_norm.launches`` (forward kernel launches),
``frozen_norm.bwd_launches`` (backward kernel launches) and
``frozen_norm.plain`` (calls of the plain route).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SOURCE = "frozen_norm_act.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BUFFER_DTYPES = (torch.float32, torch.bfloat16)
_CL = torch.channels_last


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


def mask_scale(image: int, feature: int) -> float:
    """The f32 factor of ``downsample_mask``'s index rule: feature index i
    reads image index floor(f32(i) * f32(image / feature)). On an exact
    stride it is the stride itself, and the product is exact."""
    return float(np.float32(image / feature))


def frozen_norm_plain(z: torch.Tensor, norm: nn.Module,
                      residual: Optional[torch.Tensor] = None,
                      downsample: Optional[Tuple[torch.Tensor, nn.Module]]
                      = None,
                      pad_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The epilogue as the modules compute it, differentiated by autograd:
    ``norm(z)``, plus ``residual`` or ``norm_ds(z_ds)``, ReLU, then the pad
    mask's multiply."""
    out = norm(z)
    if downsample is not None:
        z_ds, norm_ds = downsample
        residual = norm_ds(z_ds)
    if residual is not None:
        out = out + residual
    out = F.relu(out)
    if pad_mask is not None:
        keep = ~downsample_mask(pad_mask, out.shape[2], out.shape[3])
        out = out * keep[:, None].to(out.dtype)
    return out


_F32, _PTR, _INT = ctypes.c_float, ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "toist_frozen_norm_act_fwd": (
        [_PTR] * 8 + [_F32] + [_PTR] * 4 + [_F32, _PTR, ctypes.c_longlong]
        + [_INT] * 5 + [_F32] * 2 + [_INT] * 2 + [_PTR]),
    "toist_frozen_norm_act_bwd": (
        [_PTR] * 4 + [_F32] + [_PTR] * 2 + [_F32] + [_PTR] * 3
        + [ctypes.c_longlong] + [_INT] * 3 + [_PTR]),
}


def _fn(name: str):
    from toist_tpu_torch.ops import _build

    fn = getattr(_build.load_library(SOURCE), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _buffers(norm: nn.Module, z: torch.Tensor):
    bufs = (norm.weight, norm.bias, norm.running_mean, norm.running_var)
    for t in bufs:
        if (t.device != z.device or t.dtype != bufs[0].dtype
                or t.dtype not in _BUFFER_DTYPES or t.numel() != z.shape[1]
                or not t.is_contiguous()):
            raise ValueError(
                f"the norm's buffers must be contiguous [{z.shape[1]}] "
                f"float32 or bfloat16 tensors of one dtype on {z.device}")
    return bufs


def _check_activation(name: str, t: torch.Tensor, like: torch.Tensor):
    if t.device != like.device or t.dtype != like.dtype \
            or t.shape != like.shape:
        raise ValueError(f"{name} must match z: {tuple(like.shape)} "
                         f"{like.dtype} on {like.device}")
    if not t.is_contiguous(memory_format=_CL):
        raise ValueError(f"{name} must be channels-last contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_kernel_inputs(z, norm, residual, z_ds, norm_ds, pad_mask):
    if z.dim() != 4:
        raise ValueError(f"z must be [B, C, H, W], not {tuple(z.shape)}")
    if z.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{z.dtype}")
    if z.shape[1] * z.element_size() % 16:
        raise ValueError(f"C = {z.shape[1]} is not a whole number of "
                         f"16-byte vectors of {z.dtype}")
    _check_activation("z", z, z)
    for name, t in (("residual", residual), ("the downsample input", z_ds)):
        if t is not None:
            _check_activation(name, t, z)
    bufs = _buffers(norm, z)
    bufs_ds = (None,) * 4
    if norm_ds is not None:
        bufs_ds = _buffers(norm_ds, z)
        if bufs_ds[0].dtype != bufs[0].dtype:
            raise ValueError("both norms' buffers must have one dtype")
    if pad_mask is not None and (
            pad_mask.dtype != torch.bool or pad_mask.dim() != 3
            or pad_mask.shape[0] != z.shape[0]
            or pad_mask.device != z.device or not pad_mask.is_contiguous()):
        raise ValueError(f"pad_mask must be a contiguous [{z.shape[0]}, H, W]"
                         f" bool tensor on {z.device}")
    return bufs, bufs_ds


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _launch_fwd(z, norm, residual, z_ds, norm_ds, pad_mask):
    (w, b, m, v), (wd, bd, md, vd) = _check_kernel_inputs(
        z, norm, residual, z_ds, norm_ds, pad_mask)
    B, C, H, W = z.shape
    Hi, Wi = pad_mask.shape[1:] if pad_mask is not None else (0, 0)
    y = torch.empty_like(z, memory_format=_CL)
    with torch.cuda.device(z.device):
        err = _fn("toist_frozen_norm_act_fwd")(
            z.data_ptr(), _ptr(residual), _ptr(z_ds), _ptr(pad_mask),
            w.data_ptr(), b.data_ptr(), m.data_ptr(), v.data_ptr(), norm.eps,
            _ptr(wd), _ptr(bd), _ptr(md), _ptr(vd),
            norm_ds.eps if norm_ds is not None else 0.0, y.data_ptr(),
            B * H * W, C, H, W, Hi, Wi,
            mask_scale(Hi, H) if Hi else 0.0,
            mask_scale(Wi, W) if Wi else 0.0,
            _DTYPE_CODES[z.dtype], int(w.dtype == torch.bfloat16),
            _stream(z.device))
    if err != 0:
        raise RuntimeError(f"frozen_norm_act_fwd launch failed: cudaError "
                           f"{err}")
    frozen_norm.launches += 1
    return y


def _launch_bwd(y, g, norm, norm_ds, want_dr, want_dzd):
    """dz, and dr or dz_ds where asked for, from the saved output y and the
    incoming gradient g (made channels-last contiguous if it is not). The
    buffers were checked by the forward."""
    if g.dtype != y.dtype:
        raise TypeError(f"the gradient is {g.dtype}, the forward ran in "
                        f"{y.dtype}")
    g = g.contiguous(memory_format=_CL)
    B, C, H, W = y.shape
    wd = vd = None
    if norm_ds is not None:
        wd, vd = norm_ds.weight, norm_ds.running_var
    dz = torch.empty_like(y, memory_format=_CL)
    dr = torch.empty_like(y, memory_format=_CL) if want_dr else None
    dzd = torch.empty_like(y, memory_format=_CL) if want_dzd else None
    with torch.cuda.device(y.device):
        err = _fn("toist_frozen_norm_act_bwd")(
            y.data_ptr(), g.data_ptr(), norm.weight.data_ptr(),
            norm.running_var.data_ptr(), norm.eps, _ptr(wd), _ptr(vd),
            norm_ds.eps if norm_ds is not None else 0.0, dz.data_ptr(),
            _ptr(dr), _ptr(dzd), B * H * W, C, _DTYPE_CODES[y.dtype],
            int(norm.weight.dtype == torch.bfloat16), _stream(y.device))
    if err != 0:
        raise RuntimeError(f"frozen_norm_act_bwd launch failed: cudaError "
                           f"{err}")
    frozen_norm.bwd_launches += 1
    return dz, dr, dzd


class FrozenNormAct(torch.autograd.Function):
    """The kernels as one differentiable op: (z, residual, z_ds) -> y. The
    norms are modules whose buffers the kernels read; they get no
    gradient, nor does ``pad_mask``."""

    @staticmethod
    def forward(ctx, z, residual, z_ds, pad_mask, norm, norm_ds):
        y = _launch_fwd(z, norm, residual, z_ds, norm_ds, pad_mask)
        ctx.save_for_backward(y)
        ctx.norms = (norm, norm_ds)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        norm, norm_ds = ctx.norms
        _, need_r, need_zd = ctx.needs_input_grad[:3]
        dz, dr, dzd = _launch_bwd(y, g, norm, norm_ds, need_r, need_zd)
        return dz, dr, dzd, None, None, None


def frozen_norm(z: torch.Tensor, norm: nn.Module,
                residual: Optional[torch.Tensor] = None,
                downsample: Optional[Tuple[torch.Tensor, nn.Module]] = None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(norm(z) [+ residual | + norm_ds(z_ds)]) [* keep], z [B, C, H, W]
    the output of the convolution before ``norm`` (a ``FrozenBatchNorm2d``:
    buffers ``weight``, ``bias``, ``running_mean``, ``running_var`` and
    ``eps``); ``downsample`` the pair (z_ds, norm_ds) of the shortcut's
    convolution output and its norm; ``pad_mask`` [B, Hi, Wi] bool (True =
    pad) the image-level mask, applied at z's stride. On CPU tensors this is
    ``frozen_norm_plain`` under autograd; on CUDA tensors it launches the
    kernel (channels-last, float32 or bfloat16) or raises."""
    if residual is not None and downsample is not None:
        raise ValueError("a residual or a downsample pair, not both")
    if z.device.type == "cpu":
        frozen_norm.plain += 1
        return frozen_norm_plain(z, norm, residual, downsample, pad_mask)
    if z.device.type != "cuda":
        raise ValueError(f"no frozen-norm path for device {z.device}")
    z_ds, norm_ds = downsample if downsample is not None else (None, None)
    return FrozenNormAct.apply(z, residual, z_ds, pad_mask, norm, norm_ds)


frozen_norm.launches = 0
frozen_norm.bwd_launches = 0
frozen_norm.plain = 0
