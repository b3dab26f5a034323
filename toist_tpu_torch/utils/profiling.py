"""Profiling: ``trace`` and ``device_memory_stats``.

Counterpart of ``toist_tpu/utils/profiling.py``, with ``torch.profiler`` in
place of ``jax.profiler``. ``trace(logdir)`` records the span (CPU and, on a
card, CUDA activity), writes the trace into ``logdir`` as Chrome trace JSON
(gzipped; TensorBoard's profile plugin and ``chrome://tracing`` read it)
and prints one ``[profile]`` line: the device ms over the span and the top
kernel categories, taken from the profiler's own events (the JAX package
reads them from the XPlane file with ``utils/xprof.py``, which is not
ported). ``main`` traces the first epoch when ``run.profile_dir`` is set
(``toist_tpu/main.py:351-352``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import torch

# Kernel categories by name fragment, first match wins.
_KINDS = (
    ("attention forward", ("flash_fwd",)),
    ("attention dK/dV", ("flash_bwd_dkv",)),
    ("attention dQ", ("flash_bwd_dq",)),
    ("LSA", ("lsa",)),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("GEMM / convolution", ("gemm", "xmma", "cutlass", "conv", "cudnn",
                            "sm90", "sm80", "nhwc", "nchw", "wgrad",
                            "dgrad", "fprop")),
    ("reduction", ("reduce", "norm", "softmax", "cunn_", "cross_entropy")),
    ("copy / memset", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "where")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in _KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def summarize(prof) -> Tuple[float, List[Tuple[str, float, int]]]:
    """(device ms over the span, [(category, ms, percent)] by ms) from a
    finished ``torch.profiler.profile``'s device events."""
    from torch.autograd import DeviceType

    kinds: Dict[str, float] = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kind = kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    total = sum(kinds.values())
    cats = sorted(((k, ms, round(100 * ms / total) if total else 0)
                   for k, ms in kinds.items()), key=lambda c: -c[1])
    return total, cats


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Record a ``torch.profiler`` trace of the span into ``logdir`` (and
    print its ``[profile]`` line) if logdir, else nothing."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}.json.gz")
        prof.export_chrome_trace(path)
        total, cats = summarize(prof)
        if total > 0:
            print(f"[profile] device total {total:.0f}ms; top op "
                  "categories: " + ", ".join(
                      f"{n} {ms:.0f}ms ({p}%)" for n, ms, p in cats[:6])
                  + f"; trace {path}", flush=True)
        else:
            print(f"[profile] device total not measured (no device events "
                  f"in the span); trace {path}", flush=True)


def device_memory_stats() -> dict:
    """Live and peak memory of each local card (the max_memory_allocated
    analogue); {} without one."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
    return out
