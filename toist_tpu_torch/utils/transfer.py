"""Copies of a batch's device results to the host that overlap the device's
later work (``train/engine.evaluate``, ``models/postprocess``).

From a CUDA device, ``start_to_host`` copies each tensor without blocking
into pinned host memory allocated for this call alone (a pinned tensor
reused before its copy lands hands the reader an old batch) and records an
event behind the copies; ``finish_to_host`` waits on that event. Tensors on
the CPU are passed through.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def start_to_host(tensors: Dict[str, torch.Tensor]):
    """Start the copies of ``tensors`` (all on one device); returns a handle
    for ``finish_to_host``."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        return dict(tensors), None
    host = {}
    for k, v in tensors.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return host, event


def finish_to_host(handle) -> Dict[str, np.ndarray]:
    """Wait for the copies of ``start_to_host``; numpy arrays by name."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return {k: v.numpy() for k, v in host.items()}
