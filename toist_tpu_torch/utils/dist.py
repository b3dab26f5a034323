"""This process's rank and the process count, from ``torch.distributed``.

The port's counterpart of ``jax.process_index()`` / ``jax.process_count()``:
rank 0 of 1 when ``torch.distributed`` is not initialised (one process, the
port's only mode so far; data parallelism is ROADMAP queue A item 7).
"""
from __future__ import annotations

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1
