"""Process ranks and collectives over ``torch.distributed``.

The port's counterpart of ``jax.process_index()`` / ``jax.process_count()``
and of ``toist_tpu/main.py:89-122 maybe_init_distributed``.
``init_distributed`` sets up the process group from the environment that
torchrun gives every rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). A process started
without that environment has no group: it is rank 0 of 1, and every helper
below returns its input.

The backend follows from the facts, once, at start: NCCL when every rank of
the host has a card of its own; gloo on the CPU, or when ranks share a card
(NCCL refuses two ranks on one device). Under NCCL a second group, on gloo,
carries the host's own exchanges (pickled objects, the epoch loop's
per-step flag), so that they never wait for the card.
"""
from __future__ import annotations

import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

# The group of the host-side exchanges: a gloo group beside an NCCL one,
# else None (the default group serves).
_HOST_GROUP: Optional[Any] = None


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def init_distributed(device="cuda") -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device: ``cuda:LOCAL_RANK`` (modulo the cards when
    ranks share them) unless ``device`` is the CPU. Without that
    environment: no group, and ``device`` unchanged."""
    global _HOST_GROUP
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ or initialized():
        return device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("init_distributed: no CUDA device")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        if local_world > cards:
            backend = "gloo"
            why = f"{local_world} ranks share {cards} card(s)"
        else:
            backend, why = "nccl", "one card per rank"
    else:
        backend, why = "gloo", f"device {device.type}"
    dist.init_process_group(backend, rank=rank, world_size=world)
    if backend == "nccl":
        _HOST_GROUP = dist.new_group(backend="gloo")
    print(f"toist_tpu_torch.dist: rank {rank} of {world} on {device}, "
          f"backend {backend} ({why})", flush=True)
    return device


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _HOST_GROUP
    if initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    if initialized():
        dist.all_reduce(t)
    return t


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """[B, ...] of every rank -> [world * B, ...], in rank order (the
    global batch order of ``make_array_from_process_local_data``)."""
    if not initialized():
        return t
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if not initialized():
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def host_max(value: int) -> int:
    """The largest ``value`` over the ranks, exchanged on the host."""
    if not initialized():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return int(t)
