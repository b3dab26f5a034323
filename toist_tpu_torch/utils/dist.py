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

A ('data', 'model') grid of ranks (``set_grid``, from
``parallel/data.make_mesh``) puts rank r at data index r // tp and model
index r % tp: a model group is tp adjacent ranks, which hold one replica
between them (tensor parallelism, ``parallel/tp.py``), and a data group is
the dp ranks of one model index. The collectives below take an ``axis``:
"data" (the default: the replicas' reductions, over the data group), or
"model" (over the model group). Without a grid the data axis is every rank
and the model axis is this rank alone.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

# The group of the host-side exchanges: a gloo group beside an NCCL one,
# else None (the default group serves).
_HOST_GROUP: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the ('data', 'model') grid and its groups (a
    group of None is the default group for the data axis; an axis of
    extent 1 has no collectives)."""
    dp: int
    tp: int
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None
    data_host_group: Any = None       # gloo twin of data_group under NCCL


_GRID: Optional[Grid] = None


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def grid() -> Grid:
    """The grid set by ``set_grid``; without one, every rank on the data
    axis."""
    if _GRID is not None:
        return _GRID
    return Grid(process_count(), 1, process_index(), 0,
                data_host_group=_HOST_GROUP)


def data_index() -> int:
    return grid().data_index


def data_count() -> int:
    return grid().dp


def model_index() -> int:
    return grid().model_index


def model_count() -> int:
    return grid().tp


def set_grid(dp: int, tp: int) -> Grid:
    """Arrange the dp * tp ranks as a (dp, tp) grid and build its groups
    (every rank builds every group, in one order, as
    ``torch.distributed.new_group`` needs)."""
    global _GRID
    if dp * tp != process_count():
        raise ValueError(f"grid ({dp}, {tp}) over {process_count()} ranks")
    if tp == 1:
        _GRID = None
        return grid()
    rank = process_index()
    host = dist.get_backend() != "gloo"
    found = {}
    for axis, groups in (
            ("model", [[d * tp + m for m in range(tp)] for d in range(dp)]),
            ("data", [[d * tp + m for d in range(dp)] for m in range(tp)])):
        for ranks in groups:
            g = dist.new_group(ranks)
            gh = dist.new_group(ranks, backend="gloo") if host else g
            if rank in ranks:
                found[axis] = (g, gh)
    _GRID = Grid(dp, tp, rank // tp, rank % tp,
                 data_group=found["data"][0], model_group=found["model"][0],
                 data_host_group=found["data"][1])
    return _GRID


def _group(axis: str):
    """(extent, group) of ``axis``."""
    g = grid()
    if axis == "model":
        return g.tp, g.model_group
    return g.dp, g.data_group


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
    global _HOST_GROUP, _GRID
    if initialized():
        dist.destroy_process_group()
    _HOST_GROUP = _GRID = None


def all_reduce_sum(t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """``t`` summed over ``axis``'s group, in place."""
    n, group = _group(axis)
    if initialized() and n > 1:
        dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """[B, ...] of every rank of ``axis``'s group -> [n * B, ...], in
    group order (on the data axis the global batch order of
    ``make_array_from_process_local_data``)."""
    n, group = _group(axis)
    if not initialized() or n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def all_gather_object(obj: Any, axis: Optional[str] = None) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (``axis`` None), or
    every rank's of this rank's data group, in data order."""
    if not initialized():
        return [obj]
    n, group = process_count(), _HOST_GROUP
    if axis == "data":
        n, group = data_count(), grid().data_host_group
    out: List[Any] = [None] * n
    if n == 1:
        return [obj]
    dist.all_gather_object(out, obj, group=group)
    return out


def host_max(value: int) -> int:
    """The largest ``value`` over the ranks, exchanged on the host."""
    if not initialized():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return int(t)
