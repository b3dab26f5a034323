"""Data parallelism over ``torch.distributed`` ranks, one device per rank.

Counterpart of ``toist_tpu/parallel/mesh.py``. JAX runs one program over a
1-D ('data',) mesh: the batch is sharded, the parameters replicated, and
XLA inserts the gradient psum. Here each rank holds its own replica and its
own slice of the global batch (``BatchIterator(shard_id, num_shards)``), and
the step reduces explicitly:

- ``make_mesh``: the data axis's extent, the world size, checked as
  ``mesh.py:20-30`` checks a mesh shape;
- ``replicate``: at start every rank takes rank 0's tensors;
- ``reduce_gradients``: one flat, bucketed all-reduce (sum) of the f32
  master gradients per optimizer step, after accumulation and before the
  clip, so that the clip sees the global batch's gradient
  (``toist_tpu/train/step.py:15,70-99``). The losses are local sums over
  global denominators (``train/step.accumulate_gradients``), so the sum of
  the ranks' gradients is the global batch's gradient, and the step's
  scalars ride in the same buffer;
- ZeRO-1 (``train/state.init_train_state``):
  ``torch.distributed.optim.ZeroRedundancyOptimizer`` over the port's AdamW;
  ``zero1_state_dict`` gathers its shards for a checkpoint by tensor
  broadcasts (the wrapper's own ``consolidate_state_dict`` builds a tensor
  from each pickled shard one byte at a time, which takes minutes at the
  flagship's size).

No ``DistributedDataParallel``: its hooks reduce the gradients of the
parameters autograd reaches, once per backward, where the port reduces the
f32 masters (the bf16 parameters' gradients are copied into them) once per
step after accumulation, and the frozen detector's forward builds no graph
at all.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from toist_tpu_torch.utils import dist

# Tensor parallelism (toist_tpu/parallel/tp.py) in ROADMAP.md, queue A.
TP_ROADMAP_ITEM = 12
# Elements per all-reduce or broadcast call: 128 MiB of f32.
BUCKET_NUMEL = 2 ** 25


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)) -> int:
    """The extent of the data axis of ``run.mesh_shape`` over the ranks,
    each rank one device: ``(-1,)`` or ``(world,)``. A shape that needs
    more devices than there are ranks raises ``ValueError``, as JAX's
    ``make_mesh`` does, and so does one that leaves ranks out (JAX's
    ``main``: every process contributes an equal slice of the global
    batch)."""
    if "model" in axes:
        raise NotImplementedError(
            "a 'model' mesh axis (tensor parallelism, toist_tpu/parallel/"
            "tp.py) is not ported to toist_tpu_torch: ROADMAP queue A item "
            f"{TP_ROADMAP_ITEM}")
    if tuple(axes) != ("data",) or len(mesh_shape) != 1:
        raise ValueError(f"mesh {list(mesh_shape)} over axes {list(axes)}: "
                         "the port's mesh is one ('data',) axis")
    n = dist.process_count()
    n_data = n if mesh_shape[0] == -1 else int(mesh_shape[0])
    if n_data > n:
        raise ValueError(f"mesh [{n_data}] needs {n_data} devices, have {n}")
    if n_data % n:
        raise ValueError(
            f"data axis ({n_data}) must be divisible by the process count "
            f"({n}): every process contributes an equal local slice of the "
            "global batch")
    return n_data


def _buckets(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """``tensors`` by dtype and device, in order, cut into buckets of at
    most BUCKET_NUMEL elements (a larger tensor alone)."""
    groups: Dict[tuple, List[List[torch.Tensor]]] = {}
    sizes: Dict[tuple, int] = {}
    for t in tensors:
        key = (t.dtype, t.device)
        runs = groups.setdefault(key, [[]])
        if runs[-1] and sizes[key] + t.numel() > BUCKET_NUMEL:
            runs.append([])
            sizes[key] = 0
        runs[-1].append(t)
        sizes[key] = sizes.get(key, 0) + t.numel()
    return [b for runs in groups.values() for b in runs]


def _collective_flat(bucket: List[torch.Tensor], op) -> None:
    """``op`` (a collective, in place) on the bucket's tensors as one flat
    tensor, copied back."""
    if len(bucket) == 1:
        op(bucket[0])
        return
    flat = _flatten_dense_tensors(bucket)
    op(flat)
    torch._foreach_copy_(bucket, list(_unflatten_dense_tensors(flat, bucket)))


def _as_wire(t: torch.Tensor) -> torch.Tensor:
    # Collectives move bytes; a bool tensor goes as its uint8 view.
    return t.view(torch.uint8) if t.dtype == torch.bool else t


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Every rank's ``tensors`` set, in place, to rank ``src``'s: flat
    buckets, one broadcast each."""
    if dist.process_count() == 1:
        return
    seen, unique = set(), []
    for t in tensors:                  # a master may be its parameter
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            unique.append(_as_wire(t.detach()))
    for bucket in _buckets(unique):
        _collective_flat(bucket,
                         lambda t: torch.distributed.broadcast(t, src))


def replicate(state) -> None:
    """Rank 0's training state on every rank (``mesh.replicate_tree``): the
    student's and the teacher's tensors (parameters and buffers), their
    f32 masters and EMAs, and the cluster bank. A fresh start draws the
    same weights from the same seed on every rank, and ``--load`` /
    ``--resume`` read the same file; the broadcast makes it so whatever the
    rank's device."""
    tensors = []
    for model in (state.model, state.teacher):
        if model is not None:
            tensors += list(model.state_dict().values())
    tensors += [m for _, m in state.masters]
    for ema in (state.ema, state.teacher_ema):
        if ema is not None:
            tensors += list(ema.values())
    if state.cluster_bank is not None:
        b = state.cluster_bank
        tensors += [b.feature_bank, b.cluster_centers, b.update_count,
                    b.full]
    broadcast_tensors(tensors)


@torch.no_grad()
def reduce_gradients(grads: List[torch.Tensor],
                     scalars: Dict[str, torch.Tensor]) -> None:
    """Sum ``grads`` (the f32 master gradients) and the step's 0-d
    ``scalars`` over the ranks, in place: flat buckets of at most
    BUCKET_NUMEL elements, one all-reduce each, the scalars in the last
    bucket. A no-op without a process group."""
    if not dist.initialized():
        return
    keys = list(scalars)
    vec = torch.stack([scalars[k].float() for k in keys])
    buckets = _buckets(list(grads))
    buckets[-1].append(vec)
    for bucket in buckets:
        _collective_flat(bucket, dist.all_reduce_sum)
    for i, k in enumerate(keys):
        scalars[k] = vec[i]


@torch.no_grad()
def zero1_state_dict(optimizer) -> Dict:
    """The full ``state_dict`` of a ZeRO-1 optimizer over the port's AdamW,
    on every rank, in the wrapped optimizer's format (global parameter
    indices in the order of the param groups): each rank broadcasts the
    moments of the tensors it owns, in flat buckets, and its steps."""
    local = optimizer.optim
    params = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    mine = {index[id(p)]: float(local.state[p]["step"])
            for g in local.param_groups for p in g["params"]
            if p in local.state}
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for rank, steps in enumerate(dist.all_gather_object(mine)):
        for i, step in sorted(steps.items()):
            p = params[i]
            own = local.state.get(p) if rank == dist.process_index() else None
            state[i] = {"step": torch.tensor(step),
                        "exp_avg": own["exp_avg"] if own else torch.empty_like(
                            p, dtype=local.moment_dtype),
                        "exp_avg_sq": own["exp_avg_sq"] if own
                        else torch.empty_like(p)}
        broadcast_tensors([state[i][k] for i in sorted(steps)
                           for k in ("exp_avg", "exp_avg_sq")], src=rank)
    groups, start = [], 0
    for g in optimizer.param_groups:       # as the wrapped AdamW's groups
        n = len(g["params"])
        groups.append(dict(local.defaults, **{
            k: v for k, v in g.items() if k not in ("params",
                                                    "moment_dtype")},
            params=list(range(start, start + n))))
        start += n
    return {"state": dict(sorted(state.items())), "param_groups": groups}


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the moments this rank holds (ZeRO-1: its shard's)."""
    opt = getattr(optimizer, "optim", optimizer)     # ZeRO's local one
    return int(sum(v.numel() * v.element_size()
                   for s in opt.state.values() for v in s.values()
                   if torch.is_tensor(v) and v.dim() > 0))

