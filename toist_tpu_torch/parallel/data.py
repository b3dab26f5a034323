"""Data parallelism over ``torch.distributed`` ranks, one device per rank.

Counterpart of ``toist_tpu/parallel/mesh.py``. JAX runs one program over a
1-D ('data',) mesh: the batch is sharded, the parameters replicated, and
XLA inserts the gradient psum. Here each rank holds its own replica and its
own slice of the global batch (``BatchIterator(shard_id, num_shards)``), and
the step reduces explicitly:

- ``make_mesh``: the extents of the ('data',) or ('data', 'model') grid
  of ranks, checked as ``mesh.py:20-30`` checks a mesh shape; a 'model'
  axis of tp > 1 builds the grid's groups (``utils/dist.set_grid``) for
  tensor parallelism (``parallel/tp.py``), and everything below then runs
  over the data group;
- ``replicate``: at start every rank takes rank 0's tensors (under tensor
  parallelism, its data group's first rank's);
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

# Elements per all-reduce or broadcast call: 128 MiB of f32.
BUCKET_NUMEL = 2 ** 25


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)) -> dist.Grid:
    """The ranks' grid (``utils/dist.Grid``, its extents dp and tp) of
    ``run.mesh_shape`` over ``run.mesh_axes`` ("data" or "data", "model"),
    each rank one device; -1 takes the ranks left. A shape that needs more devices than there are
    ranks raises ``ValueError``, as JAX's ``make_mesh`` does, and so does
    one that leaves ranks out (JAX's ``main``: every process contributes an
    equal slice of the global batch). A model extent above 1 builds the
    grid's groups (``utils/dist.set_grid``): rank r at data index r // tp
    and model index r % tp."""
    axes, shape = tuple(axes), [int(x) for x in mesh_shape]
    if axes not in (("data",), ("data", "model")) or len(shape) != len(axes):
        raise ValueError(f"mesh {shape} over axes {list(axes)}: the port's "
                         "mesh is ('data',) or ('data', 'model')")
    n = dist.process_count()
    if -1 in shape:
        known = 1
        for x in shape:
            known *= x if x != -1 else 1
        shape[shape.index(-1)] = max(n // known, 1)
    n_data, tp = shape[0], (shape[1] if len(shape) > 1 else 1)
    if n_data * tp > n:
        raise ValueError(f"mesh {shape} needs {n_data * tp} devices, "
                         f"have {n}")
    if n_data * tp != n:
        raise ValueError(
            f"data axis ({n_data}) x model axis ({tp}) must cover the "
            f"process count ({n}): every process contributes an equal local "
            "slice of the global batch")
    return dist.set_grid(n_data, tp)


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
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0,
                      axis: str = "data") -> None:
    """Every rank's ``tensors`` set, in place, to those of the rank at
    index ``src`` of its ``axis`` group ("data", "model"): flat buckets,
    one broadcast each."""
    n, group = dist._group(axis)
    if not dist.initialized() or n == 1:
        return
    g = dist.grid()
    root = (src * g.tp + g.model_index if axis == "data"
            else g.data_index * g.tp + src)
    seen, unique = set(), []
    for t in tensors:                  # a master may be its parameter
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            unique.append(_as_wire(t.detach()))
    for bucket in _buckets(unique):
        _collective_flat(bucket, lambda t: torch.distributed.broadcast(
            t, root, group=group))


def replicate(state) -> None:
    """Rank 0's training state on every rank (``mesh.replicate_tree``): the
    student's and the teacher's tensors (parameters and buffers), their
    f32 masters and EMAs, and the cluster bank. A fresh start draws the
    same weights from the same seed on every rank, and ``--load`` /
    ``--resume`` read the same file; the broadcast makes it so whatever the
    rank's device. Under tensor parallelism each data group takes its
    first rank's tensors (each model index holds its own shards), and then
    the replicated ones go from model index 0 over each model group."""
    tensors, sharded = [], set()         # data_ptr of the sharded ones
    for model, ema in ((state.model, state.ema),
                       (state.teacher, state.teacher_ema)):
        if model is None:
            continue
        tensors += list(model.state_dict().values())
        for n, p in model.named_parameters():
            if hasattr(p, "tp_spec"):
                sharded.add(p.data_ptr())
                if ema is not None and n in ema:
                    sharded.add(ema[n].data_ptr())
        if ema is not None:
            tensors += list(ema.values())
    for p, m in state.masters:
        tensors.append(m)
        if hasattr(p, "tp_spec"):
            sharded.add(m.data_ptr())
    if state.cluster_bank is not None:
        b = state.cluster_bank
        tensors += [b.feature_bank, b.cluster_centers, b.update_count,
                    b.full]
    broadcast_tensors(tensors)
    broadcast_tensors([t for t in tensors if t.data_ptr() not in sharded],
                      axis="model")


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
    indices in the order of the param groups): each rank of the data group
    broadcasts the moments of the tensors it owns, in flat buckets, and
    its steps."""
    local = optimizer.optim
    params = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    mine = {index[id(p)]: float(local.state[p]["step"])
            for g in local.param_groups for p in g["params"]
            if p in local.state}
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for rank, steps in enumerate(dist.all_gather_object(mine, axis="data")):
        for i, step in sorted(steps.items()):
            p = params[i]
            own = local.state.get(p) if rank == dist.data_index() else None
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

