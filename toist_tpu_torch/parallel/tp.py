"""Tensor parallelism over the 'model' axis of a ('data', 'model') grid.

Counterpart of ``toist_tpu/parallel/tp.py`` (with the TP parts of
``parallel/mesh.py`` and ``ops/flash_attention.py``). JAX places the
parameters and lets GSPMD partition the activations; here each rank of a
model group holds only its shard of every sharded parameter, and the
forward calls the Megatron collectives itself:

- column-parallel (the torch weight's output rows and the bias sharded):
  the ``in_proj_weight`` / ``in_proj_bias`` of ``self_attn`` and
  ``cross_attn_image`` (each of the q, k and v chunks split by heads),
  ``linear1``, RoBERTa's ``attention.self.{query,key,value}`` and
  ``intermediate.dense``. Each distinct input of such a layer passes
  ``copy_to_model`` (identity forward, all-reduce backward);
- row-parallel (the input columns sharded, the bias replicated and added
  once after the all-reduce, ``tp.py:78-80``): ``out_proj``, ``linear2``,
  RoBERTa's ``attention.output.dense`` and ``output.dense``. The product
  passes ``reduce_from_model`` (all-reduce forward, identity backward).

Everything else is replicated. A layer is sharded only when its features
and its heads divide by tp; JAX's ``tp_spec`` checks the features alone
(ROADMAP queue C). The attention kernels run on the local heads, and a
sharded activation's dropout mask is drawn over the global shape and
sliced (``local_keep``), so the step's generator stays in lockstep over the
model group and the replicated regions draw the same bits on every rank of
it.

A spec is (dim, chunks): dim 0 shards rows, dim 1 columns; a packed q/k/v
tensor has 3 chunks, each sliced on its own.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from toist_tpu_torch.utils import dist

MODEL_AXIS = "model"

Spec = Tuple[int, int]
Shard = Tuple[int, int]          # (model index, model count)

# All-reduces over the model group since the last reset: forward (row-
# parallel products) and backward (inputs of column-parallel layers).
COUNTS = {"fwd": 0, "fwd_bytes": 0, "bwd": 0, "bwd_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _all_reduce(t: torch.Tensor, kind: str) -> torch.Tensor:
    COUNTS[kind] += 1
    COUNTS[kind + "_bytes"] += t.numel() * t.element_size()
    return dist.all_reduce_sum(t, axis=MODEL_AXIS)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), "bwd")


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone(), "fwd")

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(*xs: torch.Tensor) -> List[torch.Tensor]:
    """Megatron's f on each distinct input (one backward all-reduce each;
    an input passed twice is passed through once)."""
    seen: Dict[int, torch.Tensor] = {}
    out = []
    for x in xs:
        if id(x) not in seen:
            seen[id(x)] = _CopyToModel.apply(x)
        out.append(seen[id(x)])
    return out


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the row-parallel partial products summed."""
    return _ReduceFromModel.apply(x)


def row_linear(x: torch.Tensor, linear: torch.nn.Linear) -> torch.Tensor:
    """A row-parallel ``linear`` of a column-sharded ``x``: the partial
    product all-reduced, then the bias once."""
    return reduce_from_model(F.linear(x, linear.weight)) + linear.bias


def local_keep(keep: Optional[torch.Tensor], shard: Optional[Shard],
               dim: int) -> Optional[torch.Tensor]:
    """This shard's slice of a keep mask drawn over the global shape."""
    if keep is None or shard is None:
        return keep
    index, count = shard
    n = keep.shape[dim] // count
    return keep.narrow(dim, index * n, n)


# -- the policy -------------------------------------------------------------

def model_specs(model: torch.nn.Module, tp: int) -> Dict[str, Spec]:
    """{parameter name: spec} of ``model``'s sharded parameters at tp."""
    from toist_tpu_torch.models.joint_transformer import (DecoderLayer,
                                                          EncoderLayer)
    from toist_tpu_torch.models.layers import MultiheadAttention
    from toist_tpu_torch.models.text_encoder import RobertaLayer

    specs: Dict[str, Spec] = {}
    if tp == 1:
        return specs
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, MultiheadAttention):
            if m.embed_dim % tp == 0 and m.num_heads % tp == 0:
                specs[pre + "in_proj_weight"] = (0, 3)
                specs[pre + "in_proj_bias"] = (0, 3)
                specs[pre + "out_proj.weight"] = (1, 1)
        elif isinstance(m, (EncoderLayer, DecoderLayer)):
            if m.linear1.out_features % tp == 0:
                specs[pre + "linear1.weight"] = (0, 1)
                specs[pre + "linear1.bias"] = (0, 1)
                specs[pre + "linear2.weight"] = (1, 1)
        elif isinstance(m, RobertaLayer):
            sa = m.attention.self
            if sa.query.out_features % tp == 0 and m.num_heads % tp == 0:
                for lin in ("query", "key", "value"):
                    for leaf in ("weight", "bias"):
                        specs[f"{pre}attention.self.{lin}.{leaf}"] = (0, 1)
                specs[pre + "attention.output.dense.weight"] = (1, 1)
            if m.intermediate.dense.out_features % tp == 0:
                specs[pre + "intermediate.dense.weight"] = (0, 1)
                specs[pre + "intermediate.dense.bias"] = (0, 1)
                specs[pre + "output.dense.weight"] = (1, 1)
    return specs


def shard_tensor(t: torch.Tensor, spec: Spec, shard: Shard) -> torch.Tensor:
    """This shard's part of the whole tensor ``t``."""
    dim, chunks = spec
    index, count = shard
    parts = []
    for c in t.chunk(chunks, dim=0):
        n = c.shape[dim] // count
        parts.append(c.narrow(dim, index * n, n))
    return torch.cat(parts, dim=0).contiguous() if chunks > 1 \
        else parts[0].contiguous()


def shard_state_dict(sd: Mapping[str, torch.Tensor],
                     specs: Mapping[str, Spec], shard: Shard
                     ) -> Dict[str, torch.Tensor]:
    """A whole reference-layout state dict cut to this shard."""
    return {k: shard_tensor(v, specs[k], shard) if k in specs else v
            for k, v in sd.items()}


@torch.no_grad()
def gather_tensor(local: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole tensor from every model rank's shard (a collective over
    the model group): a packed q/k/v tensor is joined chunk by chunk, so
    that it reads [q, k, v] and not [q0, k0, v0, q1, k1, v1]."""
    dim, chunks = spec
    n = dist.model_count()
    parts = list(dist.all_gather_rows(local.contiguous()[None],
                                      axis=MODEL_AXIS).unbind(0))
    if len(parts) != n:
        raise RuntimeError("gather_tensor outside a model group")
    if chunks == 1:
        return torch.cat(parts, dim=dim)
    per = [p.chunk(chunks, dim=0) for p in parts]
    return torch.cat([torch.cat([p[c] for p in per], dim=dim)
                      for c in range(chunks)], dim=0)


def gather_state_dict(sd: Mapping[str, torch.Tensor],
                      specs: Mapping[str, Spec]) -> Dict[str, torch.Tensor]:
    """A sharded state dict made whole on every model rank (one gather per
    sharded tensor, in the dict's order, which every rank shares)."""
    if dist.model_count() == 1:
        return dict(sd)
    return {k: gather_tensor(v, specs[k]) if k in specs else v
            for k, v in sd.items()}


@torch.no_grad()
def shard_model(model: torch.nn.Module, shard: Shard) -> Dict[str, Spec]:
    """Cut ``model``'s sharded parameters to this shard, in place, and mark
    the modules that run sharded (``tp_shard``); returns the specs, which
    the model keeps as ``tp_specs``."""
    from toist_tpu_torch.models.joint_transformer import (DecoderLayer,
                                                          EncoderLayer)
    from toist_tpu_torch.models.layers import MultiheadAttention
    from toist_tpu_torch.models.text_encoder import RobertaLayer

    specs = model_specs(model, shard[1])
    params = dict(model.named_parameters())
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        p = params[name]
        q = torch.nn.Parameter(shard_tensor(p.data, spec, shard),
                               requires_grad=p.requires_grad)
        q.tp_spec = spec
        setattr(mod, leaf, q)
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, MultiheadAttention):
            m.tp_shard = shard if pre + "in_proj_weight" in specs else None
        elif isinstance(m, (EncoderLayer, DecoderLayer)):
            m.tp_shard = shard if pre + "linear1.weight" in specs else None
        elif isinstance(m, RobertaLayer):
            m.tp_attn = (shard if pre + "attention.self.query.weight"
                         in specs else None)
            m.tp_ffn = (shard if pre + "intermediate.dense.weight" in specs
                        else None)
    model.tp_specs = specs
    return specs


def specs_of(model: torch.nn.Module) -> Dict[str, Spec]:
    return getattr(model, "tp_specs", {})


def clip_grad_norm_(grads: List[torch.Tensor], sharded: Iterable[bool],
                    max_norm: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over a model group's replica:
    the norm of the replicated tensors' norms and, where tensors are
    sharded, one more entry, the sharded tensors' norm over the model
    group (their squares summed); every rank scales by the same
    coefficient. With no tensor sharded (tp 1) it is torch's clip bit for
    bit. Returns the global norm."""
    sharded = list(sharded)
    norms = torch._foreach_norm(grads)
    parts = [n for n, f in zip(norms, sharded) if not f]
    local = [n for n, f in zip(norms, sharded) if f]
    if local:
        sq = torch.linalg.vector_norm(torch.stack(local)) ** 2
        parts.append(dist.all_reduce_sum(sq, axis=MODEL_AXIS).sqrt())
    total = torch.linalg.vector_norm(torch.stack(parts))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    torch._foreach_mul_(grads, coef)
    return total


def local_heads(num_heads: int, shard: Optional[Shard]) -> int:
    return num_heads if shard is None else num_heads // shard[1]
