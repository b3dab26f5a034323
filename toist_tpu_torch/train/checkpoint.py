"""Checkpoint save/restore in the reference's format.

Counterpart of ``toist_tpu/train/checkpoint.py``. The JAX package writes its
TrainState through orbax; the port writes the reference's own payload
(main.py:641-652) with ``torch.save``:

- ``model``: the full f32 state dict in the reference layout: the f32
  masters of the trainable parameters, the model's own tensors (cast to f32)
  for the frozen parameters and the buffers;
- ``model_ema``: the same with the EMA in place of the masters (absent when
  EMA is off);
- ``optimizer``: ``torch.optim.AdamW.state_dict()`` (moments and step
  counts);
- ``epoch``, ``step``, and ``args`` (the config as a dict);
- in distillation also ``model_noun`` and ``model_noun_ema``, the teacher's
  (SURVEY.md:324-327), and ``cluster_criterion``, the bank's four tensors.

So a port checkpoint is a reference ``.pth``: ``utils/convert.
load_reference_checkpoint`` of either package reads it. ``load_params``
also reads a JAX package's checkpoint converted to an ``.npz`` by
``scripts/jax_checkpoint_to_npz.py``. A file is written under a temporary
name and renamed into place, so a cut run never leaves half a file. The
three load modes map to ``restore`` (--resume), ``load_params`` (--load
warm start, EMA preferred) and ``merge_params``.

Across ranks every rank calls ``save``, as JAX's ``main`` does
(``toist_tpu/main.py:358-372``): a ZeRO-1 optimizer's shards are gathered
(``parallel/data.zero1_state_dict``), and rank 0 alone writes the same
file, with the full ``optimizer``. ``restore`` gives every rank the same state, and a
ZeRO-1 optimizer keeps its rank's share of the moments: a checkpoint
crosses between any numbers of ranks. Under tensor parallelism the file
holds whole tensors: ``save`` gathers every sharded weight, EMA and moment
over the model group (``parallel/tp.gather_tensor``: a packed q/k/v tensor
chunk by chunk), and ``restore`` cuts them to the rank's shards, so a TP
checkpoint loads in one process and a one-process one in a TP run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from toist_tpu_torch.config import Config
from toist_tpu_torch.parallel import data as dp
from toist_tpu_torch.parallel import tp
from toist_tpu_torch.train.cluster import ClusterBank
from toist_tpu_torch.train.state import (TrainState, init_train_state,
                                         load_masters, model_masters)
from toist_tpu_torch.utils.convert import (cluster_bank_from_jax,
                                          jax_params_to_state_dict,
                                          load_reference_checkpoint)
from toist_tpu_torch.utils import dist

# One record per finished write: path, bytes, copy_s (device -> host, on the
# caller's thread), write_s (torch.save + rename).
SAVES: List[Dict[str, Any]] = []
_WRITER: Optional[ThreadPoolExecutor] = None
_PENDING: Optional[Future] = None


def full_state_dict(state: TrainState, ema: bool = False,
                    teacher: bool = False) -> Dict[str, torch.Tensor]:
    """The student's (or the teacher's) reference-layout state dict in f32
    on its device: the masters (or, with ``ema``, the EMA) for the
    trainable parameters, the model's own tensors for the frozen parameters
    and the buffers."""
    model = state.teacher if teacher else state.model
    if ema:
        own = state.teacher_ema if teacher else state.ema
    else:
        own = {n: m for n, _, m in model_masters(state, teacher)}
    return {k: own.get(k, v).detach().float()
            for k, v in model.state_dict().items()}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def whole_state_dict(state: TrainState, ema: bool = False,
                     teacher: bool = False) -> Dict[str, torch.Tensor]:
    """``full_state_dict`` with every tensor whole: under tensor
    parallelism gathered over the model group (a collective, on every
    rank)."""
    model = state.teacher if teacher else state.model
    return tp.gather_state_dict(full_state_dict(state, ema, teacher),
                                tp.specs_of(model))


def _map_moments(state: TrainState, opt: Dict[str, Any], fn
                 ) -> Dict[str, Any]:
    """The optimizer state dict ``opt`` with ``fn(moment, spec)`` applied to
    each moment of a sharded tensor (the masters' order of its groups gives
    each parameter index its TP spec)."""
    by_master = {id(m): getattr(p, "tp_spec", None)
                 for p, m in state.masters}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    spec = {i: by_master.get(id(p)) for i, p in enumerate(params)}
    return dict(opt, state={
        i: {k: fn(v, spec[i]) if spec[i] and torch.is_tensor(v)
            and v.dim() > 0 else v for k, v in st.items()}
        for i, st in opt["state"].items()})


def _host_payload(state: TrainState, epoch: int, args: Optional[dict],
                  opt: Dict[str, Any],
                  parts: Dict[str, Dict[str, torch.Tensor]]
                  ) -> Dict[str, Any]:
    payload = {
        "optimizer": {
            "state": {i: {k: _host(v) if torch.is_tensor(v) else v
                          for k, v in s.items()}
                      for i, s in opt["state"].items()},
            "param_groups": [dict(g) for g in opt["param_groups"]]},
        "epoch": epoch, "step": state.step, "args": args or {}}
    for key, sd in parts.items():
        payload[key] = {k: _host(v) for k, v in sd.items()}
    if state.cluster_bank is not None:
        payload["cluster_criterion"] = {
            f.name: _host(getattr(state.cluster_bank, f.name))
            for f in dataclasses.fields(ClusterBank)}
    return payload


def _write(path: str, payload: Dict[str, Any], copy_s: float) -> None:
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    SAVES.append({"path": path, "bytes": os.path.getsize(path),
                  "copy_s": copy_s, "write_s": time.perf_counter() - t0})


def save(path: str, state: TrainState, epoch: int,
         async_save: bool = False, args: Optional[dict] = None) -> None:
    """Full training save, called by every rank; rank 0 writes. The
    tensors are copied to the host on the caller's thread (so the device
    memory and the next steps' in-place updates are free at once); with
    ``async_save`` the write runs on one background thread, and a later
    save first waits for it."""
    global _WRITER, _PENDING
    opt = (dp.zero1_state_dict(state.optimizer)
           if hasattr(state.optimizer, "optim")                # ZeRO-1
           else state.optimizer.state_dict())
    if dist.model_count() > 1:
        opt = _map_moments(state, opt, tp.gather_tensor)
    parts = {"model": (False, False)}                     # (ema, teacher)
    if state.ema is not None:
        parts["model_ema"] = (True, False)
    if state.teacher is not None:
        parts["model_noun"] = (False, True)
        if state.teacher_ema is not None:
            parts["model_noun_ema"] = (True, True)
    wait_for_async_saves()
    t0 = time.perf_counter()
    parts = {k: whole_state_dict(state, *v) for k, v in parts.items()}
    if dist.process_index() != 0:
        return
    payload = _host_payload(state, epoch, args, opt, parts)
    copy_s = time.perf_counter() - t0
    if not async_save:
        _write(path, payload, copy_s)
        return
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(max_workers=1)
    _PENDING = _WRITER.submit(_write, path, payload, copy_s)


def wait_for_async_saves() -> None:
    """Block until the in-flight async save has been written (and raise its
    error, if it failed)."""
    global _PENDING
    if _PENDING is not None:
        pending, _PENDING = _PENDING, None
        pending.result()


def _load(path: str) -> Dict[str, Any]:
    torch.serialization.add_safe_globals([argparse.Namespace])
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(path: str, cfg: Config, steps_per_epoch: int, total_steps: int,
            device="cuda") -> Tuple[TrainState, int]:
    """Full training restore (--resume, main.py:491-531): the model in its
    compute dtype (the masters cast down), the f32 masters, the AdamW
    moments and step counts, the EMA and the step, with the schedules
    rebuilt from ``cfg``; in distillation also the teacher, its EMA and the
    cluster bank. A ZeRO-1 optimizer takes its rank's share of the moments.
    Returns (state, epoch)."""
    from toist_tpu_torch.models.toist import TOIST

    payload = _load(path)
    shard = (dist.model_index(), dist.model_count())

    def built(key):
        model = TOIST.from_state_dict(payload[key], cfg.model, device)
        specs = tp.shard_model(model, shard) if shard[1] > 1 else {}
        for k in (key, key + "_ema"):            # cut to this rank's shard
            if payload.get(k):
                payload[k] = tp.shard_state_dict(payload[k], specs, shard)
        return model

    model = built("model")
    teacher = bank = None
    if "model_noun" in payload:
        teacher = built("model_noun")
    if "cluster_criterion" in payload:
        bank = ClusterBank(**{k: v.to(device) for k, v in
                              payload["cluster_criterion"].items()})
    state = init_train_state(model, cfg, steps_per_epoch, total_steps,
                             teacher=teacher, cluster_bank=bank)
    load_masters(state, payload["model"], payload.get("model_ema"))
    if teacher is not None:
        load_masters(state, payload["model_noun"],
                     payload.get("model_noun_ema"), teacher=True)
    opt = payload["optimizer"]
    if shard[1] > 1:
        opt = _map_moments(state, opt,
                           lambda t, spec: tp.shard_tensor(t, spec, shard))
    state.optimizer.load_state_dict(opt)
    state.step = int(payload["step"])
    return state, int(payload["epoch"])


def load_params(path: str, prefer_ema: bool = True
                ) -> Dict[str, torch.Tensor]:
    """Weights-only warm start (--load, main.py:456-473, and the teacher's
    --load_noun: EMA key preferred): the checkpoint's reference-layout
    state dict. ``path`` is a reference ``.pth`` (the port's own too) or
    a JAX package's checkpoint that ``scripts/jax_checkpoint_to_npz.py``
    converted, whose params go through ``jax_params_to_state_dict``."""
    if not path.endswith(".npz"):
        return load_reference_checkpoint(path, prefer_ema=prefer_ema)
    tree = _read_npz(path)
    params = tree.get("ema_params") if prefer_ema else None
    return jax_params_to_state_dict(
        params if params is not None else tree["params"], tree["frozen"])


def load_jax_cluster_bank(path: str, device) -> Optional[ClusterBank]:
    """The cluster bank of a converted JAX checkpoint (``.npz``), on
    ``device``; None for any other file or a run without a bank. A JAX run
    cannot be resumed here, so ``--load`` of its ``.npz`` is how its
    distilled student is evaluated, and the cluster eval needs the bank
    the run built."""
    if not path.endswith(".npz"):
        return None
    bank = _read_npz(path).get("cluster_bank")
    return (cluster_bank_from_jax(argparse.Namespace(**bank), device)
            if bank is not None else None)


def _read_npz(path: str) -> Dict[str, Any]:
    """The nested dict of a ``.npz`` with '/'-joined keys."""
    import numpy as np

    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return tree


def merge_params(init_tree: Any, loaded_tree: Any) -> Any:
    """Overlay loaded params onto a (possibly larger) initialized tree.

    The reference's --frozen_weights loads a detection checkpoint into the
    `.detr` submodule of the seg model (main.py:475-489): the mask head keeps
    its fresh init. Keys present in both must match shapes; keys only in the
    init tree are kept; keys only in the checkpoint are ignored (e.g. dropping
    contrastive projections when the target model disables them)."""
    if isinstance(init_tree, dict):
        out = {}
        for k, v in init_tree.items():
            if isinstance(loaded_tree, dict) and k in loaded_tree:
                out[k] = merge_params(v, loaded_tree[k])
            else:
                out[k] = v
        return out
    loaded = loaded_tree
    if hasattr(init_tree, "shape") and hasattr(loaded, "shape"):
        if tuple(init_tree.shape) != tuple(loaded.shape):
            raise ValueError(
                f"shape mismatch merging checkpoint: {loaded.shape} vs "
                f"{init_tree.shape}")
    return loaded
