"""Ranks for the port's data- and tensor-parallel tests on the CPU (gloo).

``Ranks(case, workdir)`` starts one Python process per rank with the
environment torchrun gives its ranks (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), so
``toist_tpu_torch.utils.dist.init_distributed`` sets up the group as it does
under torchrun; ``wait()`` holds a hard timeout, kills the ranks past it
and returns each rank's result. A rank runs ``python tests/torch_ranks.py
<case> <workdir>``: it reads ``<workdir>/inputs.pkl``, runs ``CASES[case]``
and writes ``<workdir>/<case>_<rank>.pkl``. This module imports torch and
the port only, never JAX, so that a rank starts in seconds.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from typing import Any, Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from toist_tpu_torch.data.batcher import BatchIterator, BucketSpec  # noqa
from toist_tpu_torch.eval.evaluator import TaskEvaluator  # noqa: E402
from toist_tpu_torch.models.toist import TOIST  # noqa: E402
from toist_tpu_torch.ops.flash_attention import random_keep  # noqa: E402
from toist_tpu_torch.parallel import data as dp  # noqa: E402
from toist_tpu_torch.train.cluster import ClusterBank  # noqa: E402
from toist_tpu_torch.train.distill import \
    make_distillation_train_step  # noqa: E402
from toist_tpu_torch.train.engine import train_one_epoch  # noqa: E402
from toist_tpu_torch.train.state import init_train_state  # noqa: E402
from toist_tpu_torch.train.step import (dropout_generator,  # noqa: E402
                                        make_train_step)
from toist_tpu_torch.utils import dist  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """torchrun's environment of one rank on this host, CPU threads cut
    to 2 per rank."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                OMP_NUM_THREADS="2", PYTHONPATH=REPO)


class Ranks:
    """``world`` ranks of ``case`` started at once (the caller may work
    while they run); ``wait`` returns their results in rank order."""

    def __init__(self, case: str, workdir: str, inputs: Any = None,
                 world: int = 2, timeout: float = 240):
        self.case, self.workdir, self.timeout = case, str(workdir), timeout
        os.makedirs(self.workdir, exist_ok=True)
        with open(os.path.join(self.workdir, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, self.workdir],
            env=rank_env(r, world, port), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait(self) -> List[Any]:
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        for p, out in zip(self.procs, outs):
            assert p.returncode == 0, out[-4000:]
        results = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.workdir,
                                   f"{self.case}_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


# -- the cases ---------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    """A copy on the host; a bf16 tensor as its bits (int16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def _local(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's rows of a global batch (rank r holds the r-th slice)."""
    rank, world = dist.process_index(), dist.process_count()
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _state(sd, cfg, teacher_sd=None, bank=None):
    def model(weights):
        return TOIST.from_state_dict(
            {k: torch.from_numpy(v) for k, v in weights.items()}, cfg.model,
            device="cpu")
    state = init_train_state(
        model(sd), cfg, 10, 100,
        teacher=model(teacher_sd) if teacher_sd is not None else None,
        cluster_bank=ClusterBank(**{k: torch.from_numpy(v) for k, v in
                                    bank.items()}) if bank else None)
    dp.replicate(state)
    return state


def _masters(state) -> Dict[str, np.ndarray]:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: _np(m) for p, m in state.masters
            if id(p) in names}


def _scalars(sc) -> Dict[str, Any]:
    return {k: float(v) if v.dim() == 0 else _np(v) for k, v in sc.items()}


def _opt_state(sd) -> Dict[str, Any]:
    """An optimizer state dict with each state tensor as (dtype name, host
    copy)."""
    return {"param_groups": sd["param_groups"],
            "state": {i: {k: (str(v.dtype), _np(v)) for k, v in s.items()}
                      for i, s in sd["state"].items()}}


def _replace(cfg, **sections):
    return dataclasses.replace(cfg, **{
        name: dataclasses.replace(getattr(cfg, name), **kw)
        for name, kw in sections.items()})


class _Rows:
    """A dataset of the rows of one batch, one sample each, the shape of a
    COCO-Tasks sample (``cocotasks.CocoTasksDataset.get``)."""

    def __init__(self, batch: Dict[str, np.ndarray], n: int):
        self.batch, self.n = batch, n

    def __len__(self):
        return self.n

    def get(self, i: int, rng) -> List[dict]:
        b, j = self.batch, i % self.batch["images"].shape[0]
        k = int(b["box_valid"][j].sum())
        h, w = b["images"].shape[1:3]
        return [{"image": b["images"][j], "text_ids": b["text_ids"][j],
                 "text_len": int((~b["text_mask"][j]).sum()),
                 "boxes": b["boxes"][j, :k], "labels": np.zeros(k, np.int64),
                 "positive_map": b["positive_map"][j, :k],
                 "noun_token_spans": np.full((k, 2), -1, np.int32),
                 "image_id": i + 1, "task_id": 1,
                 "orig_size": np.array([h, w], np.int32),
                 "size": np.array([h, w], np.int32)}]


def rows_iterator(batch, n_samples: int, batch_size: int, shard_id: int,
                  num_shards: int, batcher=BatchIterator, spec_cls=BucketSpec):
    """A BatchIterator (of either package) over ``n_samples`` rows of
    ``batch`` at one canvas."""
    h, w = batch["images"].shape[1:3]
    spec = spec_cls(buckets=((h, w),), max_text_len=batch["text_ids"].shape[1],
                    max_boxes=batch["boxes"].shape[1],
                    num_logit_cols=batch["positive_map"].shape[2])
    return batcher([_Rows(batch, n_samples)], spec, batch_size=batch_size,
                   shuffle=False, shard_id=shard_id, num_shards=num_shards,
                   num_workers=1)


def case_steps(inp) -> Dict[str, Any]:
    """The plain step (ZeRO-1, the default), accumulation, ZeRO-1 on and off
    over two steps with f32 and bf16 first moments, each rank's dropout
    mask, the distillation step's bank and an epoch of uneven shards."""
    cfg, wd, sd = inp["cfg"], inp["wd"], inp["sd"]
    local = _local(inp["batch"])
    out: Dict[str, Any] = {}

    state, sc = make_train_step(cfg, wd)(_state(sd, cfg), local)
    out["step"] = {"scalars": _scalars(sc), "masters": _masters(state),
                   "zero1": hasattr(state.optimizer, "optim")}

    acc = _replace(cfg, optim={"grad_accum_steps": 2})
    _, sc = make_train_step(acc, wd)(_state(sd, acc), local)
    out["accum"] = _scalars(sc)

    out["zero"] = {}
    for moments in ("float32", "bfloat16"):
        for zero1 in (True, False):
            c = _replace(cfg, run={"shard_opt_state": zero1},
                         optim={"moment_dtype": moments})
            state, step = _state(sd, c), make_train_step(c, wd)
            for _ in range(2):
                state, _ = step(state, local)
            opt = state.optimizer
            out["zero"][moments, zero1] = {
                "masters": _masters(state),
                "bytes": dp.optimizer_state_bytes(opt),
                "opt": _opt_state(dp.zero1_state_dict(opt) if zero1
                                  else opt.state_dict())}

    g = dropout_generator(torch.device("cpu"), cfg.run.seed, 0)
    out["dropout_sample0"] = _np(random_keep((2, 4, 24, 24), 26, g)[0])

    dcfg = inp["dis_cfg"]
    pairs = {s: _local(b) for s, b in inp["pairs"].items()}
    state = _state(inp["dis_sd"], dcfg, inp["dis_teacher_sd"], inp["bank"])
    state, sc = make_distillation_train_step(dcfg, inp["dis_wd"])(state,
                                                                  pairs)
    out["bank"] = {f.name: _np(getattr(state.cluster_bank, f.name))
                   for f in dataclasses.fields(ClusterBank)}
    out["dis_scalars"] = _scalars(sc)

    it = rows_iterator(inp["batch"], 5, 2, dist.process_index(),
                       dist.process_count())
    state = _state(sd, cfg)
    state, _ = train_one_epoch(make_train_step(cfg, wd), state, it, 0)
    out["uneven"] = {"batches": sum(1 for _ in it.epoch(0)),
                     "steps": state.step, "masters": _masters(state)}
    return out


def case_eval_merge(inp) -> Dict[str, Any]:
    """Each rank's detections of its images into a TaskEvaluator, merged;
    rank 1 also repeats an image of rank 0 (a batch-pad duplicate)."""
    rank = dist.process_index()
    ev = TaskEvaluator(inp["gts"], iou_types=("bbox", "segm"),
                       score_threshold=0.1)
    for ids, scores, boxes, masks, valid in inp["batches"][rank]:
        ev.update(ids, scores, boxes, valid=valid, masks=masks)
    ev.synchronize_between_processes()
    return {"stats": ev.summarize(), "records": len(ev.dt_records)}


def _data_rows(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's data group's rows of a global batch."""
    d, n_data = dist.data_index(), dist.data_count()
    n = next(iter(batch.values())).shape[0] // n_data
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def _tp_state(sd, cfg):
    from toist_tpu_torch.parallel import tp
    model = TOIST.from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg.model,
        device="cpu")
    if dist.model_count() > 1:
        tp.shard_model(model, (dist.model_index(), dist.model_count()))
    state = init_train_state(model, cfg, 10, 100)
    dp.replicate(state)
    return state


def case_tp(inp) -> Dict[str, Any]:
    """A ('data', 'model') grid of inp["grid"]: one step at rate 0 (whole
    masters, gathered, and scalars), one at rate 0.1 (each rank's own
    masters: the replicated ones must agree over the model group), two
    steps with ZeRO-1 on and off, and a checkpoint written by rank 0 and
    restored into the grid."""
    from toist_tpu_torch.parallel import tp
    from toist_tpu_torch.train import checkpoint as ckpt

    dp.make_mesh(inp["grid"], ("data", "model"))
    cfg, wd, sd = inp["cfg"], inp["wd"], inp["sd"]
    local = _data_rows(inp["batch"])
    out: Dict[str, Any] = {"grid": (dist.data_index(), dist.model_index())}

    def whole(state):
        return {k: _np(v) for k, v in ckpt.whole_state_dict(state).items()}

    state = _tp_state(sd, cfg)
    tp.reset_counts()
    state, sc = make_train_step(cfg, wd)(state, local)
    out["step"] = {"scalars": _scalars(sc), "masters": whole(state),
                   "counts": dict(tp.COUNTS),
                   "sharded": sorted(tp.specs_of(state.model))}

    drop = _replace(cfg, model={"dropout": 0.1, "resizer_dropout": 0.1})
    state = _tp_state(sd, drop)
    state, _ = make_train_step(drop, wd)(state, local)
    out["dropout"] = {"masters": _masters(state),
                      "sharded": sorted(tp.specs_of(state.model))}

    out["zero"] = {}
    for zero1 in (True, False):
        c = _replace(cfg, run={"shard_opt_state": zero1})
        state, step = _tp_state(sd, c), make_train_step(c, wd)
        for _ in range(2):
            state, _ = step(state, local)
        out["zero"][zero1] = {"masters": whole(state),
                              "zero1": hasattr(state.optimizer, "optim"),
                              "bytes": dp.optimizer_state_bytes(
                                  state.optimizer)}
    path = os.path.join(inp["workdir"], f"tp_{inp['grid'][0]}x"
                        f"{inp['grid'][1]}.pth")
    ckpt.save(path, state, epoch=0, args={})
    mine = _masters(state)
    torch.distributed.barrier()
    back, _ = ckpt.restore(path, c, 10, 100, device="cpu")
    out["ckpt"] = {"path": path, "masters": whole(state),
                   "restored_equal": all(
                       np.array_equal(v, _masters(back)[k])
                       for k, v in mine.items())}
    return out


CASES = {"steps": case_steps, "eval_merge": case_eval_merge, "tp": case_tp}


def _run_rank(case: str, workdir: str) -> None:
    torch.manual_seed(0)
    dist.init_distributed("cpu")
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = CASES[case](inp)
    with open(os.path.join(workdir,
                           f"{case}_{dist.process_index()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy()


if __name__ == "__main__":
    _run_rank(sys.argv[1], sys.argv[2])
