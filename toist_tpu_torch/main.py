"""Training / evaluation entry point for detection, segmentation and
noun-pronoun distillation (the reference's main.py:277-742; counterpart of
``toist_tpu/main.py``).

Workflow: config -> tokenizer (HF vocab files if present, else a BPE trained
on the dataset's closed caption vocabulary) -> per-task datasets -> model ->
TrainState (fresh from ``init_like_jax`` / --load warm start / --resume) ->
epoch loop with a checkpoint every epoch, an eval every eval_skip epochs (on
the EMA weights when EMA is on) and the best checkpoint by mean AP@0.5
(main.py:599-738). ``--eval`` evaluates once and returns the mean AP@0.5.

Distillation (``loss.distillation``) trains a teacher on "verb + noun"
captions beside the student on "verb + something" captions, from paired
batches: the teacher is a second model from ``run.seed + 1``, or the
weights of ``run.load_noun``. ``loss.cluster`` adds the cluster bank, and
the eval then snaps the "something" span to its cluster center.

Segmentation (``model.mask_model=smallconv``, which sets ``model.masks``)
adds the mask head and its focal and dice losses; ``--load`` of a
detection checkpoint keeps the fresh mask-head init, and with
``model.frozen_detector`` only the mask branch trains. The eval then
scores bbox and segm, and the logs gain the mask AP@0.5.

Run:  python -m toist_tpu_torch.main --config configs/fixture.json \\
          [--eval] [--resume P] [--load P] [--output-dir D] [--set k=v ...]
          [--device cpu]
      torchrun --nproc_per_node N -m toist_tpu_torch.main ...

The model runs on the card (``--device cuda``, the default) unless the
caller asks for another device. Under torchrun each rank takes its own
card and its own slice of every batch (the config's batch sizes are per
rank, the reference's per-GPU batches, ``toist_tpu/main.py:160-186``): the
losses and gradients are the global batch's, ZeRO-1 shards the optimizer
state with ``run.shard_opt_state``, the eval is host-sharded and merged,
and rank 0 alone writes ``log.jsonl``, TensorBoard and the checkpoints.
With ``run.mesh_shape=[-1, tp]`` and ``run.mesh_axes=["data", "model"]``
the ranks form a (dp, tp) grid (``parallel/data.make_mesh``): each model
group of tp ranks holds one replica sharded by ``parallel/tp.py`` and runs
its data group's batches. ``run.pretrained_backbone`` /
``run.pretrained_text`` load torchvision, timm or Hugging Face files into
a fresh model (``utils/pretrained.py``), before ``--load`` and
``--resume``; ``run.profile_dir`` traces the first epoch
(``utils/profiling.py``). A ``model.compute_dtype=float32`` run computes
in f32 on the card: TF32 is off for its convolutions and products
(``f32_policy``).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from toist_tpu_torch.config import Config
from toist_tpu_torch.data.batcher import (BatchIterator, BucketSpec,
                                          default_buckets, train_buckets)
from toist_tpu_torch.data.captions import build_tokenizer
from toist_tpu_torch.data.cocotasks import TASKS, build_task_dataset
from toist_tpu_torch.eval.evaluator import mean_ap50
from toist_tpu_torch.models.init import init_like_jax
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.parallel import data as dp
from toist_tpu_torch.parallel import tp
from toist_tpu_torch.train import checkpoint as ckpt
from toist_tpu_torch.train import engine
from toist_tpu_torch.train.cluster import init_bank
from toist_tpu_torch.train.criterion import build_weight_dict
from toist_tpu_torch.train.distill import (make_cluster_eval_step,
                                           make_distillation_train_step)
from toist_tpu_torch.train.state import init_train_state, load_masters
from toist_tpu_torch.train.step import make_eval_step, make_train_step
from toist_tpu_torch.utils import dist
from toist_tpu_torch.utils.logging import JsonlLogger
from toist_tpu_torch.utils.pretrained import apply_pretrained
from toist_tpu_torch.utils.profiling import trace
from toist_tpu_torch.utils.tensorboard import SummaryWriter


def build_specs(cfg: Config):
    """(train_spec, eval_spec), as ``toist_tpu/main.py:build_all`` builds
    them. Eval uses the two-canvas spec (fixed short-side-800 resize);
    training uses the finer 8-canvas ladder so multiscale samples don't pad
    to the full eval canvas (batcher.train_buckets)."""
    common = dict(max_text_len=cfg.data.max_text_len,
                  max_boxes=cfg.data.max_boxes,
                  num_logit_cols=cfg.data.num_logit_cols,
                  with_masks=cfg.model.masks)
    eval_spec = BucketSpec(
        buckets=cfg.data.image_buckets if cfg.data.image_buckets else
        default_buckets(cfg.data.max_size, 800), **common)
    # Train canvas precedence: explicit train_image_buckets > explicit
    # image_buckets (a user pinning canvases pins BOTH phases) > the
    # multiscale ladder.
    if cfg.data.train_image_buckets:
        tb = cfg.data.train_image_buckets
    elif cfg.data.image_buckets:
        tb = cfg.data.image_buckets
    else:
        tb = train_buckets(cfg.data.max_size, cfg.data.train_scales)
    train_spec = BucketSpec(buckets=tb, **common)
    return train_spec, eval_spec


def git_sha() -> str:
    """Best-effort git stamp (reference util/misc.py:19-37, main.py:294)."""
    import subprocess
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=5).stdout.strip() or "n/a"
    except Exception:
        return "n/a"


def main(cfg: Config, device="cuda") -> Optional[float]:
    """Run ``cfg``; under torchrun, as one rank of the group it sets up
    (``utils/dist.init_distributed``) and leaves at the end."""
    own_group = not dist.initialized()
    try:
        with f32_policy(cfg.model.compute_dtype):
            return _main(cfg, dist.init_distributed(device))
    finally:
        if own_group:
            dist.destroy()


@contextlib.contextmanager
def f32_policy(compute_dtype: str):
    """A ``float32`` run computes in f32 on the card, as the JAX package
    does: cuDNN convolutions and cuBLAS products default to TF32 there, so
    both are turned off for the run and restored after it. A ``bfloat16``
    run keeps the defaults."""
    if compute_dtype != "float32":
        yield
        return
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    was = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, w in zip(flags, was):
            f.allow_tf32 = w


def _main(cfg: Config, device: torch.device) -> Optional[float]:
    grid = dp.make_mesh(cfg.run.mesh_shape, cfg.run.mesh_axes)
    shard = (grid.model_index, grid.tp)
    print(f"toist_tpu_torch git sha: {git_sha()}", flush=True)
    tokenizer = build_tokenizer(cfg)
    train_spec, eval_spec = build_specs(cfg)
    jsonl = JsonlLogger(cfg.run.output_dir)
    # TensorBoard event files next to log.jsonl (reference main.py:593 writes
    # them into output_dir; rank-gated like its is_main_process guard).
    tb = SummaryWriter(cfg.run.output_dir)

    train_sets = []
    if not cfg.run.eval_only:
        train_sets = [build_task_dataset(cfg.data, t, "train", tokenizer,
                                         masks=cfg.model.masks,
                                         distillation=cfg.loss.distillation)
                      for t in cfg.data.tasks]
    val_sets = {t: build_task_dataset(cfg.data, t, "val", tokenizer,
                                      masks=cfg.model.masks)
                for t in cfg.data.tasks}

    train_iter = None
    if train_sets:
        # With gradient accumulation the step consumes accum * B samples and
        # applies one optimizer update, so the iterator batches (and hence
        # steps_per_epoch / the LR schedules) scale accordingly. Each data
        # group takes its shard (the reference's DistributedSampler,
        # main.py:409); len() is the same on every rank, and so are the
        # schedules.
        train_iter = BatchIterator(
            train_sets, train_spec,
            batch_size=(cfg.optim.train_batch_size
                        * cfg.optim.grad_accum_steps),
            seed=cfg.run.seed, shuffle=True,
            shard_id=dist.data_index(), num_shards=dist.data_count(),
            paired=cfg.loss.distillation, num_workers=cfg.data.num_workers,
            worker_mode=cfg.data.worker_mode)
        steps_per_epoch = max(1, len(train_iter))
    elif cfg.run.eval_only:
        steps_per_epoch = 1  # LR schedules are never consulted in eval-only
    else:
        raise ValueError(
            "train mode with no train datasets: set data.tasks (or run with "
            "--eval); a placeholder steps_per_epoch would silently misshape "
            "the LR schedules")
    total_steps = steps_per_epoch * cfg.optim.epochs
    weight_dict = build_weight_dict(cfg.loss, cfg.model.masks,
                                    cfg.model.dec_layers)

    start_epoch = cfg.run.start_epoch
    if cfg.run.resume:
        state, start_epoch = ckpt.restore(cfg.run.resume, cfg,
                                          steps_per_epoch, total_steps,
                                          device)
        start_epoch += 1
    else:
        model = apply_pretrained(
            cfg, _fresh_model(cfg, tokenizer, device, cfg.run.seed))
        if cfg.run.load:
            # Overlay: keys only in the fresh model keep their init
            # (reference --frozen_weights, main.py:475-489).
            model.load_state_dict(ckpt.merge_params(
                model.state_dict(), ckpt.load_params(cfg.run.load,
                                                     prefer_ema=True)))
        teacher = bank = None
        if cfg.loss.distillation:
            teacher = apply_pretrained(cfg, _fresh_model(
                cfg, tokenizer, device, cfg.run.seed + 1))
            if cfg.run.load_noun:
                teacher.load_state_dict(ckpt.load_params(cfg.run.load_noun,
                                                         prefer_ema=True))
        if grid.tp > 1:
            for m in (model, teacher):
                if m is not None:
                    tp.shard_model(m, shard)
        if cfg.loss.cluster:
            # A converted JAX checkpoint's bank, else a fresh one.
            bank = (cfg.run.load and ckpt.load_jax_cluster_bank(
                cfg.run.load, device)) or init_bank(
                    len(TASKS), cfg.loss.cluster_memory_size,
                    cfg.loss.cluster_num, cfg.model.hidden_dim,
                    torch.Generator(device).manual_seed(cfg.run.seed))
        # The f32 weights outlive the cast below: they become the masters.
        weights = model.state_dict()
        model.to_compute_dtype()
        tweights = None
        if teacher is not None:
            tweights = teacher.state_dict()
            teacher.to_compute_dtype()
        state = init_train_state(model, cfg, steps_per_epoch, total_steps,
                                 teacher=teacher, cluster_bank=bank)
        load_masters(state, weights)
        if teacher is not None:
            load_masters(state, tweights, teacher=True)
        del weights, tweights
    dp.replicate(state)

    # The EMA is evaluated in a second model in the compute dtype, loaded
    # from the EMA before each eval; state.model keeps the trained weights.
    eval_model = state.model
    if cfg.optim.ema and state.ema is not None:
        eval_model = copy.deepcopy(state.model).eval()
    if cfg.loss.cluster:
        cluster_eval = make_cluster_eval_step(eval_model, cfg, weight_dict)

        def eval_step(batch):
            return cluster_eval(state.cluster_bank, batch)
    else:
        eval_step = make_eval_step(eval_model, cfg, weight_dict)

    def run_eval(epoch: int = 0) -> float:
        if eval_model is not state.model:
            eval_model.load_state_dict(ckpt.full_state_dict(state, ema=True))
        # Per rank: the eval is host-sharded (toist_tpu/main.py:313-319).
        results = engine.evaluate(
            eval_step, val_sets, eval_spec,
            batch_size=cfg.optim.valid_batch_size,
            iou_types=("bbox", "segm") if cfg.model.masks else ("bbox",))
        m = mean_ap50(results)
        # Reference TB tags: mean + per-task AP@0.5 (main.py:697-711).
        row = {"map@0.5_bbox": m}
        for t, stats in results.items():
            row[f"{t:02d}_ap@0.5_bbox"] = float(stats["bbox"][1])
            if "segm" in stats:
                row[f"{t:02d}_ap@0.5_masks"] = float(stats["segm"][1])
        record = {"kind": "eval", "mean_ap50": m,
                  "per_task": {t: {k: v.tolist() for k, v in s.items()}
                               for t, s in results.items()}}
        if cfg.model.masks and results:
            row["map@0.5_masks"] = record["map@0.5_masks"] = float(
                np.mean([s["segm"][1] for s in results.values()]))
        jsonl.write(record)
        tb.add_scalars(row, step=epoch)
        return m

    if cfg.run.eval_only:
        return run_eval()

    train_step = (make_distillation_train_step if cfg.loss.distillation
                  else make_train_step)(cfg, weight_dict)
    best_map = -1.0
    for epoch in range(start_epoch, cfg.optim.epochs):
        t0 = time.time()
        with trace(cfg.run.profile_dir if epoch == start_epoch else None):
            state, train_stats = engine.train_one_epoch(
                train_step, state, train_iter, epoch, jsonl=jsonl, tb=tb)
        jsonl.write({"kind": "epoch", "epoch": epoch,
                     "seconds": time.time() - t0, **train_stats})
        if cfg.run.output_dir:
            ckpt.save(os.path.join(cfg.run.output_dir, "checkpoint"), state,
                      epoch, async_save=cfg.run.async_checkpoint,
                      args=cfg.to_dict())
        if epoch % cfg.optim.eval_skip == 0:
            m = run_eval(epoch=epoch)
            if m > best_map and cfg.run.output_dir:
                best_map = m
                ckpt.save(os.path.join(cfg.run.output_dir, "BEST_checkpoint"),
                          state, epoch, async_save=cfg.run.async_checkpoint,
                          args=cfg.to_dict())
    ckpt.wait_for_async_saves()
    return best_map


def _fresh_model(cfg: Config, tokenizer, device: torch.device, seed: int
                 ) -> TOIST:
    """An f32 model on ``device`` with flax's initialisers from ``seed``."""
    with torch.device(device):
        model = TOIST(cfg.model, text_vocab_size=tokenizer.vocab_size)
    return init_like_jax(model, torch.Generator(device).manual_seed(seed))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TOIST on PyTorch")
    p.add_argument("--config", default=None, help="json config file")
    p.add_argument("--set", nargs="*", default=[],
                   help="overrides like optim.lr=1e-4 model.masks=true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--resume", default="")
    p.add_argument("--load", default="")
    p.add_argument("--output-dir", default="")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cpu: no card)")
    return p


def _config(args: argparse.Namespace) -> Config:
    overrides: Dict[str, dict] = {}
    for kv in args.set:
        key, val = kv.split("=", 1)
        sec, name = key.split(".", 1)
        try:
            val = json.loads(val)
        except json.JSONDecodeError:
            pass
        overrides.setdefault(sec, {})[name] = val
    run = overrides.setdefault("run", {})
    if args.eval:
        run["eval_only"] = True
    if args.resume:
        run["resume"] = args.resume
    if args.load:
        run["load"] = args.load
    if args.output_dir:
        run["output_dir"] = args.output_dir
    return Config.from_sources(args.config, overrides)


def parse_args(argv=None) -> Config:
    """The config of a command line (``toist_tpu/main.py:parse_args``)."""
    return _config(_parser().parse_args(argv))


if __name__ == "__main__":
    _args = _parser().parse_args()
    main(_config(_args), device=_args.device)
