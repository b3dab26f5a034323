"""Train/eval epoch loops (host-side orchestration).

Counterpart of ``toist_tpu/train/engine.py``. ``train_one_epoch``: iterate
the bucketed batches of a ``toist_tpu_torch.data.batcher.BatchIterator``,
copy each to the model's device from pinned memory, run the train step, and
read the scalars back (a host sync) only every ``print_freq`` steps and at
the last one, stopping the process on a non-finite loss as the reference
does (engine.py:82-85); those steps also go to the JSONL and TensorBoard
sinks, a distillation step's per-task bank counts with them (engine.py:
190-193). ``evaluate``: per-task loop -> ``TaskEvaluator`` -> stats vectors +
mean AP@0.5 over the tasks (engine.py:253-342, main.py:581-590), with
iou_types "segm" also the masks through the device postprocess
(``models/postprocess.start_masks_device`` / ``finish_masks_device``).

Across ranks: ``train_one_epoch`` runs the same number of steps on every
rank (each step's collectives need every rank), padding a shard that runs
out with all-invalid copies of its last batch, and merges the meters at
the epoch's end (``toist_tpu/train/engine.py:69``); ``evaluate`` is
host-sharded as JAX's is (``:105-127``): each rank evaluates its slice of
the val set and the evaluators merge their records. Under tensor
parallelism the slices are the data groups' (every rank of a model group
runs the same batches, as its forward needs), and only model rank 0 of
each data group feeds its evaluator, so nothing is counted tp times.
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from toist_tpu_torch.data.batcher import BatchIterator, BucketSpec
from toist_tpu_torch.eval.evaluator import (TaskEvaluator,
                                            gt_records_from_json, mean_ap50)
from toist_tpu_torch.models.postprocess import (finish_masks_device,
                                                start_masks_device)
from toist_tpu_torch.utils import dist
from toist_tpu_torch.utils.logging import JsonlLogger, MetricLogger
from toist_tpu_torch.utils.tracing import span
from toist_tpu_torch.utils.transfer import finish_to_host, start_to_host
from toist_tpu_torch.train.state import TrainState
from toist_tpu_torch.train.step import train_batch_to_device

LOGGED = ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm",
          "loss_contrastive_align")


def _all_invalid(batch):
    """``batch`` (or each stream of a distillation pair) with every sample
    and box marked invalid: it adds nothing to the losses, their
    denominators, the gradients or the cluster bank."""
    if "noun" in batch:
        return {k: _all_invalid(b) for k, b in batch.items()}
    return dict(batch, sample_valid=np.zeros_like(batch["sample_valid"]),
                box_valid=np.zeros_like(batch["box_valid"]))


def equal_steps(batches: Iterable) -> Iterator:
    """This rank's ``batches``, and then all-invalid copies of its last one
    until every rank's are done: shards of one epoch can yield different
    batch counts (``BatchIterator`` groups samples by canvas and flushes
    each canvas's remainder), and a rank that stopped early would leave the
    others waiting in a collective. The ranks agree on the host before each
    step."""
    it = iter(batches)
    if dist.process_count() == 1:
        yield from it
        return
    last = None
    while True:
        batch = next(it, None)
        if not dist.host_max(int(batch is not None)):
            return
        if batch is None:
            if last is None:
                raise RuntimeError(f"rank {dist.process_index()} has no "
                                   "batch in an epoch where others have")
            batch = _all_invalid(last)
        last = batch
        yield batch


def train_one_epoch(train_step: Callable, state: TrainState,
                    batch_iter: BatchIterator, epoch: int,
                    jsonl: Optional[JsonlLogger] = None, tb=None,
                    print_freq: int = 10) -> Tuple[TrainState,
                                                   Dict[str, float]]:
    """One epoch of ``train_step(state, batch)`` over ``batch_iter``'s
    batches (a distillation iterator, ``paired=True``, yields {"noun":
    Batch, "sth": Batch})."""
    logger = MetricLogger(print_freq=print_freq, header=f"Epoch [{epoch}]")
    device = state.masters[0][1].device
    n_batches = len(batch_iter)
    for i, batch in enumerate(logger.log_every(
            equal_steps(batch_iter.epoch(epoch)), total=n_batches)):
        state, scalars = train_step(state,
                                    train_batch_to_device(batch, device))
        if i % print_freq == 0 or i == n_batches - 1:
            with span("toist.host_read"):
                host = {k: float(v) for k, v in scalars.items()
                        if v.dim() == 0}
                # Per-task bank counts ([T] vectors) are logged as lists.
                vecs = {k: v.tolist() for k, v in scalars.items()
                        if v.dim() == 1}
            if not host["loss_is_finite"]:
                print(f"Loss is not finite: {host}", flush=True)
                sys.exit(1)
            logger.update(**{k: host[k] for k in LOGGED if k in host})
            if jsonl is not None:
                jsonl.write({"kind": "train_step", "epoch": epoch,
                             "step": int(state.step), **host, **vecs})
            if tb is not None:
                # Reference tags: 'training_loss' + each weighted loss
                # (engine.py:108-111); per task 'update_count_N' and
                # 'full_label_N' (engine.py:190-193).
                row = {"training_loss": host["loss"]} if "loss" in host \
                    else {}
                row.update({k: v for k, v in host.items()
                            if k.startswith("loss_")
                            and k != "loss_is_finite"})
                for name, tag in (("bank_update_count", "update_count"),
                                  ("bank_full", "full_label")):
                    for j, v in enumerate(vecs.get(name, [])):
                        row[f"{tag}_{j + 1}"] = v
                tb.add_scalars(row, step=int(state.step))
    # Global (cross-host) epoch stats, incl. iter_time/data_time.
    logger.synchronize_between_processes()
    return state, logger.summary()


def evaluate(eval_step: Callable, task_datasets: Dict[int, object],
             spec: BucketSpec, batch_size: int, iou_types=("bbox",),
             print_freq: int = 10) -> Dict[int, Dict[str, np.ndarray]]:
    """Run per-task evaluation; returns {task_id: {'bbox': stats12,
    'segm': stats12 with iou_types "segm"}}.

    ``eval_step(batch)`` (``train/step.make_eval_step``) takes a batcher
    batch and returns {"post": {"scores", "boxes", ...}, "scalars": {...}},
    and "pred_masks" for "segm". The loop is double-buffered as the JAX one
    is: each batch's detections go to the host by non-blocking copies into
    pinned memory, its mask postprocess is queued on the device with its
    transitions' copies (``start_masks_device``), and the evaluator reads
    them (after the copies' events; ``finish_masks_device`` assembles the
    RLEs) only once the next batch's forward has been issued, so the copies
    and the host's work overlap the device's."""
    segm = "segm" in iou_types
    results = {}
    for task_id, ds in task_datasets.items():
        gts = gt_records_from_json(ds.coco.dataset)
        evaluator = TaskEvaluator(gts, iou_types=iou_types)
        # Each rank evaluates its slice of the val set (the reference's
        # DistributedSampler on dataset_val, main.py:439).
        it = BatchIterator([ds], spec, batch_size=batch_size, shuffle=False,
                           shard_id=dist.data_index(),
                           num_shards=dist.data_count())
        feeds = dist.model_index() == 0
        logger = MetricLogger(print_freq=print_freq,
                              header=f"Eval task {task_id}:")

        def _flush(item):
            # Materialize one batch's results on host (blocks on the copies
            # that have been overlapping the next batch's forward).
            np_b, handle, mask_handle = item
            host = finish_to_host(handle)
            masks = (finish_masks_device(mask_handle)
                     if mask_handle is not None else None)
            if feeds:
                evaluator.update(np_b["image_id"], host["scores"],
                                 host["boxes"], valid=np_b["sample_valid"],
                                 masks=masks)
            if "loss" in host:  # absent w/ compute_eval_losses off
                logger.update(loss=float(host["loss"]))

        pending = None
        for np_batch in logger.log_every(it.epoch(0), total=len(it)):
            res = eval_step(np_batch)
            src = {k: res["post"][k] for k in ("scores", "boxes")}
            if "loss" in res["scalars"]:
                src["loss"] = res["scalars"]["loss"]
            handle = start_to_host(src)
            mask_handle = (start_masks_device(
                res["pred_masks"], np_batch["size"], np_batch["orig_size"],
                np_batch["sample_valid"]) if segm else None)
            if pending is not None:
                _flush(pending)
            pending = (np_batch, handle, mask_handle)
        if pending is not None:
            _flush(pending)
        logger.synchronize_between_processes()
        evaluator.synchronize_between_processes()
        results[task_id] = evaluator.summarize()
        ap50 = results[task_id]["bbox"][1]
        print(f"Task {task_id}: AP@0.5 = {ap50:.4f}", flush=True)
    print(f"Mean AP@0.5 over {len(results)} tasks: "
          f"{mean_ap50(results):.4f}", flush=True)
    return results
