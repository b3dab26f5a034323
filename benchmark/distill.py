"""The training mode ``distill``: TOIST's noun-pronoun distillation step
(``make_distillation_train_step``) under the training skeleton of
``training.py``.

Its program's set-up builds the training state as ``main`` does under
``loss.distillation``: the student from the seed's weights and the teacher
from the seed + 1's (``main`` draws the teacher from ``run.seed + 1``), the
cluster bank from ``init_bank`` with a generator seeded with the seed + 2
and then as a deployment's bank is after its first few hundred steps
(every task's update count past the memory size, its centres converged on
its bank),
``init_train_state`` with both models and the bank, ``load_masters`` for
each. It drives the first ``check_steps`` steps by the window's own call
and feed and keeps what the check compares: each step's loss; both
models' first gradients (AdamW's first moment over 1 - beta1), their
changes and their EMAs' changes after the checked steps; the bank after
them; and per step the pooled features both bank calls were given and the
text memory each stream's decode read (``watching``, which stands around
the program's own calls in the checked steps only). Once the window has
closed, ``reference/distill.py`` repeats the checked steps from the same
weights, bank and batches, its bank fed the program's pooled features.

A pool entry is a pair {"noun": Batch, "sth": Batch} in the batcher's
layout: the plain mode's batch (``traffic.train_pool``) with the images,
boxes and tasks shared by both sides, and the captions of the two
streams. The teacher's is the task's verb ids and 1-3 noun ids, each box
tied to the verb and the noun (its positive map) and to the noun alone
(its noun span); the student's is the same verb ids and one "something"
id (the caption's span), each box tied to the whole caption.

The step the window runs sums the step's k-means counters ("kmeans_iters",
"kmeans_issued") on the device from the first step after set-up on;
``run`` reads them once, when the run is over, into its record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import counters, traffic, train, training, weights
from benchmark.reference import distill as rd
from benchmark.reference import toist as ref
from benchmark.serve import model_sizes, program_config
from benchmark.training import Feed

FAMILY = training.FAMILY

SHARED = ("images", "image_mask", "boxes", "box_valid", "sample_valid",
          "task_id")
# The set-up's k-means on each task's bank stops on its tolerance well
# before this many iterations (11-24 from init_bank's centres at 1,024 x
# 256).
CONVERGED = 1000


def stream_seed(run_seed: int, step: int, stream: int) -> int:
    """The program's documented dropout seed of a distillation step's
    forward half ``stream`` (1, 2: the teacher's encode and decode; 3, 4:
    the student's) on one process (``train/step.dropout_generator``)."""
    return (((run_seed * 1_000_003 + step) * 1_009)
            + stream * 0x9E3779B97F4A7C15) % 2 ** 63


def pair_pool(t: dict, vocab: int, max_text_len: int, max_boxes: int,
              num_logit_cols: int, seed: int) -> List[Dict[str, dict]]:
    """The plain mode's pool of batches, each made a noun / pronoun pair."""
    verbs = traffic.task_captions(t, vocab, max_text_len, seed)
    rng = traffic.rng_of(seed, 5)
    something = int(rng.integers(3, vocab))
    lo, hi = t["noun_ids"]
    pool = []
    for b in traffic.train_pool(t, vocab, max_text_len, max_boxes,
                                num_logit_cols, seed):
        B, N = b["box_valid"].shape
        side = {s: {"text_ids": np.full((B, max_text_len), traffic.PAD,
                                        np.int32),
                    "positive_map": np.zeros((B, N, num_logit_cols),
                                             np.float32),
                    "noun_token_spans": np.full((B, N, 2), -1, np.int32),
                    "caption_noun_span": np.full((B, 2), -1, np.int32)}
                for s in ("noun", "sth")}
        for i in range(B):
            cap = verbs[b["task_id"][i] - 1]
            verb = cap[1:int((cap != traffic.PAD).sum()) - 1]
            nouns = rng.integers(3, vocab, int(rng.integers(lo, hi + 1)))
            v, boxes = len(verb), b["box_valid"][i]
            for s, tail in (("noun", nouns), ("sth", [something])):
                x, n = side[s], len(tail)
                ids = np.concatenate([[traffic.BOS], verb, tail,
                                      [traffic.EOS]])
                x["text_ids"][i, :len(ids)] = ids
                x["noun_token_spans"][i, boxes] = (1 + v, v + n)
                if s == "noun":         # each box: the verb and the noun
                    x["positive_map"][i, boxes, 1:1 + v + n] = 1 / (v + n)
                else:                   # each box: the whole caption
                    x["positive_map"][i, boxes, 1:2 + v] = 1 / (v + 1)
                    x["caption_noun_span"][i] = (1 + v, 1 + v)
        pool.append({s: dict({k: b[k] for k in SHARED}, **x,
                             text_mask=x["text_ids"] == traffic.PAD)
                     for s, x in side.items()})
    return pool


def pair_flops(m: dict, pair: dict) -> float:
    """Model FLOP of one step: both models' forward and backward on every
    image, each over the keys its own caption leaves."""
    H, W = pair["noun"]["images"].shape[1:3]
    total = 0.0
    for b in pair.values():
        for im_mask, t_mask in zip(b["image_mask"], b["text_mask"]):
            keys = int((~im_mask[::32, ::32]).sum()) + int((~t_mask).sum())
            total += counters.train_flops(m, H, W, keys, t_mask.shape[0])
    return total


def canvas(pair: dict):
    return pair["noun"]["images"].shape


def inputs(cell, seed: int, device) -> dict:
    """What both sides start from: the two models' weights ({"s", "t"},
    reference layout), the full bank (``init_bank``'s tensors, every task
    full and its centres k-means' fixed point on its bank, as a deployed
    bank's are after a few hundred steps of warm-started solves), the pool
    and the model's sizes."""
    from toist_tpu_torch.train.cluster import init_bank

    config, t = cell.config, cell.traffic
    m = model_sizes(config)
    spec = ref.param_spec(m)
    loss = config["loss"]
    bank = init_bank(t["tasks"], loss["cluster_memory_size"],
                     loss["cluster_num"], m["hidden_dim"],
                     weights.generator(seed + 2, device))
    bank.update_count.fill_(loss["cluster_memory_size"] + 1)
    bank.full.fill_(True)
    for i in range(t["tasks"]):
        bank.cluster_centers[i] = rd.lloyd(
            bank.feature_bank[i], bank.cluster_centers[i], CONVERGED,
            loss["kmeans_tol"])[0]
    return {"W": {"s": weights.make_weights(spec, seed, device),
                  "t": weights.make_weights(spec, seed + 1, device)},
            "bank0": dataclasses.asdict(bank), "m": m,
            "pool": pair_pool(t, m["vocab_size"],
                              config["data"]["max_text_len"],
                              config["data"]["max_boxes"],
                              config["data"]["num_logit_cols"], seed)}


@contextlib.contextmanager
def watching(state, log: Dict[str, list]):
    """Record, around the program's own calls, what the check compares of
    a step besides its state: the pooled features each ``cluster_select``
    call is given (the teacher's, then the student's) and the text memory
    each model's ``decode`` reads. Nothing the step computes changes."""
    from toist_tpu_torch.train import cluster as cl

    select = cl.cluster_select

    def recorded_select(bank, pooled, *args, **kwargs):
        log["pooled"].append(pooled.detach().float().clone())
        return select(bank, pooled, *args, **kwargs)

    def recorded(decode):
        def call(cache, use_modified_memory=False, generator=None):
            mem = cache["img_memory_mod" if use_modified_memory
                        else "img_memory"]
            T = cache["text_attention_mask"].shape[1]
            log["decoded"].append(mem[:, -T:].detach().float().clone())
            return decode(cache, use_modified_memory=use_modified_memory,
                          generator=generator)
        return call

    models = (state.teacher, state.model)
    cl.cluster_select = recorded_select
    for mod in models:
        mod.decode = recorded(mod.decode)
    try:
        yield
    finally:
        cl.cluster_select = select
        for mod in models:
            del mod.decode


class KmeansCounts:
    """The steps' k-means counters summed from step ``skip`` + 1 on: the
    iterations that moved centers on the device, those issued on the
    host."""

    def __init__(self):
        self.skip, self.calls, self.iters, self.issued = 0, 0, None, 0

    def add(self, scalars: dict) -> None:
        self.calls += 1
        if self.calls <= self.skip or "kmeans_iters" not in scalars:
            return
        it = scalars["kmeans_iters"]
        self.iters = it if self.iters is None else self.iters + it
        self.issued += int(scalars["kmeans_issued"])

    def read(self) -> dict:
        if self.iters is None:
            return {}
        return {"kmeans_iters": int(self.iters),
                "kmeans_issued": self.issued}


def checked_setup(cell, seed: int, device="cuda", step_hook=None,
                  counts: Optional[KmeansCounts] = None) -> dict:
    """Build the training state from the seed and drive it through its
    checked steps by the window's call and feed; returns the state, the
    step, the pool, the inputs and the program's record."""
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train.cluster import ClusterBank
    from toist_tpu_torch.train.criterion import build_weight_dict
    from toist_tpu_torch.train.distill import make_distillation_train_step
    from toist_tpu_torch.train.engine import train_one_epoch
    from toist_tpu_torch.train.state import (init_train_state, load_masters,
                                             model_masters)

    t = cell.traffic
    s = inputs(cell, seed, device)
    W, pool = s["W"], s["pool"]
    cfg = program_config(cell.config, seed)
    spe = t["steps_per_epoch"]
    bank = ClusterBank(**{k: v.clone() for k, v in s["bank0"].items()})
    state = init_train_state(
        TOIST.from_state_dict(W["s"], cfg.model, device), cfg, spe,
        spe * cfg.optim.epochs,
        teacher=TOIST.from_state_dict(W["t"], cfg.model, device),
        cluster_bank=bank)
    load_masters(state, W["s"])
    load_masters(state, W["t"], teacher=True)
    step = make_distillation_train_step(cfg, build_weight_dict(
        cfg.loss, cfg.model.masks, cfg.model.dec_layers))
    if step_hook is not None:
        step = step_hook(step)
    n_check, pf = t["check_steps"], t["print_freq"]
    log = {k: [] for k in ("losses", "pooled", "decoded", "kmeans_iters")}
    counts = counts or KmeansCounts()
    # The window's first step follows the checked steps, one step on each
    # canvas they left out and the warm-up stretch (``training.drive``).
    counts.skip = n_check + t["warmup_steps"] + len(
        {canvas(b) for b in pool} - {canvas(pool[i]) for i in range(n_check)})

    def train_step(state, batch):
        checked = len(log["losses"]) < n_check
        state, scalars = step(state, batch)
        if checked:
            log["losses"].append(scalars["loss"])
            log["kmeans_iters"].append(scalars.get("kmeans_iters"))
        counts.add(scalars)
        return state, scalars

    def masters():
        return [(f"{w}.{n}", mm, w) for w, teacher in (("s", False),
                                                        ("t", True))
                for n, _, mm in model_masters(state, teacher)]

    with watching(state, log):
        state, _ = train_one_epoch(train_step, state, Feed(pool, 0, 1), 0,
                                   print_freq=pf)
        program = {"grad": train.leaf_norms(
            {n: state.optimizer.state[mm]["exp_avg"] / 0.1
             for n, mm, _ in masters()})}
        state, _ = train_one_epoch(train_step, state,
                                   Feed(pool, 1, n_check - 1), 0,
                                   print_freq=pf)
    emas = {"s": state.ema, "t": state.teacher_ema}
    with torch.no_grad():
        program["change"] = train.leaf_norms(
            {n: mm - W[w][n[2:]] for n, mm, w in masters()})
        program["ema_change"] = train.leaf_norms(
            {n: emas[w][n[2:]] - W[w][n[2:]] for n, _, w in masters()})
    program["bank"] = {k: getattr(state.cluster_bank, k).clone()
                       for k in ("feature_bank", "cluster_centers")}
    program.update(losses=[float(x) for x in log["losses"]],
                   kmeans_iters=[None if x is None else int(x)
                                 for x in log["kmeans_iters"]],
                   **{k: [tuple(log[k][i:i + 2])
                          for i in range(0, len(log[k]), 2)]
                      for k in ("pooled", "decoded")})
    return dict(s, state=state, train_step=train_step, program=program)


def reference_steps(cell, s: dict, seed: int, device, prec: str = "f32",
                    feed: Optional[List[tuple]] = None) -> dict:
    """``reference/distill.distill_steps`` over the checked steps of the
    inputs ``s``, with the plain mode's trainable tensors and schedule,
    its bank fed the pooled features ``feed``."""
    t, optim = cell.traffic, cell.config["optim"]
    names = [k for k, _, kind in ref.param_spec(s["m"])
             if train.trainable(k, kind)]
    return rd.distill_steps(
        s["W"], s["bank0"], s["m"], cell.config, names,
        lambda k, step: train.lr_of(train.group_of(k), step, optim, t),
        s["pool"][:t["check_steps"]],
        functools.partial(stream_seed, seed), device, prec, feed)


def _rel(p: torch.Tensor, r: torch.Tensor) -> float:
    if p.shape != r.shape:
        return float("inf")
    p = p.to(r.device, torch.float32)
    return float(torch.linalg.norm(p - r)
                 / torch.linalg.norm(r).clamp(min=1e-30))


def snapped_tokens(pair: dict) -> tuple:
    """Per stream (teacher, student), the text tokens snapped in each image
    [B, T] and whether the image is snapped [B]."""
    x = {s: {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in b.items()} for s, b in pair.items()}
    n, st = x["noun"], x["sth"]
    T = n["text_ids"].shape[1]
    bv = n["box_valid"] & n["sample_valid"][:, None]
    m = rd.span_mask(n["noun_token_spans"], T) & bv[..., None]
    cap = rd.span_mask(st["caption_noun_span"], T)
    return ((m.any(1), m.any(-1).any(-1) & n["sample_valid"]),
            (cap, cap.any(-1) & st["sample_valid"]))


def change_gap(program: torch.Tensor, reference: torch.Tensor,
               start: torch.Tensor) -> float:
    """The worst task's gap between the norms of the two sides' changes
    from ``start``, over the reference's: a bank left as it was reads 1, a
    task only the program changed inf."""
    worst = 0.0
    for p, r, s in zip(program.to(reference.device), reference,
                       start.to(reference.device)):
        dp, dr = float(torch.linalg.norm(p - s)), float(
            torch.linalg.norm(r - s))
        worst = max(worst, abs(dp - dr) / dr if dr > 0
                    else (0.0 if dp == 0 else float("inf")))
    return worst


def gaps(program: dict, reference: dict, pairs: List[dict],
         bank0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The check's numbers: ``train.gaps`` over both models' tensors; the
    bank's, ``change_gap`` of its feature bank and of its centres over the
    checked steps from ``bank0``, the worse; the pooled features', the
    worst image's relative gap of those the program gave the bank to the
    reference's own; the snap's, the worst snapped image's relative gap of
    the text rows its decode read at the snapped tokens (the chosen
    centres); and, reported, not limited, the reference's own choices that
    differ from those its bank made (``reference/distill.Bank``)."""
    out = train.gaps(program, reference)
    out["bank_gap"] = max(change_gap(program["bank"][k],
                                     reference["bank"][k], bank0[k])
                          for k in ("feature_bank", "cluster_centers"))
    for key, name in (("pooled", "pool_gap"), ("decoded", "snap_gap")):
        worst = 0.0 if len(program[key]) == len(pairs) else float("inf")
        for pair, ps, rs in zip(pairs, program[key], reference[key]):
            for (tokens, valid), p, r in zip(snapped_tokens(pair), ps, rs):
                if p.shape != r.shape:
                    worst = float("inf")
                    continue
                for b in np.flatnonzero(valid.numpy()):
                    pb, rb = ((p[b][tokens[b]], r[b][tokens[b]])
                              if key == "decoded" else (p[b], r[b]))
                    worst = max(worst, _rel(pb, rb))
        out[name] = worst
    out["near_ties"] = float(reference["near_ties"])
    out["flips"] = float(reference["flips"])
    return out


def numbers(cell, s: dict, seed: int, device) -> Dict[str, float]:
    """The check's numbers: the reference's checked steps from the seed's
    weights and bank over the pool's first entries, its bank fed the
    program's pooled features, against the program's."""
    reference = reference_steps(cell, s, seed, device,
                                feed=s["program"]["pooled"])
    return gaps(s["program"], reference,
                s["pool"][:cell.traffic["check_steps"]], s["bank0"])


PROGRAM = training.Program(setup=checked_setup, flops=pair_flops,
                           canvas=canvas, numbers=numbers)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", step_hook=None) -> dict:
    """One run of a distillation cell; returns the harness's record, with
    the k-means counters of the steps after set-up."""
    counts = KmeansCounts()
    program = dataclasses.replace(
        PROGRAM, setup=functools.partial(checked_setup, counts=counts))
    record = training.drive(program, cell, seed, seconds, trace, t_start,
                            device, step_hook)
    record.update(counts.read())
    return record
