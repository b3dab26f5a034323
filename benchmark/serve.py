"""The serving runner: one closed-loop client calling
``Predictor.predict_batch`` on full batches, back to back.

Set-up makes the weights and the request pool from the seed and runs each
canvas of the mix twice. The window then sends the pool round and round
until ``--seconds`` have passed and the call in flight has returned; every
call is timed by the host clock, and each ends in the copy of its answer
to the host. A traced run then profiles ``trace_calls`` more calls, twice
(``probes.traced``). Once
the window has closed and the peak memory is read, the program is freed
and the reference answers the sampled calls.
"""
from __future__ import annotations

import gc
import itertools
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, counters, pace, probes, traffic, weights
from benchmark.reference import toist as ref

# The record's "mode": the family of runners whose records the ``*.serve``
# readers read.
FAMILY = "serve"


def model_sizes(config: dict) -> dict:
    m = dict(config["model"])
    m["vocab_size"] = config["vocab_size"]
    m["text_max_position"] = config["text_max_position"]
    return m


def program_config(config: dict, run_seed: int = None):
    """The program's ``Config`` from a configuration file's sections (and
    the run's seed, which seeds training's dropout)."""
    from toist_tpu_torch.config import Config

    over = {k: config[k] for k in ("model", "data", "optim", "loss")
            if k in config}
    if run_seed is not None:
        over["run"] = {"seed": int(run_seed)}
    return Config.from_sources(None, over)


def build_predictor(W: Dict[str, torch.Tensor], config: dict, device,
                    threshold: float):
    from toist_tpu_torch.predict import Predictor

    return Predictor.from_state_dict(W, program_config(config),
                                     device=device,
                                     score_threshold=threshold)


def check_sample(t: dict, answered: int, seed: int) -> List[int]:
    """The pool entries whose first answer the check compares, drawn
    among the first ``answered``."""
    rng = traffic.rng_of(seed, 3)
    n = min(t["check_calls"], answered)
    return sorted(int(i) for i in rng.choice(answered, n, replace=False))


@torch.no_grad()
def reference_answers(W, m: dict, batch: dict, device, prec: str = "f32"):
    """(scores [B, Q], boxes [B, Q, 4]) of the reference on one batch."""
    model = ref.Reference(W, m, prec)
    x = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
         for k in ("images", "image_mask", "text_ids", "text_mask",
                   "orig_size")}
    with ref.f32_mode():
        out = model.forward(x["images"], x["image_mask"],
                            x["text_ids"].long(), x["text_mask"])
        scores, boxes = ref.postprocess(out["pred_logits"],
                                        out["pred_boxes"], x["orig_size"])
    return scores.cpu().numpy(), boxes.cpu().numpy()


def compare(W, m, pool, answers: Dict[int, list], device,
            prec: str = "f32") -> Dict[str, float]:
    """The check's numbers over the sampled calls' answers: the widest of
    each gap, the count of answers out of order."""
    out = dict.fromkeys(check.SERVE_NUMBERS, 0.0)
    for i, res in answers.items():
        rs, rb = reference_answers(W, m, pool[i], device, prec)
        gaps = check.serve_gaps(res, rs, rb, pool[i]["orig_size"])
        for k, v in gaps.items():
            out[k] = out[k] + v if k == "unsorted" else max(out[k], v)
    return out


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", predictor_hook=None) -> dict:
    """One run of a serving cell; returns the harness's record."""
    t = cell.traffic
    m = model_sizes(cell.config)
    W = weights.make_weights(ref.param_spec(m), seed, device)
    predictor = build_predictor(W, cell.config, device,
                                t["score_threshold"])
    if predictor_hook is not None:
        predictor_hook(predictor)
    pool = traffic.serve_pool(t, m["vocab_size"],
                              cell.config["data"]["max_text_len"], seed)
    pool_flops = [batch_flops(m, b) for b in pool]
    seen = set()
    for b in pool:                       # every canvas of the mix, twice
        key = b["images"].shape
        if key not in seen:
            seen.add(key)
            predictor.predict_batch(b)
            predictor.predict_batch(b)
    sync(device)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()          # no collection walks the set-up's objects
    setup_s = time.perf_counter() - t_start

    lat, ends, counts, answers, images, flops = [], [], [], {}, 0, 0.0
    t0 = time.perf_counter()
    i = 0
    while True:
        b = pool[i % len(pool)]
        c0 = time.perf_counter()
        res = predictor.predict_batch(b)
        c1 = time.perf_counter()
        lat.append(c1 - c0)
        ends.append(c1 - t0)
        counts.append(len(res))
        images += len(res)
        if i < len(pool):                # each entry's first answer
            answers[i] = res
        flops += pool_flops[i % len(pool)]
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    calls = i
    # The sample is drawn among the entries the window answered.
    answers = {j: answers[j]
               for j in check_sample(t, min(calls, len(pool)), seed)}

    record = {"mode": FAMILY, "attempted": calls, "failed": 0,
              "setup_s": setup_s, "window_s": window_s, "calls": calls,
              "images": images,
              "serve_img_s": images / window_s,
              "serve_p95_ms": 1e3 * statistics.quantiles(lat, n=20)[-1]
              if len(lat) >= 2 else 1e3 * lat[0],
              "model_flops": flops,
              "pace": {"thirds": pace.rate_by_part(ends, counts,
                                                   window_s)}}
    if trace:
        it = itertools.count(i)

        def one_call() -> float:
            k = next(it) % len(pool)
            predictor.predict_batch(pool[k])
            return pool_flops[k]

        record.update(probes.traced(one_call, t["trace_calls"]))
        record["trace_units"] = t["trace_calls"]
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if device != "cpu" else 0)
    gc.unfreeze()
    del predictor, res
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    record["numbers"] = compare(W, m, pool, answers, device)
    return record


def batch_flops(m: dict, b: dict) -> float:
    """Forward FLOP of one batch: each valid image on the batch's canvas
    over the keys its masks leave."""
    H, W = b["images"].shape[1:3]
    total = 0.0
    for im_mask, t_mask in zip(b["image_mask"], b["text_mask"]):
        fmask = im_mask[::32, ::32]          # canvases are multiples of 32
        keys = int((~fmask).sum()) + int((~t_mask).sum())
        total += counters.forward_flops(m, H, W, keys, t_mask.shape[0])
    return total


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
