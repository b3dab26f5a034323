"""The training runners' shared skeleton: ``train_one_epoch`` over a
program's step, fed entries of its pool round and round.

A training mode's file (``benchmark/<mode>.py``) defines ``run`` by calling
``drive`` with a ``Program``: everything that names its step. ``drive``
calls the program's set-up, which builds one training state from the seed
and drives it through its first ``check_steps`` steps by the window's own
call and feed, one ``train_one_epoch`` per stretch, keeping what the check
compares. It then runs one step on every canvas not yet seen, and one
stretch of ``warmup_steps``. The window hands the same state and step to
``train_one_epoch`` over a feed that stops once ``--seconds`` have passed;
it ends when the device has finished. A traced run then profiles
``trace_steps`` more steps, twice (``probes.traced``). Once the window has
closed and the peak memory is read, the program is freed and the program's
reference side computes the check's numbers.

Every record ``drive`` returns has "mode": "train", so the ``*.train``
readers read any training mode's cell that their metrics list.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Hashable, List

import torch

from benchmark import pace, probes
from benchmark.serve import sync

# The record's "mode": the family of runners whose records the ``*.train``
# readers read.
FAMILY = "train"


@dataclass(frozen=True)
class Program:
    """What a training mode's step is made of, for ``drive``.

    ``setup(cell, seed, device, step_hook) -> dict`` builds the state from
    the seed and drives its checked steps, wrapping the step in
    ``step_hook(step) -> step`` when one is given (a test breaks the timed
    path so). The dict holds "state", "train_step" (the call
    ``train_one_epoch`` makes), "pool" (the entries it is fed) and "m"
    (the model's sizes), and whatever ``numbers`` reads.
    ``flops(m, entry)`` is the model FLOP of one step on a pool entry,
    ``canvas(entry)`` the key of the shapes it compiles for, and
    ``numbers(cell, s, seed, device)`` the check's numbers, computed once
    the state and step have been dropped from ``s``."""

    setup: Callable[..., dict]
    flops: Callable[[dict, dict], float]
    canvas: Callable[[dict], Hashable]
    numbers: Callable[..., dict]


class Feed:
    """What ``train_one_epoch`` iterates: ``epoch()`` yields pool batches
    from ``start`` on, ``count`` of them, or, with ``seconds``, until that
    long has passed since the first."""

    def __init__(self, pool: List[dict], start: int, count: int = 0,
                 seconds: float = 0.0):
        self.pool, self.start = pool, start
        self.count, self.seconds = count, seconds
        self.served = 0
        self.t0 = None
        self.times: List[float] = []     # seconds since t0 of each batch

    def __len__(self) -> int:
        return self.count or 10 ** 6

    def epoch(self, _epoch: int):
        self.t0 = time.perf_counter()
        i = self.start
        while True:
            if self.count and self.served >= self.count:
                return
            if self.seconds and time.perf_counter() - self.t0 >= self.seconds:
                return
            self.times.append(time.perf_counter() - self.t0)
            yield self.pool[i % len(self.pool)]
            i += 1
            self.served += 1


def free(s: dict, device) -> None:
    """Drop the program's state, so that the reference runs alone."""
    for k in ("state", "train_step"):
        s.pop(k, None)
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def drive(program: Program, cell, seed: int, seconds: float, trace: bool,
          t_start: float, device="cuda", step_hook=None) -> dict:
    """One run of a training cell of ``program``; returns the harness's
    record."""
    from toist_tpu_torch.train.engine import train_one_epoch

    t = cell.traffic
    s = program.setup(cell, seed, device, step_hook)
    state, train_step, pool = s["state"], s["train_step"], s["pool"]
    m, pf, n_check = s["m"], t["print_freq"], t["check_steps"]
    pool_flops = [program.flops(m, b) for b in pool]
    seen = {program.canvas(pool[i]) for i in range(n_check)}
    for i, b in enumerate(pool):                 # every other canvas once
        if program.canvas(b) not in seen:
            seen.add(program.canvas(b))
            state, _ = train_one_epoch(train_step, state, Feed(pool, i, 1),
                                       0, print_freq=pf)
    # A stretch as long as the window runs ahead of the device between two
    # host reads, so that the pinned copies' buffers are all there.
    state, _ = train_one_epoch(train_step, state,
                               Feed(pool, n_check, t["warmup_steps"]), 0,
                               print_freq=pf)
    sync(device)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()          # no collection walks the set-up's objects
    setup_s = time.perf_counter() - t_start

    feed = Feed(pool, n_check, seconds=seconds)
    t0 = time.perf_counter()
    state, _ = train_one_epoch(train_step, state, feed, 1, print_freq=pf)
    sync(device)
    window_s = time.perf_counter() - t0
    steps = feed.served
    flops = sum(pool_flops[(n_check + i) % len(pool)] for i in range(steps))
    record = {"mode": FAMILY, "attempted": steps, "failed": 0,
              "setup_s": setup_s, "window_s": window_s, "steps": steps,
              "train_samples_s": steps * t["batch"] / window_s,
              "model_flops": flops,
              "pace": {"thirds": pace.rate_by_part(
                  feed.times, [t["batch"]] * steps, window_s)}}
    if trace:
        s["state"] = state

        def more_steps() -> float:
            first = n_check + steps
            s["state"], _ = train_one_epoch(
                train_step, s["state"], Feed(pool, first, t["trace_steps"]),
                1, print_freq=pf)
            return sum(pool_flops[(first + j) % len(pool)]
                       for j in range(t["trace_steps"]))

        record.update(probes.traced(more_steps, 1))
        record["trace_units"] = t["trace_steps"]
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if device != "cpu" else 0)
    gc.unfreeze()
    del state, train_step
    free(s, device)
    record["numbers"] = program.numbers(cell, s, seed, device)
    return record
