"""Probes the benchmark puts around the program's entry points for a traced
run: named host ranges that the trace reader attributes device time to.

``AttentionProbe`` wraps the attention entry point the model's layers call
(``toist_tpu_torch.models.layers.flash_attention``). Its forward runs
inside the host range ``FWD``; when a graph is built, two identity
autograd nodes around it open the range ``BWD`` when the output's gradient
arrives and close it when the inputs' gradients leave. The autograd engine
runs the nodes made between them first, so the range holds the call's
backward, whatever implements it. Each call's shapes and unmasked keys are
kept for its bound.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import torch

from benchmark import counters

FWD = "bench.attention.fwd"
BWD = "bench.attention.bwd"
WINDOW = "bench.window"


class _Open(torch.autograd.Function):
    """Identity on the call's output; its backward opens ``BWD``."""

    @staticmethod
    def forward(ctx, holder, o):
        ctx.holder = holder
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        ctx.holder["range"] = torch.ops.profiler._record_function_enter_new(
            BWD, None)
        return None, g


class _Close(torch.autograd.Function):
    """Identity on the call's inputs; its backward closes ``BWD``."""

    @staticmethod
    def forward(ctx, holder, q, k, v):
        ctx.holder = holder
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        handle = ctx.holder.pop("range", None)
        if handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(handle)
        return None, gq, gk, gv


class AttentionProbe:
    def __init__(self):
        self.calls: List[tuple] = []
        self._layers = None
        self._orig = None

    def install(self) -> None:
        from toist_tpu_torch.models import layers

        self._layers, self._orig = layers, layers.flash_attention
        orig = self._orig

        def probed(q, k, v, key_padding_mask, num_heads, *args, **kwargs):
            B, S = k.shape[0], k.shape[1]
            keys = (torch.full((B,), S, device=k.device)
                    if key_padding_mask is None
                    else S - key_padding_mask.sum(1))
            grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v))
            holder = {}
            if grad:
                q, k, v = _Close.apply(holder, q, k, v)
            with torch.profiler.record_function(FWD):
                o, lse = orig(q, k, v, key_padding_mask, num_heads, *args,
                              **kwargs)
            if grad:
                o = _Open.apply(holder, o)
            self.calls.append((grad, B, num_heads, q.shape[1], keys,
                               q.shape[2], q.element_size()))
            return o, lse

        layers.flash_attention = probed

    def uninstall(self) -> None:
        if self._layers is not None:
            self._layers.flash_attention = self._orig
            self._layers = None

    def bound_s(self) -> float:
        """The least seconds the card needs for every probed call: the
        forward of each, the backward of each that built a graph."""
        total = 0.0
        for grad, B, H, sq, keys, d, elem in self.calls:
            kl = [int(x) for x in keys.tolist()]
            total += counters.attention_bound_s("fwd", B, H, sq, kl, d, elem)
            if grad:
                total += counters.attention_bound_s("bwd", B, H, sq, kl, d,
                                                    elem)
        return total


def profile_calls(fn: Callable[[], Optional[float]], n: int,
                  trace_path: str, host_ops: bool = True,
                  before_window: Callable[[], None] = lambda: None
                  ) -> Tuple[float, float]:
    """Run ``fn`` n times under ``torch.profiler`` with the tracing
    already warm, from an idle device to a device sync, inside the host
    range ``WINDOW``; export the trace of those n calls to
    ``trace_path``; return their wall seconds and the sum of what ``fn``
    returned (the work it did, in model FLOP). ``host_ops`` False records
    the device's activity alone (no host operations or ranges).

    The profiler's first traced calls pay for starting its tracing (about
    0.2 s on the H100), so n calls under the profiler's warm-up step,
    whose events are dropped, come first; ``before_window`` runs between
    the two."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if host_ops or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])

    def calls() -> float:
        work = sum(fn() or 0.0 for _ in range(n))
        if cuda:
            torch.cuda.synchronize()
        return work

    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(trace_path)
                 ) as prof:
        calls()
        prof.step()
        before_window()
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            work = calls()
        wall = time.perf_counter() - t0
        prof.step()
    return wall, work


def traced(fn: Callable[[], Optional[float]], n: int) -> dict:
    """Two profiled stretches of n calls of ``fn`` each (each after n
    calls of the profiler's warm-up).

    The first records the device's activity alone: the device's busy
    seconds (the union of its events), the stretch's wall time and work
    (what ``fn`` returns), and the device time by kernel. Recording each
    launch still costs the host (serving at batch 8 on the H100: 88-108
    ms a call against 57-60 ms untraced), so the stretch's own idle share
    reads high; ``readers.idle_share`` takes the busy seconds per FLOP to
    the measured window instead. The second adds the host's operations and
    the attention probe: the attention calls' device time against their
    bound, and the longest idle gaps named by the host operation running
    in them (their lengths there include what recording each host
    operation costs)."""
    from benchmark import trace as tr

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    probe = AttentionProbe()
    try:
        device_wall, work = profile_calls(fn, n, path, host_ops=False)
        dev = tr.load(path, None)
        probe.install()
        host_wall, _ = profile_calls(fn, n, path,
                                     before_window=probe.calls.clear)
        probe.uninstall()
        tra = tr.load(path, WINDOW)
    finally:
        probe.uninstall()
        os.unlink(path)
    attn_s, attn_events = tra.range_device_s(FWD)
    b_s, b_events = tra.range_device_s(BWD)
    return {"trace": dev, "host_trace": tra, "busy_s": dev.busy_s(),
            "trace_window_s": device_wall, "trace_work": work,
            "host_trace_window_s": host_wall,
            "attention_device_s": attn_s + b_s,
            "attention_events": attn_events + b_events,
            "attention_bound_s": probe.bound_s()}
