"""The program's spans in a traced run: host time inside them, the host's
launch calls made inside them, and the device's idle time by the span the
host was in.

The spans are ``toist.*`` ranges the program opens at its layer boundaries
(``toist_tpu_torch/utils/tracing.py``), recorded in the host-operation
stretch's trace (``run["host_trace"]``, a ``trace.Trace``) on the clock of
the device's events. A top-level span is a request or a step; the others
nest inside one on the thread that opened it, or, in training, stand
beside the step (the batch's copy in, the host's read of the scalars).
The backward's kernels are launched from autograd's own thread while the
caller waits inside ``toist.backward``, so launches are tied to spans by
time, not by thread. The profiler keeps every host call but drops some of
the device's records at random (up to 16% of a serving call's on the H100),
so launches are counted as the host's calls, not as the device's events.

Each reader returns None for a run of the other mode, one without a traced
stretch or whose trace holds no device event (a run on the CPU), and one
whose trace holds none of the spans it reads (a program without them).
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.trace import Trace

TOPS = ("toist.predict", "toist.eval_step", "toist.train_step")
# The host issuing work to the device, and the host waiting on it.
ISSUING = ("toist.h2d", "toist.encode", "toist.decode", "toist.postprocess",
         "toist.criterion", "toist.backward", "toist.optimizer",
         "toist.bank")
WAIT = ("toist.d2h", "toist.host_read")


def _trace(run: dict, mode: str) -> Optional[Trace]:
    if run.get("mode") != mode:
        return None
    t = run.get("host_trace")
    if t is None or not t.device:
        return None
    return t


def _clipped(t: Trace, names: Iterable[str]
             ) -> List[Tuple[int, float, float, str]]:
    """(tid, start, end, name) of every range called one of ``names``,
    cut to the window."""
    w0, w1 = t.window
    out = []
    for name in names:
        for tid, a, b in t.ranges.get(name, ()):
            a, b = max(a, w0), min(b, w1)
            if b > a:
                out.append((tid, a, b, name))
    return out


def _union(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def span_ms(run: dict, mode: str, names: Tuple[str, ...]
            ) -> Optional[float]:
    """Host ms inside the spans ``names`` per call or step (``trace_units``);
    time inside two of them at once on a thread counts once."""
    t = _trace(run, mode)
    if t is None:
        return None
    spans = _clipped(t, names)
    if not spans:
        return None
    by_tid: Dict[int, List[Tuple[float, float]]] = {}
    for tid, a, b, _ in spans:
        by_tid.setdefault(tid, []).append((a, b))
    us = sum(b - a for iv in by_tid.values() for a, b in _union(iv))
    return us / 1e3 / run["trace_units"]


def launches(run: dict, mode: str, tops: Tuple[str, ...]) -> Optional[float]:
    """The host's CUDA runtime and driver calls that carry a correlation id
    (kernel launches, copies and sets, and the few synchronisations and
    event records among them) per call or step, made on any thread inside
    one of the spans ``tops``."""
    t = _trace(run, mode)
    if t is None:
        return None
    spans = _union((a, b) for _, a, b, _ in _clipped(t, tops))
    if not spans:
        return None
    starts = [a for a, _ in spans]
    n = 0
    for _, at in t.launches.values():
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= spans[i][1]:
            n += 1
    return n / run["trace_units"]


def idle_by_span(run: dict, mode: str) -> Optional[Dict[str, float]]:
    """The window's device-idle seconds by the innermost program span open
    at each idle instant on the thread that opened the top-level spans
    ("outside" where none is). Spans of other names than ``TOPS``,
    ``ISSUING`` and ``WAIT`` are passed over: their time goes to the span
    around them."""
    t = _trace(run, mode)
    if t is None:
        return None
    tops = _clipped(t, TOPS)
    if not tops:
        return None
    tid = tops[0][0]
    spans = [(a, b, n) for s_tid, a, b, n in _clipped(t, TOPS + ISSUING + WAIT)
             if s_tid == tid]
    w0, w1 = t.window
    idle, at = [], w0
    for a, b in t.busy_intervals():
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    if w1 > at:
        idle.append((at, w1))
    out: Dict[str, float] = {}
    for a, b in idle:
        # Cut the gap at every span edge inside it; each piece goes to the
        # span opened last among those open over it (the innermost).
        open_ = [s for s in spans if s[0] < b and s[1] > a]
        cuts = sorted({a, b, *(x for s in open_ for x in s[:2]
                               if a < x < b)})
        for p, q in zip(cuts, cuts[1:]):
            over = [s for s in open_ if s[0] <= p and s[1] >= q]
            name = (max(over, key=lambda s: (s[0], -s[1]))[2] if over
                    else "outside")
            out[name] = out.get(name, 0.0) + (q - p) / 1e6
    return out


def idle_by_class(run: dict, mode: str) -> Optional[Dict[str, float]]:
    """``idle_by_span`` summed by class: "issue" (the host issuing work),
    "wait" (the host waiting on the device), "self" (a top-level span
    outside its children), "outside" (no program span)."""
    by_span = idle_by_span(run, mode)
    if by_span is None:
        return None
    out = dict.fromkeys(("issue", "wait", "self", "outside"), 0.0)
    for name, s in by_span.items():
        out["issue" if name in ISSUING else "wait" if name in WAIT
            else "self" if name in TOPS else "outside"] += s
    return out


def idle_in_issue(run: dict, mode: str) -> Optional[float]:
    """% of the window's device-idle time in which the host was issuing
    work (the *issue* class)."""
    by_class = idle_by_class(run, mode)
    if by_class is None or sum(by_class.values()) <= 0:
        return None
    return 100.0 * by_class["issue"] / sum(by_class.values())
