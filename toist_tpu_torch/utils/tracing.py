"""Spans at the program's layer boundaries, as ``torch.profiler`` ranges.

``span(name)`` marks a stretch of the host's work: a request or a step at
the top (``toist.predict``, ``toist.train_step``), the layers inside it
(``toist.encode``, ``toist.criterion``, ...). While a profiler records, it
is ``torch.profiler.record_function(name)``: the range lands in the
profiler's own trace, on the clock of the device's kernels, each of which
the trace ties to the host call that launched it by correlation id. Parent
and child are the ranges' nesting on their thread. While none records
(``torch.autograd.profiler._is_profiler_enabled``, read at each call) it
is one shared no-op, so a span costs one flag read and enters nothing.
This module keeps no spans: the profiler holds them and writes them when
it stops.

    with span("toist.d2h"):
        scores = post["scores"].cpu().numpy()

    @spanned("toist.criterion")
    def set_criterion(outputs, batch, cfg): ...
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

from torch.autograd import profiler as _profiler

PREFIX = "toist."

_NULL = contextlib.nullcontext()


def span(name: str):
    """The span ``name``, as a context manager."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL


def spanned(name: str) -> Callable[[Callable], Callable]:
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
