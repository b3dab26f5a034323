"""The window's rate in each of its thirds, printed beside a run's result
for reading its spread: whether a slow run was slow throughout or in one
stretch. Not a metric."""
from __future__ import annotations

from typing import List, Sequence


def rate_by_part(ends: Sequence[float], counts: Sequence[float],
                 window_s: float, parts: int = 3) -> List[float]:
    """Work per second in each of ``parts`` equal stretches of the window,
    each unit of work counted where it ended (``ends``: seconds since the
    window opened)."""
    span = window_s / parts
    done = [0.0] * parts
    for t, c in zip(ends, counts):
        done[min(int(t / span), parts - 1)] += c
    return [x / span for x in done]
