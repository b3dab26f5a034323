"""The arithmetic of the per-layer metrics, shared by the readers in
``metrics/``. Each takes a runner's record of a traced run and returns a
number, or None when the run holds nothing to read."""
from __future__ import annotations

from typing import Optional

from benchmark import counters


def idle_share(run: dict, mode: str) -> Optional[float]:
    """% of the measured window's wall time in which the device ran
    nothing. The window itself is not profiled: its busy seconds are the
    traced stretch's (the union of its device events) per model FLOP,
    times the window's model FLOP. That stretch's own idle share reads
    higher by what the profiler costs the host per launch."""
    if run.get("mode") != mode or run.get("trace_work", 0) <= 0 \
            or run.get("window_s", 0) <= 0:
        return None
    busy = run["busy_s"] * run["model_flops"] / run["trace_work"]
    return 100.0 * (1.0 - busy / run["window_s"])


def attn_roofline(run: dict, mode: str) -> Optional[float]:
    """% of the attention calls' least time (``counters``) in the device
    time of the kernels launched inside them."""
    if run.get("mode") != mode or run.get("attention_device_s", 0) <= 0:
        return None
    return 100.0 * run["attention_bound_s"] / run["attention_device_s"]


def mfu(run: dict, mode: str) -> Optional[float]:
    """% of the bf16 peak in the model FLOP completed in the measured
    window (before the profiled part) over its wall time."""
    if run.get("mode") != mode or run.get("window_s", 0) <= 0 \
            or run.get("model_flops", 0) <= 0:
        return None
    return (100.0 * run["model_flops"] / run["window_s"]
            / counters.PEAK_FLOPS_BF16)
