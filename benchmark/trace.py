"""Reading a ``torch.profiler`` trace: the device's busy time, its idle
gaps, time by kernel, and the device time of the kernels launched inside
named host ranges.

The trace is the Chrome trace JSON the profiler exports. Device events
(kernels, copies, sets) carry a correlation id that ties each to the host
call that launched it (a CUDA API event), whose time lies
inside the host range (``record_function``) that was open when it ran.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# Kernel categories by name fragment, first match wins (a frozen copy of
# the program's table, so that the categories do not move with it).
KINDS = (
    ("attention forward", ("flash_fwd",)),
    ("attention dK/dV", ("flash_bwd_dkv",)),
    ("attention dQ", ("flash_bwd_dq",)),
    ("LSA", ("lsa",)),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("GEMM / convolution", ("gemm", "xmma", "cutlass", "conv", "cudnn",
                            "sm90", "sm80", "nhwc", "nchw", "wgrad",
                            "dgrad", "fprop")),
    ("reduction", ("reduce", "norm", "softmax", "cunn_", "cross_entropy")),
    ("copy / memset", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "where")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


@dataclass
class Trace:
    window: Tuple[float, float]           # host us, the profiled window
    # (ts, end, name, correlation) of each device event
    device: List[Tuple[float, float, str, Optional[int]]]
    launches: Dict[int, Tuple[int, float]]  # corr -> (tid, ts)
    ranges: Dict[str, List[Tuple[int, float, float]]]  # name -> (tid, ts, end)
    host_ops: List[Tuple[float, float, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device event intervals inside the window."""
        w0, w1 = self.window
        iv = sorted((max(a, w0), min(b, w1)) for a, b, _, _ in self.device
                    if b > w0 and a < w1)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The n longest stretches of the window with nothing on the
        device, each named by the innermost host operation running at its
        middle."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [(self.host_op_at((a + b) / 2), (b - a) / 1e6)
                for a, b in gaps[:n]]

    def host_op_at(self, t: float) -> str:
        best = None
        for a, b, name in self.host_ops:
            if a <= t < b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "host outside any operation"

    def by_name(self) -> Dict[str, float]:
        """Device seconds inside the window by category and kernel name."""
        w0, w1 = self.window
        out: Dict[str, float] = {}
        for a, b, name, _ in self.device:
            if b > w0 and a < w1:
                key = f"{kernel_kind(name)}: {name[:90]}"
                out[key] = out.get(key, 0.0) + (min(b, w1) - max(a, w0)) / 1e6
        return out

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for key, s in self.by_name().items():
            kind = key.split(": ", 1)[0]
            out[kind] = out.get(kind, 0.0) + s
        return out

    def range_device_s(self, name: str) -> Tuple[float, int]:
        """(device seconds, device events) of everything launched inside
        the host ranges called ``name``."""
        spans = self.ranges.get(name, [])
        if not spans:
            return 0.0, 0
        by_tid: Dict[int, List[Tuple[float, float]]] = {}
        for tid, a, b in spans:
            by_tid.setdefault(tid, []).append((a, b))
        total, n = 0.0, 0
        for a, b, _, corr in self.device:
            launch = self.launches.get(corr) if corr is not None else None
            if launch is None:
                continue
            tid, ts = launch
            if any(s0 <= ts <= s1 for s0, s1 in by_tid.get(tid, ())):
                total += (b - a) / 1e6
                n += 1
        return total, n


def load(path: str, window_range: Optional[str]) -> Trace:
    """Parse an exported trace; ``window_range`` names the host range that
    spans the profiled window, or, None, the window is the span of the
    device's events (a trace of the device's activity alone)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, launches, ranges, host_ops = [], {}, {}, []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, end, e.get("name", ""),
                           args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat == "user_annotation":
            if e.get("name") == window_range:
                window = (ts, end)
            ranges.setdefault(e.get("name"), []).append((e.get("tid"), ts,
                                                         end))
        elif cat == "cpu_op":
            host_ops.append((ts, end, e.get("name", "")))
    if window_range is None:
        window = (min((a for a, _, _, _ in device), default=0.0),
                  max((b for _, b, _, _ in device), default=0.0))
    if window is None:
        raise ValueError(f"no range {window_range!r} in the trace")
    return Trace(window, device, launches, ranges, host_ops)
