"""Metric logging: smoothed meters and stdout progress.

The part of ``toist_tpu/utils/logging.py`` that ``train_one_epoch`` uses
(``SmoothedValue`` and ``MetricLogger`` without its cross-host merge), copied
line for line. Reference behavior: util/metrics.py SmoothedValue/MetricLogger
(window meters, eta/iter-time printing every N steps).
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

# Wall-clock meters recorded by log_every itself. They appear in summary()
# (data_time is how input-boundness is diagnosed from artifacts) but are
# excluded from the per-step meter printout, which prints them explicitly.
TIMING_METERS = ("iter_time", "data_time")


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.deque = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)




class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_freq: int = 10,
                 header: str = ""):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq
        self.header = header

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log_every(self, iterable: Iterable, total: Optional[int] = None):
        i = 0
        start = time.time()
        end = time.time()
        for obj in iterable:
            # Recorded as real meters (not just printed) so summary() carries
            # data-wait into the epoch jsonl record — the artifact-level
            # answer to "is this run input-bound?" (reference prints it,
            # util/metrics.py:108-164, but never records it).
            self.meters["data_time"].update(time.time() - end)
            yield obj
            self.meters["iter_time"].update(time.time() - end)
            end = time.time()
            if i % self.print_freq == 0:
                eta = ""
                if total:
                    eta_s = self.meters["iter_time"].global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                meters = self.delimiter.join(
                    f"{k}: {m.median:.4f} ({m.global_avg:.4f})"
                    for k, m in self.meters.items()
                    if k not in TIMING_METERS)
                print(f"{self.header} [{i}{'/' + str(total) if total else ''}]  "
                      f"{eta}{meters}  "
                      f"iter: {self.meters['iter_time'].avg:.3f}s  "
                      f"data: {self.meters['data_time'].avg:.3f}s", flush=True)
            i += 1
        print(f"{self.header} done in "
              f"{datetime.timedelta(seconds=int(time.time() - start))}",
              flush=True)

    def summary(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}
