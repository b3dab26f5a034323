"""Metric logging: smoothed meters, stdout progress, JSONL sink.

The part of ``toist_tpu/utils/logging.py`` that the engine and ``main`` use
(``SmoothedValue``, ``merge_meter_states``, ``MetricLogger`` and
``JsonlLogger``), copied line for line but for the transport: the rank and
process count, and the gather of ``MetricLogger.
synchronize_between_processes``, come from ``torch.distributed``
(``utils/dist.py``) where the JAX package asks jax. Reference behavior:
util/metrics.py SmoothedValue/MetricLogger (window meters, eta/iter-time
printing every N steps, cross-rank meter all-reduce before epoch stats) and
main.py:687-689 (log.txt JSON lines, rank 0 only via util/dist.py:199).
"""
from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Optional, Tuple

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


def merge_meter_states(states: List[Dict[str, Tuple[float, int]]]
                       ) -> Dict[str, Tuple[float, int]]:
    """Pure cross-host meter merge: per-key (total, count) sums.

    Factored out of MetricLogger.synchronize_between_processes so the merge is
    unit-testable without a multi-host runtime (two simulated hosts' states in,
    one merged state out)."""
    merged: Dict[str, Tuple[float, int]] = {}
    for state in states:
        for k, (tot, cnt) in state.items():
            t0, c0 = merged.get(k, (0.0, 0))
            merged[k] = (t0 + float(tot), c0 + int(cnt))
    return merged


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

    def meter_state(self) -> Dict[str, Tuple[float, int]]:
        return {k: (m.total, m.count) for k, m in self.meters.items()}

    def load_meter_state(self, state: Dict[str, Tuple[float, int]]):
        for k, (tot, cnt) in state.items():
            m = self.meters[k]
            m.total, m.count = float(tot), int(cnt)

    def synchronize_between_processes(self):
        """All-reduce meter totals/counts across hosts so epoch stats are
        global (reference util/metrics.py:34-46). No-op single-host. Hosts may
        hold different key sets (e.g. a loss key first seen late); the merge
        is keyed, not positional, via a pickled object gather."""
        from toist_tpu_torch.utils import dist

        if dist.process_count() == 1:
            return
        # The same JSON payloads, gathered by torch.distributed.
        payloads = dist.all_gather_object(json.dumps(self.meter_state()))
        states = [json.loads(p) for p in payloads]
        self.load_meter_state(merge_meter_states(states))

    def summary(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


class JsonlLogger:
    """Append-only JSONL sink (the reference's log.txt, main.py:687-689).

    Rank-gated: only process 0 writes (reference save_on_master,
    util/dist.py:199-202) — otherwise each host of a shared output_dir would
    append its own differing epoch records to the same file."""

    def __init__(self, output_dir: str, name: str = "log.jsonl",
                 rank_gated: bool = True):
        self.path = os.path.join(output_dir, name) if output_dir else None
        if self.path and rank_gated:
            from toist_tpu_torch.utils.dist import process_index
            if process_index() != 0:
                self.path = None
        if self.path:
            os.makedirs(output_dir, exist_ok=True)

    def write(self, record: dict):
        if not self.path:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
