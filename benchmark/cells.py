"""The benchmark's description, read from files by name.

``BENCHMARK.json`` at the repository root lists the configurations, the
cells (``workloads``) and the metrics. Everything that belongs to one of
them sits in a file of its own, found by its name:

- a configuration: ``configs/<config>.json`` (its "file" entry);
- a traffic mix: ``workloads/<traffic>.json``, the parameters the general
  generators of ``traffic.py`` read, its "mode" naming its runner;
- a traffic mode: ``<mode>.py`` beside this file, which defines
  ``run(cell, seed, seconds, trace, t_start)`` returning the run's record
  (``run.runner_of``; the record's keys are listed in ``run.py``). A
  training mode's ``run`` calls ``training.drive`` with a
  ``training.Program`` of its own: its set-up, a pool entry's model FLOP
  and canvas key, and the check's numbers from its reference (under
  ``reference/``); ``train.py`` is the plain step's;
- a cell's limits for the output check: ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<metric>.py``, a reader with
  ``read(run) -> float | None``. A training mode's records carry "mode"
  "train", so a ``*.train`` metric reads a new training cell once its
  "workloads" list names it.

Adding a configuration, a traffic mode, a cell or a metric adds files and
entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file
    traffic_name: str
    traffic: dict         # the traffic mix's parameters
    limits: dict          # number -> limit of the output check
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell
    reports: those without "workloads", and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None
              ) -> Cell:
    bench = bench or load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "benchmark")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_read_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=_read_json(os.path.join(here, "workloads",
                                        f"{w['traffic']}.json")),
        limits=_read_json(os.path.join(here, "limits", f"{name}.json")),
        end_to_end=metrics_of(bench, name, "end_to_end"),
        per_layer=metrics_of(bench, name, "per_layer"))


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, run, root: str = ROOT) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds, as
    {name: {"value", "unit"}}; a reader that finds nothing is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
