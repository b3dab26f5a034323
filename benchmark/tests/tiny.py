"""Tiny stand-ins of the benchmark's cells for CPU tests: the real cell's
files with the model cut to a few channels and layers and the traffic to
small canvases, so that the program and the reference run in seconds."""
from __future__ import annotations

import copy
import importlib

from benchmark import cells, run

TINY_MODEL = dict(backbone="resnet18-test", hidden_dim=32, nheads=2,
                  dim_feedforward=64, enc_layers=1, dec_layers=2,
                  num_queries=10, text_hidden=24, text_layers=1,
                  text_heads=2, text_intermediate=48, contrastive_hdim=16)

# The traffic's cut by the family of the mode's runner (its ``FAMILY``).
TINY_TRAFFIC = {
    "serve": dict(canvases=[[64, 96], [96, 64]], short_side=64,
                  long_side=[70, 90], pool=3, check_calls=3),
    "train": dict(canvases=[[64, 96], [96, 160]], scales=[64, 96],
                  max_long=150, steps_per_epoch=10, warmup_steps=2)}


def family_of(mode: str) -> str:
    """The family of the runner of traffic mode ``mode``."""
    name = run.runner_of(mode)
    if name is None:
        raise ValueError(f"traffic mode {mode!r} has no runner")
    return importlib.import_module(name).FAMILY


def tiny_cell(name: str, dtype: str = "float32") -> cells.Cell:
    cell = cells.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(TINY_MODEL, compute_dtype=dtype)
    cfg["data"]["max_boxes"] = 8
    cfg["vocab_size"] = 300
    cell.config = cfg
    t = dict(cell.traffic)
    family = family_of(t["mode"])
    if family not in TINY_TRAFFIC:
        raise ValueError(f"no tiny cut for mode {t['mode']!r} of runner "
                         f"family {family!r}")
    t.update(TINY_TRAFFIC[family], batch=min(t["batch"], 2))
    cell.traffic = t
    return cell
