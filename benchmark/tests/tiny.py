"""Tiny stand-ins of the benchmark's cells for CPU tests: the real cell's
files with the model cut to a few channels and layers and the traffic to
small canvases, so that the program and the reference run in seconds."""
from __future__ import annotations

import copy

from benchmark import cells

TINY_MODEL = dict(backbone="resnet18-test", hidden_dim=32, nheads=2,
                  dim_feedforward=64, enc_layers=1, dec_layers=2,
                  num_queries=10, text_hidden=24, text_layers=1,
                  text_heads=2, text_intermediate=48, contrastive_hdim=16)


def tiny_cell(name: str, dtype: str = "float32") -> cells.Cell:
    cell = cells.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(TINY_MODEL, compute_dtype=dtype)
    cfg["data"]["max_boxes"] = 8
    cfg["vocab_size"] = 300
    cell.config = cfg
    t = dict(cell.traffic)
    if t["mode"] == "serve":
        t.update(batch=min(t["batch"], 2), canvases=[[64, 96], [96, 64]],
                 short_side=64, long_side=[70, 90], pool=3, check_calls=3)
    else:
        t.update(batch=2, canvases=[[64, 96], [96, 160]], scales=[64, 96],
                 max_long=150, steps_per_epoch=10, warmup_steps=2)
    cell.traffic = t
    return cell
