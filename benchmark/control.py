"""Readings for the limits of a cell's output check, at the cell's own
sizes: the control, and for training the program and planted faults.

    python3 -m benchmark.control --workload <cell> --control-seeds 1 2 3 \
        [--seeds 1 2 3] [--fault <name> --fault-seeds 1 2 3]

For each control seed, the reference computed in float8 put in the
program's place, judged as the program is: the upper readings. Training
only: for each seed, the checked steps of ``train_one_epoch`` that a run's
set-up drives, compared with the f32 reference (the lower readings), and
for each fault seed the same with a fault of ``faults.py`` planted. The
program's serving readings are those of ``benchmark.run``'s own runs,
which compare what the window produced. One JSON line per seed and side.
The benchmark's own runs never run this;
``tests/test_benchmark_control.py`` does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import (cells, faults, serve,  # noqa: E402
                       traffic, weights)
from benchmark.reference import toist as ref  # noqa: E402


def as_answers(scores: np.ndarray, boxes: np.ndarray) -> list:
    """Reference outputs in the program's answer layout: sorted scores,
    the boxes in that order."""
    out = []
    for sc, bx in zip(scores, boxes):
        keep = np.argsort(-sc, kind="stable")
        out.append({"scores": sc[keep], "boxes": bx[keep]})
    return out


def train_readings(cell, seed: int, program: bool, control: bool,
                   device="cuda", step_hook=None) -> dict:
    from benchmark import train

    t = cell.traffic
    out = {}
    if program:
        s = train.checked_setup(cell, seed, device, step_hook)
        train.free(s, device)
        out["program"] = train.numbers(cell, s, seed, device)
    if control:
        m = serve.model_sizes(cell.config)
        W = weights.make_weights(ref.param_spec(m), seed, device)
        pool = traffic.train_pool(t, m["vocab_size"],
                                  cell.config["data"]["max_text_len"],
                                  cell.config["data"]["max_boxes"],
                                  cell.config["data"]["num_logit_cols"], seed)
        args = (W, m, cell.config, t, pool[:t["check_steps"]], seed, device)
        ref32 = train.reference_steps(*args)
        ref8 = train.reference_steps(*args, prec="fp8")
        out["control"] = train.gaps(ref8, ref32)
    return out


def serve_control(cell, seed: int, device="cuda") -> dict:
    """The control's numbers on a serving cell: the float8 reference's
    answers to the calls a run samples, judged against the f32
    reference's."""
    t = cell.traffic
    m = serve.model_sizes(cell.config)
    W = weights.make_weights(ref.param_spec(m), seed, device)
    pool = traffic.serve_pool(t, m["vocab_size"],
                              cell.config["data"]["max_text_len"], seed)
    answers = {}
    for i in serve.check_sample(t, len(pool), seed):
        cs, cb = serve.reference_answers(W, m, pool[i], device, "fp8")
        answers[i] = as_answers(cs, cb)
    return serve.compare(W, m, pool, answers, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload, ROOT)
    train = cell.traffic["mode"] == "train"
    if not train and (args.seeds or args.fault_seeds):
        print("control: a serving cell's program readings come from "
              "benchmark.run; give --control-seeds only", file=sys.stderr)
        return 2

    def emit(seed, side, gaps):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side, **gaps}), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        if train:
            r = train_readings(cell, seed, seed in args.seeds,
                               seed in args.control_seeds)
            for side, gaps in r.items():
                emit(seed, side, gaps)
        else:
            emit(seed, "control", serve_control(cell, seed))
    for seed in args.fault_seeds:
        r = train_readings(cell, seed, True, False, "cuda",
                           faults.TRAIN[args.fault])
        emit(seed, f"fault {args.fault}", r["program"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
