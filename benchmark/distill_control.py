"""Readings for the limits of a distillation cell's output check, at the
cell's own sizes: the program, the float8 control and planted faults.

    python3 -m benchmark.distill_control --workload distill-train-p3 \
        [--seeds 1 2 3] [--control-seeds 1 2 3] \
        [--fault <name> --fault-seeds 1 2 3]

For each seed, the checked steps a run's set-up drives, compared with the
f32 reference (the lower readings); for each control seed, the reference
computed in float8 put in the program's place, its pooled features fed to
the f32 reference's bank as the program's are, judged as the program is;
for each fault seed, the program with a fault of ``FAULTS`` planted. One
JSON line per seed and side. The benchmark's own runs never run this;
``benchmark/tests/test_benchmark_distill.py`` runs it at a tiny size.
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

import torch  # noqa: E402

from benchmark import cells, distill, training  # noqa: E402


def half_batch(step):
    """The step sees the first half of each stream's batch: its means are
    taken over the rest."""
    def broken(state, pair):
        return step(state, {s: {k: v[:v.shape[0] // 2] for k, v in b.items()}
                            for s, b in pair.items()})

    return broken


def frozen_bank(step):
    """The step returns the bank it was given."""
    def broken(state, pair):
        bank = state.cluster_bank
        state, scalars = step(state, pair)
        state.cluster_bank = bank
        return state, scalars

    return broken


def unsnapped(step):
    """Both decodes read the unsnapped memory: the snap hands back the
    memory as it was."""
    from toist_tpu_torch.train import cluster as cl

    def broken(state, pair):
        snap = cl.snap_text_memory
        cl.snap_text_memory = lambda img_memory, *args: img_memory
        try:
            return step(state, pair)
        finally:
            cl.snap_text_memory = snap

    return broken


FAULTS = {"half_batch": half_batch, "frozen_bank": frozen_bank,
          "unsnapped": unsnapped}


def readings(cell, seed: int, program: bool, control: bool,
             device="cuda", step_hook=None) -> dict:
    """{"program": the program's numbers} and {"control": the float8
    reference's}, as asked."""
    out = {}
    if program:
        s = distill.checked_setup(cell, seed, device, step_hook)
        training.free(s, device)
        out["program"] = distill.numbers(cell, s, seed, device)
    if control:
        s = distill.inputs(cell, seed, device)
        ref8 = distill.reference_steps(cell, s, seed, device, "fp8")
        ref32 = distill.reference_steps(cell, s, seed, device, "f32",
                                        feed=ref8["pooled"])
        out["control"] = distill.gaps(
            ref8, ref32, s["pool"][:cell.traffic["check_steps"]],
            s["bank0"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default="", choices=("",) + tuple(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("distill_control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload, ROOT)

    def emit(seed, side, gaps):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side, **gaps}), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        r = readings(cell, seed, seed in args.seeds,
                     seed in args.control_seeds)
        for side, gaps in r.items():
            emit(seed, side, gaps)
    for seed in args.fault_seeds:
        r = readings(cell, seed, True, False, "cuda", FAULTS[args.fault])
        emit(seed, f"fault {args.fault}", r["program"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
