"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository root. The run makes its inputs and weights from the
seed, sets up and warms up the program, measures for ``--seconds``, checks
the answers of the timed path against the plain reference, and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, ``pace`` (the window's rate in its thirds, and in a traced
run each profiled stretch's time per call or step beside the window's),
and last ``check``, the numbers compared beside their limits (also the
last lines of standard error, after every number the check computed). It
exits non-zero and prints no result without as many CUDA devices as the
cell asks for, when the cell's traffic mode has no runner, or when a
module of JAX or of the JAX package is loaded once the window has closed.

A traffic mix's "mode" names its runner: mode ``X`` runs
``benchmark/X.py`` (``runner_of``), which defines
``run(cell, seed, seconds, trace, t_start) -> record``. So a mode is added
by a new file, and no file here changes. The record holds "mode" (the
runner's family, which the per-layer readers match: "serve" or "train"),
"attempted", "failed", each of its cells' end-to-end metrics by name
("setup_s" among them), "window_s", "model_flops", "memory_peak_bytes",
"numbers" (the check's numbers, named as in ``limits/<cell>.json``) and
"pace"; with ``--trace 1`` also what ``probes.traced`` returns and
"trace_units", the calls or steps it traced. A training mode's ``run``
calls ``training.drive`` with a ``training.Program`` of its own, and the
skeleton writes all of these with "mode" "train".
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "toist_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the loaded
    ones), compared whole: ``toist_tpu_torch`` is not ``toist_tpu``."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def runner_of(mode: str, root: str = ROOT):
    """The module that runs traffic mode ``mode``: ``benchmark.<mode>``
    when ``benchmark/<mode>.py`` under ``root`` has a top-level
    ``def run``, else None. The file is read, not imported."""
    path = os.path.join(root, "benchmark", f"{mode}.py")
    if not mode.isidentifier() or not os.path.isfile(path):
        return None
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    if any(isinstance(n, ast.FunctionDef) and n.name == "run"
           for n in tree.body):
        return f"benchmark.{mode}"
    return None


def cache_dirs(root: str) -> dict:
    """Fixed build and kernel cache directories inside the checkout (the
    port's own kernels build into ``build/kernels`` beside its package)."""
    b = os.path.join(root, "build")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(b, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(b, "triton"),
            "CUDA_CACHE_PATH": os.path.join(b, "cuda_cache")}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_record(count: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def result_line(cell, record: dict, trace: bool, device: dict) -> tuple:
    """(the result line, the judged numbers) from a runner's record."""
    from benchmark import cells, check

    rows = check.judge(record["numbers"], cell.limits)
    out = {"correct": all(r["ok"] for r in rows),
           "attempted": record["attempted"], "failed": record["failed"]}
    if trace:
        metrics = cells.read_per_layer(cell, record)
        device = dict(device, busy_s=record["busy_s"],
                      window_s=record["trace_window_s"])
        ops = sorted(record["trace"].by_name().items(),
                     key=lambda kv: -kv[1])[:10]
        gaps = record["host_trace"].idle_gaps(10)
        out["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                            "idle_gaps": [[k, v] for k, v in gaps]}
    else:
        metrics = {m["name"]: {"value": record[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    out["device"] = device
    out["pace"] = dict(record.get("pace", {}))
    if trace:
        # The profiled stretches' time per call or step against the
        # window's: what each way of profiling costs the host.
        per = record["window_s"] / max(record["attempted"], 1)
        out["pace"].update(
            window_per_unit_s=per,
            device_only_per_unit_s=record["trace_window_s"]
            / record["trace_units"],
            host_ops_per_unit_s=record["host_trace_window_s"]
            / record["trace_units"])
    out["check"] = {r["name"]: {"value": r["value"], "limit": r["limit"]}
                    for r in rows}
    return out, rows


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.update(cache_dirs(ROOT))
    import torch

    from benchmark import cells, check

    cell = cells.load_cell(args.workload, ROOT)
    mode = cell.traffic["mode"]
    name = runner_of(mode, ROOT)
    if name is None:
        print(f"benchmark: traffic mode {mode!r} has no runner: no "
              f"benchmark/{mode}.py that defines run()", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s), this machine has {n}", file=sys.stderr)
        return 2
    if cell.traffic.get("host_threads"):
        # The host's intra-op threads: a parallel region waits on its
        # slowest thread, which a shared host may leave unscheduled.
        torch.set_num_threads(int(cell.traffic["host_threads"]))
    runner = importlib.import_module(name)
    record = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    out, rows = result_line(
        cell, record, bool(args.trace),
        device_record(cell.chips, record["memory_peak_bytes"]))
    print(f"numbers {json.dumps(record['numbers'])}", file=sys.stderr)
    print(f"pace {json.dumps(out['pace'])}", file=sys.stderr)
    check.print_judgement(rows)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
