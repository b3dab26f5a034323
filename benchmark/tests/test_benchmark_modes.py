"""Traffic modes found by name: ``run.runner_of`` resolves each cell's mode
to its runner's file, a new mode is added by a file alone, and a training
mode other than ``train`` runs through the shared training skeleton."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import cells, run, train, training
from benchmark.tests.tiny import family_of, tiny_cell

ROOT = cells.ROOT


@pytest.mark.parametrize("mode, runner", [
    ("serve", "benchmark.serve"), ("train", "benchmark.train"),
    ("nosuch", None),          # no file
    ("training", None),        # a file without run
    ("serve-b8", None)])       # no module name
def test_runner_of_resolves_modes(mode, runner):
    assert run.runner_of(mode) == runner


def test_every_cell_has_a_runner():
    bench = cells.load_benchmark(ROOT)
    for w in bench["workloads"]:
        mode = cells.load_cell(w["name"], ROOT, bench).traffic["mode"]
        assert run.runner_of(mode) is not None, (w["name"], mode)
        assert family_of(mode) in ("serve", "train")
    with pytest.raises(ValueError):
        family_of("nosuch")


def _copy(tmp_path) -> dict:
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return {p: open(p, "rb").read()
            for p in map(str, tmp_path.rglob("*")) if os.path.isfile(p)}


def test_a_mode_is_added_by_files_alone(tmp_path):
    """A new mode's file is its runner, with no other file changed; a file
    without ``run`` is none."""
    before = _copy(tmp_path)
    (tmp_path / "benchmark/stub.py").write_text(
        "FAMILY = \"train\"\n\n\n"
        "def run(cell, seed, seconds, trace, t_start):\n"
        "    raise NotImplementedError\n")
    (tmp_path / "benchmark/notes.py").write_text("def walk():\n    pass\n")
    assert run.runner_of("stub", str(tmp_path)) == "benchmark.stub"
    assert run.runner_of("notes", str(tmp_path)) is None
    assert run.runner_of("stub") is None
    for p, data in before.items():
        assert open(p, "rb").read() == data


def test_a_mode_without_runner_exits_2_naming_its_file(tmp_path):
    """The runner is looked for before the chip: no result line, and the
    message names the file."""
    _copy(tmp_path)
    t = json.load(open(tmp_path / "benchmark/workloads/train-b6.json"))
    t["mode"] = "nosuch"
    json.dump(t, open(tmp_path / "benchmark/workloads/nosuch-b6.json", "w"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["workloads"].append({"name": "r101-nosuch-b6",
                               "config": "toist-r101",
                               "traffic": "nosuch-b6", "chips": 1,
                               "why": "a temporary cell"})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    shutil.copy(tmp_path / "benchmark/limits/r101-train-b6.json",
                tmp_path / "benchmark/limits/r101-nosuch-b6.json")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "r101-nosuch-b6", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "benchmark/nosuch.py" in out.stderr


def _paired_setup(cell, seed, device, step_hook):
    """The plain step, fed {"noun": batch, "sth": batch} pairs in the
    window as the distillation step is."""
    s = train.checked_setup(cell, seed, device, step_hook)
    step = s["train_step"]
    s["train_step"] = lambda state, pair: step(state, pair["noun"])
    s["pool"] = [{"noun": b, "sth": b} for b in s["pool"]]
    return s


def _paired_numbers(cell, s, seed, device):
    return train.numbers(cell, dict(s, pool=[e["noun"] for e in s["pool"]]),
                         seed, device)


PAIRED = training.Program(
    setup=_paired_setup,
    flops=lambda m, e: train.batch_flops(m, e["noun"]),
    canvas=lambda e: e["noun"]["images"].shape,
    numbers=_paired_numbers)


def test_a_training_mode_runs_through_the_skeleton():
    """A program over paired entries runs the skeleton's set-up, window
    and check, and gives the plain mode's numbers, steps and record keys.
    A window of 30 ms holds exactly one step of the tiny cell (80 ms or
    more on the CPU)."""
    cell = tiny_cell("r101-train-b6")
    plain = train.run(cell, 29, 0.03, False, time.perf_counter(), "cpu")
    paired = training.drive(PAIRED, cell, 29, 0.03, False,
                            time.perf_counter(), "cpu")
    assert paired["mode"] == plain["mode"] == "train"
    assert paired["numbers"] == plain["numbers"]
    assert paired["attempted"] == plain["attempted"] == 1
    assert paired["model_flops"] == plain["model_flops"]
    assert sorted(paired) == sorted(plain)
    out = run.result_line(cell, paired, False, {"platform": "cpu"})[0]
    assert out["correct"] is True
    assert set(out["metrics"]) == {"train_samples_s", "setup_s"}
