"""The benchmark's files: BENCHMARK.json against the contract's shape,
every cell, configuration, traffic mix, limit and metric found by name, a
cell added by files alone, and the import rules."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import cells, run

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark(ROOT)


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.add(w["name"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"], ROOT, bench)
        reported = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


@pytest.mark.parametrize("cell", ["r101-serve-b8", "r101-train-b6"])
def test_cell_files_found_by_name(cell):
    c = cells.load_cell(cell)
    assert c.traffic["mode"] in ("serve", "train")
    assert c.limits and all(v >= 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]))


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new traffic mix, limits file and BENCHMARK.json entry make a cell
    that the harness finds, with no other file changed."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = {p: open(p, "rb").read()
              for p in map(str, (tmp_path / "benchmark").rglob("*"))
              if os.path.isfile(p)}
    t = json.load(open(tmp_path / "benchmark/workloads/serve-b8.json"))
    t.update(batch=4, why="a temporary cell")
    json.dump(t, open(tmp_path / "benchmark/workloads/serve-b4.json", "w"))
    json.dump({"score_gap": 0.5, "box_gap": 0.0075, "unsorted": 0},
              open(tmp_path / "benchmark/limits/r101-serve-b4.json", "w"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["workloads"].append({"name": "r101-serve-b4",
                               "config": "toist-r101", "traffic": "serve-b4",
                               "chips": 1, "why": "a temporary cell"})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    cell = cells.load_cell("r101-serve-b4", str(tmp_path))
    assert cell.traffic["batch"] == 4 and cell.config_name == "toist-r101"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    for p, data in before.items():
        assert open(p, "rb").read() == data


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden_modules(["toist_tpu_torch.models.toist",
                                  "benchmark.run", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "toist_tpu.config",
                                  "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "toist_tpu"]


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    names = _loaded("import benchmark.run, benchmark.serve, benchmark.train, "
                    "benchmark.control, benchmark.trace, benchmark.probes\n"
                    "import toist_tpu_torch.predict, toist_tpu_torch.train."
                    "engine, toist_tpu_torch.train.step")
    assert not names & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    names = _loaded("import benchmark.reference.toist, "
                    "benchmark.reference.train")
    assert not names & (set(run.FORBIDDEN) | {"toist_tpu_torch"})


def test_run_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "r101-serve-b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
