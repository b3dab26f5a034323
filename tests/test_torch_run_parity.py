"""The port's parity runner (``toist_tpu_torch/scripts/run_parity.py``)
against the JAX package's (``scripts/run_parity.py``).

The five BASELINE.json workloads are the JAX runner's argvs, the command
differing only in the module it runs (and the port's ``--device``); the
diff table is the same function of the same results; the checkpoint audit
stops a run on a wrong shape or a key the model lacks and lists the model
keys a checkpoint lacks; and one ``--fixture --configs dete_task1`` dry run
ends with a report on the CPU.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from toist_tpu_torch.scripts import run_parity as prp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import run_parity as jrp  # noqa: E402  (the JAX package's runner)

ALL = ["dete_task1", "dete_all14", "seg", "noun", "distill"]


def _args(**kw):
    base = dict(eval_batch=8, dis_batch=3, dis_epochs=0, cluster_memory=1024,
                cluster_num=3, configs=ALL)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("case", ["real", "fixture", "subset"])
def test_build_workloads_are_jax_argvs(case):
    ckpt = {"dete": "d.pth", "seg": "s.pth", "noun": "n.pth",
            "student": "st.pth", "teacher": "t.pth"}
    common = {"data.coco_path": "data/images",
              "data.refexp_ann_path": "data/coco-tasks/annotations"}
    base = ["--config", "configs/tdod.json"]
    args = _args()
    if case == "fixture":
        ckpt = {"dete": "d.pth", "seg": "s.pth"}
        common = {**prp.FIXTURE_MODEL, **prp.FIXTURE_DATA, **common}
        base = []
        args = _args(eval_batch=2, dis_batch=2, dis_epochs=1,
                     cluster_memory=16, cluster_num=2)
    elif case == "subset":
        ckpt = {"dete": "d.pth"}
        args = _args(configs=["dete_all14", "seg", "distill"])
    got = prp.build_workloads(args, ckpt, base, common)
    assert got == jrp.build_workloads(args, ckpt, base, common)
    assert [n for n, _ in got] == [n for n in ALL if n in args.configs
                                   and (n != "seg" or "seg" in ckpt)]
    assert prp.FIXTURE_MODEL == jrp.FIXTURE_MODEL
    assert prp.FIXTURE_DATA == jrp.FIXTURE_DATA
    for _, argv in got:
        cmd = prp.workload_command(argv, "out", "cpu")
        want = [sys.executable, "-m", "toist_tpu.main"] + argv + \
            ["--output-dir", "out"]
        assert cmd == [c.replace("toist_tpu.main", "toist_tpu_torch.main")
                       for c in want] + ["--device", "cpu"]


def test_diff_report_equals_jax(capsys):
    results = {"dete_task1": {"mean_ap50": 0.31, "per_task_ap50": {"1": 0.31}},
               "dete_all14": {"mean_ap50": 0.2,
                              "per_task_ap50": {"1": 0.1, "2": 0.3}},
               "seg": {"mean_ap50": 0.05, "per_task_ap50": {"3": 0.05}}}
    goldens = [{k: dict(v) for k, v in results.items()},
               {"dete_task1": {"mean_ap50": 0.6},
                "dete_all14": {"mean_ap50": 0.25,
                               "per_task_ap50": {"1": 0.15, "2": 0.9}}},
               {"noun": {"mean_ap50": 0.1}}]
    for golden in goldens:
        got = prp.diff_report(results, golden)
        out = capsys.readouterr().out
        assert got == jrp.diff_report(results, golden)
        assert capsys.readouterr().out == out
    assert prp.AP_TOLERANCE == jrp.AP_TOLERANCE == 0.2
    assert prp.diff_report(results, goldens[0])["pass"]
    assert not prp.diff_report(results, goldens[1])["pass"]


def test_checkpoint_audit(tmp_path, capsys):
    """A synthetic checkpoint at the fixture widths passes; one without a
    key lists it as a fresh head; a wrong shape or a key the model lacks
    stops the run, naming the key."""
    common, paths = prp.make_fixture(str(tmp_path))
    cfg = prp._cfg_from_sets(dict(common,
                                  **{"model.contrastive_align_loss": True}))
    assert prp.convert_checkpoint(paths["dete"], cfg) == paths["dete"]
    sd = torch.load(paths["dete"], weights_only=True)["model"]

    def saved(weights):
        p = str(tmp_path / "edited.pth")
        torch.save({"model": weights}, p)
        return p

    capsys.readouterr()
    dropped = "transformer.decoder.layers.1.linear1.bias"
    prp.convert_checkpoint(saved({k: v for k, v in sd.items()
                                  if k != dropped}), cfg)
    assert dropped in capsys.readouterr().out
    key = "class_embed.weight"
    with pytest.raises(SystemExit, match=key):
        prp.convert_checkpoint(saved(dict(sd, **{key: sd[key][:, :-1]})),
                               cfg)
    with pytest.raises(SystemExit, match="no home"):
        prp.convert_checkpoint(saved(dict(sd, extra_head=sd[key])), cfg)


def test_fixture_dry_run_on_the_cpu(tmp_path):
    out = str(tmp_path / "parity")
    p = subprocess.run(
        [sys.executable, "-m", "toist_tpu_torch.scripts.run_parity",
         "--fixture", "--configs", "dete_task1", "--device", "cpu",
         "--out", out],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    with open(os.path.join(out, "parity_report.json")) as f:
        res = json.load(f)["results"]
    assert set(res) == {"dete_task1"}
    assert set(res["dete_task1"]["per_task_ap50"]) == {"1"}
    assert np.isfinite(res["dete_task1"]["mean_ap50"])
    assert res["dete_task1"]["seconds"] > 0
