"""``torchrun --nproc_per_node 2 -m toist_tpu_torch.main --device cpu`` (gloo)
against one process at twice the per-rank batch, on the fixture: the port's
counterpart of ``tests/test_multiprocess.py``.

Plain detection and distillation each train one epoch from the same seeded
warm start at the same global batch, in two ranks and in one process, all
four runs at once; then one process evaluates the 2-rank checkpoint
(``--eval --resume``), one process resumes it for a second epoch, and two
ranks resume the 1-process checkpoint. Checked: the per-step losses and grad
norms (the first step within 1e-5, later ones within the drift AdamW gives
reduction-order noise, as ``tests/test_multiprocess.py`` bounds it), the
merged host-sharded eval equal to the 1-process eval of the same checkpoint
exactly, rank 0 alone writing, the bank's counters exact and its rows close,
the checkpoint crossing between 2 ranks and 1, and the JAX package reading
the 2-rank checkpoint. The model is 2 + 2 layers (at one decoder layer
every query of the warm start predicts the same box, and the AP is 0),
text 1 layer, hidden 64, 8 queries, f32, dropout 0. A distillation eval
takes batch 1: the cluster eval warm-starts
each sample's k-means from the one before it in its batch, so only
single-sample batches score alike however the val set is split.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from toist_tpu.utils.convert import \
    load_reference_checkpoint as jax_load_checkpoint
from toist_tpu_torch.config import Config
from toist_tpu_torch.data.captions import build_tokenizer
from toist_tpu_torch.data.fixtures import generate_fixture
from toist_tpu_torch.utils.convert import (jax_params_to_state_dict,
                                           synth_reference_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600


def _sets(root, batch, valid_batch, distill=False):
    sets = {
        "model": {"backbone": "resnet18-test", "hidden_dim": 64,
                  "nheads": 4, "dim_feedforward": 128, "enc_layers": 2,
                  "dec_layers": 2, "num_queries": 8,
                  "compute_dtype": "float32", "dropout": 0.0,
                  "resizer_dropout": 0.0, "contrastive_align_loss": False,
                  "backbone_norm": "frozen_bn", "text_hidden": 64,
                  "text_layers": 1, "text_heads": 4,
                  "text_intermediate": 128},
        "data": {"coco_path": root, "refexp_ann_path": root + "/annotations",
                 "tasks": [1, 2], "image_buckets": [[128, 128]],
                 "max_text_len": 48, "max_boxes": 8, "train_scales": [96],
                 "max_size": 128, "val_size": 96, "num_workers": 1},
        "optim": {"train_batch_size": batch, "valid_batch_size": valid_batch,
                  "epochs": 1, "lr": 1e-3, "lr_backbone": 1e-3,
                  "text_encoder_lr": 1e-3, "ema": False, "eval_skip": 1},
        "run": {"seed": 0, "async_checkpoint": False}}
    if distill:
        sets["loss"] = {"distillation": True, "softkd_loss": True,
                        "softkd_coef": 50.0, "nsthl2_loss": True,
                        "cluster": True, "cluster_memory_size": 8,
                        "cluster_num": 2, "cluster_feature_loss": 1e4,
                        "kmeans_max_iters": 8}
    return sets


def _argv(sets):
    return ["--set"] + [f"{sec}.{k}={json.dumps(v)}"
                        for sec, kv in sets.items() for k, v in kv.items()]


def _warm_start(path, sets):
    """Seeded weights of the tiny model in the fixture tokenizer's
    vocabulary, box centres spread over the canvas and sizes near the
    fixture's objects, so that the eval's AP is not 0."""
    cfg = Config.from_sources(None, sets)
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=2, dec=2, d=64, dim_feedforward=128,
        text_layers=1, text_hidden=64, text_intermediate=128, num_queries=8,
        vocab_size=build_tokenizer(cfg).vocab_size, contrastive=False,
        with_masks=False, seed=3)
    sd["bbox_embed.layers.2.weight"][:2] *= 2.0
    sd["bbox_embed.layers.2.bias"][:] = [0.0, 0.0, -0.7, -0.7]
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)


def _start(out, argv, ranks=1):
    cmd = [sys.executable, "-m"]
    if ranks > 1:
        cmd += ["torch.distributed.run", "--standalone",
                f"--nproc_per_node={ranks}", "-m"]
    cmd += ["toist_tpu_torch.main", "--device", "cpu", "--output-dir", out,
            *argv]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _log(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    root = generate_fixture(str(tmp / "data"), num_tasks=2,
                            imgs_per_split=4, img_size=(96, 128), seed=7)
    warm = str(tmp / "warm.pth")
    _warm_start(warm, _sets(root, 1, 2))
    out = {k: str(tmp / k) for k in ("mp", "one", "dmp", "done", "eval",
                                     "deval", "resume1", "resume2", "weval1",
                                     "weval2")}
    plain = {n: _argv(_sets(root, b, 2)) for n, b in ((1, 1), (2, 2))}
    dis = {n: _argv(_sets(root, b, 1, distill=True))
           for n, b in ((1, 1), (2, 2))}
    first = _wait([
        _start(out["mp"], ["--load", warm] + plain[1], ranks=2),
        _start(out["one"], ["--load", warm] + plain[2]),
        _start(out["dmp"], ["--load", warm] + dis[1], ranks=2),
        _start(out["done"], ["--load", warm] + dis[2]),
        _start(out["weval1"], ["--eval", "--load", warm] + plain[1])])
    ck_mp = os.path.join(out["mp"], "checkpoint")
    two_epochs = ["optim.epochs=2"]
    second = _wait([
        _start(out["eval"], ["--eval", "--resume", ck_mp] + plain[1]),
        _start(out["deval"], ["--eval", "--resume",
                              os.path.join(out["dmp"], "checkpoint")]
               + dis[1]),
        _start(out["resume1"], ["--resume", ck_mp] + plain[1] + two_epochs),
        _start(out["resume2"], ["--resume",
                                os.path.join(out["one"], "checkpoint")]
               + plain[1] + two_epochs, ranks=2),
        _start(out["weval2"], ["--eval", "--load", warm] + plain[1],
               ranks=2)])
    return {"out": out, "stdout": first + second}


def _steps(out):
    return [r for r in _log(out) if r["kind"] == "train_step"]


def _assert_steps_match(got, want, later_rtol):
    assert want and [r["step"] for r in got] == [r["step"] for r in want]
    for i, (g, w) in enumerate(zip(got, want)):
        for k, v in w.items():
            if k.startswith("loss") or k == "grad_norm":
                np.testing.assert_allclose(
                    g[k], v, rtol=1e-5 if i == 0 else later_rtol,
                    atol=1e-6 if i == 0 else 1e-4, err_msg=f"{i} {k}")


def test_two_ranks_train_as_one_process_at_twice_the_batch(runs):
    """Plain detection: the same steps, losses and grad norms; rank 0 alone
    wrote (one TensorBoard file, no record twice, no temporary file)."""
    out = runs["out"]
    _assert_steps_match(_steps(out["mp"]), _steps(out["one"]), 1e-3)
    files = sorted(os.listdir(out["mp"]))
    events = [f for f in files if f.startswith("events.out.tfevents")]
    assert len(events) == 1
    assert set(files) - set(events) == {"checkpoint", "BEST_checkpoint",
                                        "log.jsonl"}
    log = _log(out["mp"])
    assert [r["kind"] for r in log if r["kind"] != "train_step"] == \
        ["epoch", "eval"]
    steps = [r["step"] for r in log if r["kind"] == "train_step"]
    assert len(steps) == len(set(steps)) > 0
    for r in range(2):       # the ranks' lines may interleave in stdout
        assert runs["stdout"][0].count(
            f"toist_tpu_torch.dist: rank {r} of 2 on cpu, backend gloo "
            "(device cpu)") == 1


def test_merged_eval_equals_one_process_eval(runs):
    """The 2-rank run's eval (each rank half of the val set, merged) is the
    1-process --eval --resume of its checkpoint, exactly; the same for the
    distillation run's cluster eval, and for --eval of the warm start, whose
    AP is not 0."""
    out = runs["out"]
    for run, one in (("mp", "eval"), ("dmp", "deval"),
                     ("weval2", "weval1")):
        [got] = [r for r in _log(out[run]) if r["kind"] == "eval"]
        [want] = [r for r in _log(out[one]) if r["kind"] == "eval"]
        assert got["per_task"] == want["per_task"], run
        assert got["mean_ap50"] == want["mean_ap50"]
    assert got["mean_ap50"] > 0


def test_checkpoint_crosses_between_two_ranks_and_one(runs):
    """A 2-rank checkpoint resumes in one process and a 1-process one in
    two ranks, each for a second epoch; the JAX package reads the 2-rank
    checkpoint with the full optimizer state."""
    out = runs["out"]
    for run in ("resume1", "resume2"):
        log = _log(out[run])
        assert [r["epoch"] for r in log if r["kind"] == "epoch"] == [1]
        assert min(r["step"] for r in log if r["kind"] == "train_step") > 4
    ck = os.path.join(out["mp"], "checkpoint")
    payload = torch.load(ck, weights_only=False)
    n_trainable = len(payload["optimizer"]["state"])
    assert n_trainable > 0 and all(
        set(s) == {"step", "exp_avg", "exp_avg_sq"}
        for s in payload["optimizer"]["state"].values())
    params, frozen = jax_load_checkpoint(ck, d_model=64, enc_layers=2,
                                         dec_layers=2,
                                         stage_sizes=(1, 1, 1, 1))
    sd = jax_params_to_state_dict(params, frozen)
    assert set(sd) == set(payload["model"])
    for k, v in payload["model"].items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)


def test_two_rank_distillation_matches_one_process(runs):
    """Distillation: the same steps and losses; the bank's counters and
    full flags exact, its rows and centers within the drift of the
    teacher's AdamW updates (``tests/test_multiprocess.py`` bounds)."""
    out = runs["out"]
    _assert_steps_match(_steps(out["dmp"]), _steps(out["done"]), 1e-2)
    banks = [torch.load(os.path.join(out[r], "checkpoint"),
                        weights_only=False)["cluster_criterion"]
             for r in ("dmp", "done")]
    for k in ("update_count", "full"):
        np.testing.assert_array_equal(banks[0][k].numpy(),
                                      banks[1][k].numpy(), err_msg=k)
    assert int(banks[1]["update_count"].sum()) >= 8
    for k in ("feature_bank", "cluster_centers"):
        a, b = banks[0][k].numpy(), banks[1][k].numpy()
        np.testing.assert_allclose(a, b, atol=5e-3, err_msg=k)
        assert float(np.abs(a - b).mean()) < 5e-4, k
