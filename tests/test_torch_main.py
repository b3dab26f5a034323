"""The port's entry point (toist_tpu_torch.main) on the CPU.

``main`` on the tiny config of tests/test_main_integration.py over the
fixture, with a frozen-BN backbone warm-started by ``--load`` (seeded
reference-layout weights) and with a GroupNorm backbone from scratch
(``init_like_jax``): two epochs write their records, checkpoints and event
file, every eval gives a finite mean AP@0.5, ``--eval --resume`` (through
the command line) gives the last in-run eval's per-task stats exactly, and
``--eval --load`` of the last checkpoint gives its detections bit for bit
(a random model's AP at this size is mostly 0, so the detections are what
shows that the same weights came back).
``parse_args`` gives the JAX ``parse_args``'s config on the same argv; a
('data', 'model') grid, ``run.profile_dir`` and the pretrained files run. Distillation with softkd,
nsthl2 and the cluster bank, its teacher through ``run.load_noun``: one
epoch writes the distillation checkpoint and evaluates with the cluster
snapping; ``--eval --resume`` restores the state bit for bit and gives the
in-run eval's stats. Segmentation (train_seg's settings at hidden 128):
``--load`` of a detection checkpoint keeps the mask head's fresh init and
drops the checkpoint's contrastive projections, the frozen detector comes
back bit for bit, the eval logs the mask AP@0.5 and ``--eval --resume``
gives the in-run eval's stats; train_seg_dis (``loss.cluster``) runs one
epoch and evaluates bbox and segm with the cluster snapping.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from toist_tpu import main as jmain
from toist_tpu_torch.config import Config
from toist_tpu_torch.data.captions import build_tokenizer
from toist_tpu_torch.data.fixtures import generate_fixture
from toist_tpu_torch.main import main, parse_args
from toist_tpu_torch.utils.convert import synth_reference_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _overrides(root, out, norm):
    return {
        "model": {"backbone": "resnet18-test", "hidden_dim": 64, "nheads": 4,
                  "dim_feedforward": 128, "enc_layers": 2, "dec_layers": 2,
                  "num_queries": 12, "compute_dtype": "float32",
                  "contrastive_align_loss": False,
                  "backbone_norm": norm, "text_hidden": 64,
                  "text_layers": 2, "text_heads": 4,
                  "text_intermediate": 128},
        "data": {"coco_path": root, "refexp_ann_path": root + "/annotations",
                 "tasks": [1, 2], "image_buckets": [[128, 128]],
                 "max_text_len": 48, "max_boxes": 8,
                 "train_scales": [96], "max_size": 128, "val_size": 96,
                 "num_workers": 1},
        "optim": {"train_batch_size": 2, "valid_batch_size": 2, "epochs": 2,
                  "lr": 1e-3, "lr_backbone": 1e-3, "text_encoder_lr": 1e-3,
                  "ema": True, "eval_skip": 1},
        "run": {"output_dir": out, "seed": 0, "mesh_shape": [1]},
    }


def _log(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _warm_start(path, cfg):
    """Seeded reference-layout weights of the tiny model (the fixture
    tokenizer's vocabulary), box centres spread over the canvas and sizes
    near the fixture's objects, saved as a reference payload."""
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=2, dec=2, d=64, dim_feedforward=128,
        text_layers=2, text_hidden=64, text_intermediate=128, num_queries=12,
        vocab_size=build_tokenizer(cfg).vocab_size, contrastive=False,
        with_masks=False, seed=3)
    sd["bbox_embed.layers.2.weight"][:2] *= 2.0
    sd["bbox_embed.layers.2.bias"][:] = [0.0, 0.0, -0.7, -0.7]
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)


def _record_detections(monkeypatch):
    """Each main's eval detections, batch by batch: a list per main."""
    import toist_tpu_torch.main as pmain

    runs, make = [], pmain.make_eval_step

    def recording(model, cfg, weight_dict):
        step, dets = make(model, cfg, weight_dict), []
        runs.append(dets)

        def eval_step(batch):
            res = step(batch)
            dets.append({k: res["post"][k].clone() for k in ("scores",
                                                              "boxes")})
            return res
        return eval_step

    monkeypatch.setattr(pmain, "make_eval_step", recording)
    return runs


@pytest.mark.parametrize("norm", ["frozen_bn", "group_norm"])
def test_main_trains_checkpoints_and_evaluates(tmp_path, monkeypatch, norm):
    root = generate_fixture(str(tmp_path / "data"), num_tasks=2,
                            imgs_per_split=4, img_size=(96, 128), seed=1)
    out = str(tmp_path / "out")
    over = _overrides(root, out, norm)
    if norm == "frozen_bn":
        _warm_start(str(tmp_path / "warm.pth"),
                    Config.from_sources(None, over))
        over["run"]["load"] = str(tmp_path / "warm.pth")
    runs = _record_detections(monkeypatch)
    best = main(Config.from_sources(None, over), device="cpu")
    files = sorted(os.listdir(out))
    assert {"BEST_checkpoint", "checkpoint", "log.jsonl"} <= set(files)
    assert len(files) == 4 and any(f.startswith("events.out.tfevents.")
                                   for f in files)
    log = _log(out)
    kinds = [r["kind"] for r in log]
    assert kinds.count("epoch") == 2 and kinds.count("eval") == 2
    assert {"train_step", "epoch", "eval"} == set(kinds)
    steps = [r for r in log if r["kind"] == "train_step"]
    assert {"loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm",
            "step", "epoch"} <= set(steps[0])
    evals = [r for r in log if r["kind"] == "eval"]
    assert all(np.isfinite(r["mean_ap50"]) for r in evals)
    assert set(evals[-1]["per_task"]) == {"1", "2"}
    assert best == max(r["mean_ap50"] for r in evals)
    assert len(runs[0]) == 2 * 4                  # 2 evals of 2 x 2 batches

    # --eval --resume through the command line: the last in-run eval again.
    eval_out = str(tmp_path / "eval_resume")
    sets = [f"{sec}.{k}={json.dumps(v)}" for sec, d in over.items()
            if sec != "run" for k, v in d.items()]   # the same config
    proc = subprocess.run(
        [sys.executable, "-m", "toist_tpu_torch.main", "--device", "cpu",
         "--eval", "--resume", os.path.join(out, "checkpoint"),
         "--output-dir", eval_out, "--set", "run.seed=0", *sets],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    [resumed] = _log(eval_out)
    assert resumed["per_task"] == evals[-1]["per_task"]
    assert resumed["mean_ap50"] == evals[-1]["mean_ap50"]

    # --eval --load of the same checkpoint (EMA preferred): the last in-run
    # eval's detections, bit for bit.
    over_load = dict(over, run={"eval_only": True, "seed": 0,
                                "load": os.path.join(out, "checkpoint")})
    m = main(Config.from_sources(None, over_load), device="cpu")
    assert m == evals[-1]["mean_ap50"]
    assert len(runs[1]) == 4
    for a, b in zip(runs[0][4:], runs[1]):
        assert torch.equal(a["scores"], b["scores"])
        assert torch.equal(a["boxes"], b["boxes"])
    assert runs[1][0]["scores"].std() > 0        # not a degenerate model


@pytest.mark.parametrize("argv", [
    [],
    ["--config", "configs/tdod.json", "--eval", "--resume", "ck/checkpoint"],
    ["--load", "w.pth", "--output-dir", "out", "--set", "optim.lr=1e-4",
     "model.backbone_norm=group_norm", "data.tasks=[1,2]", "run.seed=3"],
])
def test_parse_args_matches_jax(argv):
    argv = [os.path.join(REPO, a) if a.endswith(".json") else a
            for a in argv]
    assert parse_args(argv).to_dict() == jmain.parse_args(argv).to_dict()


def _pretrained_file(path, cfg, prefix, seed):
    """A random state dict of the model's ``prefix`` part in the upstream
    layout (torchvision / Hugging Face names, with a classifier head or
    HF's position_ids buffer beside), as a bare ``.pth``."""
    from toist_tpu_torch.models.toist import TOIST

    with torch.device("meta"):
        model = TOIST(cfg.model, text_vocab_size=build_tokenizer(
            cfg).vocab_size)
    g = torch.Generator().manual_seed(seed)
    sd = {k[len(prefix):]: torch.rand(v.shape, generator=g) + 0.5
          for k, v in model.state_dict().items() if k.startswith(prefix)}
    if prefix.startswith("backbone"):
        sd["fc.weight"] = torch.zeros(1000, 2048)
    else:
        sd["embeddings.position_ids"] = torch.arange(514)[None]
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("mode", [
    ("run", "mesh_axes", ["data", "model"]), ("run", "profile_dir", "trace"),
    ("run", "pretrained_backbone", "r101.pth"),
    ("run", "pretrained_text", "roberta.pth"), ("run", "mesh_shape", [2])])
def test_unported_modes_raise(tmp_path, monkeypatch, capsys, mode):
    """The modes that raised NotImplementedError until the port ran them
    now run on the CPU: a ('data', 'model') grid of (1, 1) in one process
    evaluates; ``run.profile_dir`` writes a trace of the first
    epoch and prints its ``[profile]`` line; the pretrained files land in
    the model that evaluates. A mesh of 2 devices in one process still
    raises ValueError, as JAX's make_mesh does."""
    import toist_tpu_torch.main as pmain
    from toist_tpu_torch.utils import pretrained as ppre

    sec, key, val = mode
    if key == "mesh_shape":
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            main(Config.from_sources(None, {sec: {key: val}}), device="cpu")
        return
    root = generate_fixture(str(tmp_path / "data"), num_tasks=2,
                            imgs_per_split=2, img_size=(96, 128), seed=1)
    out = str(tmp_path / "out")
    over = _overrides(root, out, "frozen_bn")
    over["optim"]["epochs"] = 1
    if key == "mesh_axes":
        over["run"].update(mesh_axes=val, mesh_shape=[1, 1],
                           eval_only=True)
    elif key == "profile_dir":
        over["run"]["profile_dir"] = str(tmp_path / val)
    else:
        over["run"].update(eval_only=True, output_dir="")
        over["run"][key] = str(tmp_path / val)
    cfg = Config.from_sources(None, over)
    want = None
    if key.startswith("pretrained"):
        prefix = ppre.BACKBONE if key.endswith("backbone") else ppre.TEXT
        want = _pretrained_file(str(tmp_path / val), cfg, prefix, seed=2)
    models, make = [], pmain.make_eval_step

    def keeping(model, cfg, weight_dict):
        models.append(model)
        return make(model, cfg, weight_dict)
    monkeypatch.setattr(pmain, "make_eval_step", keeping)
    m = main(cfg, device="cpu")
    assert np.isfinite(m)
    if key == "mesh_axes":
        assert [r["kind"] for r in _log(out)] == ["eval"]
    elif key == "profile_dir":
        traces = os.listdir(str(tmp_path / val))
        assert len(traces) == 1 and traces[0].endswith(".json.gz")
        assert "[profile] " in capsys.readouterr().out
    else:
        sd = models[0].state_dict()
        for k, v in want.items():
            if prefix + k in sd:
                assert torch.equal(sd[prefix + k], v), k
        assert sum(prefix + k in sd for k in want) == len(want) - 1


def test_distillation_main_trains_and_resumes(tmp_path, monkeypatch):
    import dataclasses

    import toist_tpu_torch.main as pmain
    from toist_tpu_torch.train import checkpoint as ckpt

    root = generate_fixture(str(tmp_path / "data"), num_tasks=2,
                            imgs_per_split=4, img_size=(96, 128), seed=1)
    out = str(tmp_path / "out")
    over = _overrides(root, out, "frozen_bn")
    over["optim"]["epochs"] = 1
    over["loss"] = {"distillation": True, "softkd_loss": True,
                    "nsthl2_loss": True, "nsthl2_coef": 1.0,
                    "cluster": True, "cluster_memory_size": 8,
                    "cluster_num": 2, "kmeans_max_iters": 4}
    _warm_start(str(tmp_path / "teacher.pth"),
                Config.from_sources(None, over))
    over["run"]["load_noun"] = str(tmp_path / "teacher.pth")
    states, make = [], pmain.make_distillation_train_step

    def keeping(cfg, weight_dict):
        step = make(cfg, weight_dict)

        def train_step(state, batch):
            states.append(state)
            return step(state, batch)
        return train_step

    monkeypatch.setattr(pmain, "make_distillation_train_step", keeping)
    runs = _record_detections(monkeypatch)
    cfg = Config.from_sources(None, over)
    main(cfg, device="cpu")
    state = states[-1]
    assert {"BEST_checkpoint", "checkpoint", "log.jsonl"} <= set(
        os.listdir(out))
    # The teacher came from run.load_noun (the warm start's query
    # embeddings, before the step moved them a little).
    teacher_sd = torch.load(str(tmp_path / "teacher.pth"))["model"]
    moved = (state.teacher.query_embed.weight.detach()
             - teacher_sd["query_embed.weight"]).abs().max()
    assert 0 < moved < 0.1
    log = _log(out)
    steps = [r for r in log if r["kind"] == "train_step"]
    for key in ("loss_softkd", "loss_softkd_0", "loss_nsthl2",
                "loss_cluster_feature", "noun_loss_ce", "sth_loss_ce"):
        assert np.isfinite(steps[0][key]), key
    assert len(steps[-1]["bank_update_count"]) == 14
    assert sum(steps[-1]["bank_update_count"]) == 8     # 8 images x 1 noun
    [ev] = [r for r in log if r["kind"] == "eval"]
    assert runs == []          # the cluster eval step, not the plain one

    # The saved state restores bit for bit; --eval --resume gives the
    # in-run eval's stats.
    from tests.test_torch_checkpoint import _assert_states_equal
    n = len(states)
    restored, epoch = ckpt.restore(os.path.join(out, "checkpoint"), cfg,
                                   n, n, device="cpu")
    assert epoch == 0
    _assert_states_equal(restored, state)
    assert restored.cluster_bank.update_count.sum() == 8
    resumed = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, eval_only=True, resume=os.path.join(out, "checkpoint"),
        output_dir=str(tmp_path / "eval_resume")))
    assert main(resumed, device="cpu") == ev["mean_ap50"]
    [again] = _log(str(tmp_path / "eval_resume"))
    assert again["per_task"] == ev["per_task"]


def _seg_overrides(root, out):
    over = _overrides(root, out, "frozen_bn")
    over["model"].update(hidden_dim=128, nheads=8, enc_layers=1,
                         dec_layers=1, mask_model="smallconv",
                         frozen_detector=True)
    over["optim"]["epochs"] = 1
    over["loss"] = {"aux_loss": False}
    return over


@pytest.mark.parametrize("cluster", [False, True])
def test_segmentation_main_from_a_detection_checkpoint(tmp_path, cluster):
    """train_seg (and, with ``loss.cluster``, train_seg_dis) from a
    detection checkpoint through ``main``."""
    from toist_tpu_torch.train import checkpoint as ckpt

    root = generate_fixture(str(tmp_path / "data"), num_tasks=2,
                            imgs_per_split=4, img_size=(96, 128), seed=1)
    out = str(tmp_path / "out")
    over = _seg_overrides(root, out)
    if cluster:
        over["loss"].update(cluster=True, cluster_memory_size=8,
                            cluster_num=2, kmeans_max_iters=4)
    cfg = Config.from_sources(None, over)
    det = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=128, dim_feedforward=128,
        text_layers=2, text_hidden=64, text_intermediate=128, num_queries=12,
        vocab_size=build_tokenizer(cfg).vocab_size, contrastive=True,
        with_masks=False, seed=3)
    assert any(k.startswith("contrastive_align") for k in det)
    det = {k: torch.from_numpy(v) for k, v in det.items()}
    torch.save({"model": det}, str(tmp_path / "det.pth"))
    over["run"]["load"] = str(tmp_path / "det.pth")
    main(Config.from_sources(None, over), device="cpu")

    saved = torch.load(os.path.join(out, "checkpoint"))
    for key in ("model", "model_ema"):
        sd = saved[key]
        assert {k for k in sd if k not in det} == {
            k for k in sd if k.startswith(("bbox_attention.", "mask_head."))}
        assert len([k for k in sd if k.startswith("mask_head.")]) == 28
        assert not any(k.startswith("contrastive_align") for k in sd)
        for k, v in sd.items():          # the frozen detector, bit for bit
            if k in det:
                assert torch.equal(v, det[k]), (key, k)
    assert len(saved["optimizer"]["state"]) == 32     # the mask branch only
    log = _log(out)
    steps = [r for r in log if r["kind"] == "train_step"]
    assert all(np.isfinite(r["loss"]) for r in steps)
    [ev] = [r for r in log if r["kind"] == "eval"]
    assert np.isfinite(ev["map@0.5_masks"])
    for stats in ev["per_task"].values():
        assert set(stats) == {"bbox", "segm"}
    assert ev["map@0.5_masks"] == np.mean(
        [s["segm"][1] for s in ev["per_task"].values()])
    if cluster:
        assert saved["cluster_criterion"]["update_count"].sum() == 0
        return
    n = len(steps)
    restored, _ = ckpt.restore(os.path.join(out, "checkpoint"),
                               Config.from_sources(None, over), n, n,
                               device="cpu")
    mh = {k: v for k, v in restored.model.state_dict().items()
          if k.startswith("mask_head.")}
    assert mh["mask_head.out_lay.weight"].dtype == torch.float32
    assert len(mh) == 28
    over_eval = dict(over, run={"eval_only": True, "seed": 0,
                                "resume": os.path.join(out, "checkpoint"),
                                "output_dir": str(tmp_path / "eval")})
    assert main(Config.from_sources(None, over_eval),
                device="cpu") == ev["mean_ap50"]
    [again] = _log(str(tmp_path / "eval"))
    assert again["per_task"] == ev["per_task"]
    assert again["map@0.5_masks"] == ev["map@0.5_masks"]


def test_device_memory_stats_without_a_card(monkeypatch):
    """``utils/profiling.device_memory_stats``: {} without a card, and per
    card its live and peak bytes (read through torch.cuda) with one."""
    from toist_tpu_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 10 + i)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: 20 + i)
    assert profiling.device_memory_stats() == {
        f"cuda:{i}": {"bytes_in_use": 10 + i, "peak_bytes_in_use": 20 + i}
        for i in (0, 1)}

