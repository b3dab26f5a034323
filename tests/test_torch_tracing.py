"""The port's spans (``toist_tpu_torch/utils/tracing.py``) on the CPU, on a
tiny model: no ``record_function`` while no profiler records; under a
profiler, each span of a serving call and of a training step once, nested
where it belongs, in the exported trace (a distillation step's softkd and
bank spans too, and its k-means counters among its scalars); none left
open by a forward that raises; the ``[profile]`` line of
``utils/profiling.trace`` names them."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from toist_tpu_torch import config as pconfig
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.predict import Predictor
from toist_tpu_torch.train.cluster import init_bank
from toist_tpu_torch.train.criterion import build_weight_dict
from toist_tpu_torch.train.distill import make_distillation_train_step
from toist_tpu_torch.train.engine import train_one_epoch
from toist_tpu_torch.train.state import init_train_state
from toist_tpu_torch.train.step import make_eval_step, make_train_step
from toist_tpu_torch.utils import profiling, tracing
from toist_tpu_torch.utils.convert import synth_reference_state_dict

SERVE_SPANS = ("toist.h2d", "toist.encode", "toist.decode",
               "toist.postprocess", "toist.d2h")
STEP_SPANS = ("toist.encode", "toist.decode", "toist.criterion",
              "toist.backward", "toist.optimizer")
C = 256                                       # logit columns


@pytest.fixture(scope="module")
def tiny():
    cfg = pconfig.Config.from_sources(None, {"model": {
        "backbone": "resnet18-test", "hidden_dim": 32, "nheads": 2,
        "dim_feedforward": 64, "enc_layers": 1, "dec_layers": 2,
        "num_queries": 10, "compute_dtype": "float32",
        "contrastive_hdim": 16, "text_hidden": 32, "text_layers": 1,
        "text_heads": 2, "text_intermediate": 64}})
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=2, d=32, dim_feedforward=64,
        text_layers=1, text_hidden=32, text_intermediate=64, num_queries=10,
        vocab_size=300, contrastive_hdim=16, with_masks=False, seed=3)
    return cfg, {k: torch.from_numpy(v) for k, v in sd.items()}


def _batch(seed, b=2, h=64, w=96, n=4):
    rng = np.random.default_rng(seed)
    batch = {"images": rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8),
             "image_mask": np.zeros((b, h, w), bool),
             "text_ids": rng.integers(3, 300, (b, 12)).astype(np.int32),
             "text_mask": np.zeros((b, 12), bool),
             "boxes": np.zeros((b, n, 4), np.float32),
             "box_valid": np.zeros((b, n), bool),
             "positive_map": np.zeros((b, n, C), np.float32),
             "sample_valid": np.ones((b,), bool),
             "orig_size": np.full((b, 2), [h, w], np.int32)}
    batch["text_mask"][:, 8:] = True
    for i in range(b):
        batch["boxes"][i, :i + 1] = [0.5, 0.5, 0.3, 0.2]
        batch["box_valid"][i, :i + 1] = True
        batch["positive_map"][i, :i + 1, 1:3] = 0.5
    return batch


def _predictor(tiny):
    cfg, sd = tiny
    return Predictor(TOIST.from_state_dict(sd, cfg.model, "cpu"), None, cfg)


class _Feed:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def epoch(self, _epoch):
        return iter(self.batches)


def _train(tiny, steps, print_freq=10):
    cfg, sd = tiny
    model = TOIST.from_state_dict(sd, cfg.model, "cpu")
    state = init_train_state(model, cfg, steps_per_epoch=10, total_steps=100)
    step = make_train_step(cfg, build_weight_dict(cfg.loss, False, 2))
    feed = _Feed([_batch(10 + i) for i in range(steps)])
    return lambda: train_one_epoch(step, state, feed, 0,
                                   print_freq=print_freq)


def _spans(fn, tmp_path):
    """The ``toist.*`` ranges of one profiled call of ``fn``, as
    (name, ts, end, tid), by start, a parent before a child that opens
    with it."""
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
            e["tid"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith(tracing.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


@pytest.fixture
def entered(monkeypatch):
    """Names of the ``toist.*`` ranges ``record_function`` enters."""
    names = []
    enter = autograd_profiler.record_function.__enter__

    def counted(self):
        if self.name.startswith(tracing.PREFIX):
            names.append(self.name)
        return enter(self)

    monkeypatch.setattr(autograd_profiler.record_function, "__enter__",
                        counted)
    return names


def test_no_record_function_without_a_profiler(tiny, entered):
    assert not autograd_profiler._is_profiler_enabled
    _predictor(tiny).predict_batch(_batch(1))
    _train(tiny, 1)()
    assert entered == []
    # The count sees the spans once a profiler records.
    with profile(activities=[ProfilerActivity.CPU]):
        _predictor(tiny).predict_batch(_batch(1))
    assert entered.count("toist.predict") == 1
    assert entered.count("toist.encode") == 1


def test_serving_spans_nest_inside_predict(tiny, tmp_path):
    pred = _predictor(tiny)
    pred.predict_batch(_batch(1))

    def two_calls():
        pred.predict_batch(_batch(1))
        pred.predict_batch(_batch(2))

    spans = _spans(two_calls, tmp_path)
    tops = [s for s in spans if s[0] == "toist.predict"]
    assert len(tops) == 2
    for name in SERVE_SPANS:
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == 2, name
        for s, top in zip(mine, tops):
            assert _inside(s, top), name
    assert {s[0] for s in spans} == {"toist.predict", *SERVE_SPANS}


@pytest.mark.parametrize("losses", [True, False, "cluster"])
def test_eval_step_spans(tiny, tmp_path, losses):
    """``make_eval_step``'s step: the copy in, the forward, the criterion
    when it computes the eval losses, the postprocess, inside
    ``toist.eval_step``. "cluster" is the cluster eval, with its losses:
    the bank's snap between the encode and the decode."""
    cfg, sd = tiny
    cluster = losses == "cluster"
    cfg = pconfig.Config.from_sources(None, {
        "model": dataclasses.asdict(cfg.model),
        "run": {"compute_eval_losses": bool(losses)},
        "loss": {"cluster": cluster, "cluster_memory_size": 16}})
    step = make_eval_step(TOIST.from_state_dict(sd, cfg.model, "cpu"), cfg,
                          build_weight_dict(cfg.loss, False, 2))
    if cluster:
        bank = init_bank(14, 16, cfg.loss.cluster_num, 32,
                         torch.Generator().manual_seed(0))
        spans = _spans(lambda: step(_pair(4)["sth"], bank), tmp_path)
    else:
        spans = _spans(lambda: step(_batch(4)), tmp_path)
    want = ["toist.eval_step", "toist.h2d", "toist.encode"]
    want += ["toist.bank"] if cluster else []
    want += ["toist.decode"]
    want += ["toist.criterion"] if losses else []
    assert [s[0] for s in spans] == want + ["toist.postprocess"]
    assert all(_inside(s, spans[0]) for s in spans[1:])


def test_training_spans_per_step(tiny, tmp_path):
    """Three steps at ``print_freq`` 10: the host reads after steps 0 and
    2 (the last); the batch copy precedes each step."""
    spans = _spans(_train(tiny, 3), tmp_path)
    steps = [s for s in spans if s[0] == "toist.train_step"]
    h2d = [s for s in spans if s[0] == "toist.h2d"]
    reads = [s for s in spans if s[0] == "toist.host_read"]
    assert len(steps) == len(h2d) == 3 and len(reads) == 2
    for copy, step in zip(h2d, steps):
        assert copy[2] <= step[1] and copy[3] == step[3]
    assert steps[0][2] <= reads[0][1] <= steps[1][1]
    assert steps[2][2] <= reads[1][1]
    for name in STEP_SPANS:
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == 3, name
        for s, step in zip(mine, steps):
            assert _inside(s, step), name
    assert not {s[0] for s in spans} - {"toist.train_step", "toist.h2d",
                                        "toist.host_read", *STEP_SPANS}


def _pair(seed, b=2):
    """``_batch`` as a distillation pair: the noun stream's boxes tied to
    tokens 3-4, the student's caption span on token 5."""
    noun = _batch(seed, b)
    noun["noun_token_spans"] = np.where(noun["box_valid"][..., None],
                                        np.int32([3, 4]), -1).astype(np.int32)
    noun["caption_noun_span"] = np.full((b, 2), -1, np.int32)
    noun["task_id"] = np.arange(1, b + 1, dtype=np.int32)
    sth = dict(noun, caption_noun_span=np.full((b, 2), 5, np.int32))
    return {"noun": noun, "sth": sth}


def test_distillation_step_spans_and_counters(tiny, tmp_path):
    """Two distillation steps: ``toist.softkd`` once in each, inside its
    step, beside the two ``toist.bank`` calls; the k-means counters among
    the step's scalars, 32 iterations issued per solve (a solve per image
    and stream) and at most as many that moved the centers."""
    cfg, sd = tiny
    cfg = pconfig.Config.from_sources(None, {
        "model": dataclasses.asdict(cfg.model),
        "loss": {"distillation": True, "softkd_loss": True,
                 "cluster": True, "cluster_memory_size": 16}})
    sd_t = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=2, d=32, dim_feedforward=64,
        text_layers=1, text_hidden=32, text_intermediate=64, num_queries=10,
        vocab_size=300, contrastive_hdim=16, with_masks=False, seed=4)
    model, teacher = (TOIST.from_state_dict(w, cfg.model, "cpu") for w in
                      (sd, {k: torch.from_numpy(v) for k, v in sd_t.items()}))
    bank = init_bank(14, 16, cfg.loss.cluster_num, 32,
                     torch.Generator().manual_seed(0))
    state = init_train_state(model, cfg, 10, 100, teacher=teacher,
                             cluster_bank=bank)
    step = make_distillation_train_step(cfg, build_weight_dict(cfg.loss,
                                                               False, 2))
    scalars = []

    def two_steps():
        s = state
        for seed in (20, 21):
            s, sc = step(s, _pair(seed))
            scalars.append(sc)

    spans = _spans(two_steps, tmp_path)
    steps = [s for s in spans if s[0] == "toist.train_step"]
    kd = [s for s in spans if s[0] == "toist.softkd"]
    assert len(steps) == len(kd) == 2
    assert all(_inside(k, top) for k, top in zip(kd, steps))
    assert len([s for s in spans if s[0] == "toist.bank"]) == 4
    for sc in scalars:
        assert sc["kmeans_iters"].dtype == torch.int32
        assert sc["kmeans_iters"].dim() == sc["kmeans_issued"].dim() == 0
        assert int(sc["kmeans_issued"]) == 32 * 2 * 2
        assert 2 * 2 <= int(sc["kmeans_iters"]) <= int(sc["kmeans_issued"])


def test_a_forward_that_raises_leaves_no_span_open(tiny, tmp_path,
                                                   monkeypatch):
    pred = _predictor(tiny)
    decoder = pred.model.transformer.decoder

    def broken(*args, **kwargs):
        raise RuntimeError("decoder failed")

    def fail_then_succeed():
        monkeypatch.setattr(decoder, "forward", broken)
        with pytest.raises(RuntimeError, match="decoder failed"):
            pred.predict_batch(_batch(1))
        monkeypatch.undo()
        pred.predict_batch(_batch(2))

    spans = _spans(fail_then_succeed, tmp_path)
    tops = [s for s in spans if s[0] == "toist.predict"]
    assert len(tops) == 2
    first = [s for s in spans if s[1] < tops[1][1]]
    assert [s[0] for s in first] == ["toist.predict", "toist.h2d",
                                     "toist.encode", "toist.decode"]
    # Every span of the failed call closed before the next call began,
    # and each of the next call's spans nests in its own top alone.
    assert all(s[2] <= tops[1][1] for s in first)
    for s in spans:
        if s[1] >= tops[1][1] and s is not tops[1]:
            assert _inside(s, tops[1])
            assert not any(_inside(s, f) for f in first)


def test_profile_line_names_the_spans(tiny, tmp_path, capsys):
    pred = _predictor(tiny)
    with profiling.trace(str(tmp_path / "prof")):
        pred.predict_batch(_batch(1))
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[profile] ")]
    assert len(line) == 1
    assert "host in spans: toist.predict " in line[0]
    assert "toist.encode" in line[0] and "toist.decode" in line[0]
