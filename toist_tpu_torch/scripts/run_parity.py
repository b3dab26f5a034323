"""Turnkey absolute-parity runner of the port: PARITY.md steps 1-5 in one
command (counterpart of ``scripts/run_parity.py``).

The reference's oracle is eval against its published checkpoints
(reference README.md:84-95,254-400, main.py:546-591). They and the
COCO-Tasks data are not in the repository, so the real run waits for the
user to put them there; everything after that is this script:

  1. verify the COCO-Tasks data layout (the paths configs/tdod.json uses);
  2. audit each published ``.pth`` against the model its config builds
     (keys and shapes of ``TOIST(cfg).state_dict()``). The port loads the
     reference ``.pth`` directly (``--load`` / ``run.load_noun``), so there
     is no conversion step;
  3. run the five BASELINE.json configs through ``toist_tpu_torch.main``;
  4. collect the per-task AP@0.5 from each run's log.jsonl;
  5. print a per-task AP diff table against --golden (the reference's own
     numbers on the same data).

Real run:
  python -m toist_tpu_torch.scripts.run_parity \\
      --coco-path data/images --ann-path data/coco-tasks/annotations \\
      --dete-ckpt toist_dete.pth [--seg-ckpt toist_seg.pth] \\
      [--noun-ckpt noun.pth] [--student-ckpt s.pth --teacher-ckpt t.pth] \\
      [--golden goldens.json] [--configs dete_task1 dete_all14 seg noun
      distill] [--device cuda|cpu] --out logs/parity

Fixture dry run (synthetic data and synthetic checkpoints in the
reference's state_dict layout, at the widths of the run's config):
  python -m toist_tpu_torch.scripts.run_parity --fixture --out /tmp/parity \\
      [--device cpu] [--extra-set model.hidden_dim=256 ...]

The eval configs load the checkpoint through ``--load`` with
``optim.ema=false``: ``load_params`` already prefers the checkpoint's EMA
weights (the reference evaluates model_ema, main.py:546-562).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

AP_TOLERANCE = 0.2  # BASELINE.md quality bar: |mAP@0.5 - reference| <= 0.2


# -- step 1: data layout ------------------------------------------------------

def verify_layout(coco_path: str, ann_path: str, tasks) -> list:
    """PARITY.md step 1: the exact layout configs/tdod.json points to."""
    missing = []
    for sub in ("train2014", "val2014"):
        if not os.path.isdir(os.path.join(coco_path, sub)):
            missing.append(f"{coco_path}/{sub}/ (images)")
    if not os.path.isfile(os.path.join(ann_path, "id2name.json")):
        missing.append(f"{ann_path}/id2name.json")
    for t in tasks:
        for split in ("train", "test"):
            f = os.path.join(ann_path, f"task_{t}_{split}.json")
            if not os.path.isfile(f):
                missing.append(f)
    for f in ("vocab.json", "merges.txt"):
        if not os.path.isfile(os.path.join(ann_path, f)):
            print(f"note: {ann_path}/{f} absent — tokenizer falls back to a "
                  "BPE trained on the dataset captions (PARITY.md step 2: "
                  "drop the roberta-base files there for HF-identical ids)")
    return missing


# -- step 2: structural audit -------------------------------------------------

def convert_checkpoint(pth: str, cfg) -> str:
    """Audit a reference ``.pth`` against ``TOIST(cfg)``'s state dict and
    return the path for ``--load`` / ``run.load_noun``. Checkpoint keys the
    model lacks and shape mismatches are config or architecture errors and
    stop the run; model keys the checkpoint lacks keep their fresh init
    (a new head, e.g. a detection checkpoint under a seg model) and are
    listed."""
    import torch

    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train.checkpoint import load_params

    got = {k: tuple(v.shape) for k, v in load_params(pth).items()}
    with torch.device("meta"):
        model = TOIST(cfg.model,
                      text_vocab_size=build_tokenizer(cfg).vocab_size)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    extra = sorted(set(got) - set(want))
    if extra:
        raise SystemExit(
            f"checkpoint audit: {len(extra)} checkpoint keys have no home in "
            f"the model (config/architecture mismatch), e.g. {extra[:5]}")
    mismatched = {k: (got[k], want[k]) for k in sorted(got)
                  if got[k] != want[k]}
    if mismatched:
        raise SystemExit("checkpoint audit: shape mismatches "
                         f"{dict(list(mismatched.items())[:5])}")
    fresh = sorted(set(want) - set(got))
    if fresh:
        print(f"checkpoint audit: {len(fresh)} model keys keep fresh init "
              f"(expected for new heads), e.g. {fresh[:3]}")
    print(f"checkpoint audit: {pth} ok")
    return pth


# -- steps 3 and 4: the BASELINE configs, per-task AP@0.5 --------------------

def workload_command(argv: list, out_dir: str, device: str) -> list:
    """The command line of one workload."""
    return [sys.executable, "-m", "toist_tpu_torch.main", *argv,
            "--output-dir", out_dir, "--device", device]


def run_workload(name: str, argv: list, out_dir: str,
                 device: str = "cuda") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    cmd = workload_command(argv, out_dir, device)
    print(f"[{name}] {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "stdout.log"), "w") as log:
        p = subprocess.run(cmd, cwd=REPO, stdout=log,
                           stderr=subprocess.STDOUT, env=dict(os.environ))
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        with open(os.path.join(out_dir, "stdout.log")) as f:
            tail = f.readlines()[-30:]
        raise SystemExit(f"[{name}] failed (exit {p.returncode}):\n"
                         + "".join(tail))
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if r.get("kind") == "eval"]
    if not evals:
        raise SystemExit(f"[{name}] produced no eval record in log.jsonl")
    last = evals[-1]
    result = {"mean_ap50": last["mean_ap50"],
              "per_task_ap50": {t: s["bbox"][1]
                                for t, s in last["per_task"].items()},
              "seconds": seconds}
    segm = {t: s["segm"][1] for t, s in last["per_task"].items()
            if "segm" in s}
    if segm:
        result["per_task_ap50_segm"] = segm
    return result


def _sets(d: dict) -> list:
    return [f"{k}={json.dumps(v) if not isinstance(v, str) else v}"
            for k, v in d.items()]


def build_workloads(args, ckpt: dict, base_cfg: list, common: dict) -> list:
    """The five BASELINE.json configs as ``toist_tpu_torch.main`` argvs,
    the JAX package's own (``scripts/run_parity.py:176``).

    ckpt: checkpoint paths keyed dete/seg/noun/student/teacher.
    base_cfg: leading argv (e.g. --config configs/tdod.json).
    common: shared --set overrides (data paths; fixture-scale model dims).
    """
    eval_common = dict(common)
    eval_common["optim.ema"] = False  # load_params already returned EMA
    w = []
    # 1: single-task detection eval, batch 8, no contrastive align
    #    (reference scripts/eval_dete.sh + BASELINE config 1).
    w.append(("dete_task1", base_cfg + ["--eval", "--load", ckpt["dete"],
              "--set"] + _sets({**eval_common, "data.tasks": [1],
                                "optim.valid_batch_size": args.eval_batch,
                                "model.contrastive_align_loss": False})))
    # 2: all-14-task detection eval, contrastive align on, EMA weights.
    w.append(("dete_all14", base_cfg + ["--eval", "--load", ckpt["dete"],
              "--set"] + _sets({**eval_common,
                                "optim.valid_batch_size": args.eval_batch})))
    # 3: instance segmentation eval (mask mAP), batch 4.
    if ckpt.get("seg"):
        w.append(("seg", base_cfg + ["--eval", "--load", ckpt["seg"],
                  "--set"] + _sets({**eval_common,
                                    "optim.valid_batch_size":
                                        max(1, args.eval_batch // 2),
                                    "model.mask_model": "smallconv",
                                    "model.contrastive_align_loss": False})))
    # 4: verb-noun teacher eval (privileged text path).
    w.append(("noun", base_cfg + ["--eval", "--load",
              ckpt.get("noun") or ckpt["dete"],
              "--set"] + _sets({**eval_common, "data.verb_noun_input": True,
                                "model.contrastive_align_loss": False})))
    # 5: noun-pronoun distillation training
    #    (reference scripts/train_dete_dis.sh; student+teacher warm starts).
    dis = {**common,
           "run.load_noun": ckpt.get("teacher") or ckpt["dete"],
           "optim.train_batch_size": args.dis_batch,
           "optim.valid_batch_size": args.eval_batch,
           "loss.distillation": True, "loss.softkd_loss": True,
           "loss.softkd_coef": 50, "loss.cluster": True,
           "loss.cluster_memory_size": args.cluster_memory,
           "loss.cluster_num": args.cluster_num,
           "loss.cluster_feature_loss": 1e4,
           "optim.eval_skip": 1}
    if args.dis_epochs:
        dis["optim.epochs"] = args.dis_epochs
    w.append(("distill", base_cfg
              + ["--load", ckpt.get("student") or ckpt["dete"], "--set"]
              + _sets(dis)))
    return [x for x in w if x[0] in args.configs]


# -- step 5: diff table -------------------------------------------------------

def diff_report(results: dict, golden: dict) -> dict:
    rows, worst = [], 0.0
    for name, res in results.items():
        g = golden.get(name)
        if not g:
            continue
        for t, ours in sorted(res["per_task_ap50"].items()):
            ref = g.get("per_task_ap50", {}).get(str(t))
            if ref is None:
                continue
            d = ours - ref
            worst = max(worst, abs(d))
            rows.append((name, t, ours, ref, d))
        if "mean_ap50" in g:
            d = res["mean_ap50"] - g["mean_ap50"]
            worst = max(worst, abs(d))
            rows.append((name, "mean", res["mean_ap50"], g["mean_ap50"], d))
    if rows:
        print(f"\n{'config':<12}{'task':<6}{'ours':>8}{'golden':>8}"
              f"{'delta':>9}  ok(<= {AP_TOLERANCE})")
        for name, t, ours, ref, d in rows:
            ok = "PASS" if abs(d) <= AP_TOLERANCE else "FAIL"
            print(f"{name:<12}{str(t):<6}{ours:>8.4f}{ref:>8.4f}"
                  f"{d:>+9.4f}  {ok}")
    return {"rows": [dict(zip(("config", "task", "ours", "golden", "delta"),
                              r)) for r in rows],
            "max_abs_delta": worst,
            "pass": bool(rows) and worst <= AP_TOLERANCE}


# -- the fixture dry run ------------------------------------------------------

FIXTURE_MODEL = {
    "model.backbone": "resnet18-test", "model.backbone_norm": "frozen_bn",
    "model.hidden_dim": 128, "model.nheads": 8, "model.dim_feedforward": 256,
    "model.enc_layers": 1, "model.dec_layers": 2, "model.num_queries": 12,
    "model.compute_dtype": "float32", "model.text_hidden": 24,
    "model.text_layers": 1, "model.text_heads": 4,
    "model.text_intermediate": 96,
}
FIXTURE_DATA = {
    "data.image_buckets": [[128, 128]], "data.max_text_len": 48,
    "data.max_boxes": 8, "data.train_scales": [96], "data.max_size": 128,
    "data.val_size": 96, "data.tasks": [1, 2],
}
_STAGE_SIZES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                "resnet18-test": (1, 1, 1, 1)}


def make_fixture(out: str, extra: dict = None):
    """Synthetic dataset and synthetic torch checkpoints in the reference's
    state_dict layout (``utils/convert.synth_reference_state_dict``), at the
    widths of the fixture model with ``extra``'s overrides."""
    import torch

    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.fixtures import generate_fixture
    from toist_tpu_torch.utils.convert import synth_reference_state_dict

    root = generate_fixture(os.path.join(out, "data"), num_tasks=2,
                            imgs_per_split=3, img_size=(96, 128), seed=7)
    common = {**FIXTURE_MODEL, **FIXTURE_DATA,
              "data.coco_path": root,
              "data.refexp_ann_path": root + "/annotations",
              "optim.epochs": 1, "optim.eval_skip": 1, "run.seed": 0,
              "loss.kmeans_max_iters": 8, **(extra or {})}
    cfg = _cfg_from_sets(common)
    m = cfg.model
    kw = dict(stage_sizes=_STAGE_SIZES[m.backbone], enc=m.enc_layers,
              dec=m.dec_layers, d=m.hidden_dim,
              dim_feedforward=m.dim_feedforward, text_layers=m.text_layers,
              text_hidden=m.text_hidden,
              text_intermediate=m.text_intermediate,
              num_queries=m.num_queries,
              vocab_size=build_tokenizer(cfg).vocab_size)
    paths = {}
    for name, extra_kw in (("dete", dict(with_masks=False, contrastive=True,
                                         seed=0)),
                           ("seg", dict(with_masks=True, contrastive=False,
                                        seed=1))):
        sd = synth_reference_state_dict(**kw, **extra_kw)
        p = os.path.join(out, f"synth_{name}.pth")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                    "model_ema": None}, p)
        paths[name] = p
    return common, paths


def _cfg_from_sets(sets: dict, config_file=None):
    from toist_tpu_torch.config import Config
    overrides = {}
    for k, v in sets.items():
        sec, name = k.split(".", 1)
        overrides.setdefault(sec, {})[name] = v
    return Config.from_sources(config_file, overrides)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fixture", action="store_true",
                   help="hermetic dry-run on synthetic data + checkpoints")
    p.add_argument("--out", default="logs/parity")
    p.add_argument("--coco-path", default="data/images")
    p.add_argument("--ann-path", default="data/coco-tasks/annotations")
    p.add_argument("--dete-ckpt", default="")
    p.add_argument("--seg-ckpt", default="")
    p.add_argument("--noun-ckpt", default="")
    p.add_argument("--student-ckpt", default="")
    p.add_argument("--teacher-ckpt", default="")
    p.add_argument("--golden", default="", help="reference AP json: "
                   '{"dete_task1": {"mean_ap50": x, "per_task_ap50": '
                   '{"1": y}}, ...}')
    p.add_argument("--configs", nargs="*", default=[
        "dete_task1", "dete_all14", "seg", "noun", "distill"])
    p.add_argument("--eval-batch", type=int, default=8)
    p.add_argument("--dis-batch", type=int, default=3)
    p.add_argument("--dis-epochs", type=int, default=0,
                   help="override distillation epochs (0 = config value)")
    p.add_argument("--cluster-memory", type=int, default=1024)
    p.add_argument("--cluster-num", type=int, default=3)
    p.add_argument("--extra-set", nargs="*", default=[],
                   help="extra k=v overrides appended to every workload")
    p.add_argument("--device", default="cuda",
                   help="torch device of every workload (cpu: no card)")
    return p


def main(argv=None) -> dict:
    p = _parser()
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    extra = {}
    for kv in args.extra_set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        extra[k] = v

    if args.fixture:
        common, pths = make_fixture(args.out, extra)
        args.eval_batch, args.dis_batch = 2, 2
        args.dis_epochs = args.dis_epochs or 1
        args.cluster_memory, args.cluster_num = 16, 2
        base_cfg = []
        pth = {"dete": pths["dete"], "seg": pths["seg"], "noun": "",
               "student": "", "teacher": ""}
    else:
        common = {"data.coco_path": args.coco_path,
                  "data.refexp_ann_path": args.ann_path, **extra}
        base_cfg = ["--config", os.path.join(REPO, "configs", "tdod.json")]
        pth = {"dete": args.dete_ckpt, "seg": args.seg_ckpt,
               "noun": args.noun_ckpt, "student": args.student_ckpt,
               "teacher": args.teacher_ckpt}
        if not pth["dete"]:
            p.error("--dete-ckpt is required (or use --fixture)")
    config_file = None if args.fixture else base_cfg[1]

    # Step 1: layout.
    cfg0 = _cfg_from_sets(common, config_file)
    missing = verify_layout(cfg0.data.coco_path, cfg0.data.refexp_ann_path,
                            cfg0.data.tasks)
    if missing:
        raise SystemExit("data layout incomplete (PARITY.md step 1):\n  "
                         + "\n  ".join(missing))
    print("data layout: ok")

    # Step 2: audits (seg gets the masks model; others the plain one).
    ckpt = {}
    for name, path in pth.items():
        if not path:
            continue
        sets = dict(common)
        if name == "seg":
            sets["model.mask_model"] = "smallconv"
        if args.fixture:
            sets["model.contrastive_align_loss"] = name != "seg"
        ckpt[name] = convert_checkpoint(path, _cfg_from_sets(sets,
                                                             config_file))

    # Steps 3 and 4: the five workloads.
    results = {}
    for name, argv in build_workloads(args, ckpt, base_cfg, common):
        results[name] = run_workload(name, argv,
                                     os.path.join(args.out, name),
                                     args.device)
        print(f"[{name}] mean AP@0.5 = {results[name]['mean_ap50']:.4f} "
              f"per-task {results[name]['per_task_ap50']} in "
              f"{results[name]['seconds']:.1f} s", flush=True)

    # Step 5: diff.
    report = {"results": results}
    if args.golden:
        with open(args.golden) as f:
            report["diff"] = diff_report(results, json.load(f))
    with open(os.path.join(args.out, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"report: {os.path.join(args.out, 'parity_report.json')}")
    return report


if __name__ == "__main__":
    main()
