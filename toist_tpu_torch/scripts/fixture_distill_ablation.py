"""Fixture-scale distillation ablation: the student's AP@0.5 with and
without noun-pronoun distillation, through ``toist_tpu_torch.main``.

Counterpart of ``scripts/fixture_distill_ablation.py``, with its config.
The reference claims that distillation adds +2.8 mAP to the pronoun student
(reference README.md:11). At fixture scale the absolute APs mean little,
but the ordering is checkable: a teacher trained on privileged noun
captions, which name the true category, hands the student soft per-query
targets through softkd, and with them the student reaches a higher AP@0.5
than the same student trained plain for as many epochs.

The val split is a mirror of the train split (the same images and
annotations): a 3-layer 64-wide model on 8 synthetic images generalises by
noise, while its progress on what it trains on is signal. Both students
share the init (``run.seed`` 1), the epochs and the deterministic config
(dropout 0). The trainings run f32 (``main.f32_policy``: no TF32) under
``torch.use_deterministic_algorithms``, as the JAX package's runs are
deterministic by construction: on the card, cuDNN's f32 weight-gradient
algorithms otherwise differ between processes, and so did the APs. The
result carries a digest of each training's checkpoint, so that two
processes can be held to bit-equal trainings. Three trainings:

1. the verb-noun teacher (``data.verb_noun_input``);
2. the plain pronoun student;
3. the distilled pronoun student, its teacher through ``run.load_noun``.

Run:  python -m toist_tpu_torch.scripts.fixture_distill_ablation \\
          [--epochs 6] [--device cuda|cpu] [--fixture-seed 11]
          [--workdir D] [--out f.json]
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import tempfile

EPOCHS = 6
FIXTURE_SEED = 11


def mirror_val_to_train(root: str, tasks) -> None:
    """Make the test split identical to the train split (file names are
    split-agnostic ``fix_{id}.jpg``, so a copy suffices)."""
    for t in tasks:
        src = os.path.join(root, "annotations", f"task_{t}_train.json")
        dst = os.path.join(root, "annotations", f"task_{t}_test.json")
        shutil.copyfile(src, dst)
        with open(src) as f:
            ann = json.load(f)
        for im in ann["images"]:
            shutil.copyfile(os.path.join(root, "train2014", im["file_name"]),
                            os.path.join(root, "val2014", im["file_name"]))


def base_config(root: str, out_dir: str, seed: int, epochs: int = EPOCHS,
                **extra):
    from toist_tpu_torch.config import Config

    over = {
        "model": {"backbone": "resnet18-test", "hidden_dim": 64, "nheads": 4,
                  "dim_feedforward": 128, "enc_layers": 1, "dec_layers": 2,
                  "num_queries": 10, "compute_dtype": "float32",
                  "dropout": 0.0, "resizer_dropout": 0.0,
                  "contrastive_align_loss": False,
                  "backbone_norm": "group_norm", "text_hidden": 64,
                  "text_layers": 1, "text_heads": 4,
                  "text_intermediate": 128},
        "data": {"coco_path": root, "refexp_ann_path": root + "/annotations",
                 "tasks": [1, 2], "image_buckets": [[128, 128]],
                 "max_text_len": 48, "max_boxes": 8, "train_scales": [96],
                 "max_size": 128, "val_size": 96},
        "optim": {"train_batch_size": 2, "valid_batch_size": 2,
                  "epochs": epochs, "lr": 1e-3, "lr_backbone": 1e-3,
                  "text_encoder_lr": 1e-3, "ema": False,
                  "eval_skip": max(1, epochs - 1)},
        "run": {"output_dir": out_dir, "seed": seed, "mesh_shape": [1]},
    }
    for sec, kv in extra.items():
        over.setdefault(sec, {}).update(kv)
    return Config.from_sources(None, over)


def last_eval_ap(out_dir: str) -> float:
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return float([r for r in recs if r.get("kind") == "eval"][-1]
                 ["mean_ap50"])


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for the block (an op with no
    deterministic form raises), with the fixed cuBLAS workspace it needs."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def checkpoint_digest(path: str) -> str:
    """blake2b of every tensor of a checkpoint (weights, EMA, moments, the
    bank), in key order; the config it carries is left out, since it names
    the output directory."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=True)
    h = hashlib.blake2b(digest_size=16)

    def walk(key, x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                if k != "args":
                    walk(f"{key}/{k}", x[k])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{key}/{i}", v)
        elif isinstance(x, torch.Tensor):
            t = x.detach().contiguous()
            if t.dtype in (torch.bfloat16, torch.bool):
                t = t.view(torch.int16 if t.dtype == torch.bfloat16
                           else torch.uint8)
            h.update(key.encode())
            h.update(t.numpy().tobytes())
        else:
            h.update(f"{key}={x!r}".encode())

    walk("", payload)
    return h.hexdigest()


def run(workdir: str, epochs: int = EPOCHS, device: str = "cuda",
        fixture_seed: int = FIXTURE_SEED) -> dict:
    from toist_tpu_torch.data.fixtures import generate_fixture
    from toist_tpu_torch.main import main

    root = generate_fixture(os.path.join(workdir, "data"), num_tasks=2,
                            imgs_per_split=4, img_size=(96, 128),
                            seed=fixture_seed)
    mirror_val_to_train(root, (1, 2))

    tdir, pdir, ddir = (os.path.join(workdir, d)
                        for d in ("teacher", "plain", "distill"))
    with deterministic():
        # 1. Teacher on privileged noun captions
        #    (scripts/train_dete_noun.sh).
        main(base_config(root, tdir, seed=0, epochs=epochs,
                         data={"verb_noun_input": True}), device=device)
        # 2. Plain pronoun student (scripts/train_dete.sh).
        main(base_config(root, pdir, seed=1, epochs=epochs), device=device)
        # 3. Distilled pronoun student: the same init and epochs, the
        #    teacher from step 1 (scripts/train_dete_dis.sh).
        main(base_config(
            root, ddir, seed=1, epochs=epochs,
            run={"load_noun": os.path.join(tdir, "checkpoint")},
            loss={"distillation": True, "softkd_loss": True,
                  "softkd_coef": 50.0, "nsthl2_loss": True,
                  "nsthl2_coef": 1.0, "cluster": True,
                  "cluster_memory_size": 16, "cluster_num": 2,
                  "kmeans_max_iters": 8}), device=device)
    teacher, plain, distill = (last_eval_ap(d) for d in (tdir, pdir, ddir))
    return {"teacher_ap50": teacher, "plain_student_ap50": plain,
            "distill_student_ap50": distill,
            "distill_minus_plain": distill - plain, "epochs": epochs,
            "device": device, "fixture_seed": fixture_seed,
            "digests": {k: checkpoint_digest(os.path.join(d, "checkpoint"))
                        for k, d in (("teacher", tdir), ("plain", pdir),
                                     ("distill", ddir))}}


def main_cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="")
    p.add_argument("--workdir", default="")
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--device", default="cuda",
                   help="torch device of the three trainings (cpu: no card)")
    p.add_argument("--fixture-seed", type=int, default=FIXTURE_SEED)
    args = p.parse_args(argv)
    wd = args.workdir or tempfile.mkdtemp(prefix="toist_distill_abl_")
    res = run(wd, epochs=args.epochs, device=args.device,
              fixture_seed=args.fixture_seed)
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main_cli()
