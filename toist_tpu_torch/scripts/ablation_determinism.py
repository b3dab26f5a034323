"""Per-step digests of the fixture ablation's three trainings, to find what
varies between two processes on the card.

Runs ``fixture_distill_ablation.run`` once under one numerics setting and
writes, for the teacher, the plain and the distilled student, a blake2b
digest of every f32 master and of the cluster bank's tensors after every
step, and the APs. Two processes of one setting whose digests differ met a
nondeterministic op; the first step and tensor that differ say where.

- ``defaults``: PyTorch's own numerics, as the ablation ran before it was
  made reproducible (TF32 convolutions, f32 products, no deterministic
  algorithms);
- ``no_tf32``: TF32 off, no deterministic algorithms;
- ``repaired``: the ablation as it runs (``main.f32_policy`` and
  ``fixture_distill_ablation.deterministic``).

Run:  python -m toist_tpu_torch.scripts.ablation_determinism \\
          --setting defaults|no_tf32|repaired --out f.json [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import tempfile

SETTINGS = ("defaults", "no_tf32", "repaired")


def _digest(t) -> str:
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype in (torch.bfloat16, torch.bool):
        t = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.uint8)
    return hashlib.blake2b(t.numpy().tobytes(), digest_size=8).hexdigest()


def _state_digests(state) -> dict:
    names = {}
    for prefix, model in (("student.", state.model),
                          ("teacher.", state.teacher)):
        if model is not None:
            names.update({id(p): prefix + n
                          for n, p in model.named_parameters()})
    out = {names[id(p)]: _digest(m) for p, m in state.masters}
    if state.cluster_bank is not None:
        for f in dataclasses.fields(state.cluster_bank):
            out[f"bank.{f.name}"] = _digest(getattr(state.cluster_bank,
                                                    f.name))
    return out


def probe(setting: str, device: str = "cuda") -> dict:
    """The ablation under ``setting``: its result and, per training, the
    digests after every step."""
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.scripts import fixture_distill_ablation as abl
    from toist_tpu_torch.train import engine

    trainings = []
    train_one_epoch = engine.train_one_epoch

    def recording(step, state, batches, epoch, **kwargs):
        if epoch == 0:
            trainings.append([])

        def digested(st, batch):
            st, scalars = step(st, batch)
            trainings[-1].append(_state_digests(st))
            return st, scalars
        return train_one_epoch(digested, state, batches, epoch, **kwargs)

    patches = [(engine, "train_one_epoch", recording)]
    if setting != "repaired":
        patches += [(abl, "deterministic", contextlib.nullcontext),
                    (pmain, "f32_policy",
                     lambda dtype: contextlib.nullcontext())]
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    was = [getattr(m, n) for m, n, _ in patches] + [f.allow_tf32
                                                     for f in flags]
    for m, n, v in patches:
        setattr(m, n, v)
    if setting == "no_tf32":
        for f in flags:
            f.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory() as wd:
            res = abl.run(wd, device=device)
    finally:
        for (m, n, _), v in zip(patches, was):
            setattr(m, n, v)
        for f, v in zip(flags, was[len(patches):]):
            f.allow_tf32 = v
    return dict(res, setting=setting,
                step_digests=dict(zip(("teacher", "plain", "distill"),
                                      trainings)))


def first_difference(a: dict, b: dict) -> dict:
    """Per training, the first step at which two probes' digests differ
    and the tensors that differ there (None: equal throughout)."""
    out = {}
    for name, steps in a["step_digests"].items():
        out[name] = None
        for i, (x, y) in enumerate(zip(steps, b["step_digests"][name])):
            diff = sorted(k for k in x if x[k] != y.get(k))
            if diff:
                out[name] = {"step": i, "tensors": diff}
                break
    return out


def main_cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--setting", choices=SETTINGS, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    res = probe(args.setting, args.device)
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(json.dumps({k: v for k, v in res.items() if k != "step_digests"}),
          flush=True)
    return res


if __name__ == "__main__":
    main_cli()
