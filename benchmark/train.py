"""The training mode ``train``: the plain TOIST step (``make_train_step``)
under the training skeleton of ``training.py``.

Its program's set-up builds one training state from the seed's weights
(``init_train_state`` and ``load_masters``, as ``main`` does) and drives it
through its first ``check_steps`` steps by the window's own call and feed,
one ``train_one_epoch`` per stretch. It keeps what the check compares:
each step's loss, every trainable tensor's first gradient as AdamW got it
(its first moment after one step over 1 - beta1), and each tensor's
change and its EMA's change after the checked steps. Once the window has
closed, the reference repeats the checked steps from the same weights and
batches.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import counters, traffic, training, weights
from benchmark.reference import toist as ref
from benchmark.reference import train as reftrain
from benchmark.serve import model_sizes, program_config
from benchmark.training import Feed, free  # noqa: F401  (importable here)

FAMILY = training.FAMILY

TRAIN_KEYS = ("images", "image_mask", "text_ids", "text_mask", "boxes",
              "positive_map", "box_valid", "sample_valid")


def trainable(name: str, kind: str) -> bool:
    """The reference's rule: frozen-BatchNorm statistics are buffers; the
    ResNet's stem and layer1 are frozen, as in MDETR."""
    if kind.startswith("bn_"):
        return False
    body = "backbone.0.body."
    return not (name.startswith(body) and name[len(body):].startswith(
        ("conv1.", "bn1.", "layer1.")))


def group_of(name: str) -> str:
    if name.startswith("backbone."):
        return "backbone"
    if name.startswith("transformer.text_encoder."):
        return "text_encoder"
    return "model"


def lr_of(group: str, step: int, optim: dict, t: dict) -> float:
    """The learning rate of ``group`` at ``step`` under the configuration's
    "linear_with_warmup" schedule: the backbone and the rest at their
    rates (step decay every ``lr_drop`` epochs), the text encoder warmed
    up linearly over 1% of the run, then decayed linearly."""
    spe = t["steps_per_epoch"]
    total = spe * optim["epochs"]
    if group == "text_encoder":
        warm = max(1, round(optim["fraction_warmup_steps"] * total))
        g = (step / warm if step < warm
             else max(0.0, (total - step) / max(1, total - warm)))
        return optim["text_encoder_lr"] * g
    g = 0.1 ** ((step // spe) // optim["lr_drop"])
    return (optim["lr_backbone"] if group == "backbone" else optim["lr"]) * g


def dropout_seed(run_seed: int, step: int) -> int:
    """The program's documented dropout seed of a step's only microbatch on
    one process (``train/step.dropout_generator``)."""
    return ((run_seed * 1_000_003 + step) * 1_009) % 2 ** 63


def to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in TRAIN_KEYS}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float()
                                             for n in names])).cpu()
    return dict(zip(names, norms.tolist()))


def reference_steps(W, m: dict, config: dict, t: dict, batches: List[dict],
                    run_seed: int, device, prec: str = "f32") -> dict:
    """The reference's first len(batches) steps from the weights ``W``:
    each step's loss, the first step's clipped gradient norms, the change
    norms of the weights and of their EMA after the last."""
    spec = ref.param_spec(m)
    names = [k for k, _, kind in spec if trainable(k, kind)]
    P = {k: W[k].detach().clone().requires_grad_(k in names) for k in W}
    params = [P[k] for k in names]
    ema = [p.detach().clone() for p in params]
    opt = reftrain.AdamW(params, config["optim"]["weight_decay"])
    optim, loss_cfg = config["optim"], config["loss"]
    mcfg = config["model"]
    out = {"losses": []}
    with ref.f32_mode():
        for s, b in enumerate(batches):
            g = torch.Generator(device=device)
            g.manual_seed(dropout_seed(run_seed, s))
            model = ref.Reference(P, m, prec, ref.Dropout(
                g, mcfg["dropout"], mcfg["resizer_dropout"]))
            x = to_device(b, device)
            o = model.forward(x["images"], x["image_mask"],
                              x["text_ids"].long(), x["text_mask"])
            loss = reftrain.total_loss(o, x, loss_cfg)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            del o
            grads = [torch.zeros_like(p) if gr is None else gr
                     for p, gr in zip(params, grads)]
            reftrain.clip_(grads, optim["clip_max_norm"])
            if s == 0:
                out["grad"] = leaf_norms(dict(zip(names, grads)))
            opt.step(grads, [lr_of(group_of(n), s, optim, t) for n in names])
            with torch.no_grad():
                for e, p in zip(ema, params):
                    e.mul_(optim["ema_decay"]).add_(
                        p, alpha=1 - optim["ema_decay"])
            out["losses"].append(float(loss.detach()))
            del grads, loss
    with torch.no_grad():
        out["change"] = leaf_norms({n: p - W[n] for n, p in
                                    zip(names, params)})
        out["ema_change"] = leaf_norms({n: e - W[n] for n, e in
                                        zip(names, ema)})
    return out


def gaps(program: dict, reference: dict) -> Dict[str, float]:
    """The check's numbers: the widest relative loss gap over the checked
    steps; for the first gradient, the change and the EMA's change, the
    worst tensor's gap between the two sides' norms over the larger of
    its reference norm and the median tensor's. Tensors whose reference
    gradient is under a thousandth of the median tensor's move by
    round-off alone and are left out of all three."""
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in
                           zip(program["losses"], reference["losses"]))
           if len(program["losses"]) == len(reference["losses"])
           else float("inf")}
    med_g = float(np.median(list(reference["grad"].values())))
    keep = [n for n, v in reference["grad"].items() if v >= 1e-3 * med_g]
    for key in ("grad", "change", "ema_change"):
        med = float(np.median([reference[key][n] for n in keep]))
        worst = 0.0
        for n in keep:
            p = program[key].get(n, float("inf"))
            r = reference[key][n]
            worst = max(worst, abs(p - r) / max(r, med))
        out[f"{key}_gap"] = worst
    return out


def batch_flops(m: dict, b: dict) -> float:
    H, W = b["images"].shape[1:3]
    total = 0.0
    for im_mask, t_mask in zip(b["image_mask"], b["text_mask"]):
        keys = int((~im_mask[::32, ::32]).sum()) + int((~t_mask).sum())
        total += counters.train_flops(m, H, W, keys, t_mask.shape[0])
    return total


def checked_setup(cell, seed: int, device="cuda", step_hook=None) -> dict:
    """Build the training state from the seed and drive it through its
    checked steps by the window's call and feed; returns the state, the
    step, the pool and what the program read."""
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train.criterion import build_weight_dict
    from toist_tpu_torch.train.engine import train_one_epoch
    from toist_tpu_torch.train.state import (init_train_state, load_masters,
                                             model_masters)
    from toist_tpu_torch.train.step import make_train_step

    t, config = cell.traffic, cell.config
    m = model_sizes(config)
    cfg = program_config(config, seed)
    W = weights.make_weights(ref.param_spec(m), seed, device)
    model = TOIST.from_state_dict(W, cfg.model, device)
    spe = t["steps_per_epoch"]
    state = init_train_state(model, cfg, spe, spe * cfg.optim.epochs)
    load_masters(state, W)
    step = make_train_step(cfg, build_weight_dict(
        cfg.loss, cfg.model.masks, cfg.model.dec_layers))
    if step_hook is not None:
        step = step_hook(step)
    losses: List[torch.Tensor] = []
    n_check = t["check_steps"]

    def train_step(state, batch):
        state, scalars = step(state, batch)
        if len(losses) < n_check:
            losses.append(scalars["loss"])
        return state, scalars

    pool = traffic.train_pool(t, m["vocab_size"],
                              config["data"]["max_text_len"],
                              config["data"]["max_boxes"],
                              config["data"]["num_logit_cols"], seed)
    pf = t["print_freq"]
    state, _ = train_one_epoch(train_step, state, Feed(pool, 0, 1), 0,
                               print_freq=pf)
    named = model_masters(state)
    program = {"grad": leaf_norms(
        {n: state.optimizer.state[mm]["exp_avg"] / 0.1 for n, _, mm in
         named})}
    state, _ = train_one_epoch(train_step, state,
                               Feed(pool, 1, n_check - 1), 0, print_freq=pf)
    with torch.no_grad():
        program["change"] = leaf_norms({n: mm - W[n] for n, _, mm in named})
        program["ema_change"] = leaf_norms({n: state.ema[n] - W[n]
                                            for n, _, _ in named})
    program["losses"] = [float(x) for x in losses]
    return {"state": state, "train_step": train_step, "pool": pool,
            "program": program, "W": W, "m": m}




def numbers(cell, s: dict, seed: int, device) -> Dict[str, float]:
    """The check's numbers: the reference's checked steps from the seed's
    weights over the pool's first entries, against the program's."""
    reference = reference_steps(s["W"], s["m"], cell.config, cell.traffic,
                                s["pool"][:cell.traffic["check_steps"]],
                                seed, device)
    return gaps(s["program"], reference)


PROGRAM = training.Program(setup=checked_setup, flops=batch_flops,
                           canvas=lambda b: b["images"].shape,
                           numbers=numbers)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", step_hook=None) -> dict:
    """One run of a training cell; returns the harness's record.
    ``step_hook(step) -> step`` lets a test break the timed path."""
    return training.drive(PROGRAM, cell, seed, seconds, trace, t_start,
                          device, step_hook)
