"""Parameter groups, per-group LR schedules, AdamW and EMA.

Counterpart of ``toist_tpu/train/optim.py`` (reference main.py:351-392 and
util/optim.py): three trainable groups (backbone at lr_backbone, text encoder
at text_encoder_lr, the rest at lr), frozen parameters (the ResNet stem and
layer1; everything but the mask branch under ``frozen_detector``; the text
encoder under ``freeze_text_encoder``) taking no gradient and no update, the
schedules as functions of the global step, EMA decay 0.9998.

optax's ``adamw`` and ``torch.optim.AdamW`` compute the same update: eps is
added to sqrt(v_hat) after bias correction in both (optax's eps_root is 0),
and both decay decoupled from the gradient, p <- p - lr * wd * p, with the
step's lr. optax evaluates a schedule at the count of updates done before
(0 for the first), which is the step the train step passes here.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from toist_tpu_torch.config import OptimConfig

GROUPS = ("model", "backbone", "text_encoder")


def label_params(model: torch.nn.Module, frozen_detector: bool = False,
                 freeze_text_encoder: bool = False) -> Dict[str, str]:
    """Parameter name -> "frozen" | "backbone" | "text_encoder" | "model"
    (``label_params``, reference backbone.py:68-73: the stem and layer1 of
    the ResNet are frozen)."""
    labels = {}
    for name, _ in model.named_parameters():
        if frozen_detector:
            label = ("model" if name.startswith(("bbox_attention.",
                                                 "mask_head."))
                     else "frozen")
        elif name.startswith("backbone.0.body."):
            body = name[len("backbone.0.body."):]
            label = ("frozen" if body.startswith(("conv1.", "bn1.",
                                                  "layer1."))
                     else "backbone")
        elif name.startswith("transformer.text_encoder."):
            label = "frozen" if freeze_text_encoder else "text_encoder"
        else:
            label = "model"
        labels[name] = label
    return labels


def freeze_parameters(model: torch.nn.Module, labels: Dict[str, str]
                      ) -> None:
    """``requires_grad_(False)`` on the frozen-labelled parameters, as the
    reference freezes them: autograd computes no backward for them and
    ``clip_grad_norm_`` never sees them (``stop_frozen_gradients``)."""
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")


def make_schedules(cfg: OptimConfig, steps_per_epoch: int,
                   total_steps: int) -> Dict[str, Callable[[int], float]]:
    """Per-group step -> lr (util/optim.py:57-90 semantics)."""
    warmup = max(1, round(cfg.fraction_warmup_steps * total_steps))

    def step_gamma(step):
        epoch = step // max(steps_per_epoch, 1)
        return 0.1 ** (epoch // cfg.lr_drop)

    def multistep_gamma(step):
        epoch = step // max(steps_per_epoch, 1)
        return 0.5 ** len(range(cfg.lr_drop, min(epoch + 1, cfg.epochs), 50))

    def linear_warmup_gamma(step):
        if step < warmup:
            return step / warmup
        return max(0.0, (total_steps - step) / max(1, total_steps - warmup))

    model_g, text_g = {
        "step": (step_gamma, step_gamma),
        "multistep": (multistep_gamma, multistep_gamma),
        "linear_with_warmup": (step_gamma, linear_warmup_gamma),
        "all_linear_with_warmup": (linear_warmup_gamma, linear_warmup_gamma),
    }[cfg.schedule]
    return {
        "model": lambda s: cfg.lr * model_g(s),
        "backbone": lambda s: cfg.lr_backbone * model_g(s),
        "text_encoder": lambda s: cfg.text_encoder_lr * text_g(s),
    }


def make_optimizer(params: Dict[str, List[torch.Tensor]], cfg: OptimConfig
                   ) -> torch.optim.AdamW:
    """AdamW over the trainable groups {group name: tensors}; each param
    group carries its name, and the train step sets its lr every step. In
    distillation each group holds the student's tensors, then the
    teacher's (``train/state.init_train_state``): one AdamW over both
    models, in a fixed order, since ``checkpoint.restore`` loads the
    moments by index."""
    if cfg.moment_dtype != "float32":
        raise NotImplementedError(
            f"optim.moment_dtype={cfg.moment_dtype!r}: torch.optim.AdamW "
            "keeps its moments in the parameters' dtype (f32 master "
            "weights); bf16 moments are not ported")
    groups = [{"params": params[g], "name": g, "lr": 0.0}
              for g in GROUPS if params.get(g)]
    return torch.optim.AdamW(groups, lr=0.0, weight_decay=cfg.weight_decay)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float) -> None:
    """In place: w_ema = w_ema * decay + (1 - decay) * w (util/optim.py)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)
