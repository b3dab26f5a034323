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
(0 for the first), which is the step the train step passes here. The
port's ``AdamW`` runs ``torch.optim.AdamW``'s update, with its state names,
and adds ``optim.moment_dtype="bfloat16"``: the first moment is kept in
bf16 and the second in f32, as optax's ``mu_dtype`` keeps them
(``toist_tpu/train/optim.py:124-129``).
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


class AdamW(torch.optim.Optimizer):
    """AdamW with decoupled weight decay, ``torch.optim.AdamW``'s update in
    ``torch._foreach_*`` ops, state ``step`` / ``exp_avg`` /
    ``exp_avg_sq`` as that optimizer names and keeps them (so its
    ``state_dict`` is the reference's ``optimizer``), and the ZeRO-1
    wrapper can take it.

    ``moment_dtype`` "bfloat16" keeps ``exp_avg`` in bf16, as optax's
    ``scale_by_adam(mu_dtype=bf16)``: the step's first moment is
    (1 - b1) * g + b1 * m with b1 and the product b1 * m in bf16, and the
    update uses that f32 moment before it is stored in bf16. ``exp_avg_sq``
    stays f32."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2,
                 moment_dtype: str = "float32"):
        if moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"moment_dtype {moment_dtype!r}")
        # Not a group option: a checkpoint's groups replace the optimizer's
        # on load, and the run's config decides the dtype.
        self.moment_dtype = getattr(torch, moment_dtype)
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    def __setstate__(self, state):
        # A checkpoint's groups replace these on load; one written through
        # the ZeRO-1 wrapper carries only the options given to it.
        super().__setstate__(state)
        for group in self.param_groups:
            for k in ("betas", "eps", "weight_decay"):
                group.setdefault(k, self.defaults[k])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = []
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                # Optimizer.load_state_dict casts the moments to the
                # parameter's dtype.
                st["exp_avg"] = st["exp_avg"].to(self.moment_dtype)
                st["step"] += 1
                states.append(st)
            grads = [p.grad for p in params]
            avgs = [st["exp_avg"] for st in states]
            sqs = [st["exp_avg_sq"] for st in states]
            step = float(states[0]["step"])
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            beta1, beta2 = group["betas"]
            torch._foreach_mul_(params, 1 - lr * wd)
            if self.moment_dtype == torch.float32:
                torch._foreach_lerp_(avgs, grads, 1 - beta1)
                mus = avgs
            else:
                # optax: (1 - b1) * g + b1 * m, where JAX's promotion of
                # the Python float b1 against the bf16 m rounds b1 to bf16
                # too (0.9 -> 0.8984375).
                b1 = float(torch.tensor(beta1, dtype=torch.bfloat16))
                mus = torch._foreach_mul(grads, 1 - beta1)
                torch._foreach_add_(mus, [a.float() for a in
                                          torch._foreach_mul(avgs, b1)])
                torch._foreach_copy_(avgs, mus)
            torch._foreach_mul_(sqs, beta2)
            torch._foreach_addcmul_(sqs, grads, grads, 1 - beta2)
            step_size = lr / (1 - beta1 ** step)
            denom = torch._foreach_sqrt(sqs)
            torch._foreach_div_(denom, (1 - beta2 ** step) ** 0.5)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(params, mus, denom, -step_size)


def make_optimizer(params: Dict[str, List[torch.Tensor]], cfg: OptimConfig,
                   zero1: bool = False) -> torch.optim.Optimizer:
    """AdamW over the trainable groups {group name: tensors}; each param
    group carries its name, and the train step sets its lr every step. In
    distillation each group holds the student's tensors, then the
    teacher's (``train/state.init_train_state``): one AdamW over both
    models, in a fixed order, since ``checkpoint.restore`` loads the
    moments by index. With ``zero1`` the AdamW is wrapped in
    ``ZeroRedundancyOptimizer`` over the data group: each rank keeps the
    moments of its share of the tensors (every tensor is one rank's: the
    wrapper has no room for JAX's policy of replicating leaves under 2**12
    elements, ``toist_tpu/parallel/mesh.py:87-113``), and broadcasts its
    updated tensors after each step."""
    groups = [{"params": params[g], "name": g, "lr": 0.0}
              for g in GROUPS if params.get(g)]
    kw = dict(lr=0.0, weight_decay=cfg.weight_decay,
              moment_dtype=cfg.moment_dtype)
    if zero1:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        from toist_tpu_torch.utils import dist
        return ZeroRedundancyOptimizer(
            groups, optimizer_class=AdamW,
            process_group=dist.grid().data_group, **kw)
    return AdamW(groups, **kw)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float) -> None:
    """In place: w_ema = w_ema * decay + (1 - decay) * w (util/optim.py)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)
