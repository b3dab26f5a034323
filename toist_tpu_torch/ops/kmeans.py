"""Bounded-iteration k-means (Lloyd's algorithm) on the tensors' device.

Counterpart of ``toist_tpu/ops/kmeans.py`` (reference models/kmeans.py:
Lloyd iterations until the center shift^2 < tol, euclidean or cosine
distance, warm start from the stored centers). JAX runs the iterations in a
``lax.while_loop`` that stops on a device value. Here a Python loop runs
``max_iters`` iterations, each gated by a "still running" flag on the
device, (it < max_iters) & (shift > tol), tested before the body as the
while loop's ``cond`` is. A stopped state is a fixed point of the gate, so
the result equals the while loop's, and no iteration reads a value back to
the host: a caller on the card queues the whole solve without a sync.

Empty clusters keep their previous center. ``argmin`` takes the first
minimum, as ``jnp.argmin`` does. Distances are sum((x - c)^2) as in JAX,
not the x^2 - 2xc + c^2 expansion of ``torch.cdist``, which can flip an
``argmin`` on a near-tie.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _pairwise_dist(x: torch.Tensor, centers: torch.Tensor,
                   distance: str) -> torch.Tensor:
    if distance == "euclidean":
        return ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    if distance == "cosine":
        xn = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-8)
        cn = centers / torch.linalg.norm(centers, dim=-1,
                                         keepdim=True).clamp(min=1e-8)
        return 1.0 - xn @ cn.T
    raise ValueError(distance)


def kmeans(x: torch.Tensor, init_centers: torch.Tensor, max_iters: int = 32,
           tol: float = 1e-4, distance: str = "euclidean"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, D], init_centers [K, D] -> (assignments [N] int64, centers
    [K, D] in x's dtype)."""
    K = init_centers.shape[0]
    ks = torch.arange(K, device=x.device)

    def assign(centers):
        return torch.argmin(_pairwise_dist(x, centers, distance), dim=-1)

    centers = init_centers.to(x.dtype)
    it = torch.zeros((), dtype=torch.int32, device=x.device)
    shift = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    for _ in range(max_iters):
        running = (it < max_iters) & (shift > tol)
        onehot = (assign(centers)[:, None] == ks).to(x.dtype)     # [N, K]
        counts = onehot.sum(0)
        new = (onehot.T @ x) / torch.clamp(counts[:, None], min=1.0)
        new = torch.where(counts[:, None] > 0, new, centers)
        # Reference convergence: (sum_k ||delta c_k||)^2 < tol.
        new_shift = torch.linalg.norm(new - centers, dim=-1).sum() ** 2
        centers = torch.where(running, new, centers)
        shift = torch.where(running, new_shift, shift)
        it = it + running.to(torch.int32)
    return assign(centers), centers


def kmeans_predict(x: torch.Tensor, centers: torch.Tensor,
                   distance: str = "euclidean") -> torch.Tensor:
    """Nearest-center assignment [N] (reference kmeans.py:99-133)."""
    return torch.argmin(_pairwise_dist(x, centers, distance), dim=-1)


def init_centers_from_bank(bank: torch.Tensor, k: int,
                           seed: int = 0) -> torch.Tensor:
    """k distinct rows of the bank, deterministically (the reference's
    random-choice init, kmeans.py:54-58, made reproducible)."""
    n = bank.shape[0]
    idx = (torch.arange(k, device=bank.device) * max(1, n // k)) % n
    return bank[idx]
