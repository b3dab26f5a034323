"""The cluster memory of noun-pronoun distillation (the reference's
ClusterCriterion) as functions of a bank of tensors.

Counterpart of ``toist_tpu/train/cluster.py`` (reference models/mdetr.py:
29-312), with its semantics:

- FIFO shift-insert until a task's bank is full, with the reference's
  full-flag quirk (full is set when update_count exceeds memory_size before
  the increment, mdetr.py:85-92);
- once full: FIFO mode shifts on; the default mode replaces the L1-nearest
  bank row, one batch row at a time (mdetr.py:98-103);
- per sample, k-means on the task's bank, warm-started from and writing back
  the stored centers, sequentially over the batch (mdetr.py:213-234);
- snapping: the text positions of the noun / "something" span in the joint
  memory are overwritten with the chosen cluster center (mdetr.py:170-211,
  236-312).

The bank and the k-means are f32; the pooled features that enter them are
detached. Every function here queues its work on the tensors' device with
no host sync: the sequential loops run over the batch's rows in Python,
JAX's ``lax.cond`` becomes ``torch.where`` over both branches, and a task
index stays a device tensor. A padding row's task index is -1 (task id 0):
its reads wrap to the last task, as JAX's indexing does, and its writes are
masked off.

Across ranks (``across_ranks``, the train steps) the bank is one global
object, as JAX's is: each rank all-gathers the pooled features, task ids
and valid flags of its rows, and every rank pushes and clusters the global
batch's rows in rank order (the global batch order of
``make_array_from_process_local_data``, which ``toist_tpu/train/cluster.py:
81-115`` scans), so every rank ends the step with the same bank. Each rank
snaps its own rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from toist_tpu_torch.ops.kmeans import kmeans, kmeans_predict
from toist_tpu_torch.utils import dist


@dataclasses.dataclass
class ClusterBank:
    feature_bank: torch.Tensor     # [T, M, D] f32
    cluster_centers: torch.Tensor  # [T, K, D] f32
    update_count: torch.Tensor     # [T] int32
    full: torch.Tensor             # [T] bool


def init_bank(task_count: int, memory_size: int, cluster_num: int,
              feature_dim: int, generator: torch.Generator) -> ClusterBank:
    """Standard-normal bank and centers drawn from ``generator``, on its
    device (the reference's buffers, mdetr.py:42-51)."""
    dev = generator.device
    return ClusterBank(
        feature_bank=torch.randn((task_count, memory_size, feature_dim),
                                 generator=generator, device=dev),
        cluster_centers=torch.randn((task_count, cluster_num, feature_dim),
                                    generator=generator, device=dev),
        update_count=torch.zeros(task_count, dtype=torch.int32, device=dev),
        full=torch.zeros(task_count, dtype=torch.bool, device=dev))


def span_box_masks(spans: torch.Tensor, T: int) -> torch.Tensor:
    """Inclusive token spans [B, N, 2] -> boolean masks [B, N, T]."""
    pos = torch.arange(T, device=spans.device)
    beg, end = spans[..., 0:1], spans[..., 1:2]
    return (pos >= beg) & (pos <= end) & (beg >= 0)


def pool_span_features(text_memory: torch.Tensor, spans: torch.Tensor,
                       box_valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per image, the mean over its valid boxes of the mean over each box's
    span: text_memory [B, T, D], spans [B, N, 2], box_valid [B, N] ->
    (pooled [B, D], has_any [B]) (mdetr.py:112-146)."""
    T = text_memory.shape[1]
    m = span_box_masks(spans, T).to(text_memory.dtype)            # [B, N, T]
    cnt = m.sum(-1)                                               # [B, N]
    per_box = torch.einsum("bnt,btd->bnd", m, text_memory) \
        / torch.clamp(cnt, min=1.0)[..., None]
    ok = box_valid & (cnt > 0)
    n_ok = ok.sum(-1)
    pooled = (per_box * ok[..., None]).sum(1) \
        / torch.clamp(n_ok, min=1)[..., None]
    return pooled, n_ok > 0


def caption_span_mask(batch: Mapping[str, torch.Tensor],
                      T: int) -> torch.Tensor:
    """The caption's "something" span (``caption_noun_span``) as a mask
    [B, T] over the text tokens."""
    return span_box_masks(batch["caption_noun_span"][:, None, :], T)[:, 0]


def _global_rows(pooled: torch.Tensor, task_idx: torch.Tensor,
                 valid: torch.Tensor, across_ranks: bool):
    """(pooled, task_idx, valid) of the global batch, all-gathered over the
    data group in its order in one f32 collective, and the slice of this
    rank's rows."""
    if not across_ranks or not dist.initialized():
        return pooled, task_idx, valid, slice(None)
    B = pooled.shape[0]
    rows = torch.cat([pooled.float(), task_idx[:, None].float(),
                      valid[:, None].float()], 1)
    g = dist.all_gather_rows(rows)
    r = dist.data_index()
    return (g[:, :-2], g[:, -2].long(), g[:, -1] > 0,
            slice(r * B, (r + 1) * B))


@torch.no_grad()
def update_bank(bank: ClusterBank, features: torch.Tensor,
                task_idx: torch.Tensor, valid: torch.Tensor,
                fifo: bool = False) -> ClusterBank:
    """Push [B] pooled features into their task banks, one row at a time,
    in batch order."""
    fb, count, full = bank.feature_bank, bank.update_count, bank.full
    ntasks, M = fb.shape[:2]
    tasks = torch.arange(ntasks, device=fb.device)
    rows = torch.arange(M, device=fb.device)
    features = features.float()
    for b in range(features.shape[0]):
        feat, t, ok = features[b], task_idx[b].long(), valid[b]
        row = (t % ntasks).view(1)
        fb_t = fb.index_select(0, row)[0]                         # [M, D]
        shifted = torch.cat([fb_t[1:], feat[None]], 0)
        if fifo:
            new_fb_t = shifted
        else:
            j = torch.argmin((fb_t - feat[None]).abs().sum(-1))
            replaced = torch.where((rows == j)[:, None], feat[None], fb_t)
            new_fb_t = torch.where(full.index_select(0, row), replaced,
                                   shifted)
        new_fb_t = torch.where(ok, new_fb_t, fb_t)
        at_t = tasks == t
        fb = torch.where(at_t[:, None, None], new_fb_t[None], fb)
        full = torch.where(at_t & ok, full | (count > M), full)
        count = torch.where(at_t & ok, count + 1, count)
    return dataclasses.replace(bank, feature_bank=fb, update_count=count,
                               full=full)


@torch.no_grad()
def cluster_select(bank: ClusterBank, pooled: torch.Tensor,
                   task_idx: torch.Tensor, valid: torch.Tensor,
                   max_iters: int = 32, tol: float = 1e-4
                   ) -> Tuple[ClusterBank, torch.Tensor, torch.Tensor]:
    """Per sample, k-means on its task's bank, warm-started from the
    centers the previous sample of that task left (mdetr.py:171-178).
    Returns (bank with the new centers, the chosen center per sample [B, D],
    the choice [B])."""
    centers_all = bank.cluster_centers
    ntasks = centers_all.shape[0]
    tasks = torch.arange(ntasks, device=centers_all.device)
    pooled = pooled.float()
    feats, choices = [], []
    for b in range(pooled.shape[0]):
        t, ok = task_idx[b].long().view(1), valid[b]
        row = t % ntasks
        _, new_centers = kmeans(bank.feature_bank.index_select(0, row)[0],
                                centers_all.index_select(0, row)[0],
                                max_iters=max_iters, tol=tol)
        choice = kmeans_predict(pooled[b][None], new_centers)[0]
        feats.append(new_centers.index_select(0, choice.view(1))[0])
        choices.append(choice)
        centers_all = torch.where(((tasks == t) & ok)[:, None, None],
                                  new_centers[None], centers_all)
    return (dataclasses.replace(bank, cluster_centers=centers_all),
            torch.stack(feats), torch.stack(choices))


def snap_text_memory(img_memory: torch.Tensor, text_len: int,
                     span_union: torch.Tensor, center_feats: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The joint memory [B, S_img + T, D] with the text positions in
    ``span_union`` [B, T] of the ``valid`` samples overwritten by their
    center [B, D] (cast to the memory's dtype)."""
    S = img_memory.shape[1]
    text = img_memory[:, S - text_len:]
    sel = (span_union & valid[:, None])[..., None]
    text_mod = torch.where(sel, center_feats[:, None, :].to(img_memory.dtype),
                           text)
    return torch.cat([img_memory[:, :S - text_len], text_mod], 1)


def teacher_update_and_snap(bank: ClusterBank,
                            cache: Mapping[str, torch.Tensor],
                            batch: Mapping[str, torch.Tensor],
                            max_iters: int = 32, tol: float = 1e-4,
                            fifo: bool = False, across_ranks: bool = False
                            ) -> Tuple[ClusterBank, torch.Tensor, Dict]:
    """Teacher path (update_memory, mdetr.py:105-211): pool the noun spans,
    push them into the bank, snap the noun positions to their k-means
    center. Returns (bank, img_memory_mod, aux); with ``across_ranks`` the
    bank takes the global batch's rows."""
    tm = cache["text_memory"].float()
    spans = batch["noun_token_spans"]
    bv = batch["box_valid"] & batch["sample_valid"][:, None]
    pooled, has_any = pool_span_features(tm, spans, bv)
    pooled = pooled.detach()
    task0 = batch["task_id"].long() - 1
    valid = has_any & batch["sample_valid"]
    g_pooled, g_task0, g_valid, own = _global_rows(pooled, task0, valid,
                                                   across_ranks)
    bank = update_bank(bank, g_pooled, g_task0, g_valid, fifo=fifo)
    bank, center_feats, choices = cluster_select(bank, g_pooled, g_task0,
                                                 g_valid, max_iters, tol)
    center_feats, choices = center_feats[own], choices[own]
    T = tm.shape[1]
    union = (span_box_masks(spans, T) & bv[..., None]).any(1)
    mod = snap_text_memory(cache["img_memory"], T, union, center_feats,
                           valid)
    return bank, mod, {"choices": choices, "pooled": pooled, "valid": valid}


def student_cluster(bank: ClusterBank, cache: Mapping[str, torch.Tensor],
                    batch: Mapping[str, torch.Tensor], max_iters: int = 32,
                    tol: float = 1e-4, train: bool = True,
                    num_valid: Optional[torch.Tensor] = None,
                    across_ranks: bool = False
                    ) -> Tuple[ClusterBank, torch.Tensor, Dict]:
    """Student path (forward mdetr.py:236-280 / infer_choice :282-312):
    pool the caption's "something" span (``caption_noun_span``, so an image
    without boxes is snapped too), snap it to its k-means center; in
    training also the MSE of the pooled feature to its center, whose
    gradient reaches the student through the pooled feature only, averaged
    over the samples with a span (``num_valid`` of them, by default the
    batch's). With ``across_ranks`` the k-means runs over the global
    batch's rows."""
    tm = cache["text_memory"].float()
    T = tm.shape[1]
    m = caption_span_mask(batch, T)
    cnt = m.sum(-1)
    pooled = torch.einsum("bt,btd->bd", m.to(tm.dtype), tm) \
        / torch.clamp(cnt, min=1)[..., None]
    valid = (cnt > 0) & batch["sample_valid"]
    task0 = batch["task_id"].long() - 1
    g_pooled, g_task0, g_valid, own = _global_rows(pooled.detach(), task0,
                                                   valid, across_ranks)
    bank, center_feats, choices = cluster_select(
        bank, g_pooled, g_task0, g_valid, max_iters, tol)
    center_feats, choices = center_feats[own], choices[own]
    mod = snap_text_memory(cache["img_memory"], T, m, center_feats, valid)
    aux = {"choices": choices, "valid": valid}
    if train:
        # MSE(pooled, chosen center), averaged over samples (:269-278).
        per = ((pooled - center_feats) ** 2).mean(-1)
        if num_valid is None:
            num_valid = torch.clamp(valid.sum(), min=1)
        aux["loss_cluster_feature"] = (per * valid).sum() / num_valid
        aux["loss_cluster_choice"] = torch.zeros((), device=tm.device)
    return bank, mod, aux
