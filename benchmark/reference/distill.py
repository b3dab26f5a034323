"""Plain PyTorch reference of TOIST's noun-pronoun distillation step, for the
benchmark's output check: the teacher and the student forward, the cluster
bank with its k-means and snaps, both streams' set losses, softkd with its
re-pairing, the cluster feature loss, one gradient over both models, the
clip over both, AdamW and both EMAs.

Written from the published method (TOIST, Li et al. 2022; its
``scripts/train_dete_dis.sh``, engine.py's distillation loop, models/
mdetr.py's ClusterCriterion and SetCriterion's softkd, models/kmeans.py, as
SURVEY.md §2.1 describes them). It imports nothing of the program: the
models are ``toist.Reference``'s methods, the matching, the set losses,
the clip and AdamW ``train.py``'s; every assignment is scipy's. It runs in
f32 with TF32 off; ``prec`` "fp8" stores the models' tensors in float8 as
``toist.Reference`` does (the bank stays f32, as the configuration keeps
it).

One step over a pair of batches that share images and boxes:

- the teacher ("verb + noun" captions) encodes with its dropout stream; its
  pooled noun features (per image, the mean over its boxes of the mean
  over each box's noun tokens) go into the bank; per image, k-means on its
  task's bank; the noun tokens of the joint memory take the chosen centre;
  the teacher decodes that memory with a second stream;
- the student ("verb + something") encodes; per image, k-means on its
  task's bank and the "something" token snapped to the nearest centre; the
  cluster feature loss, the mean square gap of the student's pooled
  "something" feature to its centre, averaged over the images with a span;
  the student decodes;
- each stream's set losses over every decoder level (Hungarian matching,
  soft-token cross-entropy, L1, GIoU, contrastive alignment, whose text
  side reads the unsnapped text memory); softkd per level; all weighted
  and summed: set losses at their coefficients, softkd 50 a level, the
  cluster feature loss 1e4;
- one gradient over both models' trainable tensors, the clip by the
  global norm over both, AdamW at each tensor's group rate, both EMAs.

The bank (ClusterCriterion):

- a push, per image in batch order: until its task is full the task's
  bank shifts the feature in (first in, first out); once full the feature
  replaces the bank row nearest to it in L1;
- the full flag's quirk: a task turns full when its update count exceeds
  the memory size before the push's increment, so on its memory size +
  2-th push;
- k-means (Lloyd), per image in batch order: warm-started from the
  centres the previous image of that task left, iterated until the
  squared sum of the centres' moves is under ``tol``; the image's choice is
  its pooled feature's nearest centre (squared euclidean).

softkd (SetCriterion.loss_softkd): each query's binary probabilities
[P(object), P(no object)] from its logits; KL(teacher || student) of the
two queries matched to the same target, plus the two streams' unmatched
queries re-paired by one assignment over KL + L1 - GIoU, in query order;
per image summed over the pairs over the queries, mean over the images.
The teacher's side carries no gradient.

Departures (the first four are the configuration the program states, the
last is the check's):

- an empty cluster keeps its centre (the published k-means draws a random
  point);
- k-means stops after ``max_iters`` (32) iterations if still moving;
- no all-gather: one rank's bank takes its own rows;
- KL takes 1e-10 inside each logarithm;
- the bank runs on the program's pooled features where ``feed`` gives
  them, as the check does: k-means on the full standard-normal bank is
  chaotic (with 3 of its 1,024 rows moved by bf16 rounding its centres
  moved by up to 8% on the H100, and a moved centre flips the snaps that
  follow), so the reference applies its own push, k-means and choice
  rules to the features the program pooled; the runner holds those
  features to the reference's own. Where its own feature would choose
  another centre, the choice counts in "near_ties" (within ``NEAR`` of
  the chosen centre's distance, relative to it) or in "flips" (beyond):
  reported, not limited.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from benchmark.reference import toist as ref
from benchmark.reference import train as reftrain

NEAR = 1e-3
KL_EPS = 1e-10
PAIR_KEYS = ("images", "image_mask", "text_ids", "text_mask", "boxes",
             "positive_map", "box_valid", "sample_valid", "task_id",
             "noun_token_spans", "caption_noun_span")


# --------------------------------------------------------------------------
# The bank.

def lloyd(x: torch.Tensor, centers: torch.Tensor, max_iters: int,
          tol: float) -> Tuple[torch.Tensor, int]:
    """Lloyd's k-means of x [N, D] from ``centers`` [K, D]: (centers, the
    iterations run). Each centre is the mean of its members (a one-hot
    product over the counts); an empty one stays."""
    ks = torch.arange(centers.shape[0], device=x.device)
    it = 0
    while it < max_iters:
        a = ((x[:, None, :] - centers[None]) ** 2).sum(-1).argmin(1)
        onehot = (a[:, None] == ks).to(x.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ x) / counts.clamp(min=1.0)[:, None]
        new = torch.where(counts[:, None] > 0, new, centers)
        shift = torch.linalg.norm(new - centers, dim=-1).sum() ** 2
        centers = new
        it += 1
        if float(shift) < tol:
            break
    return centers, it


class Bank:
    """The cluster bank: feature_bank [T, M, D], cluster_centers [T, K, D]
    (f32), update_count [T] and full [T] as host lists. ``select`` counts
    in ``near_ties`` and ``flips`` the images whose own pooled feature
    would choose another centre than the feature it was given, within
    ``NEAR`` and beyond it."""

    def __init__(self, state: Dict[str, torch.Tensor]):
        self.fb = state["feature_bank"].detach().float().clone()
        self.cc = state["cluster_centers"].detach().float().clone()
        self.count = [int(c) for c in state["update_count"]]
        self.full = [bool(f) for f in state["full"]]
        self.near_ties = self.flips = 0

    def push(self, feats: torch.Tensor, tasks: Sequence[int],
             valid: Sequence[bool]) -> None:
        """Push the valid rows in order."""
        M = self.fb.shape[1]
        for f, t, ok in zip(feats, tasks, valid):
            if not ok:
                continue
            if self.full[t]:
                self.fb[t, int((self.fb[t] - f).abs().sum(-1).argmin())] = f
            else:
                self.fb[t] = torch.cat([self.fb[t, 1:], f[None]])
            self.full[t] = self.full[t] or self.count[t] > M
            self.count[t] += 1

    def select(self, pooled: torch.Tensor, tasks: Sequence[int],
               valid: Sequence[bool], max_iters: int, tol: float,
               own: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, List[int], int]:
        """Per valid image in order, k-means on its task's bank from the
        stored centres, which it then replaces, and the centre nearest to
        its ``pooled`` feature; returns (the chosen centre per image
        [B, D], zero for an invalid one; the choices, -1 for an invalid
        image; the iterations run). ``own``: the reference's own pooled
        features, for ``near_ties`` and ``flips``."""
        out = torch.zeros_like(pooled)
        choices, iters = [], 0
        for b, (t, ok) in enumerate(zip(tasks, valid)):
            if not ok:
                choices.append(-1)
                continue
            c, it = lloyd(self.fb[t], self.cc[t], max_iters, tol)
            iters += it
            k = int(((pooled[b][None] - c) ** 2).sum(-1).argmin())
            if own is not None:
                d = ((own[b][None] - c) ** 2).sum(-1)
                mine = int(d.argmin())
                if mine != k:
                    gap = float((d[k] - d[mine]) / d[k].clamp(min=1e-30))
                    if gap < NEAR:
                        self.near_ties += 1
                    else:
                        self.flips += 1
            self.cc[t] = c
            out[b] = c[k]
            choices.append(k)
        return out, choices, iters


def span_mask(spans: torch.Tensor, T: int) -> torch.Tensor:
    """Inclusive token spans [..., 2] (-1: none) -> masks [..., T]."""
    pos = torch.arange(T, device=spans.device)
    lo, hi = spans[..., 0:1], spans[..., 1:2]
    return (pos >= lo) & (pos <= hi) & (lo >= 0)


def noun_pool(text: torch.Tensor, x: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The teacher's pooled noun feature per image [B, D], whether it has
    one [B], and the union of its boxes' noun tokens [B, T]."""
    T = text.shape[1]
    bv = x["box_valid"] & x["sample_valid"][:, None]
    m = span_mask(x["noun_token_spans"], T) & bv[..., None]     # [B, N, T]
    cnt = m.sum(-1)
    per_box = (m.float() @ text) / cnt.clamp(min=1)[..., None]
    ok = cnt > 0
    n = ok.sum(-1)
    pooled = (per_box * ok[..., None]).sum(1) / n.clamp(min=1)[..., None]
    return pooled, (n > 0) & x["sample_valid"], m.any(1)


def caption_pool(text: torch.Tensor, x: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The student's pooled "something" feature [B, D], whether it has one
    [B], and its tokens [B, T]."""
    m = span_mask(x["caption_noun_span"], text.shape[1])
    cnt = m.sum(-1)
    pooled = (m.float()[:, None, :] @ text)[:, 0] / cnt.clamp(min=1)[:, None]
    return pooled, (cnt > 0) & x["sample_valid"], m


def snap(memory: torch.Tensor, tokens: torch.Tensor, centres: torch.Tensor,
         valid: torch.Tensor) -> torch.Tensor:
    """The joint memory with the text ``tokens`` [B, T] of the valid
    images replaced by their centre [B, D]."""
    T = tokens.shape[1]
    text = memory[:, -T:]
    sel = (tokens & valid[:, None])[..., None]
    return torch.cat([memory[:, :-T],
                      torch.where(sel, centres[:, None, :], text)], 1)


# --------------------------------------------------------------------------
# The two halves of the forward.

def encode(R: ref.Reference, x: Dict[str, torch.Tensor]) -> dict:
    """Everything before the decoder (``Reference.forward``'s first half):
    the joint memory [B, S, D], its key mask and position."""
    m, images, image_mask = R.m, x["images"], x["image_mask"]
    mean = torch.tensor(ref.IMAGENET_MEAN, device=images.device)
    std = torch.tensor(ref.IMAGENET_STD, device=images.device)
    im = (images.float() / 255.0 - mean) / std
    im = im * (~image_mask)[..., None].float()
    feat = R.backbone(im.permute(0, 3, 1, 2).contiguous(), image_mask)
    B, _, fh, fw = feat.shape
    fmask = R.feature_mask(image_mask, fh, fw)
    d = m["hidden_dim"]
    pos = R.sine_position(fmask, d // 2).reshape(B, fh * fw, d)
    img = R.conv(feat, "input_proj").permute(0, 2, 3, 1).reshape(
        B, fh * fw, d)
    text = R.roberta(x["text_ids"].long(), x["text_mask"])
    text = R.u8(R.layer_norm(R.linear(text, "transformer.resizer.fc"),
                             "transformer.resizer.layer_norm", 1e-12),
                R.drop.resizer_rate if R.drop is not None else None)
    joint = torch.cat([img, text], 1)
    mask = torch.cat([fmask.reshape(B, fh * fw), x["text_mask"]], 1)
    jpos = torch.cat([pos, torch.zeros_like(text)], 1)
    return {"memory": R.encoder(joint, jpos, mask), "mask": mask,
            "pos": jpos}


def decode(R: ref.Reference, memory: torch.Tensor, enc: dict, T: int
           ) -> Dict[str, torch.Tensor]:
    """The decoder over ``memory`` and the heads, in ``Reference.forward``'s
    layout; the text projection reads the encoder's (unsnapped) text."""
    hs = R.decoder(memory, enc["pos"], enc["mask"])
    logits = R.linear(hs, "class_embed")
    h = hs
    for i in range(3):
        h = R.linear(h, f"bbox_embed.layers.{i}")
        if i < 2:
            h = torch.relu(h)
    boxes = torch.sigmoid(h)
    pq = R.linear(hs, "contrastive_align_projection_image")
    pt = R.linear(enc["memory"][:, -T:], "contrastive_align_projection_text")
    pq = pq / pq.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    pt = pt / pt.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    return {"pred_logits": logits[-1], "pred_boxes": boxes[-1],
            "aux_pred_logits": logits[:-1], "aux_pred_boxes": boxes[:-1],
            "proj_queries": pq[-1], "aux_proj_queries": pq[:-1],
            "proj_tokens": pt}


# --------------------------------------------------------------------------
# The losses.

def set_losses(out: Dict[str, torch.Tensor], x: Dict[str, torch.Tensor],
               loss: dict) -> Tuple[torch.Tensor, list]:
    """One stream's weighted set losses over every level (aux levels, then
    the last), and each level's matching (``train.total_loss``)."""
    logits = torch.cat([out["aux_pred_logits"], out["pred_logits"][None]])
    boxes = torch.cat([out["aux_pred_boxes"], out["pred_boxes"][None]])
    proj = torch.cat([out["aux_proj_queries"], out["proj_queries"][None]])
    valid = x["box_valid"] & x["sample_valid"][:, None]
    pos_map = x["positive_map"].float()
    num_boxes = valid.sum().float().clamp(min=1.0)
    assign = reftrain.match(logits.detach(), boxes.detach(), x["boxes"],
                            pos_map, valid, loss["set_cost_class"],
                            loss["set_cost_bbox"], loss["set_cost_giou"])
    w = {"ce": loss["ce_loss_coef"], "bbox": loss["bbox_loss_coef"],
         "giou": loss["giou_loss_coef"],
         "align": loss["contrastive_align_loss_coef"]}
    total = logits.new_zeros(())
    for lvl in range(logits.shape[0]):
        ls = reftrain.level_losses(
            logits[lvl], boxes[lvl], proj[lvl], out["proj_tokens"],
            x["text_mask"], x["boxes"], pos_map, assign[lvl],
            loss["eos_coef"], loss["temperature_NCE"], num_boxes)
        total = total + sum(w[k] * v for k, v in ls.items())
    return total, assign


def binary(logits: torch.Tensor) -> torch.Tensor:
    """[..., C] logits -> [..., 2]: P(any object), P(no object)."""
    p = torch.softmax(logits, -1)
    return torch.stack([p[..., :-1].sum(-1), p[..., -1]], -1)


def kl(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) over the last axis."""
    return (p * (torch.log(p + KL_EPS) - torch.log(q + KL_EPS))).sum(-1)


def softkd(t_logits, s_logits, t_boxes, s_boxes, t_assign, s_assign,
           sample_valid: torch.Tensor) -> torch.Tensor:
    """softkd of one decoder level: [B, Q, ...] per stream, each stream's
    matching as a list of (targets, queries) per image."""
    Q = t_logits.shape[1]
    pt, ps = binary(t_logits).detach(), binary(s_logits)
    total = t_logits.new_zeros(())
    for b in range(t_logits.shape[0]):
        if not bool(sample_valid[b]):
            continue
        tq = dict(zip(t_assign[b][0].tolist(), t_assign[b][1].tolist()))
        sq = dict(zip(s_assign[b][0].tolist(), s_assign[b][1].tolist()))
        pairs = [(tq[n], sq[n]) for n in tq if n in sq]
        tp = kl(pt[b, [a for a, _ in pairs]], ps[b, [s for _, s in pairs]])
        t_un = [q for q in range(Q) if q not in set(tq.values())]
        s_un = [q for q in range(Q) if q not in set(sq.values())]
        fpt, fps = pt[b, t_un], ps[b, s_un]
        tb = reftrain.cxcywh_to_xyxy(t_boxes[b, t_un])
        sb = reftrain.cxcywh_to_xyxy(s_boxes[b, s_un])
        cost = (kl(fpt[None], fps[:, None])
                + (s_boxes[b, s_un][:, None] - t_boxes[b, t_un][None])
                .abs().sum(-1) - reftrain.giou(sb, tb))
        r, c = linear_sum_assignment(cost.detach().cpu().numpy())
        fp = kl(fpt[c], fps[r])
        total = total + (tp.sum() + fp.sum()) / Q
    return total / sample_valid.sum().clamp(min=1)


# --------------------------------------------------------------------------
# The steps.

def pair_on(batch: dict, device) -> Dict[str, Dict[str, torch.Tensor]]:
    return {s: {k: torch.from_numpy(np.ascontiguousarray(b[k])).to(device)
                for k in PAIR_KEYS} for s, b in batch.items()}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack(torch._foreach_norm([tensors[n].float()
                                             for n in names])).cpu()
    return dict(zip(names, norms.tolist()))


def distill_steps(models: Dict[str, Dict[str, torch.Tensor]],
                  bank: Dict[str, torch.Tensor], m: dict, config: dict,
                  trainable: Sequence[str], lr: Callable[[str, int], float],
                  batches: List[dict], dropout_seed: Callable[[int, int],
                                                              int],
                  device, prec: str = "f32",
                  feed: Optional[List[tuple]] = None) -> dict:
    """The first len(batches) distillation steps from the weights
    ``models`` ({"s": student, "t": teacher}, reference layout) and the
    bank state ``bank``; ``trainable`` the keys trained in each model;
    ``lr(key, step)`` a key's learning rate; ``dropout_seed(step,
    stream)`` the seed of the teacher's encode (1) and decode (2), the
    student's encode (3) and decode (4). ``feed`` gives, per step, the
    teacher's and the student's pooled features the bank is to run on.

    Returns the check's record: each step's loss; the first step's
    clipped gradient norms, and after the last the change norms of the
    weights and of their EMAs, by "s.<key>" and "t.<key>"; the final
    bank ("feature_bank", "cluster_centers"); per step both streams' own
    pooled features and the text memory each decoded (on the host), and
    the k-means iterations; "near_ties" and "flips"."""
    optim, loss_cfg, mcfg = config["optim"], config["loss"], config["model"]
    keep = set(trainable)
    P = {w: {k: W[k].detach().clone().requires_grad_(k in keep)
             for k in W} for w, W in models.items()}
    names = [f"{w}.{k}" for w in P for k in trainable]
    params = [P[n[0]][n[2:]] for n in names]
    ema = [p.detach().clone() for p in params]
    opt = reftrain.AdamW(params, optim["weight_decay"])
    state = Bank(bank)
    iters, tol = loss_cfg["kmeans_max_iters"], loss_cfg["kmeans_tol"]
    out = {"losses": [], "pooled": [], "decoded": [], "kmeans_iters": []}

    def fed(s, i, own):
        """The bank's input: the fed features where they fit, else own."""
        f = feed[s][i] if feed is not None and s < len(feed) else None
        return own if f is None or f.shape != own.shape else f.to(own)

    def model(w, step, stream):
        g = torch.Generator(device=device)
        g.manual_seed(dropout_seed(step, stream))
        return ref.Reference(P[w], m, prec, ref.Dropout(
            g, mcfg["dropout"], mcfg["resizer_dropout"]))

    with ref.f32_mode():
        for s, pair in enumerate(batches):
            x = pair_on(pair, device)
            xt, xs = x["noun"], x["sth"]
            T = xt["text_ids"].shape[1]
            # Teacher: push, cluster, snap the noun tokens, decode.
            enc_t = encode(model("t", s, 1), xt)
            text_t = enc_t["memory"][:, -T:].detach()
            pooled, ok, tokens = noun_pool(text_t, xt)
            tasks = (xt["task_id"].long() - 1).tolist()
            valid = ok.tolist()
            state.push(fed(s, 0, pooled), tasks, valid)
            centres, _, it_t = state.select(fed(s, 0, pooled), tasks, valid,
                                            iters, tol, own=pooled)
            mem_t = snap(enc_t["memory"], tokens, centres, ok)
            out_t = decode(model("t", s, 2), mem_t, enc_t, T)
            # Student: cluster, snap "something", the feature loss, decode.
            enc_s = encode(model("s", s, 3), xs)
            pooled_s, ok_s, tokens_s = caption_pool(enc_s["memory"][:, -T:],
                                                    xs)
            centres_s, _, it_s = state.select(
                fed(s, 1, pooled_s.detach()),
                (xs["task_id"].long() - 1).tolist(), ok_s.tolist(), iters,
                tol, own=pooled_s.detach())
            mem_s = snap(enc_s["memory"], tokens_s, centres_s, ok_s)
            out_s = decode(model("s", s, 4), mem_s, enc_s, T)
            feature = ((((pooled_s - centres_s) ** 2).mean(-1) * ok_s).sum()
                       / ok_s.sum().clamp(min=1))
            out["pooled"].append((pooled.cpu(), pooled_s.detach().cpu()))
            out["decoded"].append((mem_t[:, -T:].detach().cpu(),
                                   mem_s[:, -T:].detach().cpu()))
            out["kmeans_iters"].append(it_t + it_s)

            lt, a_t = set_losses(out_t, xt, loss_cfg)
            ls, a_s = set_losses(out_s, xs, loss_cfg)
            (tl, sl), (tb, sb) = (
                [torch.cat([o[f"aux_{k}"], o[k][None]]) for o in (out_t,
                                                                  out_s)]
                for k in ("pred_logits", "pred_boxes"))
            kd = sum(softkd(tl[i], sl[i], tb[i], sb[i], a_t[i], a_s[i],
                            xs["sample_valid"]) for i in range(len(a_t)))
            loss = (lt + ls + loss_cfg["softkd_coef"] * kd
                    + loss_cfg["cluster_feature_loss"] * feature)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            del out_t, out_s, enc_t, enc_s, mem_t, mem_s
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            reftrain.clip_(grads, optim["clip_max_norm"])
            if s == 0:
                out["grad"] = leaf_norms(dict(zip(names, grads)))
            opt.step(grads, [lr(n[2:], s) for n in names])
            with torch.no_grad():
                for e, p in zip(ema, params):
                    e.mul_(optim["ema_decay"]).add_(
                        p, alpha=1 - optim["ema_decay"])
            out["losses"].append(float(loss.detach()))
            del grads, loss
    with torch.no_grad():
        out["change"] = leaf_norms({n: p - models[n[0]][n[2:]]
                                    for n, p in zip(names, params)})
        out["ema_change"] = leaf_norms({n: e - models[n[0]][n[2:]]
                                        for n, e in zip(names, ema)})
    out["bank"] = {"feature_bank": state.fb, "cluster_centers": state.cc}
    out["near_ties"], out["flips"] = state.near_ties, state.flips
    return out
