"""The general traffic generators: a traffic mix's parameters and the seed
in, the program's inputs out.

Every seed gets the same set of sizes and the same share of each canvas;
the seed changes the content, the order and which task each image asks
about. Images are u8 noise inside their resized extent, zero padding on
the canvas beyond it (the batcher's layout); captions are token ids of the
configuration's vocabulary, begin and end tokens around 2-8 ids, padded.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

BOS, PAD, EOS = 0, 1, 2


def rng_of(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def task_captions(t: dict, vocab: int, max_len: int, seed: int
                  ) -> np.ndarray:
    """[tasks, max_len] int32 ids: one fixed caption per task, its length
    (begin and end tokens counted) uniform over ``caption_ids``."""
    rng = rng_of(seed, 1)
    lo, hi = t["caption_ids"]
    ids = np.full((t["tasks"], max_len), PAD, np.int32)
    for i in range(t["tasks"]):
        n = int(rng.integers(lo, hi + 1))
        ids[i, 0], ids[i, n - 1] = BOS, EOS
        ids[i, 1:n - 1] = rng.integers(3, vocab, n - 2)
    return ids


def canvas_sequence(t: dict, n: int, rng: np.random.Generator
                    ) -> List[int]:
    """n canvas indices in the mix's shares (rounded, exact for n a
    multiple of the shares' sum), in an order drawn from ``rng``."""
    share = np.asarray(t["canvas_share"], float)
    counts = np.floor(n * share / share.sum()).astype(int)
    counts[0] += n - counts.sum()
    seq = np.repeat(np.arange(len(share)), counts)
    return list(rng.permutation(seq))


def image_extent(t: dict, canvas, rng: np.random.Generator):
    """(h, w) of one image on ``canvas`` (H, W): the short side
    ``short_side``, the long side uniform over ``long_side``."""
    lo, hi = t["long_side"]
    long_ = int(rng.integers(lo, hi + 1))
    H, W = canvas
    return (t["short_side"], long_) if W >= H else (long_, t["short_side"])


def serve_pool(t: dict, vocab: int, max_text_len: int, seed: int
               ) -> List[Dict[str, np.ndarray]]:
    """``pool`` full batches of ``batch`` images, with the keys
    ``Predictor.predict_batch`` reads; the closed-loop client sends them in
    this order, round and round."""
    rng = rng_of(seed, 2)
    caps = task_captions(t, vocab, max_text_len, seed)
    B = t["batch"]
    pool = []
    for ci in canvas_sequence(t, t["pool"], rng):
        H, W = t["canvases"][ci]
        images = np.zeros((B, H, W, 3), np.uint8)
        image_mask = np.ones((B, H, W), bool)
        orig = np.zeros((B, 2), np.int32)
        tasks = rng.integers(0, t["tasks"], B)
        for b in range(B):
            h, w = image_extent(t, (H, W), rng)
            images[b, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
            image_mask[b, :h, :w] = False
            orig[b] = (h, w)
        text_ids = caps[tasks]
        pool.append({"images": images, "image_mask": image_mask,
                     "text_ids": text_ids, "text_mask": text_ids == PAD,
                     "orig_size": orig, "size": orig.copy(),
                     "sample_valid": np.ones(B, bool),
                     "task_id": (tasks + 1).astype(np.int32)})
    return pool


def train_canvas(t: dict, short: int, portrait: bool):
    """The smallest canvas of the mix's ladder whose short side holds
    ``short``: (H, W)."""
    rung = min((c for c in t["canvases"] if min(c) >= short),
               key=lambda c: c[0] * c[1])
    s, l = min(rung), max(rung)
    return (l, s) if portrait else (s, l)


def train_pool(t: dict, vocab: int, max_text_len: int, max_boxes: int,
               num_logit_cols: int, seed: int
               ) -> List[Dict[str, np.ndarray]]:
    """One batch for each short side of ``scales`` in each orientation slot
    of ``orientation_share`` (landscape, portrait), in an order drawn from
    the seed. A batch's images share its short side and lie on the
    ladder's smallest canvas that holds it; each image's long side is
    uniform over [1.2, 1.7] times the short side, capped by the canvas and
    ``max_long``; each holds ``boxes`` (lo, hi) boxes, each tied to 1-3
    caption tokens by its positive map."""
    rng = rng_of(seed, 4)
    caps = task_captions(t, vocab, max_text_len, seed)
    cap_len = (caps != PAD).sum(1)
    slots = []
    for s in t["scales"]:
        for o, n in enumerate(t["orientation_share"]):
            slots += [(s, bool(o))] * n
    B, N, L = t["batch"], max_boxes, num_logit_cols
    pool = []
    for k in rng.permutation(len(slots)):
        s, portrait = slots[k]
        H, W = train_canvas(t, s, portrait)
        images = np.zeros((B, H, W, 3), np.uint8)
        image_mask = np.ones((B, H, W), bool)
        boxes = np.zeros((B, N, 4), np.float32)
        box_valid = np.zeros((B, N), bool)
        pos = np.zeros((B, N, L), np.float32)
        tasks = rng.integers(0, t["tasks"], B)
        cap_long = min(max(H, W), t["max_long"])
        for b in range(B):
            long_ = int(rng.integers(min(round(1.2 * s), cap_long),
                                     min(round(1.7 * s), cap_long) + 1))
            h, w = (long_, s) if portrait else (s, long_)
            images[b, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
            image_mask[b, :h, :w] = False
            n = int(rng.integers(t["boxes"][0], t["boxes"][1] + 1))
            wh = rng.uniform(0.05, 0.4, (n, 2))
            c = rng.uniform(wh / 2, 1 - wh / 2)
            boxes[b, :n] = np.concatenate([c, wh], 1)
            box_valid[b, :n] = True
            words = int(cap_len[tasks[b]]) - 2          # between BOS, EOS
            for i in range(n):
                span = int(rng.integers(1, min(3, words) + 1))
                start = 1 + int(rng.integers(0, words - span + 1))
                pos[b, i, start:start + span] = 1.0 / span
        text_ids = caps[tasks]
        pool.append({"images": images, "image_mask": image_mask,
                     "text_ids": text_ids, "text_mask": text_ids == PAD,
                     "boxes": boxes, "box_valid": box_valid,
                     "positive_map": pos,
                     "sample_valid": np.ones(B, bool),
                     "task_id": (tasks + 1).astype(np.int32)})
    return pool
