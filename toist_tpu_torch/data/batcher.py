"""Static bucketed pad-to-shape batching — the TPU replacement for NestedTensor.

The port's own copy of ``toist_tpu/data/batcher.py``, kept line for line so that it
diffs against it (the port imports nothing of the JAX package).

The reference pads each batch to its own max H,W (util/misc.py:184-209) and text to the
longest caption; under XLA that means a recompile per novel shape. Here every batch is
padded to one of a small fixed set of (H, W) canvas buckets and a fixed text length /
box count, so the jitted step compiles once per bucket (SURVEY.md §5.7, the north-star
requirement in BASELINE.json).

A `Batch` is a flat dict of numpy arrays with fully static shapes:
  images      [B, H, W, 3] f32 host-normalized, or u8 raw when
                                 DataConfig.device_normalize is on (NHWC,
                                 zero-padded; the model normalizes u8 on-device)
  image_mask  [B, H, W]    bool  True on PADDING pixels (NestedTensor convention)
  text_ids    [B, T]       i32   (PAD=1)
  text_mask   [B, T]       bool  True on padding tokens
  boxes       [B, N, 4]    f32   normalized cxcywh, zero-padded
  labels      [B, N]       i64
  box_valid   [B, N]       bool
  positive_map[B, N, 256]  f32
  noun_token_spans [B, N, 2] i32 (inclusive, -1 = missing)
  caption_noun_span[B, 2]    i32 caption-level "something" span (box-independent)
  gt_masks    [B, N, H/4, W/4] u8 (only when masks on)
  sample_valid[B]          bool  False for batch-padding rows
  image_id / task_id / orig_size / size — bookkeeping for eval
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MASK_STRIDE = 4  # GT masks stored at this stride for the mask loss


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    buckets: Tuple[Tuple[int, int], ...]  # (H, W) canvases, multiples of 32
    max_text_len: int = 64
    max_boxes: int = 25
    num_logit_cols: int = 256
    with_masks: bool = False

    def pick(self, h: int, w: int) -> int:
        """Smallest-area bucket that fits; -1 if none."""
        best, best_area = -1, None
        for i, (bh, bw) in enumerate(self.buckets):
            if h <= bh and w <= bw:
                area = bh * bw
                if best_area is None or area < best_area:
                    best, best_area = i, area
        return best


def default_buckets(max_size: int = 1333, short: int = 800) -> Tuple[Tuple[int, int], ...]:
    """Two-orientation canvases covering the reference's resize envelope."""
    long_r = _round_up(max_size, 32)
    short_r = _round_up(short, 32)
    return ((short_r, long_r), (long_r, short_r))


def train_buckets(max_size: int = 1333,
                  scales: Tuple[int, ...] = (480, 800)) -> Tuple[Tuple[int, int], ...]:
    """Finer canvas ladder for training's multiscale resize.

    Train-time RandomResize emits short sides 480..800 (reference
    datasets/tdod.py:316-327); padding everything to the single 832x1344 eval
    canvas wastes up to ~3.6x conv pixels on a 480-scale sample. This ladder
    adds intermediate canvases so a sample pads to the smallest one that fits.

    Coverage proof: after resize, short <= max(scales) and long <= max_size.
    For a landscape sample (h <= w), if h <= 480 then w <= 1333 <= 1344 so
    (480, 800) or a wider rung fits once w is bracketed; each rung widens BOTH
    dims, so the sequence (480,800) -> (608,1008) -> (736,1216) -> (832,1344)
    always ends in a canvas with h <= 832, w <= 1344 (and symmetrically for
    portrait). `BucketSpec.pick` chooses the smallest-area fit.

    Compile-count budget: 8 canvases => at most 8 train-step compilations per
    process in the JAX package (XLA caches by shape; the port compiles none).
    Typical padding waste drops from ~3.6x to <=1.3x on 4:3 inputs.

    The top rung is derived from max(scales): with the default 480..800
    multiscale range it is (832, long_cap) as before; raising train_scales
    past 832 grows the top rung so resized samples always fit a bucket
    (BatchIterator silently skips samples that fit no bucket, so an
    undersized ladder would shrink the training set without warning).
    """
    long_cap = _round_up(max_size, 32)
    # Post-resize bound: short side <= min(max(scales), max_size).
    top_short = min(max(832, _round_up(max(scales), 32)), long_cap)
    ladder = []
    for s, l in ((480, 800), (608, 1008), (736, 1216)):
        if s < top_short:
            ladder.append((s, min(l, long_cap)))
            ladder.append((min(l, long_cap), s))
    ladder.append((top_short, long_cap))
    ladder.append((long_cap, top_short))
    return tuple(ladder)


def pad_sample_to_canvas(sample: dict, bh: int, bw: int,
                         spec: BucketSpec) -> dict:
    """Pad one transformed sample's image/masks to the (bh, bw) canvas."""
    img = sample["image"]
    h, w = img.shape[:2]
    assert h <= bh and w <= bw, (h, w, bh, bw)
    # Canvas dtype follows the sample: f32 host-normalized, or u8 when
    # normalization is deferred to the device (DataConfig.device_normalize;
    # pad pixels are zeroed on-device after the normalize affine either way).
    out = np.zeros((bh, bw, 3), img.dtype)
    out[:h, :w] = img
    mask = np.ones((bh, bw), bool)
    mask[:h, :w] = False
    padded = {"image": out, "image_mask": mask}
    if spec.with_masks:
        n = len(sample.get("masks", []))
        mh, mw = bh // MASK_STRIDE, bw // MASK_STRIDE
        gm = np.zeros((spec.max_boxes, mh, mw), np.uint8)
        for i in range(min(n, spec.max_boxes)):
            m = sample["masks"][i]
            ys = (np.arange(m.shape[0] // MASK_STRIDE) * MASK_STRIDE)
            xs = (np.arange(m.shape[1] // MASK_STRIDE) * MASK_STRIDE)
            sub = m[np.ix_(ys, xs)]
            gm[i, :sub.shape[0], :sub.shape[1]] = sub
        padded["gt_masks"] = gm
    return padded


def collate(samples: Sequence[dict], spec: BucketSpec, bucket_idx: int,
            batch_size: int) -> Dict[str, np.ndarray]:
    """Samples (already same bucket) -> fixed-shape Batch dict; pads to batch_size."""
    bh, bw = spec.buckets[bucket_idx]
    B, N, T = batch_size, spec.max_boxes, spec.max_text_len
    L = spec.num_logit_cols
    img_dtype = samples[0]["image"].dtype if samples else np.float32
    batch = {
        "images": np.zeros((B, bh, bw, 3), img_dtype),
        "image_mask": np.ones((B, bh, bw), bool),
        "text_ids": np.full((B, T), 1, np.int32),
        "text_mask": np.ones((B, T), bool),
        "boxes": np.zeros((B, N, 4), np.float32),
        "labels": np.zeros((B, N), np.int64),
        "box_valid": np.zeros((B, N), bool),
        "positive_map": np.zeros((B, N, L), np.float32),
        "noun_token_spans": np.full((B, N, 2), -1, np.int32),
        "caption_noun_span": np.full((B, 2), -1, np.int32),
        "sample_valid": np.zeros((B,), bool),
        "image_id": np.zeros((B,), np.int64),
        "task_id": np.zeros((B,), np.int32),
        "orig_size": np.zeros((B, 2), np.int32),
        "size": np.zeros((B, 2), np.int32),
    }
    if spec.with_masks:
        batch["gt_masks"] = np.zeros(
            (B, N, bh // MASK_STRIDE, bw // MASK_STRIDE), np.uint8)
    for b, s in enumerate(samples):
        if b >= B:
            break
        p = pad_sample_to_canvas(s, bh, bw, spec)
        batch["images"][b] = p["image"]
        batch["image_mask"][b] = p["image_mask"]
        if spec.with_masks:
            batch["gt_masks"][b] = p["gt_masks"]
        tl = int(s["text_len"])
        tt = min(len(s["text_ids"]), T)
        batch["text_ids"][b, :tt] = s["text_ids"][:tt]
        batch["text_mask"][b, :min(tl, T)] = False
        n = min(len(s["boxes"]), N)
        if n:
            batch["boxes"][b, :n] = s["boxes"][:n]
            batch["labels"][b, :n] = s["labels"][:n]
            batch["box_valid"][b, :n] = True
            pm = s["positive_map"][:n, :L]
            batch["positive_map"][b, :n, :pm.shape[1]] = pm
            batch["noun_token_spans"][b, :n] = s["noun_token_spans"][:n]
        batch["caption_noun_span"][b] = s.get(
            "caption_noun_span", np.full(2, -1, np.int32))
        batch["sample_valid"][b] = True
        batch["image_id"][b] = s["image_id"]
        batch["task_id"][b] = s["task_id"]
        batch["orig_size"][b] = s["orig_size"]
        batch["size"][b] = s["size"]
    return batch


# Per-worker-process loader state, set once by the pool initializer (fork
# start method: the datasets are inherited by reference through the fork,
# nothing is pickled on the way in; only the loaded samples — plain numpy
# dicts — are pickled on the way back, exactly like a torch DataLoader
# worker's result queue).
_PROC_STATE: Dict[str, object] = {}


def _proc_init(datasets, seed, epoch):
    _PROC_STATE["datasets"] = datasets
    _PROC_STATE["seed"] = seed
    _PROC_STATE["epoch"] = epoch


def _proc_load(di: int, si: int, flat_idx: int):
    rng = np.random.default_rng(
        (_PROC_STATE["seed"], _PROC_STATE["epoch"], int(flat_idx)))
    return _PROC_STATE["datasets"][di].get(si, rng)


class BatchIterator:
    """Groups dataset samples into same-bucket fixed-shape batches.

    Supports multi-host data parallelism by slicing indices per process
    (`shard_id` / `num_shards`, the DistributedSampler equivalent,
    reference main.py:409).
    """

    def __init__(self, datasets: List, spec: BucketSpec, batch_size: int,
                 seed: int = 42, shuffle: bool = True, drop_last: bool = False,
                 shard_id: int = 0, num_shards: int = 1, paired: bool = False,
                 num_workers: int = 4, worker_mode: str = "thread"):
        """paired=True: datasets yield (noun, sth) pairs (distillation train,
        reference collate_fn util/misc.py:40-92); epochs then yield
        {"noun": Batch, "sth": Batch} with aligned rows.

        worker_mode: "thread" (default; PIL decode and the large numpy
        transforms release the GIL) or "process" — real worker processes
        like the reference's DataLoader(num_workers=5, main.py:415-424),
        for hosts where the Python-level transform code itself becomes the
        bottleneck. Uses the fork start method (workers inherit datasets
        and the native tokenizer state without pickling; they touch only
        numpy/PIL, never JAX). Falls back to threads where fork is
        unavailable. Batch content is identical in all modes (per-sample
        rng is keyed on (seed, epoch, index))."""
        self.datasets = datasets
        self.spec = spec
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.paired = paired
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self._index: List[Tuple[int, int]] = []
        for di, ds in enumerate(datasets):
            for si in range(len(ds)):
                self._index.append((di, si))

    def __len__(self):
        per_shard = len(self._index) // self.num_shards
        return per_shard // self.batch_size if self.drop_last else \
            -(-per_shard // self.batch_size)

    def epoch(self, epoch: int,
              num_workers: int = None) -> Iterator[Dict[str, np.ndarray]]:
        """Yield fixed-shape batches; samples are loaded/transformed by a
        thread pool (the reference's DataLoader num_workers equivalent —
        PIL decode/resize release the GIL). Ordering stays deterministic:
        futures are submitted and consumed in epoch order."""
        if num_workers is None:
            num_workers = self.num_workers
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self._index))
        if self.shuffle:
            rng.shuffle(order)
        order = order[self.shard_id::self.num_shards]

        def load(flat_idx):
            di, si = self._index[flat_idx]
            sample_rng = np.random.default_rng(
                (self.seed, epoch, int(flat_idx)))
            return self.datasets[di].get(si, sample_rng)

        mode = self.worker_mode
        if mode == "process":
            import multiprocessing as mp
            if "fork" not in mp.get_all_start_methods():
                mode = "thread"
        if num_workers > 1 and len(order):
            import collections
            if mode == "process":
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor
                pool = ProcessPoolExecutor(
                    max_workers=num_workers,
                    mp_context=mp.get_context("fork"),
                    initializer=_proc_init,
                    initargs=(self.datasets, self.seed, epoch))

                def submit(flat_idx):
                    di, si = self._index[flat_idx]
                    return pool.submit(_proc_load, di, si, int(flat_idx))
            else:
                from concurrent.futures import ThreadPoolExecutor
                pool = ThreadPoolExecutor(max_workers=num_workers)

                def submit(flat_idx):
                    return pool.submit(load, flat_idx)
            inflight = collections.deque()
            it = iter(order)

            def loaded():
                try:
                    for _ in range(num_workers * 2):
                        inflight.append(submit(next(it)))
                except StopIteration:
                    pass
                while inflight:
                    result = inflight.popleft().result()
                    try:
                        inflight.append(submit(next(it)))
                    except StopIteration:
                        pass
                    yield result
                pool.shutdown(wait=False)
            sample_lists = loaded()
        else:
            sample_lists = (load(i) for i in order)

        pending: Dict[int, List] = {}

        def emit(bi, items):
            if self.paired:
                nouns, sths = zip(*items)
                return {"noun": collate(nouns, self.spec, bi, self.batch_size),
                        "sth": collate(sths, self.spec, bi, self.batch_size)}
            return collate(items, self.spec, bi, self.batch_size)

        for samples in sample_lists:
            if self.paired:
                assert len(samples) == 2, "paired mode expects (noun, sth)"
                items = [tuple(samples)]
            else:
                items = samples
            for s in items:
                probe = s[0] if self.paired else s
                h, w = probe["image"].shape[:2]
                bi = self.spec.pick(h, w)
                if bi < 0:
                    continue  # oversized sample (shouldn't happen post-resize)
                pending.setdefault(bi, []).append(s)
                if len(pending[bi]) == self.batch_size:
                    yield emit(bi, pending.pop(bi))
        if not self.drop_last:
            for bi, rest in sorted(pending.items()):
                if rest:
                    yield emit(bi, rest)
