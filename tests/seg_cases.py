"""Inputs shared by the port's segmentation tests on the CPU
(tests/test_torch_segmentation.py) and on the card
(tests/test_torch_cuda.py): a seeded seg training batch, mask logits for
each path of the device mask postprocess, and the RLE comparison that
allows knife-edge pixels. Imports nothing of the JAX package (the card's
machine cannot run it)."""
import numpy as np

from toist_tpu_torch.models import postprocess as ppost
from toist_tpu_torch.ops import rle

B, H, W, T, N, C = 2, 96, 128, 16, 4, 256
VOCAB = 600
KNIFE = 1e-5


def seg_batch(seed=9):
    """Two samples on a 96x128 canvas (the second padded), targets with GT
    masks at stride 4, the second sample's targets fewer."""
    rng = np.random.default_rng(seed)
    batch = {"images": rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8),
             "image_mask": np.zeros((B, H, W), bool),
             "text_ids": np.full((B, T), 1, np.int32),
             "text_mask": np.ones((B, T), bool),
             "boxes": np.zeros((B, N, 4), np.float32),
             "box_valid": np.zeros((B, N), bool),
             "positive_map": np.zeros((B, N, C), np.float32),
             "sample_valid": np.ones((B,), bool),
             "gt_masks": np.zeros((B, N, H // 4, W // 4), np.uint8),
             "orig_size": np.asarray([[H, W], [80, 96]], np.int32)}
    batch["image_mask"][1, 80:] = True
    batch["image_mask"][1, :, 96:] = True
    for i, k in enumerate((3, 2)):
        batch["text_ids"][i, :6 + i] = rng.integers(3, VOCAB, 6 + i)
        batch["text_mask"][i, :6 + i] = False
        for j in range(k):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            w, h = rng.uniform(0.15, 0.4, 2)
            batch["boxes"][i, j] = [cx, cy, w, h]
            batch["box_valid"][i, j] = True
            batch["positive_map"][i, j, 1 + j:3 + j] = 0.5
            y0, y1 = int((cy - h / 2) * H / 4), int((cy + h / 2) * H / 4)
            x0, x1 = int((cx - w / 2) * W / 4), int((cx + w / 2) * W / 4)
            batch["gt_masks"][i, j, y0:y1, x0:x1] = 1
    return batch


def blob_logits(rng, b, q, h, w):
    """Smooth logits: one or two Gaussian blobs per mask (few transitions
    per column, the transitions path)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((b, q, h, w), -4.0, np.float32)
    for i in range(b):
        for j in range(q):
            for _ in range(1 + (i + j) % 2):
                cy, cx = rng.uniform(0, h), rng.uniform(0, w)
                s = rng.uniform(1.5, 4.0)
                out[i, j] += 8.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                          / (2 * s * s))
    return out


def postprocess_case(name):
    """(logits [4,3,40,48], sizes, orig_sizes, valid) for each case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    bq = (4, 3, 40, 48)
    blobs = blob_logits(rng, *bq)
    salt = rng.normal(size=bq).astype(np.float32)
    logits = {"blobs": blobs, "salt": salt, "invalid": blobs,
              "oversized": salt}.get(name)
    if name == "mixed":
        logits = np.concatenate([blobs[:2], salt[2:]])
    sizes = np.asarray([[160, 192], [150, 180], [160, 160], [100, 192]],
                       np.int32)
    orig = np.asarray([[480, 600], [333, 401], [640, 640], [97, 311]],
                      np.int32)
    if name == "oversized":
        orig[1] = [700, 500]
    valid = np.array([True, True, name != "invalid", True])
    return logits, sizes, orig, valid


def interp64(logits, size, orig, stride=4):
    """One sample's [Q, oh, ow] bilinear logits in float64, with the
    two-tap vectors the device path uses."""
    ch, cw = max(1, size[0] // stride), max(1, size[1] // stride)
    iy0, iy1, ly0, ly1 = (np.asarray(a, np.float64 if a.dtype.kind == "f"
                                     else np.int64)
                          for a in ppost._interp_vectors(int(orig[0]), ch))
    ix0, ix1, lx0, lx1 = (np.asarray(a, np.float64 if a.dtype.kind == "f"
                                     else np.int64)
                          for a in ppost._interp_vectors(int(orig[1]), cw))
    m = logits.astype(np.float64)
    rows = m[:, iy0] * ly0[None, :, None] + m[:, iy1] * ly1[None, :, None]
    return rows[:, :, ix0] * lx0 + rows[:, :, ix1] * lx1


def assert_rles_agree(got, want, logits, sizes, orig, valid):
    """Equal RLE strings, or masks that differ only at knife-edge pixels."""
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        if not valid[b]:
            assert g is None and w is None
            continue
        assert len(g) == len(w)
        near = None
        for q, (rg, rw) in enumerate(zip(g, w)):
            assert rg["size"] == rw["size"] == [int(orig[b][0]),
                                                 int(orig[b][1])]
            if rg["counts"] == rw["counts"]:
                continue
            if near is None:
                near = np.abs(interp64(logits[b], sizes[b], orig[b])) < KNIFE
            diff = rle.decode(rg) != rle.decode(rw)
            assert not (diff & ~near[q]).any(), (b, q, int(diff.sum()))
