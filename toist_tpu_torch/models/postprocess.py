"""Output postprocessing to absolute-coordinate detections and COCO RLE
masks.

Counterpart of ``toist_tpu/models/postprocess.py``:

- ``postprocess_boxes``: score = 1 - P(no-object) from the softmax over the
  logit columns, every label 1, boxes cxcywh -> xyxy scaled by the original
  (unpadded) image size;
- the reference's PostProcessSegm (postprocessors.py:59-109): each valid
  sample's stride-4 mask logits cropped to its unpadded size, resized
  bilinearly (torch ``F.interpolate`` semantics, half-pixel centres) to the
  original size, thresholded at sigmoid 0.5 and RLE-encoded.
  ``start_masks_device`` / ``finish_masks_device`` resize, threshold,
  bit-pack and extract the per-column RLE transitions with torch ops on the
  logits' device, on a canvas sized to the batch's largest original, and
  the host assembles the RLEs. The JAX package runs this part in XLA, not
  Pallas, so it has no kernel of its own here. Its jitted version needs a
  static canvas (640x640) and sends a batch with a larger original to a
  PIL host path; here every batch of the eval stays on the device, and
  such a batch gives the same RLEs except at pixels whose logit lies at
  the threshold;
- ``postprocess_masks_host``: that PIL host path, which ``visualize``
  draws its masks from, as the JAX package's does. PIL's bilinear equals
  ``F.interpolate`` on upscales (the stride-4 logits to the original) and
  antialiases on downscales, where a few pixels of a mask differ from the
  device path's.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from toist_tpu_torch.ops import box_ops
from toist_tpu_torch.ops import rle as rle_ops
from toist_tpu_torch.utils.transfer import finish_to_host, start_to_host

# The mask logits' stride on the padded canvas.
MASK_STRIDE = 4
# Per column, the transitions that leave the device as positions; a sample
# with a column past this takes its packed bits.
MAX_COL_TRANSITIONS = 8
# Pixels of the output canvas per pass over a chunk of queries (the JAX
# package's fixed canvas for a batch of 4 x 100 queries): a pass holds about
# 15 bytes per pixel, so a batch of large originals is resized in chunks.
MAX_CHUNK_PIXELS = 4 * 100 * 640 * 640


def postprocess_boxes(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                      orig_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B,Q,C] logits, [B,Q,4] cxcywh, [B,2] (h,w) -> scores/labels/boxes."""
    prob = torch.softmax(pred_logits.float(), dim=-1)
    scores = 1.0 - prob[..., -1]
    labels = torch.ones(scores.shape, dtype=torch.int32,
                        device=scores.device)
    boxes = box_ops.box_cxcywh_to_xyxy(pred_boxes)
    h = orig_sizes[:, 0].float()
    w = orig_sizes[:, 1].float()
    scale = torch.stack([w, h, w, h], dim=1)[:, None, :]
    return {"scores": scores, "labels": labels, "boxes": boxes * scale}


def _interp_matrix(o: int, s: int, transpose: bool = False) -> np.ndarray:
    """Bilinear-interpolation matrix W with W @ v resampling length-s
    signals to length o: torch ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=False)``, the reference's PostProcessSegm
    interpolation (postprocessors.py:98-104), as a dense [o, s] matrix of
    two taps per row (``_interp_vectors``'s arithmetic)."""
    i0, i1, w0, w1 = _interp_vectors(o, s)
    W = np.zeros((o, s), np.float32)
    W[np.arange(o), i0] += w0
    W[np.arange(o), i1] += w1
    return W.T if transpose else W


def _bilinear_resize_qhw(m: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize of [Q, h, w] -> [Q, oh, ow] with ``F.interpolate``'s
    arithmetic (``_interp_matrix``)."""
    _, h, w = m.shape
    return _interp_matrix(oh, h) @ m @ _interp_matrix(ow, w, transpose=True)


def postprocess_masks_host(pred_masks, sizes, orig_sizes, sample_valid):
    """Host PostProcessSegm (reference postprocessors.py:59-109), the JAX
    package's ``postprocess_masks_host``: per valid sample, each query's
    stride-4 logits cropped to the unpadded size, resized to the original
    by PIL bilinear, thresholded at sigmoid 0.5 (logit 0) and RLE-encoded.
    PIL resizes one mask in a fraction of the time two-tap gathers or
    ``_bilinear_resize_qhw`` take on a CPU; on an upscale it has
    ``F.interpolate``'s half-pixel arithmetic, on a downscale it
    antialiases. pred_masks: [B, Q, h4, w4] logits on any device; returns
    per-sample lists of RLE dicts (None for invalid samples)."""
    from PIL import Image

    if isinstance(pred_masks, torch.Tensor):
        pred_masks = pred_masks.detach().float().cpu().numpy()
    pred_masks = np.asarray(pred_masks, dtype=np.float32)
    out = []
    for b in range(pred_masks.shape[0]):
        if not sample_valid[b]:
            out.append(None)
            continue
        ih, iw = int(sizes[b][0]), int(sizes[b][1])
        oh, ow = int(orig_sizes[b][0]), int(orig_sizes[b][1])
        ch, cw = max(1, ih // MASK_STRIDE), max(1, iw // MASK_STRIDE)
        rles = []
        for q in range(pred_masks.shape[1]):
            img = Image.fromarray(
                np.ascontiguousarray(pred_masks[b, q, :ch, :cw]), mode="F")
            m_up = np.asarray(img.resize((ow, oh), Image.BILINEAR))
            rles.append(rle_ops.encode((m_up > 0.0).astype(np.uint8)))
        out.append(rles)
    return out


def _interp_vectors(o: int, s: int):
    """Bilinear resampling of length-s signals to length o as two taps: per
    output position, source indices (i0, i1) and weights (1-lam, lam). The
    arithmetic of torch ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=False)``, the reference's PostProcessSegm
    interpolation (postprocessors.py:98-104): half-pixel source centres
    computed in float32, clamped at 0, replicate border."""
    scale = np.float32(s) / np.float32(o)
    src = np.maximum(
        (np.arange(o, dtype=np.float32) + np.float32(0.5)) * scale
        - np.float32(0.5), np.float32(0.0))
    i0 = src.astype(np.int32)
    i1 = np.minimum(i0 + 1, s - 1)
    lam = (src - i0).astype(np.float32)
    return i0, i1, np.float32(1.0) - lam, lam


def _device_resize_threshold(pred_masks: torch.Tensor, iy0, iy1, ly0, ly1,
                             ix0, ix1, lx0, lx1, oh_arr, ow_arr):
    """[B,Q,h4,w4] logits x per-sample two-tap bilinear gathers -> packed
    binary masks AND their per-column RLE transitions, on the logits'
    device.

    iy*/ly* are [B, OH] row indices / weights (OH a multiple of 8), ix*/lx*
    [B, OW]; weights are zero beyond each sample's (oh, ow) crop, so
    out-of-crop pixels threshold to 0. The rows are resized first, then the
    columns, emitted x-major ([B,Q,OW,OH]: COCO's column-major RLE stream).
    The threshold is sigmoid 0.5, i.e. logit 0; 8 pixels per byte, MSB
    first, column-major.

    Transitions: at column x, row y, bits[y, x] differs from the previous
    stream element, which is bits[y-1, x] within a column, bits[oh-1, x-1]
    (the last VALID row of the column before) at a column wrap, and a
    virtual 0 before the stream starts. Per column the first
    ``MAX_COL_TRANSITIONS`` such positions and the count go out as uint16
    (trained masks are blobs with 2-4 per column); a sample with any column
    past that is flagged in ``overflow`` and its packed bits are used
    instead. oh_arr / ow_arr are [B] crop sizes (ow 0 for an invalid
    sample).

    Returns (packed uint8 [B,Q,OW,OH/8], pos uint16 [B,Q,OW,kc],
             cnt uint16 [B,Q,OW], overflow bool [B]).
    """
    m = pred_masks.float()
    B, Q, h4, w4 = m.shape
    OH, OW = iy0.shape[1], ix0.shape[1]
    kc = MAX_COL_TRANSITIONS

    def lerp(x, i0, i1, l0, l1, n):
        # Two taps along dim 2 of x [B,Q,*,m]: x[i0] * l0 + x[i1] * l1.
        shape = (B, Q, n, x.shape[3])
        a = torch.gather(x, 2, i0.long()[:, None, :, None].expand(shape))
        b = torch.gather(x, 2, i1.long()[:, None, :, None].expand(shape))
        return a * l0[:, None, :, None] + b * l1[:, None, :, None]

    rows = lerp(m, iy0, iy1, ly0, ly1, OH)                  # [B,Q,OH,w4]
    rows = rows.transpose(2, 3).contiguous()                # [B,Q,w4,OH]
    full = lerp(rows, ix0, ix1, lx0, lx1, OW)               # [B,Q,OW,OH]
    del rows
    bits = (full > 0.0).to(torch.uint8)
    del full
    groups = bits.view(B, Q, OW, OH // 8, 8)
    packed = groups[..., 0] << 7
    for k in range(1, 8):
        packed |= groups[..., k] << (7 - k)

    dev = bits.device
    y_valid = (torch.arange(OH, device=dev)[None, :]
               < oh_arr[:, None])[:, None, None, :]         # [B,1,1,OH]
    x_valid = (torch.arange(OW, device=dev)[None, :]
               < ow_arr[:, None])[:, None, :, None]         # [B,1,OW,1]
    last_idx = (oh_arr - 1).clamp(min=0).long()
    last_row = torch.gather(bits, 3, last_idx[:, None, None, None].expand(
        B, Q, OW, 1))                                       # [B,Q,OW,1]
    prev_col_last = torch.cat([bits.new_zeros(B, Q, 1, 1),
                               last_row[:, :, :-1]], dim=2)
    prev = torch.cat([prev_col_last, bits[..., :-1]], dim=3)
    t = (bits != prev) & y_valid & x_valid                  # [B,Q,OW,OH]
    del prev
    rank = torch.cumsum(t.to(torch.int32), dim=-1, dtype=torch.int32)
    cnt = rank[..., -1]                                     # [B,Q,OW]
    # The r-th transition (r = 1..kc) is the first row whose rank reaches
    # r: rank is non-decreasing along the column.
    want = torch.arange(1, kc + 1, dtype=torch.int32, device=dev).expand(
        B, Q, OW, kc).contiguous()
    pos = torch.searchsorted(rank, want)
    pos = torch.where(want <= cnt[..., None], pos, 0)
    overflow = (cnt > kc).flatten(1).any(dim=1)             # [B]
    return packed, pos.to(torch.uint16), cnt.to(torch.uint16), overflow


@torch.no_grad()
def start_masks_device(pred_masks: torch.Tensor, sizes, orig_sizes,
                       sample_valid) -> dict:
    """Phase 1 of the device PostProcessSegm: queue the batched resize +
    threshold + transition extraction on the logits' device, on a canvas of
    the batch's largest original (its height rounded up to 8), and start
    the copies of the per-column transitions to the host without blocking
    (``utils/transfer.start_to_host``). Returns a handle for
    ``finish_masks_device``; between the two calls the caller queues the
    next batch's forward (``train/engine.evaluate``), so the copies and the
    host's work overlap the device's. The packed bits stay on the device
    until ``finish_masks_device`` knows which samples overflowed."""
    orig_sizes = np.asarray(orig_sizes)
    sizes = np.asarray(sizes)
    sample_valid = np.asarray(sample_valid)
    B, Q, h4, w4 = pred_masks.shape
    crops = [(int(orig_sizes[b][0]), int(orig_sizes[b][1]))
             if sample_valid[b] else (1, 0) for b in range(B)]
    OH = (max([8] + [oh for oh, _ in crops]) + 7) // 8 * 8
    OW = max([1] + [ow for _, ow in crops])
    iy0 = np.zeros((B, OH), np.int32)
    iy1 = np.zeros((B, OH), np.int32)
    ly0 = np.zeros((B, OH), np.float32)
    ly1 = np.zeros((B, OH), np.float32)
    ix0 = np.zeros((B, OW), np.int32)
    ix1 = np.zeros((B, OW), np.int32)
    lx0 = np.zeros((B, OW), np.float32)
    lx1 = np.zeros((B, OW), np.float32)
    for b, (oh, ow) in enumerate(crops):
        if not sample_valid[b]:
            continue
        ch = max(1, int(sizes[b][0]) // MASK_STRIDE)
        cw = max(1, int(sizes[b][1]) // MASK_STRIDE)
        # Positions beyond the (oh, ow) crop keep zero weights (threshold to
        # 0); source indices beyond the (ch, cw) crop are never referenced.
        iy0[b, :oh], iy1[b, :oh], ly0[b, :oh], ly1[b, :oh] = \
            _interp_vectors(oh, ch)
        ix0[b, :ow], ix1[b, :ow], lx0[b, :ow], lx1[b, :ow] = \
            _interp_vectors(ow, cw)
    dev = pred_masks.device
    cuda = dev.type == "cuda"
    events = None
    if cuda:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()

    def put(a):
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) if cuda else t

    vecs = [put(a) for a in (iy0, iy1, ly0, ly1, ix0, ix1, lx0, lx1)]
    crop = [put(np.asarray(c, np.int64)) for c in zip(*crops)]
    qc = max(1, min(Q, MAX_CHUNK_PIXELS // (B * OH * OW)))
    parts = [_device_resize_threshold(pred_masks[:, q:q + qc], *vecs, *crop)
             for q in range(0, Q, qc)]
    packed, pos, cnt = (torch.cat([p[i] for p in parts], dim=1)
                        for i in range(3))
    overflow = torch.stack([p[3] for p in parts]).any(dim=0)
    if cuda:
        events[1].record()
    return {"packed": packed, "events": events, "orig_sizes": orig_sizes,
            "sample_valid": sample_valid, "Q": Q,
            "copies": start_to_host({"pos": pos, "cnt": cnt,
                                     "overflow": overflow})}


def finish_masks_device(handle: dict, timings: Optional[dict] = None):
    """Phase 2: wait for the transition copies started by
    ``start_masks_device`` and assemble COCO RLEs on the host: the
    uncompressed RLE counts are the diffs of the column-major transition
    positions (``rle.encode_from_counts``). A sample that overflowed the
    per-column cap takes its packed bits instead
    (``rle.encode_packed_cm``): only those samples' bits are copied, or the
    whole tensor in one copy when every valid sample overflowed. Returns
    per-sample lists of RLE dicts (None for invalid samples).

    ``timings``, when given, receives: "device_ms" (CUDA events around the
    device work; absent off the card), "copy_ms" (host wait for the copies
    and the packed pull), "host_rle_ms", "packed_mb" (bytes copied) and
    "n_overflow_samples"."""
    t0 = time.perf_counter()
    host = finish_to_host(handle["copies"])
    overflow, pos, cnt = host["overflow"], host["pos"], host["cnt"]
    transferred = pos.nbytes + cnt.nbytes + overflow.nbytes
    orig_sizes, sample_valid = handle["orig_sizes"], handle["sample_valid"]
    Q = handle["Q"]
    packed = {}
    need = [b for b in range(len(sample_valid))
            if sample_valid[b] and overflow[b]]
    if need and len(need) == int(sample_valid.sum()):
        whole = handle["packed"].cpu().numpy()
        transferred += whole.nbytes
        packed = {b: whole[b] for b in need}
    else:
        for b in need:
            packed[b] = handle["packed"][b].cpu().numpy()
            transferred += packed[b].nbytes
    t1 = time.perf_counter()
    out = []
    for b in range(len(sample_valid)):
        if not sample_valid[b]:
            out.append(None)
            continue
        oh, ow = int(orig_sizes[b][0]), int(orig_sizes[b][1])
        if b in packed:
            out.append([rle_ops.encode_packed_cm(packed[b][q], oh, ow)
                        for q in range(Q)])
            continue
        rles = []
        n_pix = oh * ow
        xs_full = np.arange(ow, dtype=np.int64) * oh
        for q in range(Q):
            c = cnt[b, q, :ow].astype(np.int64)
            ks = np.arange(MAX_COL_TRANSITIONS,
                           dtype=np.int64)[None, :] < c[:, None]
            ys = pos[b, q, :ow][ks].astype(np.int64)
            trans = np.repeat(xs_full, c) + ys
            counts = np.diff(np.concatenate(([0], trans, [n_pix])))
            rles.append(rle_ops.encode_from_counts(counts, oh, ow))
        out.append(rles)
    if timings is not None:
        events = handle["events"]
        if events is not None:
            timings["device_ms"] = events[0].elapsed_time(events[1])
        timings["copy_ms"] = (t1 - t0) * 1e3
        timings["host_rle_ms"] = (time.perf_counter() - t1) * 1e3
        timings["packed_mb"] = transferred / 1e6
        timings["n_overflow_samples"] = len(packed)
    return out


def postprocess_masks_device(pred_masks: torch.Tensor, sizes, orig_sizes,
                             sample_valid, timings: Optional[dict] = None):
    """Device-side PostProcessSegm: ``start_masks_device`` then
    ``finish_masks_device`` (use those two directly to overlap the copies
    with the next batch's work, as ``train/engine.evaluate`` does).
    pred_masks: [B, Q, h4, w4] logits at stride 4 on the padded canvas;
    sizes / orig_sizes: [B, 2] (h, w) unpadded and original; returns
    per-sample lists of RLE dicts (None for invalid samples)."""
    handle = start_masks_device(pred_masks, sizes, orig_sizes, sample_valid)
    return finish_masks_device(handle, timings=timings)
