"""COCO mask RLE API over the C++ core (replacement for pycocotools.mask).

The port's own copy of ``toist_tpu/ops/rle.py``, kept line for line so that it
diffs against it (the port imports nothing of the JAX package).

The reference calls pycocotools' C extension for polygon decode at data-load
time (datasets/tdod.py:133-147) and RLE encode at eval time
(datasets/coco_eval.py:256-288). pycocotools is not present in this image at
all, so this module IS the framework's mask codec. The dict format matches
COCO: {"size": [h, w], "counts": bytes} with the standard compressed string.
"""
from __future__ import annotations

from typing import List, Sequence

import ctypes
import numpy as np

from toist_tpu_torch import native


def _lib():
    return native.load()


def _as_u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def encode(mask: np.ndarray) -> dict:
    """Binary mask [H, W] (any integer/bool dtype) -> RLE dict."""
    h, w = mask.shape
    m = np.asfortranarray(mask, dtype=np.uint8)
    flat = np.ascontiguousarray(m.reshape(-1, order="F"))
    counts = np.empty(h * w + 1, np.uint32)
    n = _lib().rle_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        _as_u32p(counts))
    s = ctypes.create_string_buffer(int(n) * 7 + 1)
    _lib().rle_to_string(_as_u32p(counts), n, s)
    return {"size": [int(h), int(w)], "counts": s.value}


def encode_packed_cm(packed: np.ndarray, oh: int, ow: int) -> dict:
    """Column-major bit-packed mask [n_cols, col_bytes] (8 rows/byte,
    MSB-first; columns padded to the canvas height) -> RLE dict for the
    (oh, ow) crop. The packed layout comes straight off the device
    (models/postprocess._device_resize_threshold); no unpackbits/transpose.
    """
    packed = np.ascontiguousarray(packed, np.uint8)
    n_cols, col_bytes = packed.shape
    assert ow <= n_cols and oh <= col_bytes * 8, (oh, ow, packed.shape)
    counts = np.empty(oh * ow + 1, np.uint32)
    n = _lib().rle_encode_packed_cm(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), col_bytes,
        oh, ow, _as_u32p(counts))
    s = ctypes.create_string_buffer(int(n) * 7 + 1)
    _lib().rle_to_string(_as_u32p(counts), n, s)
    return {"size": [int(oh), int(ow)], "counts": s.value}


def encode_from_counts(counts: np.ndarray, oh: int, ow: int) -> dict:
    """Uncompressed RLE counts (alternating 0-run/1-run lengths, column-major,
    first run counts zeros) -> RLE dict with the standard compressed string.
    Used by the device postprocess transitions path
    (models/postprocess.finish_masks_device), where the counts come straight
    off the device as diffs of transition positions."""
    counts = np.ascontiguousarray(np.asarray(counts, np.uint32))
    s = ctypes.create_string_buffer(len(counts) * 7 + 1)
    _lib().rle_to_string(_as_u32p(counts), len(counts), s)
    return {"size": [int(oh), int(ow)], "counts": s.value}


def decode(rle: dict) -> np.ndarray:
    """RLE dict -> binary mask [H, W] uint8."""
    h, w = rle["size"]
    counts = _counts(rle)
    out = np.zeros(h * w, np.uint8)
    _lib().rle_decode(_as_u32p(counts), len(counts), h, w,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.reshape((h, w), order="F")


def _counts(rle: dict) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        if isinstance(c, str):
            c = c.encode()
        buf = np.empty(rle["size"][0] * rle["size"][1] + 2, np.uint32)
        n = _lib().rle_from_string(c, _as_u32p(buf), len(buf))
        if n < 0:
            raise ValueError("bad RLE string")
        return np.ascontiguousarray(buf[:n])
    return np.ascontiguousarray(np.asarray(c, np.uint32))


def area(rle: dict) -> int:
    counts = _counts(rle)
    return int(_lib().rle_area(_as_u32p(counts), len(counts)))


def iou(dts: Sequence[dict], gts: Sequence[dict],
        iscrowd: Sequence[int]) -> np.ndarray:
    """Pairwise IoU matrix [len(dts), len(gts)] (pycocotools.mask.iou shape)."""
    out = np.zeros((len(dts), len(gts)), np.float64)
    dcs = [_counts(d) for d in dts]
    gcs = [_counts(g) for g in gts]
    for i, dc in enumerate(dcs):
        for j, gc in enumerate(gcs):
            out[i, j] = _lib().rle_iou(
                _as_u32p(dc), len(dc), _as_u32p(gc), len(gc),
                int(iscrowd[j]) if j < len(iscrowd) else 0)
    return out


def merge(rles: Sequence[dict], intersect: bool = False) -> dict:
    if not rles:
        raise ValueError("merge of empty list")
    h, w = rles[0]["size"]
    acc = _counts(rles[0])
    for r in rles[1:]:
        nxt = _counts(r)
        out = np.empty(len(acc) + len(nxt) + 2, np.uint32)
        n = _lib().rle_merge(_as_u32p(acc), len(acc), _as_u32p(nxt), len(nxt),
                             int(intersect), _as_u32p(out))
        acc = np.ascontiguousarray(out[:n])
    s = ctypes.create_string_buffer(len(acc) * 7 + 1)
    _lib().rle_to_string(_as_u32p(acc), len(acc), s)
    return {"size": [int(h), int(w)], "counts": s.value}


def frPyObjects(pyobj, h: int, w: int):
    """Polygons / uncompressed RLE / bbox -> RLE dict(s), pycocotools-style."""
    if isinstance(pyobj, dict) and "counts" in pyobj:
        if isinstance(pyobj["counts"], list):  # uncompressed RLE
            counts = np.asarray(pyobj["counts"], np.uint32)
            s = ctypes.create_string_buffer(len(counts) * 7 + 1)
            _lib().rle_to_string(_as_u32p(counts), len(counts), s)
            return {"size": [int(h), int(w)], "counts": s.value}
        return pyobj
    if isinstance(pyobj, (list, tuple)) and len(pyobj) and \
            isinstance(pyobj[0], (list, tuple, np.ndarray)):
        return [frPyObjects(p, h, w) for p in pyobj]
    # single polygon: flat [x0,y0,...]
    poly = np.ascontiguousarray(np.asarray(pyobj, np.float64))
    mask = np.zeros(h * w, np.uint8)
    _lib().poly_to_mask(
        poly.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(poly) // 2, h, w,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return encode(mask.reshape((h, w), order="F"))


def polygons_to_mask(polygons: List[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Union of polygons -> binary mask [H, W] (datasets/tdod.py:133-147 path)."""
    mask = np.zeros(h * w, np.uint8)
    for poly in polygons:
        p = np.ascontiguousarray(np.asarray(poly, np.float64))
        _lib().poly_to_mask(
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(p) // 2, h, w,
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return mask.reshape((h, w), order="F")
