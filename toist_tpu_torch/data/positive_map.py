"""Soft token-alignment (positive map) construction.

The port's own copy of ``toist_tpu/data/positive_map.py``, kept line for line so that it
diffs against it (the port imports nothing of the JAX package).

Reference: create_positive_map at reference datasets/tdod.py:150-176 — for each box,
a 256-wide row with uniform mass over the caption token span(s) covering the box's text,
using char_to_token with +-1/2/3-char probing when a char lands on trimmed whitespace.

Runs entirely on the host at dataset-build time (SURVEY.md §7 hard part 7): the device
only ever sees the precomputed [num_boxes, 256] rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from toist_tpu_torch.data.tokenizer import Tokenized


def _probe_begin(tok: Tokenized, beg: int) -> Optional[int]:
    pos = tok.char_to_token(beg)
    if pos is None:
        pos = tok.char_to_token(beg + 1)
        if pos is None:
            pos = tok.char_to_token(beg + 2)
    return pos


def _probe_end(tok: Tokenized, end: int) -> Optional[int]:
    pos = tok.char_to_token(end - 1)
    if pos is None:
        pos = tok.char_to_token(end - 2)
        if pos is None:
            pos = tok.char_to_token(end - 3)
    return pos


def token_span(tok: Tokenized, beg: int, end: int) -> Optional[Tuple[int, int]]:
    """Char span [beg, end) -> inclusive token span (beg_pos, end_pos), or None."""
    beg_pos = _probe_begin(tok, beg)
    end_pos = _probe_end(tok, end)
    if beg_pos is None or end_pos is None:
        return None
    return beg_pos, end_pos


def create_positive_map(tok: Tokenized,
                        tokens_positive: Sequence[List[List[int]]],
                        num_cols: int = 256) -> np.ndarray:
    """[num_boxes, num_cols] rows normalized to sum ~1 (or 0 if span missing)."""
    pm = np.zeros((len(tokens_positive), num_cols), np.float32)
    for j, spans in enumerate(tokens_positive):
        for beg, end in spans:
            ts = token_span(tok, beg, end)
            if ts is None:
                continue
            b, e = ts
            pm[j, b:min(e + 1, num_cols)] = 1.0
    return pm / (pm.sum(-1, keepdims=True) + 1e-6)
