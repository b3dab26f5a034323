"""The comparison that decides ``correct``.

Serving: for each sampled image, the program's answer (scores sorted, the
boxes in that order, as ``Predictor.predict_batch`` returns them) against
the reference's per-query scores and boxes. The program's answers are
paired with the reference's queries by a least-cost assignment (log-odds
difference of the scores plus box L1 over the image's long side). Over the
sampled images:

- ``score_gap``: the widest log-odds difference of a pair's scores. A
  score is 1 - P(no object); random heads put every query near 1, where
  the scores differ in their fourth digit and their log-odds by about
  one, so the log-odds carry the class head, its no-object margin and
  which score belongs to which box;
- ``box_gap``: the widest image's mean box-coordinate difference over its
  long side. A mean over one image's hundreds of values is steady from
  seed to seed, where the single widest value of thousands is not; the
  widest image still catches one answer gone wrong;
- ``unsorted``: how many neighbouring answers are in rising score order,
  where the answers are to come best first (limit 0).

A number passes when it is at most its limit (``limits/<cell>.json``).
"""
from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

SERVE_NUMBERS = ("score_gap", "box_gap", "unsorted")


def log_odds(scores) -> np.ndarray:
    s = np.clip(np.asarray(scores, np.float64), 1e-12, 1.0 - 1e-12)
    return np.log(s) - np.log1p(-s)


def serve_gaps(program: Sequence[dict], ref_scores: np.ndarray,
               ref_boxes: np.ndarray, orig_sizes: np.ndarray
               ) -> Dict[str, float]:
    """program: one dict per image ({"scores" [K], "boxes" [K, 4]});
    ref_scores [N, Q], ref_boxes [N, Q, 4] (absolute xyxy); orig_sizes
    [N, 2] (h, w). Returns the ``SERVE_NUMBERS``; a missing, misshapen or
    non-finite answer reads inf in each."""
    bad = {k: float("inf") for k in SERVE_NUMBERS}
    if len(program) != len(ref_scores):
        return bad
    score, box, unsorted = 0.0, 0.0, 0
    for res, rs, rb, hw in zip(program, ref_scores, ref_boxes, orig_sizes):
        ps = np.asarray(res["scores"], np.float64)
        pb = np.asarray(res["boxes"], np.float64)
        if ps.shape != rs.shape or pb.shape != rb.shape:
            return bad
        if not (np.isfinite(ps).all() and np.isfinite(pb).all()):
            return bad
        side = float(max(hw))
        lp, lr = log_odds(ps), log_odds(rs)
        cost = (np.abs(lp[:, None] - lr[None, :])
                + np.abs(pb[:, None, :] - rb[None, :, :]).sum(-1) / side)
        r, c = linear_sum_assignment(cost)
        score = max(score, float(np.abs(lp[r] - lr[c]).max()))
        box = max(box, float(np.abs(pb[r] - rb[c]).mean() / side))
        unsorted += int((np.diff(ps) > 0).sum())
    return {"score_gap": score, "box_gap": box, "unsorted": float(unsorted)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> List[dict]:
    """[{"name", "value", "limit", "ok"}] for every limited number; a
    number the run did not produce fails."""
    out = []
    for name, limit in limits.items():
        value = numbers.get(name, float("inf"))
        ok = bool(np.isfinite(value) and value <= limit)
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return out


def print_judgement(rows: List[dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for r in rows:
        print(f"check {r['name']} {r['value']!r} limit {r['limit']!r} "
              f"{'ok' if r['ok'] else 'FAIL'}", file=sys.stderr, flush=True)
