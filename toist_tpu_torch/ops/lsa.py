"""Exact linear-sum assignment for batches of small cost matrices: the
hand-written CUDA solver (``csrc/lsa.cu``), its wrapper and its plain
version.

Counterpart of ``toist_tpu/ops/lsa.py`` (``solve_lsa`` / ``solve_lsa_batch``,
the vmapped XLA solver) and ``toist_tpu/ops/lsa_pallas.py``
(``solve_lsa_batch_pallas``), with their contract: cost [B, R, C] f32 with
R <= C, n_rows [B] -> col4row [B, R] int32, the column of each of the first
n_rows rows and -1 on the rows past it. The algorithm is lsa.py's step for
step (non-finite sanitisation, row-reduction warm start, one shortest
augmenting path per row the warm start left unmatched), so assignments equal
the JAX solver's exactly, ties included; the scan's exit is the Pallas
kernel's ``_CUT`` reachability test.

``solve_lsa_batch`` dispatches on where its inputs lie: CPU tensors go to
``solve_lsa_batch_plain`` (numpy, f32 arithmetic in lsa.py's order); CUDA
tensors launch the kernel (one warp per problem) or raise.
``solve_lsa_batch.launches`` counts kernel launches. ``lsa_scan_steps``
counts the dependent steps of each problem's solve, the quantity that sets
the kernel's time; ``softkd_like_costs`` makes problems shaped like
distillation's softkd re-pairing for tests and timing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from toist_tpu_torch.ops import box_ops

KERNEL_SOURCE = "lsa.cu"
_BIG = np.float32(1e30)   # tentative distance of an unreached column
_CUT = np.float32(5e29)   # minval >= _CUT: no unscanned column is reachable
MAX_SMEM_BYTES = 227 * 1024


def _solve_one(cost: np.ndarray, n: int) -> tuple:
    """One [R, C] f32 problem, first ``n`` rows -> (col4row [R] int32, the
    number of dependent steps: scan steps of every augmenting path plus the
    hops of every path walk)."""
    R, C = cost.shape
    finite = np.isfinite(cost)
    big = (np.where(finite, np.abs(cost), np.float32(0)).max()
           + np.float32(1.0)) * np.float32(R + 1)
    cost = np.where(finite, cost, big).astype(np.float32)

    rows = np.arange(R)
    valid = rows < n
    best = np.argmin(cost, axis=1)
    u = np.where(valid, cost.min(axis=1), np.float32(0)).astype(np.float32)
    v = np.zeros(C, np.float32)
    row4col = np.full(C, -1, np.int64)
    for r in range(n - 1, -1, -1):          # the lowest claiming row wins
        row4col[best[r]] = r
    col4row = np.where(valid & (row4col[best] == rows), best, -1)

    steps = 0
    for cur in range(n):
        if col4row[cur] >= 0:
            continue
        shortest = np.full(C, _BIG, np.float32)
        path = np.full(C, -1, np.int64)
        sc = np.zeros(C, bool)
        sr = np.zeros(R, bool)
        i, sink, minval = cur, -1, np.float32(0)
        while sink < 0 and minval < _CUT:
            steps += 1
            sr[i] = True
            r = minval + cost[i] - u[i] - v
            better = ~sc & (r < shortest)
            path[better] = i
            shortest[better] = r[better]
            masked = np.where(sc, _BIG, shortest)
            j = int(np.argmin(masked))
            minval = masked[j]
            sc[j] = True
            free = row4col[j] < 0 and minval < _CUT
            sink = j if free else -1
            i = i if free else int(row4col[j])
        if sink < 0:
            continue                         # unreachable: leave cur at -1
        other = sr & (rows != cur)
        u[cur] = u[cur] + minval
        u[other] = u[other] + minval - shortest[col4row[other]]
        v[sc] = v[sc] - (minval - shortest[sc])
        j = sink
        for _ in range(R + 1):
            steps += 1
            r_ = int(path[j])
            row4col[j] = r_
            prev = int(col4row[r_])
            col4row[r_] = j
            if r_ == cur:
                break
            j = prev
    return np.where(valid, col4row, -1).astype(np.int32), steps


def solve_lsa_batch_plain(cost: torch.Tensor, n_rows: torch.Tensor
                          ) -> torch.Tensor:
    """The plain version: lsa.py's algorithm in numpy, one problem at a
    time. cost [B, R, C], n_rows [B] -> col4row [B, R] int32 on cost's
    device."""
    c = cost.detach().to("cpu", torch.float32).numpy()
    n = n_rows.detach().cpu().numpy()
    out = np.stack([_solve_one(c[b], int(n[b]))[0]
                    for b in range(c.shape[0])])
    return torch.from_numpy(out).to(cost.device)


def lsa_scan_steps(cost: torch.Tensor, n_rows: torch.Tensor) -> np.ndarray:
    """The dependent steps of each problem's solve, [B] int64: the scan
    steps (one relaxation and arg-min each) of every augmenting path plus
    the hops of every path walk, counted by the plain version's own loop.
    A batch's problems run concurrently on the card, so the largest count
    sets the kernel's time."""
    c = cost.detach().to("cpu", torch.float32).numpy()
    n = n_rows.detach().cpu().numpy()
    return np.array([_solve_one(c[b], int(n[b]))[1]
                     for b in range(c.shape[0])], np.int64)


def softkd_like_costs(seed: int, batch: int, queries: int = 100,
                      n_fp: tuple = (90, 100)) -> tuple:
    """A batch of assignment problems shaped like distillation's softkd
    false-positive re-pairing (toist_tpu/train/criterion.py
    ``_softkd_per_image``), made with numpy from ``seed``: rows are the
    student's (sth) unmatched queries, columns the teacher's (noun); cost =
    KL(noun || sth) of the binary object probabilities + L1 - GIoU of the
    boxes; columns at or past ``n_fp`` cost 1e6 and rows past it are
    padding. The teacher's queries cluster on a few objects and the
    student's are a small perturbation of them in another order, so
    near-duplicate queries make near-ties, as a trained detector's do.
    -> (cost [batch, queries, queries] f32, n_rows [batch] int32 drawn
    from [n_fp[0], n_fp[1]))."""
    rng = np.random.default_rng(seed)
    shape = (batch, queries)
    objects = np.concatenate([rng.uniform(0.2, 0.8, (batch, 8, 2)),
                              rng.uniform(0.05, 0.4, (batch, 8, 2))], -1)
    pick = rng.integers(0, 8, shape)
    noun_box = np.take_along_axis(objects, pick[..., None], 1) \
        + rng.normal(0, 0.01, shape + (4,))
    # The two streams compact their unmatched queries independently, so a
    # student query sits at another index than its teacher query.
    perm = np.argsort(rng.random(shape), -1)
    sth_box = np.take_along_axis(noun_box, perm[..., None], 1) \
        + rng.normal(0, 0.01, shape + (4,))
    noun_box[..., 2:] = np.abs(noun_box[..., 2:]) + 1e-3
    sth_box[..., 2:] = np.abs(sth_box[..., 2:]) + 1e-3
    p_noun = rng.uniform(0.01, 0.99, shape)
    p_sth = np.clip(np.take_along_axis(p_noun, perm, 1)
                    + rng.normal(0, 0.02, shape), 1e-3, 1 - 1e-3)
    bi_noun = np.stack([p_noun, 1 - p_noun], -1)
    bi_sth = np.stack([p_sth, 1 - p_sth], -1)
    kl = np.sum(bi_noun[:, None, :, :]
                * (np.log(bi_noun[:, None, :, :] + 1e-10)
                   - np.log(bi_sth[:, :, None, :] + 1e-10)), -1)
    l1 = np.abs(sth_box[:, :, None, :] - noun_box[:, None, :, :]).sum(-1)
    xyxy = [box_ops.box_cxcywh_to_xyxy(torch.from_numpy(x))
            for x in (sth_box, noun_box)]
    cost = kl + l1 - box_ops.generalized_box_iou(*xyxy).numpy()
    n = rng.integers(n_fp[0], n_fp[1], batch).astype(np.int32)
    cost = np.where(np.arange(queries)[None, None, :] >= n[:, None, None],
                    1e6, cost)
    return cost.astype(np.float32), n


def _check_inputs(cost: torch.Tensor, n_rows: torch.Tensor) -> None:
    if cost.dim() != 3:
        raise ValueError(f"cost must be [B, R, C], got {tuple(cost.shape)}")
    B, R, C = cost.shape
    if R > C:
        raise ValueError(f"need R <= C, got {tuple(cost.shape)}")
    if n_rows.shape != (B,):
        raise ValueError(f"n_rows must be [{B}], got {tuple(n_rows.shape)}")
    if n_rows.device != cost.device:
        raise ValueError("cost and n_rows must lie on one device")


def _smem_bytes(R: int, C: int) -> int:
    """One problem's shared memory (csrc/lsa.cu problem_words): cost, u,
    col4row, row4col and path, plus v, shortest and the scanned flags past
    128 columns, and 128 words the scan may read past them, in 16-byte
    units."""
    nk = (C + 31) // 32
    words = R * C + 2 * R + 2 * C + 128 + (3 * 32 * nk if nk > 4 else 0)
    return 4 * ((words + 3) // 4 * 4)


def _lib():
    from toist_tpu_torch.ops import _build

    fn = _build.load_library(KERNEL_SOURCE).toist_lsa_solve_batch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    return fn


def _launch(cost: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    B, R, C = cost.shape
    if _smem_bytes(R, C) > MAX_SMEM_BYTES:
        raise ValueError(f"a [{R}, {C}] problem exceeds the kernel's shared "
                         "memory")
    fn = _lib()
    cost = cost.detach().float().contiguous()
    n = n_rows.to(torch.int32).contiguous()
    out = torch.empty((B, R), dtype=torch.int32, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = fn(cost.data_ptr(), n.data_ptr(), out.data_ptr(), B, R, C,
                 stream)
    if err != 0:
        raise RuntimeError(f"lsa launch failed: cudaError {err}")
    solve_lsa_batch.launches += 1
    return out


def solve_lsa_batch(cost: torch.Tensor, n_rows: torch.Tensor
                    ) -> torch.Tensor:
    """cost [B, R, C] (R <= C), n_rows [B] -> col4row [B, R] int32 (-1 on
    rows at or past n_rows). Not differentiable (the assignment is
    discrete). CPU tensors: the plain version; CUDA tensors: the kernel, one
    launch for the whole batch, or an error."""
    _check_inputs(cost, n_rows)
    if cost.device.type == "cpu":
        return solve_lsa_batch_plain(cost, n_rows)
    if cost.device.type != "cuda":
        raise ValueError(f"no LSA path for device {cost.device}")
    return _launch(cost, n_rows)


solve_lsa_batch.launches = 0
