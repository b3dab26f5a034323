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
tensors launch the kernel or raise. ``solve_lsa_batch.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

KERNEL_SOURCE = "lsa.cu"
_BIG = np.float32(1e30)   # tentative distance of an unreached column
_CUT = np.float32(5e29)   # minval >= _CUT: no unscanned column is reachable
MAX_SMEM_BYTES = 227 * 1024


def _solve_one(cost: np.ndarray, n: int) -> np.ndarray:
    """One [R, C] f32 problem, first ``n`` rows -> col4row [R] int32."""
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

    for cur in range(n):
        if col4row[cur] >= 0:
            continue
        shortest = np.full(C, _BIG, np.float32)
        path = np.full(C, -1, np.int64)
        sc = np.zeros(C, bool)
        sr = np.zeros(R, bool)
        i, sink, minval = cur, -1, np.float32(0)
        while sink < 0 and minval < _CUT:
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
            r_ = int(path[j])
            row4col[j] = r_
            prev = int(col4row[r_])
            col4row[r_] = j
            if r_ == cur:
                break
            j = prev
    return np.where(valid, col4row, -1).astype(np.int32)


def solve_lsa_batch_plain(cost: torch.Tensor, n_rows: torch.Tensor
                          ) -> torch.Tensor:
    """The plain version: lsa.py's algorithm in numpy, one problem at a
    time. cost [B, R, C], n_rows [B] -> col4row [B, R] int32 on cost's
    device."""
    c = cost.detach().to("cpu", torch.float32).numpy()
    n = n_rows.detach().cpu().numpy()
    out = np.stack([_solve_one(c[b], int(n[b])) for b in range(c.shape[0])])
    return torch.from_numpy(out).to(cost.device)


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
    """The kernel's shared memory (csrc/lsa.cu smem_bytes)."""
    return 4 * (R * C + 2 * C + R) + 4 * (3 * C + 3 * R)


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
