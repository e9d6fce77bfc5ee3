"""The sweep's validation metrics on the device (binary classification).

The port's counterpart of ``transmogrifai_tpu/ops/metrics.py``:
``BINARY_METRICS`` and ``binary_grid_metrics`` (``_binary_grid_metrics``),
every (fold, candidate)'s AuROC (midrank ties), AuPR (one step per
distinct threshold), Error, Precision, Recall and F1 from the [F, C, n]
validation scores, as ``evaluators/classification.py`` computes them on the
host.  One hand-written kernel carries it:

- ``binary_metrics`` (K-L, CUDA, ``csrc/binary_metrics.cu``) replaces
  ``_binary_one``'s tie-aware pass after the sort: one block per (fold,
  candidate) scans the row's sorted scores once for the tie groups, the
  midrank sum, the AuPR steps and the thresholded counts.

The rows outside a fold's validation mask get the score -inf and every
row is ordered by one batched stable ``torch.sort`` (a library call, as the
reference leaves its sort to XLA's).  The labels and validation weights
are 0/1, so the counts are exact integers; the midrank sum and the AuPR
steps are summed exactly and rounded to float32 once (the reference sums
them in float32).  The wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises;
``binary_metrics.launches`` counts its launches.  The regression and
multiclass metrics are not ported.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build

#: metric order of the stacked output row
BINARY_METRICS = ("AuROC", "AuPR", "Error", "Precision", "Recall", "F1")
#: the fixed-point scale of the AuPR steps' sum (each step below 1, their
#: total at most 1)
AUPR_SCALE = 2.0 ** 62


def _finish(P_tot, N_tot, TP, FP, FN, R2, PR):
    """The reference's float32 formulas from the exact counts and sums."""
    npos, nneg = P_tot.float(), N_tot.float()
    r_pos = (R2.double() * 0.5).float()
    zero = torch.zeros_like(npos)
    auroc = torch.where((P_tot > 0) & (N_tot > 0),
                        (r_pos - npos * (npos + 1.0) * 0.5) / torch.clamp_min(npos * nneg, 1.0),
                        zero)
    aupr = torch.where(P_tot > 0, (PR.double() * (1.0 / AUPR_SCALE)).float(), zero)
    tpf, fpf, fnf = TP.float(), FP.float(), FN.float()
    err = (fpf + fnf) / torch.clamp_min(npos + nneg, 1.0)
    pd, rd = tpf + fpf, tpf + fnf
    precision = torch.where(pd > 0, tpf / torch.clamp_min(pd, 1.0), zero)
    recall = torch.where(rd > 0, tpf / torch.clamp_min(rd, 1.0), zero)
    s = precision + recall
    f1 = torch.where(s > 0, 2.0 * precision * recall / torch.clamp_min(s, 1e-30), zero)
    return torch.stack([auroc, aupr, err, precision, recall, f1], dim=-1)


def binary_metrics_plain(ss: torch.Tensor, order: torch.Tensor, y: torch.Tensor,
                         vm: torch.Tensor, strict: torch.Tensor, C: int) -> torch.Tensor:
    """Plain PyTorch version of K-L: the same integer counts and exact sums,
    over every tie group at once."""
    R, n = ss.shape
    dev = ss.device
    rows = torch.arange(R, device=dev)
    valid = vm[(rows // C)[:, None], order] != 0
    yv = y[order] != 0
    yp, yn = (valid & yv).long(), (valid & ~yv).long()
    p1 = torch.where((strict[rows % C] != 0)[:, None], ss > 0.5, ss >= 0.5)
    P_tot, N_tot = yp.sum(1), yn.sum(1)
    TP = (yp * p1).sum(1)
    FP = (yn * p1).sum(1)
    FN = (yp * ~p1).sum(1)
    n_exc = n - P_tot - N_tot
    zc = torch.zeros((R, 1), dtype=torch.long, device=dev)
    Pc = torch.cat([zc, torch.cumsum(yp, 1)], 1)                       # [R, n + 1]
    Nc = torch.cat([zc, torch.cumsum(yn, 1)], 1)
    start = torch.ones((R, n), dtype=torch.bool, device=dev)
    start[:, 1:] = ss[:, 1:] != ss[:, :-1]
    idx = torch.arange(n, device=dev).expand(R, n)
    # each group's end: the next start after it, or n
    nxt = torch.where(start, idx, torch.full_like(idx, n))
    nxt = torch.cat([nxt[:, 1:], torch.full((R, 1), n, dtype=torch.long, device=dev)], 1)
    hi = torch.flip(torch.cummin(torch.flip(nxt, [1]), 1).values, [1])  # [R, n]
    P_lo, P_hi, N_lo = Pc[:, :n], Pc.gather(1, hi), Nc[:, :n]
    r2 = torch.where(start, (P_hi - P_lo) * (idx + hi + 1 - 2 * n_exc[:, None]), 0).sum(1)
    A, B, Ah = P_tot[:, None] - P_lo, N_tot[:, None] - N_lo, P_tot[:, None] - P_hi
    Af = A.float()
    rec_den = torch.clamp_min(P_tot.float(), 1.0)[:, None]
    prec = Af / torch.clamp_min(Af + B.float(), 1.0)
    step = prec * (Af / rec_den - Ah.float() / rec_den)
    fixed = torch.round(step.double() * AUPR_SCALE).long()
    PR = torch.where(start & (ss > float("-inf")), fixed, 0).sum(1)
    return _finish(P_tot, N_tot, TP, FP, FN, r2, PR)


_METRIC_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def binary_metrics(ss: torch.Tensor, order: torch.Tensor, y: torch.Tensor, vm: torch.Tensor,
                   strict: torch.Tensor, C: int) -> torch.Tensor:
    """The six metrics f32[R, 6] of R = F x C sorted score rows.

    ``ss`` f32[R, n] each row's scores, ascending, -inf outside its fold's
    validation mask; ``order`` i64[R, n] the sort's permutation (row r is
    fold r // C, candidate r % C); ``y`` f32[n] the 0/1 labels; ``vm``
    f32[F, n] the folds' 0/1 validation masks; ``strict`` i32[C] each
    candidate's class decision (score > 0.5 when set, >= 0.5 otherwise)."""
    if ss.dtype != torch.float32 or ss.ndim != 2:
        raise ValueError("ss must be float32[R, n]")
    R, n = ss.shape
    if order.dtype != torch.int64 or tuple(order.shape) != (R, n):
        raise ValueError(f"order must be int64[{R}, {n}]")
    if y.dtype != torch.float32 or tuple(y.shape) != (n,):
        raise ValueError(f"y must be float32[{n}]")
    if vm.dtype != torch.float32 or vm.ndim != 2 or vm.shape[1] != n or vm.shape[0] * C != R:
        raise ValueError(f"vm must be float32[{R // max(C, 1)}, {n}]")
    if strict.dtype != torch.int32 or tuple(strict.shape) != (C,):
        raise ValueError(f"strict must be int32[{C}]")
    if not _on_cuda(ss, order, y, vm, strict):
        return binary_metrics_plain(ss, order, y, vm, strict, C)
    ss, order, y, vm, strict = (a.contiguous() for a in (ss, order, y, vm, strict))
    out = torch.empty((R, 6), dtype=torch.float32, device=ss.device)
    lib = cuda_build.load("binary_metrics", {"binary_metrics": (_METRIC_ARGS, ctypes.c_int)})
    with torch.cuda.device(ss.device):
        rc = lib.binary_metrics(ss.data_ptr(), order.data_ptr(), y.data_ptr(), vm.data_ptr(),
                                strict.data_ptr(), out.data_ptr(), R, n, C,
                                ctypes.c_void_p(torch.cuda.current_stream(ss.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"binary_metrics kernel launch failed: CUDA error {rc}")
    binary_metrics.launches += 1
    return out


binary_metrics.launches = 0


def sort_scores(scores: torch.Tensor, val_w: torch.Tensor):
    """(sorted scores f32[F C, n], permutation i64[F C, n]): the scores with
    -inf outside each fold's validation mask, stably sorted ascending."""
    F, C, n = scores.shape
    sv = torch.where(val_w[:, None, :] > 0, scores, torch.full_like(scores, float("-inf")))
    ss, order = torch.sort(sv.reshape(F * C, n), dim=1, stable=True)
    return ss, order


def binary_grid_metrics(y: torch.Tensor, scores: torch.Tensor, val_w: torch.Tensor,
                        strict_c) -> torch.Tensor:
    """y f32[n] (0/1); scores f32[F, C, n] class-1 scores; val_w f32[F, n]
    (0/1); strict_c the C strict flags.  Returns f32[F, C, 6] in
    ``BINARY_METRICS`` order."""
    F, C, n = scores.shape
    dev = scores.device
    y = y.to(dev, torch.float32)
    val_w = val_w.to(dev, torch.float32)
    if bool(((y != 0) & (y != 1)).any() | ((val_w != 0) & (val_w != 1)).any()):
        raise ValueError("binary_grid_metrics takes 0/1 labels and 0/1 validation masks")
    strict = torch.as_tensor(strict_c, device=dev).to(torch.int32).reshape(C)
    ss, order = sort_scores(scores.to(torch.float32), val_w)
    return binary_metrics(ss, order, y, val_w, strict, C).reshape(F, C, 6)
