"""The sweep's validation metrics on the device (binary classification,
regression and multiclass classification).

The port's counterpart of ``transmogrifai_tpu/ops/metrics.py``:
``BINARY_METRICS`` and ``binary_grid_metrics`` (``_binary_grid_metrics``),
every (fold, candidate)'s AuROC (midrank ties), AuPR (one step per
distinct threshold), Error, Precision, Recall and F1 from the [F, C, n]
validation scores, as ``evaluators/classification.py`` computes them on the
host; ``REGRESSION_METRICS`` and ``regression_grid_metrics``
(``_regression_grid_metrics``), every (fold, candidate)'s RMSE, MSE, R2 and
MAE from the [F, C, n] predictions; ``MULTICLASS_METRICS`` and
``multiclass_grid_metrics`` (``_multiclass_grid_metrics``), every (fold,
candidate)'s F1, Precision, Recall and Error from the [F, C, n, k] class
probabilities.  Three hand-written kernels carry them:

- ``binary_metrics`` (K-L, CUDA, ``csrc/binary_metrics.cu``) replaces
  ``_binary_one``'s tie-aware pass after the sort: one block per (fold,
  candidate) scans the row's sorted scores once for the tie groups, the
  midrank sum, the AuPR steps and the thresholded counts.
- ``regression_metrics`` (K-O, CUDA, ``csrc/regression_metrics.cu``)
  replaces ``_regression_one``: one block per (fold, candidate) sums the
  row's squared and absolute errors, the mask, the masked labels and the
  labels' squares about their mean.
- ``multiclass_metrics`` (K-Q, CUDA, ``csrc/multiclass_metrics.cu``)
  replaces ``_multiclass_one``: per (fold, candidate) row, the first
  argmax of each row's class probabilities and each class's true
  positives, false positives, false negatives and count, then Spark's
  class-frequency-weighted F1, Precision and Recall and the Error.

For the binary metrics, the rows outside a fold's validation mask get the
score -inf and every row is ordered by one batched stable ``torch.sort`` (a
library call, as the reference leaves its sort to XLA's).  The labels and
validation weights are 0/1, so the counts are exact integers; the midrank
sum and the AuPR steps are summed exactly and rounded to float32 once (the
reference sums them in float32).  The regression metrics' elementwise terms
are the reference's float32 operations; their sums are float64, each
rounded to float32 once (the reference sums in float32).  The wrappers take
the plain version only for tensors on the CPU; for CUDA tensors they launch
the kernel or raise; ``<wrapper>.launches`` counts their launches.  The
multiclass metrics count in integers (0/1 masks, integer labels) and
convert each count to float32 once, so they are bit-equal to the
reference's float32 sums of 0/1 terms; the float32 formulas that finish a
row are the reference's, in its order.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build

#: metric order of the stacked output row
BINARY_METRICS = ("AuROC", "AuPR", "Error", "Precision", "Recall", "F1")
#: metric order of regression_grid_metrics' output row
REGRESSION_METRICS = ("RootMeanSquaredError", "MeanSquaredError", "R2", "MeanAbsoluteError")
#: metric order of multiclass_grid_metrics' output row
MULTICLASS_METRICS = ("F1", "Precision", "Recall", "Error")
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


# ---------------------------------------------------------------------------
# K-O regression_metrics
# ---------------------------------------------------------------------------
def _check_regression(preds, y, vm, C):
    if preds.dtype != torch.float32 or preds.ndim != 2:
        raise ValueError("preds must be float32[R, n]")
    R, n = preds.shape
    if y.dtype != torch.float32 or tuple(y.shape) != (n,):
        raise ValueError(f"y must be float32[{n}]")
    if C < 1 or vm.dtype != torch.float32 or vm.ndim != 2 or vm.shape[1] != n \
            or vm.shape[0] * C != R:
        raise ValueError(f"vm must be float32[{R // max(C, 1)}, {n}]")


def regression_metrics_plain(preds: torch.Tensor, y: torch.Tensor, vm: torch.Tensor,
                             C: int) -> torch.Tensor:
    """Plain PyTorch version of K-O: the same float32 terms, float64 sums
    (the folds' label sums once per fold)."""
    R, n = preds.shape
    fold = torch.arange(R, device=preds.device) // C
    v = vm[fold]                                                       # [R, n]
    err = (preds - y) * v
    se = (err * err).double().sum(1).float()
    sa = err.abs().double().sum(1).float()
    nv = torch.clamp_min(vm.double().sum(1).float(), 1.0)               # [F]
    ybar = (y * vm).double().sum(1).float() / nv
    dy = y - ybar[:, None]
    ss = (dy * dy * vm).double().sum(1).float()
    nv, ss = nv[fold], ss[fold]
    mse = se / nv
    r2 = torch.where(ss > 0, 1.0 - se / torch.clamp_min(ss, 1e-30), torch.zeros_like(ss))
    return torch.stack([torch.sqrt(mse), mse, r2, sa / nv], dim=-1)


_REG_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def regression_metrics(preds: torch.Tensor, y: torch.Tensor, vm: torch.Tensor,
                       C: int) -> torch.Tensor:
    """The four metrics f32[R, 4] (``REGRESSION_METRICS`` order) of R = F x C
    prediction rows: ``preds`` f32[R, n] (row r is fold r // C, candidate
    r % C), ``y`` f32[n] the labels, ``vm`` f32[F, n] the folds' validation
    weights."""
    _check_regression(preds, y, vm, C)
    if not _on_cuda(preds, y, vm):
        return regression_metrics_plain(preds, y, vm, C)
    preds, y, vm = preds.contiguous(), y.contiguous(), vm.contiguous()
    R, n = preds.shape
    out = torch.empty((R, 4), dtype=torch.float32, device=preds.device)
    if R == 0:
        return out
    lib = cuda_build.load("regression_metrics",
                          {"regression_metrics": (_REG_ARGS, ctypes.c_int)})
    with torch.cuda.device(preds.device):
        rc = lib.regression_metrics(
            preds.data_ptr(), y.data_ptr(), vm.data_ptr(), out.data_ptr(), R, n, C,
            ctypes.c_void_p(torch.cuda.current_stream(preds.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"regression_metrics kernel launch failed: CUDA error {rc}")
    regression_metrics.launches += 1
    return out


regression_metrics.launches = 0


def regression_grid_metrics(y: torch.Tensor, preds: torch.Tensor,
                            val_w: torch.Tensor) -> torch.Tensor:
    """y f32[n]; preds f32[F, C, n]; val_w f32[F, n].  Returns f32[F, C, 4]
    in ``REGRESSION_METRICS`` order."""
    F, C, n = preds.shape
    dev = preds.device
    out = regression_metrics(preds.to(torch.float32).reshape(F * C, n).contiguous(),
                             y.to(dev, torch.float32), val_w.to(dev, torch.float32), C)
    return out.reshape(F, C, 4)


# ---------------------------------------------------------------------------
# K-Q multiclass_metrics
# ---------------------------------------------------------------------------
#: the most classes K-Q takes
MULTICLASS_MAX_CLASSES = 8


def _check_multiclass(probs, y, vm, C):
    if probs.dtype != torch.float32 or probs.ndim != 3:
        raise ValueError("probs must be float32[R, n, k]")
    R, n, k = probs.shape
    if not 2 <= k <= MULTICLASS_MAX_CLASSES:
        raise ValueError(f"multiclass_metrics takes 2 to {MULTICLASS_MAX_CLASSES} classes, "
                         f"got {k}")
    if y.dtype != torch.float32 or tuple(y.shape) != (n,):
        raise ValueError(f"y must be float32[{n}]")
    if C < 1 or vm.dtype != torch.float32 or vm.ndim != 2 or vm.shape[1] != n \
            or vm.shape[0] * C != R:
        raise ValueError(f"vm must be float32[{R // max(C, 1)}, {n}]")


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product is exact in float64
    and so, for these operands (at most 1 in magnitude), is the sum but in
    cases too rare to meet (a double rounding needs the float64 sum to fall
    on a float32 midpoint).  XLA's CPU code fuses the reference's weighted
    class sums into such operations."""
    return (a.double() * b.double() + c.double()).float()


def _multiclass_finish(TP, FP, FN, CN, NV) -> torch.Tensor:
    """The reference's float32 formulas from the exact counts: TP, FP, FN,
    CN i64[R, k], NV i64[R]."""
    tp, fp, fn = TP.float(), FP.float(), FN.float()
    nv = torch.clamp_min(NV.float(), 1.0)[:, None]
    wgt = CN.float() / nv
    zero = torch.zeros_like(tp)
    pd, rd = tp + fp, tp + fn
    p = torch.where(pd > 0, tp / torch.clamp_min(pd, 1.0), zero)
    r = torch.where(rd > 0, tp / torch.clamp_min(rd, 1.0), zero)
    s = p + r
    f = torch.where(s > 0, 2.0 * p * r / torch.clamp_min(s, 1e-30), zero)
    f1, prec, rec = f[:, 0] * wgt[:, 0], p[:, 0] * wgt[:, 0], r[:, 0] * wgt[:, 0]
    for j in range(1, tp.shape[1]):  # in class order, fused, as XLA sums them
        f1, prec, rec = (fma(v[:, j], wgt[:, j], acc)
                         for v, acc in ((f, f1), (p, prec), (r, rec)))
    err = 1.0 - TP.sum(1).float() / nv[:, 0]
    return torch.stack([f1, prec, rec, err], dim=-1)


def multiclass_metrics_plain(probs: torch.Tensor, y: torch.Tensor, vm: torch.Tensor,
                             C: int) -> torch.Tensor:
    """Plain PyTorch version of K-Q: the same integer counts, then the same
    float32 formulas."""
    R, n, k = probs.shape
    v = vm[torch.arange(R, device=probs.device) // C] != 0                  # [R, n]
    pred = torch.nn.functional.one_hot(torch.argmax(probs, dim=-1), k).bool()   # first max
    lab = torch.nn.functional.one_hot(y.long(), k).bool()[None]              # [1, n, k]
    vk = v[..., None]
    TP = (vk & pred & lab).sum(1)
    FP = (vk & pred & ~lab).sum(1)
    FN = (vk & ~pred & lab).sum(1)
    CN = (vk & lab).sum(1)
    return _multiclass_finish(TP, FP, FN, CN, v.sum(1))


_MC_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def multiclass_metrics(probs: torch.Tensor, y: torch.Tensor, vm: torch.Tensor,
                       C: int) -> torch.Tensor:
    """The four metrics f32[R, 4] (``MULTICLASS_METRICS`` order) of R = F x
    C rows of class probabilities: ``probs`` f32[R, n, k] (row r is fold
    r // C, candidate r % C; the first argmax decides), ``y`` f32[n] the
    class labels 0 .. k - 1, ``vm`` f32[F, n] the folds' 0/1 validation
    masks.  At most ``MULTICLASS_MAX_CLASSES`` classes."""
    _check_multiclass(probs, y, vm, C)
    if not _on_cuda(probs, y, vm):
        return multiclass_metrics_plain(probs, y, vm, C)
    probs, y, vm = probs.contiguous(), y.contiguous(), vm.contiguous()
    R, n, k = probs.shape
    if R == 0 or n == 0:
        raise ValueError("multiclass_metrics needs at least one row and one example")
    out = torch.empty((R, 4), dtype=torch.float32, device=probs.device)
    counts = torch.empty((R, 4 * k + 1), dtype=torch.int64, device=probs.device)
    lib = cuda_build.load("multiclass_metrics",
                          {"multiclass_metrics": (_MC_ARGS, ctypes.c_int)})
    with torch.cuda.device(probs.device):
        rc = lib.multiclass_metrics(
            probs.data_ptr(), y.data_ptr(), vm.data_ptr(), counts.data_ptr(), out.data_ptr(),
            R, n, k, C, ctypes.c_void_p(torch.cuda.current_stream(probs.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"multiclass_metrics kernel launch failed: CUDA error {rc}")
    multiclass_metrics.launches += 1
    return out


multiclass_metrics.launches = 0


def multiclass_grid_metrics(y: torch.Tensor, probs: torch.Tensor,
                            val_w: torch.Tensor) -> torch.Tensor:
    """y f32[n] (class labels 0 .. k - 1); probs f32[F, C, n, k]; val_w
    f32[F, n] (0/1).  Returns f32[F, C, 4] in ``MULTICLASS_METRICS``
    order."""
    F, C, n, k = probs.shape
    dev = probs.device
    y = y.to(dev, torch.float32)
    val_w = val_w.to(dev, torch.float32)
    if bool(((y < 0) | (y >= k) | (y != torch.round(y))).any()
            | ((val_w != 0) & (val_w != 1)).any()):
        raise ValueError(f"multiclass_grid_metrics takes class labels in [0, {k}) and 0/1 "
                         "validation masks")
    out = multiclass_metrics(probs.to(torch.float32).reshape(F * C, n, k), y, val_w, C)
    return out.reshape(F, C, 4)
