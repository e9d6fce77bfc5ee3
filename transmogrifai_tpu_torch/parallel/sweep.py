"""The logistic model-grid sweep on one device: folds as weight masks,
every (fold, l2) candidate fitted and scored at once.

The port's copy of ``transmogrifai_tpu/parallel/sweep.py`` (reference: the
ModelSelector grid that OpValidator.scala:299-357 trains as JVM futures):

- ``make_fold_weights``: the 0/1 (train, validation) masks of k-fold CV,
  stratified by dealing each label class's shuffled rows round-robin over
  the folds (the one copy in the port; ``impl/tuning/validators.py``
  imports it);
- ``fit_logistic_grid_folds``: the pure-L2 logistic fit of every (fold,
  l2) pair by Newton's method (``ops/linear.fit_logistic_grid_folds_newton``,
  its weighted Grams on K-S), as the reference's thin wrapper;
- ``eval_logistic_grid_folds``: the masked 0/1 validation error of every
  (fold, candidate), on the card one launch of K-AE
  (``logistic_grid_error``, ``csrc/logistic_eval.cu``), on the CPU its
  plain version ``eval_logistic_grid_folds_plain``;
- ``sharded_logistic_sweep``: the folds, the fits and the errors, with the
  mean error over the folds.

The reference shards the grid over a mesh's ``model`` axis; on one device
that is a plain call, and so it is here: a mesh of more than one device
raises ``NotImplementedError`` (multi-GPU through ``torch.distributed``,
ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import linear as L
from ..utils.device import on_cuda as _on_cuda
from ..utils.device import resolve_device

__all__ = ["make_fold_weights", "fit_logistic_grid_folds", "eval_logistic_grid_folds",
           "eval_logistic_grid_folds_plain", "sharded_logistic_sweep"]


def make_fold_weights(n: int, n_folds: int, seed: int = 42,
                      stratify_labels: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(train_w [n_folds, n], val_w [n_folds, n]) float32 0/1 mask pairs;
    stratified, each label class's rows are dealt round-robin across folds
    (OpCrossValidation.scala:200-236)."""
    rng = np.random.default_rng(seed)
    assign = np.empty(n, dtype=np.int64)
    if stratify_labels is not None:
        labels = np.asarray(stratify_labels)
        for cls in np.unique(labels):
            idx = np.where(labels == cls)[0]
            rng.shuffle(idx)
            assign[idx] = np.arange(idx.size) % n_folds
    else:
        assign = rng.permutation(n) % n_folds
    val = np.stack([(assign == k).astype(np.float32) for k in range(n_folds)])
    return 1.0 - val, val


def fit_logistic_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, l2_grid,
                            max_iter: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (fold, l2) pure-L2 logistic fit on X's device: (coef [F, g, d],
    intercept [F, g, 1])."""
    fit = L.fit_logistic_grid_folds_newton(X, y, train_w, np.asarray(l2_grid, np.float32),
                                           max_iter=max_iter)
    return fit.coef, fit.intercept


def _check_eval(X, y, val_w, coef, intercept) -> None:
    if X.dtype != torch.float32 or X.ndim != 2:
        raise ValueError("X must be float32[n, d]")
    n, d = X.shape
    if y.dtype != torch.float32 or tuple(y.shape) != (n,):
        raise ValueError(f"y must be float32[{n}]")
    if val_w.dtype != torch.float32 or val_w.ndim != 2 or val_w.shape[1] != n:
        raise ValueError(f"val_w must be float32[F, {n}]")
    F = val_w.shape[0]
    if coef.dtype != torch.float32 or coef.ndim != 3 or coef.shape[0] != F \
            or coef.shape[2] != d:
        raise ValueError(f"coef must be float32[{F}, g, {d}]")
    if intercept.dtype != torch.float32 or tuple(intercept.shape) != (F, coef.shape[1], 1):
        raise ValueError(f"intercept must be float32[{F}, {coef.shape[1]}, 1]")


def eval_logistic_grid_folds_plain(X: torch.Tensor, y: torch.Tensor, val_w: torch.Tensor,
                                   coef: torch.Tensor, intercept: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-AE: the margins by one product, the wrong
    predictions weighted by each fold's validation weights, each (fold,
    candidate)'s sum over the fold's weight sum, at least 1."""
    z = torch.einsum("nd,fgd->fgn", X, coef) + intercept
    wrong = ((z >= 0.0).to(torch.float32) != y).to(torch.float32)
    num = (wrong * val_w[:, None, :]).double().sum(-1).float()
    den = torch.clamp_min(val_w.double().sum(-1).float(), 1.0)
    return num / den[:, None]


_EVAL_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def eval_logistic_grid_folds(X: torch.Tensor, y: torch.Tensor, val_w: torch.Tensor,
                             coef: torch.Tensor, intercept: torch.Tensor) -> torch.Tensor:
    """The masked validation error f32[F, g] of every (fold, candidate):
    ``sum_r val_w[f, r] [(X_r . coef[f, g] + intercept[f, g, 0] >= 0) != y_r]
    / max(sum_r val_w[f, r], 1)``, with ``X`` f32[n, d], ``y`` f32[n] the
    0/1 labels, ``val_w`` f32[F, n], ``coef`` f32[F, g, d] and ``intercept``
    f32[F, g, 1]."""
    _check_eval(X, y, val_w, coef, intercept)
    if not _on_cuda(X, y, val_w, coef, intercept):
        return eval_logistic_grid_folds_plain(X, y, val_w, coef, intercept)
    lib = cuda_build.load("logistic_eval", {
        "logistic_grid_error": (_EVAL_ARGS, ctypes.c_int),
        "logistic_error_tile_rows": ([], ctypes.c_int),
        "logistic_error_chunk": ([ctypes.c_int], ctypes.c_int)})
    n, d = X.shape
    F, G = coef.shape[:2]
    C = F * G
    out = torch.empty((F, G), dtype=torch.float32, device=X.device)
    if n == 0 or C == 0:
        return out.fill_(0.0)
    if lib.logistic_error_chunk(d) < 1:
        raise ValueError(f"K-AE stages one candidate's {d} coefficients in 48 KB: d too wide")
    X, y, val_w = X.contiguous(), y.contiguous(), val_w.contiguous()
    coef, b = coef.contiguous(), intercept.reshape(C).contiguous()
    blocks = -(-n // lib.logistic_error_tile_rows())
    partials = torch.empty((2, blocks, C), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        rc = lib.logistic_grid_error(
            X.data_ptr(), y.data_ptr(), val_w.data_ptr(), coef.data_ptr(), b.data_ptr(),
            partials.data_ptr(), out.data_ptr(), n, d, G, C,
            ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream))
    cuda_build.check_launch("logistic_grid_error", rc)
    eval_logistic_grid_folds.launches += 1
    return out


eval_logistic_grid_folds.launches = 0


def _mesh_devices(mesh) -> int:
    """The number of devices of a mesh: a ``torch.distributed`` DeviceMesh's
    ``size()``, else the size of its ``devices`` array."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    if callable(size):
        return int(size())
    return int(np.size(np.asarray(getattr(mesh, "devices", [None]), dtype=object)))


def sharded_logistic_sweep(X: np.ndarray, y: np.ndarray, l2_grid: np.ndarray,
                           n_folds: int = 3, mesh=None, max_iter: int = 30, seed: int = 42,
                           device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The full CV sweep of the l2 grid on one device (``None``: the CUDA
    card): stratified folds, the fold x grid Newton fits, their validation
    errors.  Returns (mean validation error [g] over the folds, coef [F, g,
    d], intercept [F, g, 1]) as numpy arrays.  A ``mesh`` of more than one
    device raises ``NotImplementedError``."""
    if _mesh_devices(mesh) > 1:
        raise NotImplementedError(
            "the port's logistic sweep runs on one device: a mesh of several devices waits "
            "for multi-GPU through torch.distributed (ROADMAP Queue 1 item 7)")
    dev = resolve_device(device)
    train_w, val_w = make_fold_weights(len(y), n_folds, seed=seed, stratify_labels=y)
    Xd = torch.as_tensor(np.ascontiguousarray(np.asarray(X, np.float32)), device=dev)
    yd = torch.as_tensor(np.ascontiguousarray(np.asarray(y, np.float32)), device=dev)
    coef, intercept = fit_logistic_grid_folds(Xd, yd, torch.as_tensor(train_w, device=dev),
                                              l2_grid, max_iter=max_iter)
    err = eval_logistic_grid_folds(Xd, yd, torch.as_tensor(val_w, device=dev), coef, intercept)
    mean_err = err.cpu().numpy().mean(axis=0)
    return mean_err, coef.cpu().numpy(), intercept.cpu().numpy()
