"""Linear models on the device: the elastic-net solvers and prediction.

The port's counterpart of ``transmogrifai_tpu/ops/linear.py``:
``fit_logistic_fista``, ``fit_linear_fista`` and ``fit_softmax`` and
their fold x grid batches ``fit_logistic_grid_folds_fista``,
``fit_linear_grid_folds_fista`` and ``fit_softmax_grid_folds`` (FISTA
proximal gradient, a fixed iteration count), ``predict_binary_logistic``,
``predict_softmax``, ``predict_softmax_grid`` and ``predict_linear``.
Three hand-written kernels in one CUDA source (``csrc/fista.cu``) carry
the solvers:

- ``fista_grad`` (K-K) replaces the gradient of ``fit_logistic_fista``'s
  body for all fits of the batch at once:
  ``X1^T (w * (sigmoid(X1 z) - y)) / sum(w) + l2 * z``;
- ``linear_fista_grad`` (K-N) replaces the gradient of
  ``fit_linear_fista``'s body: ``X1^T (w * (X1 z - y)) / sum(w) + l2 * z``;
- ``softmax_fista_grad`` (K-P) replaces the gradient of ``fit_softmax``'s
  body, a matrix of coefficients [p, k] per fit:
  ``X1^T (w * (softmax(X1 B) - Y)) / sum(w) + l2 * B`` with Y the one-hot
  labels.

The proximal step, the soft threshold and the momentum are elementwise
torch on [C, p] (or [C, p, k]); the shared momentum scalars are float32 on
the host.  The wrappers take the plain version only for tensors on the
CPU; for CUDA tensors they launch the kernel or raise;
``<wrapper>.launches`` counts their launches.  Predictions are plain
products: ``torch.matmul`` in full float32 (see
``utils/device.apply_f32_policy``).  The Newton solver (K9), ridge and the
SVC fits are not ported.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build


class LinearFit(NamedTuple):
    """Fitted linear parameters: coefficients [..., d] and intercept [..., 1]."""

    coef: torch.Tensor
    intercept: torch.Tensor


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), the expansion XLA uses for ``jax.nn.sigmoid``."""
    return 1.0 / (1.0 + torch.exp(-x))


def _soft_threshold(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thr, 0.0)


# ---------------------------------------------------------------------------
# K-K fista_grad
# ---------------------------------------------------------------------------
def _check_fista(X1, y, w, fold, z, l2v, wsum):
    if not (X1.dtype == torch.float32 and X1.ndim == 2):
        raise ValueError("X1 must be float32[n, p]")
    n, p = X1.shape
    C = z.shape[0]
    for name, a, shape in (("y", y, (n,)), ("z", z, (C, p)), ("l2v", l2v, (C, p)),
                           ("wsum", wsum, (C,))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}")
    if w.dtype != torch.float32 or w.ndim != 2 or w.shape[1] != n:
        raise ValueError(f"w must be float32[F, {n}]")
    if fold.dtype != torch.int32 or tuple(fold.shape) != (C,):
        raise ValueError(f"fold must be int32[{C}]")


def fista_grad_plain(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                     z: torch.Tensor, l2v: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-K: two products and the elementwise terms."""
    r = w[fold.long()] * (_sigmoid(z @ X1.T) - y)                      # [C, n]
    return (r @ X1) / wsum[:, None] + l2v * z


def linear_fista_grad_plain(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                            fold: torch.Tensor, z: torch.Tensor, l2v: torch.Tensor,
                            wsum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-N: two products and the elementwise terms."""
    r = w[fold.long()] * (z @ X1.T - y)                                 # [C, n]
    return (r @ X1) / wsum[:, None] + l2v * z


_FISTA_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SOFTMAX_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
#: the entry points of csrc/fista.cu (the library is loaded once, with all)
_FISTA_SIGNATURES = {"fista_grad": (_FISTA_ARGS, ctypes.c_int),
                     "linear_fista_grad": (_FISTA_ARGS, ctypes.c_int),
                     "softmax_fista_grad": (_SOFTMAX_ARGS, ctypes.c_int)}
#: rows of one block's chunk: at least 2048 (8 rows a thread), else enough
#: chunks to give every SM two blocks
_FISTA_MIN_CHUNK = 2048
_FISTA_TARGET_CHUNKS = 2 * 132


def _fista_launch(entry: str, X1, y, w, fold, z, l2v, wsum) -> torch.Tensor:
    """Launch ``csrc/fista.cu``'s ``entry`` (``fista_grad`` or
    ``linear_fista_grad``) on CUDA tensors; returns the gradients."""
    n, p = X1.shape
    C = z.shape[0]
    if p > 64:
        raise ValueError(f"{entry} takes at most 64 coefficients, got {p}")
    X1, y, w, fold = X1.contiguous(), y.contiguous(), w.contiguous(), fold.contiguous()
    z, l2v, wsum = z.contiguous(), l2v.contiguous(), wsum.contiguous()
    chunk_rows = max(_FISTA_MIN_CHUNK, -(-n // _FISTA_TARGET_CHUNKS))
    chunks = -(-n // chunk_rows)
    partial = torch.empty((chunks, C, p), dtype=torch.float32, device=X1.device)
    grad = torch.empty((C, p), dtype=torch.float32, device=X1.device)
    lib = cuda_build.load("fista", _FISTA_SIGNATURES)
    with torch.cuda.device(X1.device):
        rc = getattr(lib, entry)(X1.data_ptr(), y.data_ptr(), w.data_ptr(), fold.data_ptr(),
                                 z.data_ptr(), wsum.data_ptr(), l2v.data_ptr(),
                                 partial.data_ptr(), grad.data_ptr(), n, p, C, chunks,
                                 chunk_rows,
                                 ctypes.c_void_p(torch.cuda.current_stream(X1.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return grad


def fista_grad(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
               z: torch.Tensor, l2v: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """The gradients f32[C, p] of C logistic fits at their points ``z``:
    ``X1^T (w[fold[c]] * (sigmoid(X1 z_c) - y)) / wsum[c] + l2v[c] * z_c``.

    ``X1`` f32[n, p] (the features with the intercept column), ``y`` f32[n],
    ``w`` f32[F, n] the folds' row weights, ``fold`` i32[C] each fit's fold,
    ``l2v`` f32[C, p] each fit's L2 penalty per coefficient, ``wsum`` f32[C]
    each fit's weight total.  At most 64 coefficients."""
    _check_fista(X1, y, w, fold, z, l2v, wsum)
    if not _on_cuda(X1, y, w, fold, z, l2v, wsum):
        return fista_grad_plain(X1, y, w, fold, z, l2v, wsum)
    grad = _fista_launch("fista_grad", X1, y, w, fold, z, l2v, wsum)
    fista_grad.launches += 1
    return grad


fista_grad.launches = 0


def linear_fista_grad(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                      z: torch.Tensor, l2v: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """The gradients f32[C, p] of C squared-loss linear fits at their points
    ``z``: ``X1^T (w[fold[c]] * (X1 z_c - y)) / wsum[c] + l2v[c] * z_c``;
    the arguments as ``fista_grad``'s."""
    _check_fista(X1, y, w, fold, z, l2v, wsum)
    if not _on_cuda(X1, y, w, fold, z, l2v, wsum):
        return linear_fista_grad_plain(X1, y, w, fold, z, l2v, wsum)
    grad = _fista_launch("linear_fista_grad", X1, y, w, fold, z, l2v, wsum)
    linear_fista_grad.launches += 1
    return grad


linear_fista_grad.launches = 0


# ---------------------------------------------------------------------------
# K-P softmax_fista_grad
# ---------------------------------------------------------------------------
#: the most classes and coefficients (features + intercept) K-P takes
SOFTMAX_MAX_CLASSES = 8
SOFTMAX_MAX_COEFS = 64


def _check_softmax(X1, y, w, fold, z, l2m, wsum):
    if not (X1.dtype == torch.float32 and X1.ndim == 2):
        raise ValueError("X1 must be float32[n, p]")
    n, p = X1.shape
    if z.dtype != torch.float32 or z.ndim != 3 or z.shape[1] != p:
        raise ValueError(f"z must be float32[C, {p}, k]")
    C, _, k = z.shape
    for name, a, shape in (("y", y, (n,)), ("l2m", l2m, (C, p, k)), ("wsum", wsum, (C,))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}")
    if w.dtype != torch.float32 or w.ndim != 2 or w.shape[1] != n:
        raise ValueError(f"w must be float32[F, {n}]")
    if fold.dtype != torch.int32 or tuple(fold.shape) != (C,):
        raise ValueError(f"fold must be int32[{C}]")
    if k > SOFTMAX_MAX_CLASSES or p > SOFTMAX_MAX_COEFS:
        raise ValueError(f"softmax_fista_grad takes at most {SOFTMAX_MAX_CLASSES} classes and "
                         f"{SOFTMAX_MAX_COEFS} coefficients, got {k} and {p}")


def _softmax(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` as the reference writes it: exp(z - max) / sum."""
    e = torch.exp(z - z.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def softmax_fista_grad_plain(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                             fold: torch.Tensor, z: torch.Tensor, l2m: torch.Tensor,
                             wsum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-P: two products and the elementwise terms;
    the second product sums in float64 and rounds once, as the kernel's
    reduction does."""
    k = z.shape[2]
    Y = torch.nn.functional.one_hot(y.long(), k).to(z.dtype)                 # [n, k]
    mu = _softmax(torch.einsum("np,cpk->cnk", X1, z))                         # [C, n, k]
    r = w[fold.long()][..., None] * (mu - Y)
    g = torch.einsum("np,cnk->cpk", X1.double(), r.double()).to(z.dtype)
    return g / wsum[:, None, None] + l2m * z


def softmax_fista_grad(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                       z: torch.Tensor, l2m: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """The gradients f32[C, p, k] of C multinomial (softmax) fits at their
    points ``z`` f32[C, p, k]: ``X1^T (w[fold[c]] * (softmax(X1 z_c) - Y)) /
    wsum[c] + l2m[c] * z_c`` with Y the one-hot of the class labels ``y``
    f32[n] (0 .. k - 1); the other arguments as ``fista_grad``'s, ``l2m``
    f32[C, p, k] each fit's L2 penalty per coefficient.  At most
    ``SOFTMAX_MAX_CLASSES`` classes and ``SOFTMAX_MAX_COEFS``
    coefficients."""
    _check_softmax(X1, y, w, fold, z, l2m, wsum)
    if not _on_cuda(X1, y, w, fold, z, l2m, wsum):
        return softmax_fista_grad_plain(X1, y, w, fold, z, l2m, wsum)
    n, p = X1.shape
    C, _, k = z.shape
    X1, y, w, fold = X1.contiguous(), y.contiguous(), w.contiguous(), fold.contiguous()
    z, l2m, wsum = z.contiguous(), l2m.contiguous(), wsum.contiguous()
    chunk_rows = max(_FISTA_MIN_CHUNK, -(-n // _FISTA_TARGET_CHUNKS))
    chunks = -(-n // chunk_rows)
    partial = torch.empty((chunks, C, p, k), dtype=torch.float64, device=X1.device)
    grad = torch.empty((C, p, k), dtype=torch.float32, device=X1.device)
    lib = cuda_build.load("fista", _FISTA_SIGNATURES)
    with torch.cuda.device(X1.device):
        rc = lib.softmax_fista_grad(
            X1.data_ptr(), y.data_ptr(), w.data_ptr(), fold.data_ptr(), z.data_ptr(),
            wsum.data_ptr(), l2m.data_ptr(), partial.data_ptr(), grad.data_ptr(), n, p, k, C,
            chunks, chunk_rows, ctypes.c_void_p(torch.cuda.current_stream(X1.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"softmax_fista_grad kernel launch failed: CUDA error {rc}")
    softmax_fista_grad.launches += 1
    return grad


softmax_fista_grad.launches = 0


# ---------------------------------------------------------------------------
# The solver: FISTA for every (fold, grid) fit at once
# ---------------------------------------------------------------------------
def _momentum(max_iter: int):
    """The FISTA momentum factors (t - 1) / t_next of each step, in float32
    as the reference's scan carries t (the same for every fit)."""
    one, t, out = np.float32(1.0), np.float32(1.0), []
    for _ in range(max_iter):
        t_next = np.float32(0.5) * (one + np.sqrt(one + np.float32(4.0) * t * t))
        out.append(float((t - one) / t_next))
        t = t_next
    return out


#: the Lipschitz factor of each loss's curvature bound (the reference's
#: ``L = factor * sum(w x^2) / sum(w) + l2 + 1e-6``)
_LIPSCHITZ = {"logistic": 0.25, "linear": 1.0, "softmax": 0.5}


def _fista_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, l1s, l2s,
                      max_iter: int, fit_intercept: bool, loss: str, k: int = 1) -> LinearFit:
    """FISTA for every (fold, grid) fit at once: the logistic fits through
    K-K, the linear ones through K-N, the softmax ones (``k`` classes, a
    coefficient matrix [p, k] per fit) through K-P (the reference's three
    solvers differ only in the link and the Lipschitz bound's factor)."""
    dev = X.device
    n, d = X.shape
    F = train_w.shape[0]
    l1 = torch.as_tensor(np.asarray(l1s, np.float32).reshape(-1), device=dev)
    l2 = torch.as_tensor(np.asarray(l2s, np.float32).reshape(-1), device=dev)
    G = l1.shape[0]
    C = F * G
    X1 = torch.cat([X, torch.ones((n, 1), dtype=torch.float32, device=dev)], 1) \
        if fit_intercept else X
    X1 = X1.contiguous()
    p = X1.shape[1]
    w = train_w.to(dev, torch.float32).contiguous()
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)   # [C]
    l1_c, l2_c = l1.repeat(F), l2.repeat(F)                                      # [C]
    pen = torch.ones(p, dtype=torch.float32, device=dev)
    if fit_intercept:
        pen[-1] = 0.0
    l1v, l2v = l1_c[:, None] * pen, (l2_c[:, None] * pen).contiguous()          # [C, p]
    w_sum = torch.clamp_min(w.sum(1), 1e-12)                                      # [F]
    sq = ((X1 * X1).T * w[:, None, :]).sum((1, 2))
    lip = _LIPSCHITZ[loss] * sq / w_sum                                           # [F]
    L = (lip[fold.long()] + l2_c) + 1e-6
    step = (1.0 / L)[:, None]                                                     # [C, 1]
    shape = (C, p)
    if loss == "softmax":  # a [p, k] matrix per fit
        shape = (C, p, k)
        l1v, l2v = l1v[..., None].expand(shape), l2v[..., None].expand(shape).contiguous()
        step = step[..., None]
    thr = step * l1v
    wsum_c = w_sum[fold.long()].contiguous()
    beta = torch.zeros(shape, dtype=torch.float32, device=dev)
    z = beta
    yd = y.to(dev, torch.float32).contiguous()
    grad_fn = {"logistic": fista_grad, "linear": linear_fista_grad,
               "softmax": softmax_fista_grad}[loss]
    for coef in _momentum(max_iter):
        grad = grad_fn(X1, yd, w, fold, z.contiguous(), l2v, wsum_c)
        beta_next = _soft_threshold(z - step * grad, thr)
        z = beta_next + coef * (beta_next - beta)
        beta = beta_next
    beta = beta.reshape((F, G) + shape[1:])
    if loss == "softmax":
        if fit_intercept:
            return LinearFit(beta[:, :, :-1].contiguous(), beta[:, :, -1].contiguous())
        return LinearFit(beta, torch.zeros((F, G, k), dtype=torch.float32, device=dev))
    if fit_intercept:
        return LinearFit(beta[..., :-1].contiguous(), beta[..., -1:].contiguous())
    return LinearFit(beta, torch.zeros((F, G, 1), dtype=torch.float32, device=dev))


def fit_logistic_grid_folds_fista(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor,
                                  l1s, l2s, max_iter: int = 200,
                                  fit_intercept: bool = True) -> LinearFit:
    """Elastic-net logistic fits for every (fold, grid) pair, on X's device.

    X f32[n, d]; y f32[n]; train_w f32[F, n]; l1s / l2s the G candidates'
    penalties.  Returns LinearFit with coef [F, G, d], intercept [F, G, 1].
    Each fit is the reference's ``fit_logistic_fista``: the step 1 / L with
    ``L = 0.25 sum(w x^2) / sum(w) + l2 + 1e-6``, the intercept unpenalized,
    ``max_iter`` FISTA steps with one shared momentum sequence."""
    return _fista_grid_folds(X, y, train_w, l1s, l2s, max_iter, fit_intercept, "logistic")


def fit_linear_grid_folds_fista(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor,
                                l1s, l2s, max_iter: int = 300,
                                fit_intercept: bool = True) -> LinearFit:
    """Elastic-net linear-regression fits for every (fold, grid) pair, on X's
    device: the reference's ``fit_linear_fista`` (the step 1 / L with
    ``L = sum(w x^2) / sum(w) + l2 + 1e-6``, the intercept unpenalized,
    ``max_iter`` FISTA steps); shapes as ``fit_logistic_grid_folds_fista``'s."""
    return _fista_grid_folds(X, y, train_w, l1s, l2s, max_iter, fit_intercept, "linear")


def fit_softmax_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, l1s, l2s,
                           num_classes: int, max_iter: int = 100,
                           fit_intercept: bool = True) -> LinearFit:
    """Elastic-net multinomial (softmax) fits for every (fold, grid) pair,
    on X's device: the reference's ``fit_softmax`` (the step 1 / L with
    ``L = 0.5 sum(w x^2) / sum(w) + l2 + 1e-6``, the intercept row
    unpenalized, ``max_iter`` FISTA steps) with ``y`` the class labels 0 ..
    ``num_classes`` - 1.  Returns coef [F, G, d, k], intercept [F, G, k]."""
    return _fista_grid_folds(X, y, train_w, l1s, l2s, max_iter, fit_intercept, "softmax",
                             k=int(num_classes))


def fit_logistic_fista(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor,
                       l1: float, l2: float, max_iter: int = 200,
                       fit_intercept: bool = True) -> LinearFit:
    """One elastic-net logistic fit (``l1 = reg * alpha``, ``l2 = reg * (1 -
    alpha)``, Spark's parameterization): coef [d], intercept [1]."""
    fit = fit_logistic_grid_folds_fista(X, y, sample_weight[None], [l1], [l2],
                                        max_iter=max_iter, fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


def fit_linear_fista(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor,
                     l1: float, l2: float, max_iter: int = 300,
                     fit_intercept: bool = True) -> LinearFit:
    """One elastic-net linear-regression fit: coef [d], intercept [1]."""
    fit = fit_linear_grid_folds_fista(X, y, sample_weight[None], [l1], [l2],
                                      max_iter=max_iter, fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


def fit_softmax(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor, l2: float,
                num_classes: int, max_iter: int = 100, fit_intercept: bool = True,
                l1: float = 0.0) -> LinearFit:
    """One elastic-net multinomial fit: coef [d, k], intercept [k]."""
    fit = fit_softmax_grid_folds(X, y, sample_weight[None], [l1], [l2], num_classes,
                                 max_iter=max_iter, fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


def predict_linear(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                   ) -> torch.Tensor:
    """The linear prediction f32[n]: ``X @ coef + intercept[0]``."""
    return X @ coef + intercept[0]


def predict_binary_logistic_grid(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every (fold, grid) fit's (raw [F, G, n, 2], prob [F, G, n, 2], pred
    [F, G, n]) from coef [F, G, d], intercept [F, G, 1]."""
    z = torch.einsum("nd,fgd->fgn", X, coef) + intercept
    p1 = _sigmoid(z)
    raw = torch.stack([-z, z], dim=-1)
    prob = torch.stack([1.0 - p1, p1], dim=-1)
    return raw, prob, (p1 >= 0.5).to(torch.float32)


def predict_binary_logistic(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(raw [n, 2], prob [n, 2], pred [n]) matching the reference's
    Prediction schema (rawPrediction_*, probability_*, prediction)."""
    z = X @ coef + intercept[0]
    p1 = torch.sigmoid(z)
    raw = torch.stack([-z, z], dim=-1)
    prob = torch.stack([1.0 - p1, p1], dim=-1)
    pred = (p1 >= 0.5).to(torch.float32)
    return raw, prob, pred


def predict_softmax_grid(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every (fold, grid) fit's (raw [F, G, n, k], prob [F, G, n, k], pred
    [F, G, n]) from coef [F, G, d, k], intercept [F, G, k]; the softmax as
    the reference's ``jax.nn.softmax`` writes it."""
    z = torch.einsum("nd,fgdk->fgnk", X, coef) + intercept[:, :, None, :]
    return z, _softmax(z), torch.argmax(z, dim=-1).to(torch.float32)


def predict_softmax(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(raw [n, k], prob [n, k], pred [n]) of a multinomial fit."""
    z = X @ coef + intercept
    prob = torch.softmax(z, dim=-1)
    pred = torch.argmax(z, dim=-1).to(torch.float32)
    return z, prob, pred
