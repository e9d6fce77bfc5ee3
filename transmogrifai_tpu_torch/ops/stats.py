"""The sanity checker's column products on the device: the correlation
matrix (K-I) and the contingency counts (K-J).

Replace the two jit'd products of ``transmogrifai_tpu/utils/stats.py``:

- ``corr_gram`` (K-I) — ``_corr_matrix_kernel`` (:47): ``Z^T Z / max(n-1, 1)``
  of the standardized columns Z f32[n, d].
- ``contingency_counts`` (K-J) — ``_contingency_kernel`` (:137):
  ``X^T onehot(y)`` of the indicator columns X f32[n, d] against the label
  classes y i32[n], without building the one-hot (a class outside
  [0, n_classes) adds to no column).

Both are CUDA (``csrc/col_stats.cu``): row chunks summed in row order by
one thread per output cell, the chunks added in chunk order, so runs repeat
bit for bit.  The plain PyTorch version of each sits beside it; a wrapper
takes it only for CPU tensors, and for CUDA tensors launches its kernel or
raises.  ``<wrapper>.launches`` counts the wrapper's launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build
from .trees import _require, _stream

_SIGNATURES = {
    "col_products_chunks": ([ctypes.c_int] * 3, ctypes.c_int),
    "corr_gram_f32": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                                     ctypes.c_void_p],
                      ctypes.c_int),
    "contingency_counts_f32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                               ctypes.c_int),
}


def _denominator(n: int) -> float:
    return float(max(n - 1, 1))


# ---------------------------------------------------------------------------
# K-I corr_gram
# ---------------------------------------------------------------------------
def corr_gram_plain(Z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-I."""
    return (Z.T @ Z) / _denominator(Z.shape[0])


def corr_gram(Z: torch.Tensor) -> torch.Tensor:
    """The correlation matrix f32[d, d] of standardized columns Z f32[n, d]:
    ``Z^T Z / max(n - 1, 1)``, summed in float32."""
    _require(Z.dtype == torch.float32 and Z.ndim == 2, "Z must be float32[n, d]")
    n, d = Z.shape
    if not _on_cuda(Z):
        return corr_gram_plain(Z)
    if n == 0 or d == 0:
        return torch.zeros((d, d), dtype=torch.float32, device=Z.device)
    lib = cuda_build.load("col_stats", _SIGNATURES)
    Z = Z.contiguous()
    partial = torch.empty((lib.col_products_chunks(n, d, d), d, d), dtype=torch.float32,
                          device=Z.device)
    out = torch.empty((d, d), dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = lib.corr_gram_f32(Z.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d,
                               _denominator(n), _stream(Z))
    cuda_build.check_launch("corr_gram", rc)
    corr_gram.launches += 1
    return out


corr_gram.launches = 0


# ---------------------------------------------------------------------------
# K-J contingency_counts
# ---------------------------------------------------------------------------
def contingency_counts_plain(X: torch.Tensor, cls: torch.Tensor, n_classes: int
                             ) -> torch.Tensor:
    """Plain PyTorch version of K-J."""
    onehot = cls.long()[:, None] == torch.arange(n_classes, device=X.device)[None]
    return X.T @ onehot.to(torch.float32)


def contingency_counts(X: torch.Tensor, cls: torch.Tensor, n_classes: int) -> torch.Tensor:
    """``counts[j, k] = sum_i X[i, j] * (cls[i] == k)`` as f32[d, n_classes]
    for the columns X f32[n, d] and the label classes cls i32[n]."""
    _require(X.dtype == torch.float32 and X.ndim == 2, "X must be float32[n, d]")
    n, d = X.shape
    _require(cls.dtype == torch.int32 and tuple(cls.shape) == (n,), f"cls must be int32[{n}]")
    _require(n_classes >= 1, "need n_classes >= 1")
    if not _on_cuda(X, cls):
        return contingency_counts_plain(X, cls, n_classes)
    if n == 0 or d == 0:
        return torch.zeros((d, n_classes), dtype=torch.float32, device=X.device)
    lib = cuda_build.load("col_stats", _SIGNATURES)
    X, cls = X.contiguous(), cls.contiguous()
    partial = torch.empty((lib.col_products_chunks(n, d, n_classes), d, n_classes),
                          dtype=torch.float32, device=X.device)
    out = torch.empty((d, n_classes), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        rc = lib.contingency_counts_f32(X.data_ptr(), cls.data_ptr(), partial.data_ptr(),
                                        out.data_ptr(), n, d, n_classes, _stream(X))
    cuda_build.check_launch("contingency_counts", rc)
    contingency_counts.launches += 1
    return out


contingency_counts.launches = 0
