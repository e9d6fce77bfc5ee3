"""Streamed column statistics on one device: moments, correlations, ranks.

The port's copy of ``transmogrifai_tpu/parallel/stats.py`` (reference: the
treeAggregates of Spark's ``Statistics.colStats`` / ``Statistics.corr``,
SanityChecker.scala:406-470).  Rows arrive in chunks: torch tensors, which
stay on their device, or numpy arrays, which are cast to float32 as the
reference's and placed on ``device`` (``None``: the CUDA card).  Each chunk
is reduced on the device by the port's kernels (``ops/stats.py``), the
carries stay there in float64 and merge by torch ops, and the finalize
(variances, correlations) is host numpy in float64, as the reference's:

- pass 1, ``DataShardedStats.moments``: count, sum, sum of squares, min and
  max of each column (K-X raw mode);
- pass 2, ``correlations_from``: the Gram of ``[X | y]`` centered at given
  means (K-I centered mode), whence the label correlations and the
  feature x feature correlation matrix;
- one pass, ``fused_moments_and_correlations``: each chunk's own means,
  min and max (K-X Chan mode) and its Gram at those means (K-I centered
  mode), merged into the carry by Chan's pairwise rule, so no large-offset
  cancellation enters the sums when the mean drifts over the rows;
- ``sharded_column_moments``: column mean and population std by Chan
  partials (K-X Chan mode);
- ``rank_transform``: per-column average-tie midranks in blocks of 128
  columns (K-Y), Spearman's rank transform; the Pearson passes then run
  over the ranks, whose mean is exactly (n + 1) / 2.

One device, one process: a ``mesh`` or more than one device raises
``NotImplementedError`` (multi-GPU through ``torch.distributed``, ROADMAP
Queue 1 item 7).  The reference's cross-host tier (``_kv_gather``,
``_cross_host_gather``, ``host_*``), the identity in one process, is not
ported, and neither is its padding of a chunk to the mesh's shard count
(no mask: every row of a chunk counts).  The reference's carries are
float32, the port's float64: its sums are the exact answer's to float64
rounding, the reference's to its float32 accumulation.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import stats as K
from ..utils.device import resolve_device
from ..utils.stats import ColStats, _host


def _single_device(mesh=None, devices=None) -> None:
    if mesh is not None or (devices is not None and len(devices) > 1):
        raise NotImplementedError(
            "the port's streamed statistics run on one device: a mesh or several devices "
            "wait for multi-GPU through torch.distributed (ROADMAP Queue 1 item 7)")


def _place(arr, device) -> torch.Tensor:
    """A chunk as a float32 tensor: a tensor on its own device, a numpy
    array on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.float32)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(arr, np.float32)),
                           device=resolve_device(device))


def _correlations(G: np.ndarray, with_corr_matrix: bool
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(corr_with_label [d], corr_matrix [d, d] | None) from the centered
    Gram f64[d + 1, d + 1] of [X | y]; a column whose centered sum of
    squares is not positive gets NaN (Spark semantics)."""
    d = G.shape[0] - 1
    gy, yy = G[:d, d], float(G[d, d])
    G = G[:d, :d]
    diag = np.diag(G).copy()
    zero = diag <= 0.0
    denom = np.sqrt(np.maximum(diag, 1e-300))
    with np.errstate(invalid="ignore", divide="ignore"):
        corr_label = gy / (denom * np.sqrt(max(yy, 1e-300)))
    corr_label[zero] = np.nan
    corr_matrix = None
    if with_corr_matrix:
        corr_matrix = G / np.outer(denom, denom)
        np.fill_diagonal(corr_matrix, 1.0)
        corr_matrix[zero, :] = np.nan
        corr_matrix[:, zero] = np.nan
    return corr_label, corr_matrix


class DataShardedStats:
    """Two-pass streaming moments + correlations over row chunks, on one
    device (``mesh`` must be ``None``).  Chunks may be any row count."""

    def __init__(self, d: int, mesh=None, device=None):
        _single_device(mesh)
        self.d = d
        self.device = device

    # ---- pass 1 ------------------------------------------------------------
    def moments(self, chunks: Iterable) -> ColStats:
        n, carry = 0, None
        for X in chunks:
            X = _place(X, self.device)
            st = K.chunk_moments(X, mode="raw")
            if carry is None:
                carry = st
            else:
                carry[:2] += st[:2]
                torch.minimum(carry[2], st[2], out=carry[2])
                torch.maximum(carry[3], st[3], out=carry[3])
            n += X.shape[0]
        if carry is None:
            z = np.zeros(self.d)
            s1, s2, mn, mx = z, z, np.full(self.d, np.inf), np.full(self.d, -np.inf)
        else:
            s1, s2, mn, mx = _host(carry)
        mean = s1 / max(n, 1.0)
        var = np.maximum(s2 / max(n, 1.0) - mean * mean, 0.0) * (
            n / max(n - 1.0, 1.0))  # sample variance (Spark colStats)
        return ColStats(count=n, mean=mean, variance=var, min=mn, max=mx)

    # ---- pass 2 ------------------------------------------------------------
    def correlations_from(self, chunks_factory, mean: np.ndarray, y_mean: float,
                          with_corr_matrix: bool = True
                          ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``chunks_factory()`` yields (X_chunk [rows, d], y_chunk [rows])
        pairs.  Returns (corr_with_label [d], corr_matrix [d, d] | None)."""
        centers = np.append(np.asarray(mean, np.float64), float(y_mean))
        G = None
        for X, y in chunks_factory():
            X, y = _place(X, self.device), _place(y, self.device)
            if G is None:
                centers = torch.from_numpy(centers).to(X.device)
                G = K.centered_gram(X, y, centers)
            else:
                G += K.centered_gram(X, y, centers)
        G = np.zeros((self.d + 1, self.d + 1)) if G is None else _host(G)
        return _correlations(G, with_corr_matrix)


def chunked(X, y=None, chunk_rows: int = 1 << 18):
    """Row-chunk an in-memory array or tensor (factory usable for both
    passes)."""
    n = X.shape[0]

    def gen_x():
        for lo in range(0, n, chunk_rows):
            yield X[lo:lo + chunk_rows]

    if y is None:
        return gen_x

    def gen_xy():
        for lo in range(0, n, chunk_rows):
            yield X[lo:lo + chunk_rows], y[lo:lo + chunk_rows]

    return gen_xy


def _chan_merge(a, b):
    """Chan's pairwise merge of two (n, mean, M2) carries (numpy or torch)."""
    na, ma, qa = a
    nb, mb, qb = b
    nt = na + nb
    dx = mb - ma
    return nt, ma + dx * (nb / nt), qa + qb + (na * nb / nt) * dx * dx


def _merge_moment_carries(carries):
    """Chan-merge per-device (n, mean, M2) partials host-side in f64 (one
    device: the one carry)."""
    n_t: float = 0.0
    mean_t = M2_t = None
    for c in carries:
        n_c, mean_c, M2_c = (np.asarray(x, np.float64) for x in c)
        n_c = float(n_c)
        if n_c <= 0:
            continue
        if mean_t is None:
            n_t, mean_t, M2_t = n_c, mean_c, M2_c
            continue
        n_t, mean_t, M2_t = _chan_merge((n_t, mean_t, M2_t), (n_c, mean_c, M2_c))
    return n_t, mean_t, M2_t


def sharded_column_moments(X, chunk_rows: int = 1 << 18, devices: Optional[list] = None
                           ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Column mean and POPULATION std of ``X [n, d]`` by Chan partials of
    its row chunks (K-X Chan mode), merged on the device in float64.
    Returns ``(count, mean, std)`` f64.  ``devices`` names at most one
    device (numpy chunks go there; ``None``: the CUDA card, or a tensor's
    own device)."""
    _single_device(devices=devices)
    n = X.shape[0]
    d = X.shape[1] if X.ndim > 1 else 1
    X = X.reshape(n, d)
    device = devices[0] if devices else None
    carry = None
    for lo in range(0, n, chunk_rows):
        chunk = _place(X[lo:lo + chunk_rows], device)
        st = K.chunk_moments(chunk, mode="chan")
        part = (chunk.shape[0], st[0], st[1])
        carry = part if carry is None else _chan_merge(carry, part)
    n_t, mean, M2 = _merge_moment_carries(
        [] if carry is None else [(carry[0], _host(carry[1]), _host(carry[2]))])
    if not n_t or mean is None:
        z = np.zeros(d)
        return 0.0, z, z.copy()
    return n_t, mean, np.sqrt(np.maximum(M2, 0.0) / n_t)


def rank_transform(X, block_cols: int = 128, device=None) -> torch.Tensor:
    """Global average-tie ranks (1-based) f32 of each column of X [n, d] (or
    of X [n]), in column blocks on the device (K-Y; parity with
    ``utils/stats.rank_data``).  A numpy X is cast to float32 and placed on
    ``device``; a tensor is ranked in its own float type."""
    if not isinstance(X, torch.Tensor):
        X = _place(X, device)
    if X.ndim == 1:
        return rank_transform(X[:, None], block_cols)[:, 0]
    n, d = X.shape
    out = torch.empty((n, d), dtype=torch.float32, device=X.device)
    for lo in range(0, d, block_cols):
        K.midranks(X[:, lo:lo + block_cols], out=out[:, lo:lo + block_cols])
    return out


def fused_moments_and_correlations(chunks_factory, d: int, mesh=None,
                                   with_corr_matrix: bool = True, device=None
                                   ) -> Tuple[ColStats, np.ndarray, Optional[np.ndarray]]:
    """ONE streaming pass: column moments AND label/feature correlations.

    ``chunks_factory()`` yields (X_chunk [rows, d], y_chunk [rows]) pairs.
    Each chunk's means, min and max (K-X Chan mode) and its Gram centered at
    those means (K-I centered mode) merge into the carry by Chan's pairwise
    rule (f = n0 nc / (n0 + nc); G += Gc + f dx dx^T over [X | y]); the
    sample variance falls out of the Gram's diagonal.
    """
    _single_device(mesh)
    n, mean, G, mn, mx = 0, None, None, None, None
    for X, y in chunks_factory():
        X, y = _place(X, device), _place(y, device)
        nc = X.shape[0]
        st = K.chunk_moments(X, y, mode="chan")
        mc = st[0]
        Gc = K.centered_gram(X, y, mc)
        if mean is None:
            n, mean, G, mn, mx = nc, mc, Gc, st[2, :d], st[3, :d]
            continue
        nt = n + nc
        dx = mc - mean
        G = G + Gc + (n * nc / nt) * torch.outer(dx, dx)
        mean = mean + dx * (nc / nt)
        mn, mx = torch.minimum(mn, st[2, :d]), torch.maximum(mx, st[3, :d])
        n = nt
    if mean is None:
        z = np.zeros(d)
        return ColStats(0, z, z.copy(), z.copy(), z.copy()), np.full(d, np.nan), None
    mean, G, mn, mx = (_host(t) for t in (mean, G, mn, mx))
    # sample variance straight off the centered Gram's diagonal
    var = np.maximum(np.diag(G)[:d], 0.0) / max(n - 1.0, 1.0)
    stats = ColStats(count=n, mean=mean[:d], variance=var, min=mn, max=mx)
    corr_label, corr_matrix = _correlations(G, with_corr_matrix)
    return stats, corr_label, corr_matrix


def _mean64(y) -> float:
    if isinstance(y, torch.Tensor):
        return float(y.double().mean()) if len(y) else 0.0
    y64 = np.asarray(y, np.float64)
    return float(y64.mean()) if len(y64) else 0.0


def sharded_correlations(X, y, mesh=None, with_corr_matrix: bool = True,
                         chunk_rows: int = 1 << 18, method: str = "pearson", device=None,
                         cols: Optional[Sequence[int]] = None
                         ) -> Tuple[ColStats, np.ndarray, Optional[np.ndarray]]:
    """The large-data correlation path of the sanity checker: two streaming
    passes over row chunks.  ``method`` "spearman" rank-transforms the
    columns on the device first and streams Pearson over the ranks; column
    stats are always raw-space and cover every column, the correlations
    only ``cols`` (default: all; the others are dropped chunk by chunk).
    Returns (col_stats, corr_with_label, corr_matrix | None) matching
    ``utils/stats.correlations_with_label``."""
    _single_device(mesh)
    n, d = X.shape
    stats = DataShardedStats(d, device=device).moments(chunked(X, chunk_rows=chunk_rows)())
    sub = None if cols is None or len(cols) == d else list(cols)
    if method == "spearman":
        Xc = rank_transform(X if sub is None else X[:, sub], device=device)
        yc = rank_transform(_place(y, device))
        sub = None  # the ranks hold only the correlated columns
        mean_c = np.full(Xc.shape[1], (n + 1) / 2.0)  # midrank mean, exact
        y_mean = (n + 1) / 2.0
    else:
        Xc, yc = X, y
        mean_c = stats.mean if sub is None else stats.mean[sub]
        y_mean = _mean64(y)

    def xy_chunks():
        for lo in range(0, n, chunk_rows):
            Xb = Xc[lo:lo + chunk_rows]
            yield (Xb if sub is None else Xb[:, sub]), yc[lo:lo + chunk_rows]

    corr_label, corr_matrix = DataShardedStats(len(mean_c), device=device).correlations_from(
        xy_chunks, mean_c, y_mean, with_corr_matrix=with_corr_matrix)
    return stats, corr_label, corr_matrix
