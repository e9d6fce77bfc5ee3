"""Statistics of the sanity checker — correlations, contingency stats, moments.

The port's copy of ``transmogrifai_tpu/utils/stats.py`` (reference:
OpStatistics.scala ``computeCorrelationsWithLabel:71``, ``chiSquaredTest:188``,
``contingencyStats:300``, ``mutualInfo:234``, ``maxConfidences:280``).  The
column moments and label correlations are float64, as the JAX package's
host numpy, but taken on the device that holds the columns; the JAX
package's two jit'd products run as the port's kernels (``ops/stats.py``):
the correlation matrix ``Z^T Z`` of the standardized columns (K-I) and the
contingency counts ``X^T onehot(y)`` (K-J).  Only their d-sized results
come to the host.  The statistics of the small contingency matrices are
host numpy; the chi-squared p-value uses scipy's regularized upper
incomplete gamma function.  Spearman correlations rank the columns and the
label on the device (``rank_data``: K-Y's midranks, the reference's
host ``_rank_data``), then run the same float64 Pearson over the ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy.special import gammaincc

from ..ops import stats as K


# ---------------------------------------------------------------------------
# Column moments + correlations
# ---------------------------------------------------------------------------
@dataclass
class ColStats:
    """Per-column summary (Statistics.colStats analog)."""

    count: int
    mean: np.ndarray
    variance: np.ndarray
    min: np.ndarray
    max: np.ndarray


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _col_moments(X: torch.Tensor):
    """Mean, n-1 variance, min and max of every column of X f64[n, d]."""
    n = X.shape[0]
    mean = X.mean(dim=0)
    var = X.var(dim=0, unbiased=True) if n > 1 else torch.zeros_like(mean)
    return mean, var, X.amin(dim=0), X.amax(dim=0)


def col_stats(X: torch.Tensor) -> ColStats:
    """Column moments of X f64[n, d] (inputs are already filled/dense)."""
    n, d = X.shape
    if n == 0:
        z = np.zeros(d)
        return ColStats(0, z, z.copy(), z.copy(), z.copy())
    return ColStats(n, *(_host(a) for a in _col_moments(X)))


def rank_data(x: torch.Tensor) -> torch.Tensor:
    """Average-tie ranks (1-based) f64 of x [n], or of each column of x [n,
    d], on x's device (Spearman prep; the reference's ``_rank_data``, whose
    ranks K-Y's midranks are)."""
    if x.ndim == 1:
        return rank_data(x[:, None])[:, 0]
    return K.midranks(x).to(torch.float64)


def correlations_with_label(X: torch.Tensor, y: torch.Tensor, method: str = "pearson",
                            with_corr_matrix: bool = False
                            ) -> Tuple[ColStats, np.ndarray, Optional[np.ndarray]]:
    """Label correlations of every column of X f64[n, d] with y f64[n] (one
    device), and optionally the full feature x feature correlation matrix.

    Reference: OpStatistics.computeCorrelationsWithLabel:71 (the n-1
    covariance formula, OpStatistics.scala:85-94); Spearman goes through the
    rank transform first (Spark Statistics.corr(..., "spearman")), and
    reports raw-space column stats with rank-space correlations.  Returns
    (col_stats_of_X, corr_with_label, corr_matrix_or_None) on the host.
    """
    n, d = X.shape
    if n < 2:
        z = np.zeros(d)
        return ColStats(n, z, z.copy(), z.copy(), z.copy()), np.full(d, np.nan), None
    Xr, yr = X, y
    if method == "spearman":
        Xr, yr = rank_data(X), rank_data(y)
    mean, var, xmin, xmax = _col_moments(Xr)
    yc = yr - yr.mean()
    cov_label = (Xr - mean).T @ yc / (n - 1)
    y_var = (yc @ yc) / (n - 1)
    corr = _host(cov_label / torch.sqrt(torch.clamp(var * y_var, min=1e-300)))
    var_h = _host(var)
    stats = (col_stats(X) if method == "spearman"
             else ColStats(n, _host(mean), var_h, _host(xmin), _host(xmax)))
    zero_var = var_h <= 0
    corr = np.where(zero_var, np.nan, corr)
    corr_matrix = None
    if with_corr_matrix:
        # standardized in float64, the product summed in float32 (K-I)
        Z = ((Xr - mean) / torch.sqrt(torch.clamp(var, min=1e-300))).to(torch.float32)
        corr_matrix = _host(K.corr_gram(Z)).astype(np.float64)
        np.fill_diagonal(corr_matrix, 1.0)
        corr_matrix[zero_var, :] = np.nan
        corr_matrix[:, zero_var] = np.nan
    return stats, corr, corr_matrix


# ---------------------------------------------------------------------------
# Contingency tables
# ---------------------------------------------------------------------------
def contingency_all_columns(X_indicator: torch.Tensor, y_classes: torch.Tensor,
                            n_classes: int) -> np.ndarray:
    """``counts[j, k] = Σ_i X[i, j] * 1[y_i == k]`` for every indicator column
    at once (the reference's label-grouped contingency reduce,
    SanityChecker.scala:252-272), one float32 product on the columns'
    device (K-J); float32 integer counts are exact below 2^24."""
    out = K.contingency_counts(X_indicator.to(torch.float32),
                               y_classes.to(X_indicator.device, torch.int32), n_classes)
    return _host(out).astype(np.float64)


def filter_empties(contingency: np.ndarray) -> np.ndarray:
    """Strip all-zero rows/cols (OpStatistics.filterEmpties:141 — the always-
    empty OTHER row from topK pivots must not break the chi-squared test)."""
    c = np.asarray(contingency, dtype=np.float64)
    c = c[c.sum(axis=1) > 0][:, None if c.size == 0 else slice(None)]
    if c.size:
        c = c[:, c.sum(axis=0) > 0]
    return c


def chi_squared(contingency: np.ndarray) -> Tuple[float, float, float]:
    """(cramers_v, chi2_stat, p_value) — OpStatistics.chiSquaredTestOnFiltered:202.

    No Yates' correction (explicitly matching the reference). Returns NaNs when
    the filtered matrix has <2 rows or <2 cols.
    """
    c = filter_empties(contingency)
    r, k = c.shape if c.ndim == 2 else (0, 0)
    if r < 2 or k < 2:
        return float("nan"), float("nan"), float("nan")
    total = c.sum()
    expected = np.outer(c.sum(axis=1), c.sum(axis=0)) / total
    stat = float(((c - expected) ** 2 / expected).sum())
    dof = (r - 1) * (k - 1)
    p = float(gammaincc(dof / 2.0, stat / 2.0))
    phi2 = stat / total
    cramers_v = float(np.sqrt(phi2 / min(r - 1, k - 1)))
    return cramers_v, stat, p


def pointwise_mutual_info(contingency: np.ndarray) -> Tuple[Dict[str, np.ndarray], float]:
    """PMI per (choice, label) + total MI — OpStatistics.mutualInfo:234.

    Zero-count cells get PMI 0.0 (reference behavior). Returns
    ({label_index_str: pmi_per_row}, mutual_info).
    """
    c = np.asarray(contingency, dtype=np.float64)
    if c.ndim != 2 or c.size == 0:
        return {}, float("nan")
    total = c.sum()
    row_sums = c.sum(axis=1, keepdims=True)   # per choice
    col_sums = c.sum(axis=0, keepdims=True)   # per label
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log2(np.maximum(c, 1e-99) * total / (row_sums * col_sums))
    pmi = np.where((c == 0) | (row_sums == 0) | (col_sums == 0), 0.0, pmi)
    mi = float((pmi * c / total).sum()) if total > 0 else float("nan")
    return {str(j): pmi[:, j] for j in range(c.shape[1])}, mi


def max_confidences(contingency: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Association-rule (choice => label) max confidence + per-choice support —
    OpStatistics.maxConfidences:280."""
    c = np.asarray(contingency, dtype=np.float64)
    row_sums = c.sum(axis=1)
    total = row_sums.sum()
    supports = row_sums / total if total > 0 else np.zeros_like(row_sums)
    with np.errstate(divide="ignore", invalid="ignore"):
        conf = np.where(row_sums > 0, c.max(axis=1) / np.maximum(row_sums, 1e-300), 0.0)
    return conf, supports


@dataclass
class ContingencyStats:
    """OpStatistics.ContingencyStats analog (OpStatistics.scala:119)."""

    cramers_v: float
    chi_squared_stat: float
    p_value: float
    pointwise_mutual_info: Dict[str, np.ndarray]
    mutual_info: float
    max_rule_confidences: np.ndarray
    supports: np.ndarray

    def to_json(self) -> Dict:
        return {
            "cramersV": self.cramers_v,
            "chiSquaredStat": self.chi_squared_stat,
            "pValue": self.p_value,
            "pointwiseMutualInfo": {k: list(v) for k, v in self.pointwise_mutual_info.items()},
            "mutualInfo": self.mutual_info,
            "maxRuleConfidences": list(self.max_rule_confidences),
            "supports": list(self.supports),
        }


def contingency_stats(contingency: np.ndarray) -> ContingencyStats:
    """All contingency-derived statistics (OpStatistics.contingencyStats:300)."""
    c = np.asarray(contingency, dtype=np.float64)
    if c.size == 0 or c.sum() == 0:
        nrows = c.shape[0] if c.ndim == 2 else 0
        return ContingencyStats(float("nan"), float("nan"), float("nan"), {},
                                float("nan"), np.zeros(nrows), np.zeros(nrows))
    cv, stat, p = chi_squared(c)
    pmi, mi = pointwise_mutual_info(c)
    conf, supports = max_confidences(c)
    return ContingencyStats(cv, stat, p, pmi, mi, conf, supports)
