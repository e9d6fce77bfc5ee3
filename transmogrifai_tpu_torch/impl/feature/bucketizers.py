"""Numeric bucketizers: fixed-split and label-aware (decision-tree) binning.

The port's copy of ``NumericBucketizer``, ``DecisionTreeNumericBucketizer``
(with ``find_tree_splits``) and its model from
``transmogrifai_tpu/impl/feature/bucketizers.py`` (reference:
NumericBucketizer.scala:54, DecisionTreeNumericBucketizer.scala:60).  The
split search is the JAX package's host numpy histogram sweep.  The one-hot
bucket membership runs on the stage's device with plain torch ops; the
right-side ``np.searchsorted`` becomes ``torch.searchsorted`` in float64.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import types as T
from ...columns import Column, Dataset, NumericColumn, VectorColumn
from ...features.metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata
from ...stages.base import AllowLabelAsInput, BinaryEstimator, Model, UnaryTransformer
from ._util import finalize_vector, stage_device


def _bucket_block(values: np.ndarray, mask: np.ndarray, splits: Sequence[float],
                  track_nulls: bool, track_invalid: bool,
                  device: torch.device) -> torch.Tensor:
    """One-hot bucket membership; buckets are [s_i, s_{i+1}) half-open with
    the last bucket closed (Spark Bucketizer semantics)."""
    v = torch.from_numpy(np.asarray(values, np.float64)).to(device)
    m = torch.from_numpy(np.asarray(mask, bool)).to(device)
    k = len(splits) - 1
    width = k + (1 if track_invalid else 0) + (1 if track_nulls else 0)
    inner = torch.tensor(splits[1:-1], dtype=torch.float64, device=device)
    idx = torch.clamp(torch.searchsorted(inner, v, right=True), max=k - 1)
    in_range = (v >= splits[0]) & (v <= splits[-1])
    cols = torch.arange(width, device=device)[None, :]
    block = ((cols == idx[:, None]) & (m & in_range)[:, None])
    if track_invalid:
        block[:, k] = m & ~in_range
    if track_nulls:
        block[:, width - 1] = ~m
    return block.to(torch.float32)


def _bucket_meta(fname: str, ftype: str, splits: Sequence[float], track_nulls: bool,
                 track_invalid: bool) -> List[VectorColumnMetadata]:
    meta = [VectorColumnMetadata((fname,), (ftype,),
                                 indicator_value=f"{splits[j]}-{splits[j + 1]}")
            for j in range(len(splits) - 1)]
    if track_invalid:
        meta.append(VectorColumnMetadata((fname,), (ftype,), indicator_value="OutOfBound"))
    if track_nulls:
        meta.append(VectorColumnMetadata((fname,), (ftype,), indicator_value=NULL_INDICATOR))
    return meta


class NumericBucketizer(UnaryTransformer):
    """Real -> OPVector one-hot buckets for fixed splits
    (NumericBucketizer.scala:54)."""

    def __init__(self, splits: Sequence[float], track_nulls: bool = True,
                 track_invalid: bool = False, uid: Optional[str] = None):
        splits = [float(s) for s in splits]
        if len(splits) < 2 or any(a >= b for a, b in zip(splits, splits[1:])):
            raise ValueError(f"Splits must be monotonically increasing, got {splits}")
        super().__init__(operation_name="numBucket", input_type=T.Real,
                         output_type=T.OPVector, uid=uid, splits=splits,
                         track_nulls=track_nulls, track_invalid=track_invalid)

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        splits = self.get_param("splits")
        track_nulls = bool(self.get_param("track_nulls"))
        track_invalid = bool(self.get_param("track_invalid"))
        block = _bucket_block(col.values, col.mask, splits, track_nulls, track_invalid,
                              stage_device(self))
        f = self.inputs[0]
        meta = _bucket_meta(f.name, f.ftype.__name__, splits, track_nulls, track_invalid)
        return finalize_vector(self, [block], meta, len(col))


def find_tree_splits(values: np.ndarray, labels: np.ndarray, max_depth: int = 2,
                     min_info_gain: float = 0.01, max_bins: int = 32,
                     min_instances_per_node: int = 1) -> List[float]:
    """Decision-tree split thresholds via vectorized histogram impurity sweep.

    Gini impurity over integer class labels; candidate thresholds are
    ``max_bins`` quantile edges (Spark DecisionTree's binning strategy).
    Recursion depth ``max_depth`` yields at most 2^depth buckets.
    """
    if values.size == 0:
        return []
    classes = np.unique(labels)
    if classes.size < 2:
        return []
    y = np.searchsorted(classes, labels)
    k = classes.size
    edges = np.unique(np.quantile(values, np.linspace(0, 1, max_bins + 1)[1:-1]))
    if edges.size == 0:
        return []

    def gini(counts: np.ndarray) -> float:
        tot = counts.sum()
        if tot == 0:
            return 0.0
        p = counts / tot
        return float(1.0 - np.sum(p * p))

    def best_split(vals: np.ndarray, ys: np.ndarray) -> Optional[Tuple[float, float]]:
        if vals.size < 2 * min_instances_per_node:
            return None
        # class histogram per candidate bin
        bin_idx = np.searchsorted(edges, vals, side="right")  # 0..len(edges)
        hist = np.zeros((edges.size + 1, k), dtype=np.float64)
        np.add.at(hist, (bin_idx, ys), 1.0)
        left = np.cumsum(hist, axis=0)[:-1]          # counts <= edge_j
        total = hist.sum(axis=0)
        right = total - left
        nl, nr = left.sum(axis=1), right.sum(axis=1)
        n = vals.size
        parent = gini(total)
        valid = (nl >= min_instances_per_node) & (nr >= min_instances_per_node)
        if not valid.any():
            return None
        with np.errstate(divide="ignore", invalid="ignore"):
            gl = 1.0 - np.sum((left / np.maximum(nl, 1)[:, None]) ** 2, axis=1)
            gr = 1.0 - np.sum((right / np.maximum(nr, 1)[:, None]) ** 2, axis=1)
        gain = parent - (nl / n) * gl - (nr / n) * gr
        gain = np.where(valid, gain, -np.inf)
        j = int(np.argmax(gain))
        if gain[j] < min_info_gain:
            return None
        return float(edges[j]), float(gain[j])

    splits: List[float] = []

    def recurse(vals: np.ndarray, ys: np.ndarray, depth: int) -> None:
        if depth >= max_depth:
            return
        found = best_split(vals, ys)
        if found is None:
            return
        thr, _ = found
        splits.append(thr)
        lm = vals <= thr
        recurse(vals[lm], ys[lm], depth + 1)
        recurse(vals[~lm], ys[~lm], depth + 1)

    recurse(values, y, 0)
    return sorted(set(splits))


class DecisionTreeNumericBucketizer(AllowLabelAsInput, BinaryEstimator):
    """(label RealNN, Real) -> OPVector of tree-learned buckets
    (DecisionTreeNumericBucketizer.scala:60).

    If the tree finds no informative split (info gain below
    ``min_info_gain``), the output is an empty vector block — the feature
    contributes nothing, exactly the reference's degenerate-tree behavior.
    """

    def __init__(self, max_depth: int = 2, min_info_gain: float = 0.01,
                 max_bins: int = 32, track_nulls: bool = True,
                 track_invalid: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="dtNumBucket", output_type=T.OPVector, uid=uid,
                         max_depth=max_depth, min_info_gain=min_info_gain,
                         max_bins=max_bins, track_nulls=track_nulls,
                         track_invalid=track_invalid)

    def fit_columns(self, cols: Sequence[Column],
                    dataset: Dataset) -> "DecisionTreeNumericBucketizerModel":
        label, col = cols
        assert isinstance(label, NumericColumn) and isinstance(col, NumericColumn)
        m = col.mask & label.mask
        inner = find_tree_splits(col.values[m], label.values[m],
                                 max_depth=int(self.get_param("max_depth")),
                                 min_info_gain=float(self.get_param("min_info_gain")),
                                 max_bins=int(self.get_param("max_bins")))
        splits = [-np.inf] + inner + [np.inf] if inner else []
        return DecisionTreeNumericBucketizerModel(
            splits=splits, track_nulls=bool(self.get_param("track_nulls")),
            track_invalid=bool(self.get_param("track_invalid")),
            operation_name=self.operation_name, output_type=self.output_type)


class DecisionTreeNumericBucketizerModel(Model):
    def __init__(self, splits: List[float], track_nulls: bool = True,
                 track_invalid: bool = True, operation_name: str = "dtNumBucket",
                 output_type=T.OPVector, uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.splits = [float(s) for s in splits]
        self.track_nulls = bool(track_nulls)
        self.track_invalid = bool(track_invalid)

    @property
    def did_split(self) -> bool:
        return len(self.splits) >= 2

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        _, col = cols
        assert isinstance(col, NumericColumn)
        f = self.inputs[1]
        if not self.did_split:
            vm = VectorMetadata(self.get_outputs()[0].name, ())
            self.metadata["vector_metadata"] = vm
            return VectorColumn(T.OPVector, torch.zeros((len(col), 0), dtype=torch.float32,
                                                         device=stage_device(self)), vm)
        block = _bucket_block(col.values, col.mask, self.splits, self.track_nulls,
                              self.track_invalid, stage_device(self))
        meta = _bucket_meta(f.name, f.ftype.__name__, self.splits, self.track_nulls,
                            self.track_invalid)
        return finalize_vector(self, [block], meta, len(col))
