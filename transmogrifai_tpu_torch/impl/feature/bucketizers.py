"""Numeric bucketizers on the scoring path.

The port's copy of ``DecisionTreeNumericBucketizerModel`` and
``NumericBucketizer`` from ``transmogrifai_tpu/impl/feature/bucketizers.py``
(reference: NumericBucketizer.scala:54, DecisionTreeNumericBucketizer.scala:60).
The one-hot bucket membership runs on the stage's device with plain torch
ops; the right-side ``np.searchsorted`` becomes ``torch.searchsorted`` in
float64.  The tree fit that learns the splits is not ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ... import types as T
from ...columns import Column, NumericColumn, VectorColumn
from ...features.metadata import NULL_INDICATOR, VectorColumnMetadata, VectorMetadata
from ...stages.base import Model, UnaryTransformer
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
