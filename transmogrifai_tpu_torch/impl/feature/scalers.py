"""Scalers and calibrators.

The port's copy of ``transmogrifai_tpu/impl/feature/scalers.py`` (reference:
OpScalarStandardScaler.scala:49, ScalerTransformer.scala:56,
PercentileCalibrator.scala:48, IsotonicRegressionCalibrator.scala):

- ``OpScalarStandardScaler`` / ``Model``: z-score of one Real feature;
- ``ScalerTransformer`` / ``DescalerTransformer``: invertible scaling whose
  parameters ride in the scaler's stage metadata, so a descaler downstream
  can undo it;
- ``PercentileCalibrator`` / ``Model``: scores to [0, buckets) by the
  empirical quantiles;
- ``IsotonicRegressionCalibrator`` / ``Model`` and ``pav_fit``: monotone
  calibration by pool-adjacent-violators.  Its model has no device program:
  it stays a host stage, as in the JAX package.

The fits are host numpy, as in the JAX package.  The transforms follow the
fused-layer protocol (``impl/feature/_util.py``): a stage alone in its
layer computes on the host in float64 (``transform_columns``); fused or
streamed (past ``workflow/dag.STREAM_ROWS`` rows) it runs its device program
in float32, K-AC ``numeric_scale`` (``ops/layer.py``), as the JAX package
runs its ``jax_transform``.
"""
from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import numpy as np

from ... import types as T
from ...columns import Column, Dataset, NumericColumn
from ...ops import layer as L
from ...stages.base import (AllowLabelAsInput, BinaryEstimator, BinaryTransformer, Model,
                            UnaryEstimator, UnaryTransformer)
from ._util import stage_constant


class OpScalarStandardScaler(UnaryEstimator):
    """Real -> RealNN z-score (OpScalarStandardScaler.scala:49)."""

    def __init__(self, with_mean: bool = True, with_std: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="stdScaled", input_type=T.Real,
                         output_type=T.RealNN, uid=uid,
                         with_mean=with_mean, with_std=with_std)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset
                    ) -> "OpScalarStandardScalerModel":
        col = cols[0]
        assert isinstance(col, NumericColumn)
        vals = col.values[col.mask]
        mean = float(vals.mean()) if vals.size else 0.0
        std = float(vals.std()) if vals.size else 1.0
        return OpScalarStandardScalerModel(
            mean=mean if self.get_param("with_mean") else 0.0,
            std=std if (self.get_param("with_std") and std > 1e-12) else 1.0,
            operation_name=self.operation_name, output_type=self.output_type)


class OpScalarStandardScalerModel(Model):
    torch_output = "numeric"  # fused-layer protocol

    def __init__(self, mean: float, std: float, operation_name: str = "stdScaled",
                 output_type=T.RealNN, uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.mean = float(mean)
        self.std = float(std)

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        vals = (np.where(col.mask, col.values, self.mean) - self.mean) / self.std
        return NumericColumn(T.RealNN, vals, np.ones_like(col.mask))

    def torch_transform(self, v, m):
        return L.numeric_scale("standardize", v, m, self.mean, self.std)


class ScalingType(str, enum.Enum):
    Linear = "linear"
    Logarithmic = "log"


class ScalerTransformer(UnaryTransformer):
    """Invertible scaling; records (type, args) in metadata for the paired
    DescalerTransformer (ScalerTransformer.scala:56)."""

    torch_output = "numeric"  # fused-layer protocol

    def __init__(self, scaling_type: ScalingType = ScalingType.Linear,
                 slope: float = 1.0, intercept: float = 0.0,
                 uid: Optional[str] = None):
        super().__init__(operation_name="scaled", input_type=T.Real,
                         output_type=T.Real, uid=uid,
                         scaling_type=str(getattr(scaling_type, "value", scaling_type)),
                         slope=float(slope), intercept=float(intercept))
        self.metadata["scaler"] = {"type": self.get_param("scaling_type"),
                                   "slope": float(slope), "intercept": float(intercept)}

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        v, m = col.values, col.mask
        with np.errstate(divide="ignore", invalid="ignore"):
            if ScalingType(self.get_param("scaling_type")) is ScalingType.Linear:
                vals, mask = self.get_param("slope") * v + self.get_param("intercept"), m
            else:
                vals = np.log(v)
                mask = m & np.isfinite(vals)
        return NumericColumn(T.Real, np.where(mask, vals, 0.0), mask)

    def torch_transform(self, v, m):
        if ScalingType(self.get_param("scaling_type")) is ScalingType.Linear:
            return L.numeric_scale("scale_linear", v, m, self.get_param("slope"),
                                   self.get_param("intercept"))
        return L.numeric_scale("scale_log", v, m)


class DescalerTransformer(BinaryTransformer):
    """(scaled feature, scaler-origin feature) -> unscaled value: reads the
    scaler args from the second input's origin-stage metadata
    (DescalerTransformer.scala:56)."""

    torch_output = "numeric"  # fused-layer protocol

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="descaled", output_type=T.Real, uid=uid)

    def _scaler_args(self):
        origin = self.inputs[1].origin_stage
        info = (origin.metadata or {}).get("scaler")
        if info is None:
            raise ValueError("Descaler input 2 must descend from a ScalerTransformer")
        return info

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        info = self._scaler_args()
        if info["type"] == ScalingType.Linear.value:
            vals = (col.values - info["intercept"]) / info["slope"]
        else:
            vals = np.exp(col.values)
        return NumericColumn(T.Real, np.where(col.mask, vals, 0.0), col.mask)

    def torch_transform(self, v, m, v2, m2):
        info = self._scaler_args()
        if info["type"] == ScalingType.Linear.value:
            return L.numeric_scale("descale_linear", v, m, info["slope"], info["intercept"])
        return L.numeric_scale("descale_exp", v, m)


class PercentileCalibrator(UnaryEstimator):
    """RealNN score -> RealNN percentile bucket [0, buckets)
    (PercentileCalibrator.scala:48, default 100 buckets)."""

    def __init__(self, buckets: int = 100, uid: Optional[str] = None):
        super().__init__(operation_name="percCalibrate", input_type=T.RealNN,
                         output_type=T.RealNN, uid=uid, buckets=int(buckets))

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset
                    ) -> "PercentileCalibratorModel":
        col = cols[0]
        assert isinstance(col, NumericColumn)
        b = int(self.get_param("buckets"))
        qs = np.quantile(col.values[col.mask], np.linspace(0, 1, b + 1)) \
            if col.mask.any() else np.zeros(b + 1)
        return PercentileCalibratorModel(splits=np.asarray(qs, dtype=np.float64),
                                         operation_name=self.operation_name,
                                         output_type=self.output_type)


class PercentileCalibratorModel(Model):
    """The host path compares in float64; the device program compares with
    the float32 splits, as the JAX package's device program does (its
    ``jnp.asarray`` of the float64 splits is float32), so values at a split
    may land in the next bucket there."""

    torch_output = "numeric"  # fused-layer protocol

    def __init__(self, splits: np.ndarray, operation_name: str = "percCalibrate",
                 output_type=T.RealNN, uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.splits = np.asarray(splits, dtype=np.float64)

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        b = len(self.splits) - 1
        idx = np.clip(np.searchsorted(self.splits[1:-1], col.values, side="right"),
                      0, b - 1).astype(np.float64)
        return NumericColumn(T.RealNN, idx, np.ones_like(col.mask))

    def torch_transform(self, v, m):
        inner = stage_constant(self, "splits", self.splits[1:-1].astype(np.float32), v.device)
        return L.numeric_scale("bucket", v, m, splits=inner)


def pav_fit(x: np.ndarray, y: np.ndarray) -> tuple:
    """Pool-adjacent-violators: returns (thresholds, values) of the step fn."""
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order].astype(np.float64)
    vals: List[float] = []
    weights: List[float] = []
    xs_blocks: List[float] = []
    for xi, yi in zip(xs, ys):
        vals.append(float(yi))
        weights.append(1.0)
        xs_blocks.append(float(xi))
        while len(vals) > 1 and vals[-2] > vals[-1]:
            v = (vals[-2] * weights[-2] + vals[-1] * weights[-1]) / (weights[-2] + weights[-1])
            wsum = weights[-2] + weights[-1]
            vals.pop()
            weights.pop()
            xs_blocks.pop()
            vals[-1], weights[-1] = v, wsum
    return np.asarray(xs_blocks), np.asarray(vals)


class IsotonicRegressionCalibrator(AllowLabelAsInput, BinaryEstimator):
    """(label RealNN, score RealNN) -> calibrated RealNN via isotonic
    regression (IsotonicRegressionCalibrator.scala)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="isoCalibrate", output_type=T.RealNN, uid=uid)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset
                    ) -> "IsotonicRegressionCalibratorModel":
        label, score = cols
        assert isinstance(label, NumericColumn) and isinstance(score, NumericColumn)
        m = label.mask & score.mask
        thr, vals = pav_fit(score.values[m], label.values[m])
        return IsotonicRegressionCalibratorModel(
            thresholds=thr, values=vals, operation_name=self.operation_name,
            output_type=self.output_type)


class IsotonicRegressionCalibratorModel(Model):
    def __init__(self, thresholds: np.ndarray, values: np.ndarray,
                 operation_name: str = "isoCalibrate", output_type=T.RealNN,
                 uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.thresholds = np.asarray(thresholds, dtype=np.float64)
        self.values = np.asarray(values, dtype=np.float64)

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        _, score = cols
        assert isinstance(score, NumericColumn)
        if self.thresholds.size == 0:
            return NumericColumn(T.RealNN, np.zeros(len(score)), np.ones(len(score), bool))
        # linear interpolation between block means (Spark IsotonicRegression)
        vals = np.interp(score.values, self.thresholds, self.values)
        return NumericColumn(T.RealNN, vals, np.ones(len(score), bool))
