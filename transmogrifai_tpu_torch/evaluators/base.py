"""Evaluator base classes.

The port's copy of ``transmogrifai_tpu/evaluators/base.py`` (host numpy).
Reference parity: core/src/main/scala/com/salesforce/op/evaluators/
``OpEvaluatorBase`` (:113): name, ``isLargerBetter``, ``evaluate`` (default
metric) / ``evaluateAll`` (full metric map).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..columns import Dataset, NumericColumn, PredictionColumn


class OpEvaluatorBase:
    name: str = "evaluator"
    default_metric: str = ""
    is_larger_better: bool = True

    def __init__(self, label_col: Optional[str] = None, prediction_col: Optional[str] = None):
        self.label_col = label_col
        self.prediction_col = prediction_col

    # ---- column extraction -------------------------------------------------
    def _extract(self, ds: Dataset, label_col: Optional[str], prediction_col: Optional[str]
                 ) -> Tuple[np.ndarray, PredictionColumn]:
        label_col = label_col or self.label_col
        prediction_col = prediction_col or self.prediction_col
        if label_col is None or prediction_col is None:
            raise ValueError(f"{self.name}: label/prediction columns not set")
        lab = ds[label_col]
        assert isinstance(lab, NumericColumn), f"label column {label_col} must be numeric"
        pred = ds[prediction_col]
        assert isinstance(pred, PredictionColumn), \
            f"prediction column {prediction_col} must be a Prediction"
        if not lab.mask.all():  # unlabeled rows never contribute to metrics
            keep = np.where(lab.mask)[0]
            lab = lab.take(keep)
            pred = pred.take(keep)
        return lab.values.astype(np.float64), pred

    def evaluate_all(self, ds: Dataset, label_col: Optional[str] = None,
                     prediction_col: Optional[str] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def evaluate(self, ds: Dataset, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None) -> float:
        return float(self.evaluate_all(ds, label_col, prediction_col)[self.default_metric])

    def evaluate_arrays(self, y: np.ndarray, prediction: np.ndarray,
                        probability: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Array fast path used by the model-selector sweep (no Dataset)."""
        raise NotImplementedError


class OpBinaryClassificationEvaluatorBase(OpEvaluatorBase):
    pass


class OpMultiClassificationEvaluatorBase(OpEvaluatorBase):
    pass


class OpRegressionEvaluatorBase(OpEvaluatorBase):
    pass
