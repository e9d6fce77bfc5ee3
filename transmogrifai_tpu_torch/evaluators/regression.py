"""The regression evaluator (host numpy).

The port's copy of ``OpRegressionEvaluator`` of
``transmogrifai_tpu/evaluators/regression.py`` (reference:
evaluators/OpRegressionEvaluator.scala:55): RMSE (the default), MSE, R2,
MAE and the signed-percentage-error histogram, in float64.  The forecast
evaluator is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .base import OpRegressionEvaluatorBase


class OpRegressionEvaluator(OpRegressionEvaluatorBase):
    name = "regEval"
    default_metric = "RootMeanSquaredError"
    is_larger_better = False

    def __init__(self, label_col: Optional[str] = None, prediction_col: Optional[str] = None,
                 percentage_error_histogram_bins: Optional[List[float]] = None):
        super().__init__(label_col, prediction_col)
        self.hist_bins = percentage_error_histogram_bins or \
            [float("-inf"), -100.0, -50.0, -25.0, -10.0, 0.0, 10.0, 25.0, 50.0, 100.0,
             float("inf")]

    def evaluate_arrays(self, y, prediction, probability=None) -> Dict[str, Any]:
        y = np.asarray(y, dtype=np.float64)
        pred = np.asarray(prediction, dtype=np.float64)
        err = pred - y
        mse = float(np.mean(err ** 2)) if len(y) else 0.0
        ss_tot = float(((y - y.mean()) ** 2).sum()) if len(y) else 0.0
        r2 = 1.0 - float((err ** 2).sum()) / ss_tot if ss_tot > 0 else 0.0
        # signed percentage errors (SignedPercentageErrorHistogram)
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = np.where(y != 0, 100.0 * err / np.abs(y), np.sign(err) * np.inf)
        counts, _ = np.histogram(pct[np.isfinite(pct)], bins=self.hist_bins)
        return {
            "RootMeanSquaredError": float(np.sqrt(mse)),
            "MeanSquaredError": mse,
            "R2": r2,
            "MeanAbsoluteError": float(np.mean(np.abs(err))) if len(y) else 0.0,
            "SignedPercentageErrorHistogram": {
                "bins": [b for b in self.hist_bins],
                "counts": counts.tolist(),
            },
        }

    def evaluate_all(self, ds, label_col=None, prediction_col=None) -> Dict[str, Any]:
        y, pred = self._extract(ds, label_col, prediction_col)
        return self.evaluate_arrays(y, pred.prediction)
