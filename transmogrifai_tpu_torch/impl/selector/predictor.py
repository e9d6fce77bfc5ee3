"""Predictor stage abstraction on the scoring path.

The port's counterpart of ``transmogrifai_tpu/impl/selector/predictor.py``
(reference: OpPredictorWrapperModel, OpPredictorWrapper.scala:121).  A
predictor class implements the prediction half of the array-level contract:

- ``device_params(params, device)`` moves the saved numpy parameters onto
  the device once, when the model is placed;
- ``predict_tensors(dparams, X) -> (prediction, raw, probability)`` scores a
  float32 feature matrix on that device and returns host numpy arrays.

Together they are the JAX package's ``predict_arrays(params, X)``, split
so that the parameters cross to the device once.  Fitting is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ... import types as T
from ...columns import Column, PredictionColumn, VectorColumn
from ...stages.base import Model
from ..feature._util import stage_device

Preds = Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]


class PredictorEstimator:
    """Base of the selector-grid predictors: their prediction contract."""

    #: classification predictors emit probability/raw columns
    is_classifier: bool = True

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        raise NotImplementedError

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor) -> Preds:
        """Returns (prediction[n], raw[n,k]|None, probability[n,k]|None)."""
        raise NotImplementedError


class PredictorModel(Model):
    """Fitted predictor: applies ``predict_tensors`` to the feature vector."""

    def __init__(self, predictor_class: Type[PredictorEstimator] = PredictorEstimator,
                 model_params: Optional[Dict[str, Any]] = None,
                 operation_name: str = "predictor", uid: Optional[str] = None, **kw):
        super().__init__(operation_name, T.Prediction, uid=uid, **kw)
        self.predictor_class = predictor_class
        self.model_params = model_params or {}

    #: score in row chunks once n*d exceeds this many elements, so that the
    #: binned matrix and the walk's working set of a huge batch stay bounded
    _PREDICT_CHUNK_CELLS = 1 << 27

    def to(self, device) -> "PredictorModel":
        super().to(device)
        self._dparams = self.predictor_class.device_params(self.model_params, self.device)
        return self

    def _device_params(self) -> Dict[str, Any]:
        dparams = getattr(self, "_dparams", None)
        if dparams is None:
            self.to(stage_device(self))
            dparams = self._dparams
        return dparams

    def transform_columns(self, cols: Sequence[Column]) -> PredictionColumn:
        vec_col = cols[-1]
        assert isinstance(vec_col, VectorColumn)
        dparams = self._device_params()
        V = vec_col.tensor(stage_device(self))
        n, d = V.shape
        if n * d <= self._PREDICT_CHUNK_CELLS:
            parts = [self.predictor_class.predict_tensors(dparams, V)]
        else:
            rows = max(self._PREDICT_CHUNK_CELLS // max(d, 1), 1)
            parts = [self.predictor_class.predict_tensors(dparams, V[lo:lo + rows])
                     for lo in range(0, n, rows)]
        pred = np.concatenate([np.asarray(p, np.float64) for p, _, _ in parts])
        raw = None if parts[0][1] is None else np.concatenate(
            [np.asarray(r, np.float64) for _, r, _ in parts])
        prob = None if parts[0][2] is None else np.concatenate(
            [np.asarray(q, np.float64) for _, _, q in parts])
        return PredictionColumn(T.Prediction, pred, raw, prob)
