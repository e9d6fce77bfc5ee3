"""Predictor stage abstraction: (RealNN label, OPVector features) -> Prediction.

The port's counterpart of ``transmogrifai_tpu/impl/selector/predictor.py``
(reference: OpPredictorWrapper / OpPredictorWrapperModel,
OpPredictorWrapper.scala:71,121).  A predictor implements the array-level
contract on a device:

- ``fit_arrays(X, y, w) -> params`` trains on a float32 feature matrix
  (a tensor on the training device) and returns numpy parameters, saved
  in the JAX package's layout;
- ``fit_grid_folds(X, y, train_w, grids)`` trains the whole fold x grid
  block and returns each candidate's predictions on every row;
- ``device_params(params, device)`` moves the parameters onto a device
  once, and ``predict_tensors(dparams, X) -> (prediction, raw,
  probability)`` scores there and returns host numpy arrays.  Together
  they are ``predict_arrays(params, X)``;
- ``predict_program(params)`` is the same head as a closure over device
  tensors (the linear families; the serving plane's head).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ... import types as T
from ...columns import Column, Dataset, NumericColumn, PredictionColumn, VectorColumn
from ...stages.base import AllowLabelAsInput, BinaryEstimator, Model
from ..feature._util import stage_device

Preds = Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]


def linear_head_program(params: Dict[str, Any], mode: str):
    """The ``predict_program`` of a linear family: ``X -> (pred, raw | None,
    prob | None)`` through K-AF (``ops/linear.predict_head``) in ``mode``,
    the fitted coefficients placed on each device the first time it scores
    there (a caller that captures it in a CUDA graph runs it eagerly
    first)."""
    from ...ops import linear as L

    coef = np.ascontiguousarray(params["coef"], dtype=np.float32)
    intercept = np.ascontiguousarray(params["intercept"], dtype=np.float32)
    placed: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def program(X: torch.Tensor):
        dp = placed.get(X.device)
        if dp is None:
            dp = placed.setdefault(X.device, (torch.from_numpy(coef).to(X.device),
                                              torch.from_numpy(intercept).to(X.device)))
        return L.predict_head(X.to(torch.float32), dp[0], dp[1], mode)

    return program


def as_matrix(X: Any, device: torch.device) -> torch.Tensor:
    """X as a contiguous float32 tensor on ``device``."""
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))
    return X.to(device=device, dtype=torch.float32).contiguous()


class PredictorEstimator(BinaryEstimator, AllowLabelAsInput):
    """Base estimator of the selector-grid models."""

    #: classification predictors emit probability/raw columns
    is_classifier: bool = True

    def __init__(self, operation_name: str, uid: Optional[str] = None, **params):
        super().__init__(operation_name=operation_name, output_type=T.Prediction,
                         uid=uid, **params)

    def check_input_types(self, features) -> None:
        super().check_input_types(features)
        label, vec = features
        if not issubclass(vec.ftype, T.OPVector):
            raise ValueError(f"{type(self).__name__} second input must be OPVector, "
                             f"got {vec.ftype.__name__}")
        if not label.is_response:
            raise ValueError("First input (label) must be a response feature "
                             "(CheckIsResponseValues analog)")

    # ---- array-level contract ---------------------------------------------
    def fit_arrays(self, X: Any, y: np.ndarray,
                   w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        raise NotImplementedError(f"{type(self).__name__}: fitting is not ported yet")

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        raise NotImplementedError

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor) -> Preds:
        """Returns (prediction[n], raw[n,k]|None, probability[n,k]|None)."""
        raise NotImplementedError

    @classmethod
    def predict_arrays(cls, params: Dict[str, Any], X: torch.Tensor) -> Preds:
        """Score X f32[n, d] (a tensor, on its device) with fitted params."""
        return cls.predict_tensors(cls.device_params(params, X.device), X)

    @classmethod
    def predict_program(cls, params: Dict[str, Any]):
        """A closure ``X -> (prediction, raw | None, probability | None)``
        over the fitted params, on ``X``'s device, returning device tensors
        (no host sync): the serving plane captures it in a bucket's CUDA
        graph or launches it on a replica's stream.  Families whose
        inference is not one device program (the trees' bin and walk) raise
        NotImplementedError, as the JAX package's do, and serve through the
        generic ``transform_dataset`` path."""
        raise NotImplementedError

    # ---- grid support ------------------------------------------------------
    def copy_with_params(self, overrides: Dict[str, Any]) -> "PredictorEstimator":
        merged = {**self._params, **overrides}
        est = type(self)(**merged)
        est.device = self.device
        return est

    def fit_grid_folds(self, X: Any, y: np.ndarray, train_w: np.ndarray,
                       grids: List[Dict[str, Any]]) -> List[List[Preds]]:
        """Train the fold x grid block; predictions on every row of X,
        indexed ``[fold][grid]``.  Raises NotImplementedError where there is
        no batched fit (the validator then fits candidate by candidate)."""
        raise NotImplementedError

    # ---- Dataset-level fit -------------------------------------------------
    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "PredictorModel":
        label_col, vec_col = cols
        assert isinstance(label_col, NumericColumn) and isinstance(vec_col, VectorColumn)
        X = vec_col.tensor(stage_device(self))
        y = label_col.values.astype(np.float32)
        if not label_col.mask.all():  # unlabeled rows never train
            keep = np.flatnonzero(label_col.mask)
            X, y = X[torch.from_numpy(keep).to(X.device)], y[keep]
        params = self.fit_arrays(X, y)
        return PredictorModel(predictor_class=type(self), model_params=params,
                              operation_name=self.operation_name)


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
