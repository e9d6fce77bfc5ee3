"""OpLogisticRegression: the binary elastic-net fit and prediction.

The port's counterpart of ``transmogrifai_tpu/impl/classification/logistic.py``
(reference: OpLogisticRegression.scala wrapping Spark's LogisticRegression:
regParam, elasticNetParam, maxIter, fitIntercept, family).  Binary fits
with an L1 share (``elastic_net_param > 0`` and ``reg_param > 0``) run the
FISTA solver of ``ops/linear.py`` (K-K) for at least 200 iterations, as the
JAX package does; prediction is a float32 product on the device.  The
Newton solver of the pure-L2 fits (K9) and the multinomial (softmax) fits
are not ported and raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import linear as L
from ..feature._util import stage_device
from ..selector.predictor import PredictorEstimator, as_matrix


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported: the Newton solver (K9, transmogrifai_tpu/ops/linear.py:53) "
        "and the softmax fits (K14) are queued; the port fits elastic-net grids "
        "(reg_param > 0, elastic_net_param > 0)")


class OpLogisticRegression(PredictorEstimator):
    is_classifier = True

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 100, tol: float = 1e-6, fit_intercept: bool = True,
                 standardization: bool = True, family: str = "auto",
                 uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpLogisticRegression", uid=uid,
                         reg_param=reg_param, elastic_net_param=elastic_net_param,
                         max_iter=max_iter, tol=tol, fit_intercept=fit_intercept,
                         standardization=standardization, family=family, **extra)

    def _check_binary(self, y: np.ndarray) -> None:
        family = self.get_param("family", "auto")
        num_classes = int(np.max(np.asarray(y))) + 1 if len(y) else 2
        if family == "multinomial" or (family == "auto" and num_classes > 2):
            raise _not_ported("multinomial logistic regression")

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        self._check_binary(y)
        X = as_matrix(X, stage_device(self))
        dev = X.device
        reg = float(self.get_param("reg_param", 0.0))
        alpha = float(self.get_param("elastic_net_param", 0.0))
        if not (alpha > 0.0 and reg > 0.0):
            raise _not_ported("a pure-L2 logistic fit")
        sw = np.ones(X.shape[0], np.float32) if w is None else np.asarray(w, np.float32)
        fit = L.fit_logistic_fista(
            X, torch.from_numpy(np.asarray(y, np.float32)).to(dev), torch.from_numpy(sw).to(dev),
            l1=reg * alpha, l2=reg * (1.0 - alpha),
            max_iter=max(int(self.get_param("max_iter", 100)), 200),
            fit_intercept=bool(self.get_param("fit_intercept", True)))
        return {"coef": fit.coef.cpu().numpy(), "intercept": fit.intercept.cpu().numpy(),
                "num_classes": 2, "multinomial": False}

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid block of elastic-net fits as one FISTA batch
        (``ops/linear.fit_logistic_grid_folds_fista``); predictions on every
        row, ``[fold][grid]``."""
        self._check_binary(y)
        for g in grids:
            for k in g:
                if k not in ("reg_param", "elastic_net_param"):
                    raise NotImplementedError(f"non-batchable logistic grid key {k}")
        X = as_matrix(X, stage_device(self))
        dev = X.device
        reg = np.array([float(g.get("reg_param", self.get_param("reg_param", 0.0)))
                        for g in grids], np.float32)
        alpha = np.array([float(g.get("elastic_net_param",
                                      self.get_param("elastic_net_param", 0.0)))
                          for g in grids], np.float32)
        l1, l2 = reg * alpha, reg * (1.0 - alpha)
        if np.any(l1 == 0.0):
            raise _not_ported("a pure-L2 logistic fit")
        fit = L.fit_logistic_grid_folds_fista(
            X, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
            torch.from_numpy(np.asarray(train_w, np.float32)).to(dev), l1, l2,
            max_iter=max(int(self.get_param("max_iter", 100)), 200),
            fit_intercept=bool(self.get_param("fit_intercept", True)))
        raw, prob, pred = (a.cpu().numpy() for a in
                           L.predict_binary_logistic_grid(X, fit.coef, fit.intercept))
        F, G = fit.coef.shape[:2]
        return [[(pred[f, c], raw[f, c], prob[f, c]) for c in range(G)] for f in range(F)]

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return {"coef": torch.tensor(np.asarray(params["coef"], np.float32), device=device),
                "intercept": torch.tensor(np.asarray(params["intercept"], np.float32),
                                          device=device),
                "multinomial": bool(params.get("multinomial"))}

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        predict = L.predict_softmax if dparams["multinomial"] else L.predict_binary_logistic
        raw, prob, pred = predict(X, dparams["coef"], dparams["intercept"])
        return pred.cpu().numpy(), raw.cpu().numpy(), prob.cpu().numpy()
