"""OpLinearRegression: the elastic-net linear-regression fit and prediction.

The port's counterpart of ``transmogrifai_tpu/impl/regression/linear.py``
(reference: OpLinearRegression.scala wrapping Spark's LinearRegression:
regParam, elasticNetParam, maxIter, fitIntercept).  Fits with an L1 share
(``elastic_net_param > 0`` and ``reg_param > 0``) run the FISTA solver of
``ops/linear.py`` (K-N) for at least 300 iterations, as the JAX package
does; prediction is a float32 product on the device.  The closed-form
ridge fits (``reg_param`` or ``elastic_net_param`` 0, K14 ``fit_ridge``)
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
        f"{what} is not ported: the ridge solver (K14 fit_ridge, "
        "transmogrifai_tpu/ops/linear.py:193) is queued; the port fits elastic-net grids "
        "(reg_param > 0, elastic_net_param > 0)")


class OpLinearRegression(PredictorEstimator):
    is_classifier = False

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 100, tol: float = 1e-6, fit_intercept: bool = True,
                 standardization: bool = True, solver: str = "auto",
                 uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpLinearRegression", uid=uid,
                         reg_param=reg_param, elastic_net_param=elastic_net_param,
                         max_iter=max_iter, tol=tol, fit_intercept=fit_intercept,
                         standardization=standardization, solver=solver, **extra)

    def _max_iter(self) -> int:
        return max(int(self.get_param("max_iter", 100)), 300)

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        reg = float(self.get_param("reg_param", 0.0))
        alpha = float(self.get_param("elastic_net_param", 0.0))
        if not (alpha > 0.0 and reg > 0.0):
            raise _not_ported("a ridge (L1-free) linear-regression fit")
        sw = np.ones(X.shape[0], np.float32) if w is None else np.asarray(w, np.float32)
        fit = L.fit_linear_fista(
            X, torch.from_numpy(np.asarray(y, np.float32)).to(dev), torch.from_numpy(sw).to(dev),
            l1=reg * alpha, l2=reg * (1.0 - alpha), max_iter=self._max_iter(),
            fit_intercept=bool(self.get_param("fit_intercept", True)))
        return {"coef": fit.coef.cpu().numpy(), "intercept": fit.intercept.cpu().numpy()}

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid block of elastic-net fits as one FISTA batch
        (``ops/linear.fit_linear_grid_folds_fista``); predictions on every
        row, ``[fold][grid]``."""
        for g in grids:
            for k in g:
                if k not in ("reg_param", "elastic_net_param"):
                    raise NotImplementedError(f"non-batchable linear-regression grid key {k}")
        X = as_matrix(X, stage_device(self))
        dev = X.device
        reg = np.array([float(g.get("reg_param", self.get_param("reg_param", 0.0)))
                        for g in grids], np.float32)
        alpha = np.array([float(g.get("elastic_net_param",
                                      self.get_param("elastic_net_param", 0.0)))
                          for g in grids], np.float32)
        l1, l2 = reg * alpha, reg * (1.0 - alpha)
        if np.any(l1 == 0.0):
            raise _not_ported("a ridge (L1-free) linear-regression fit")
        fit = L.fit_linear_grid_folds_fista(
            X, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
            torch.from_numpy(np.asarray(train_w, np.float32)).to(dev), l1, l2,
            max_iter=self._max_iter(), fit_intercept=bool(self.get_param("fit_intercept", True)))
        z = (torch.einsum("nd,fgd->fgn", X, fit.coef) + fit.intercept).cpu().numpy()
        F, G = fit.coef.shape[:2]
        return [[(z[f, c], None, None) for c in range(G)] for f in range(F)]

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return {"coef": torch.tensor(np.asarray(params["coef"], np.float32), device=device),
                "intercept": torch.tensor(np.asarray(params["intercept"], np.float32),
                                          device=device)}

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        pred = L.predict_linear(X, dparams["coef"], dparams["intercept"])
        return pred.cpu().numpy(), None, None
