"""OpLinearRegression: the elastic-net and ridge linear-regression fits and prediction.

The port's counterpart of ``transmogrifai_tpu/impl/regression/linear.py``
(reference: OpLinearRegression.scala wrapping Spark's LinearRegression:
regParam, elasticNetParam, maxIter, fitIntercept).  Fits with an L1 share
(``elastic_net_param > 0`` and ``reg_param > 0``) run the FISTA solver of
``ops/linear.py`` (K-N) for at least 300 iterations; the others (pure L2,
the default constructor's reg 0 among them) the closed-form ridge fit
(``ops/linear.fit_ridge``, its normal equations from K-S) with ``l2 =
reg_param``, as the JAX package does; prediction is a float32 product on
the device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import linear as L
from ..feature._util import stage_device
from ..selector.predictor import PredictorEstimator, as_matrix


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
        sw = torch.from_numpy(np.ones(X.shape[0], np.float32) if w is None
                              else np.asarray(w, np.float32)).to(dev)
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        fit_intercept = bool(self.get_param("fit_intercept", True))
        if alpha > 0.0 and reg > 0.0:
            fit = L.fit_linear_fista(X, yd, sw, l1=reg * alpha, l2=reg * (1.0 - alpha),
                                     max_iter=self._max_iter(), fit_intercept=fit_intercept)
        else:
            fit = L.fit_ridge(X, yd, sw, l2=reg, fit_intercept=fit_intercept)
        return {"coef": fit.coef.cpu().numpy(), "intercept": fit.intercept.cpu().numpy()}

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid block as one batch per solver, picked per point as
        ``fit_arrays`` picks it: the pure-L2 points (l1 = 0) in closed form
        (``ops/linear.fit_ridge_grid_folds``), the elastic-net ones by
        ``fit_linear_grid_folds_fista``; predictions on every row,
        ``[fold][grid]``."""
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
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        twd = torch.from_numpy(np.asarray(train_w, np.float32)).to(dev)
        fit_intercept = bool(self.get_param("fit_intercept", True))
        F, G, d = twd.shape[0], len(grids), X.shape[1]
        coef = torch.zeros((F, G, d), dtype=torch.float32, device=dev)
        intercept = torch.zeros((F, G, 1), dtype=torch.float32, device=dev)
        ridge, fista = np.where(l1 == 0.0)[0], np.where(l1 != 0.0)[0]
        if len(ridge):
            fit = L.fit_ridge_grid_folds(X, yd, twd, l2[ridge], fit_intercept=fit_intercept)
            coef[:, ridge], intercept[:, ridge] = fit.coef, fit.intercept
        if len(fista):
            fit = L.fit_linear_grid_folds_fista(X, yd, twd, l1[fista], l2[fista],
                                                max_iter=self._max_iter(),
                                                fit_intercept=fit_intercept)
            coef[:, fista], intercept[:, fista] = fit.coef, fit.intercept
        z = (torch.einsum("nd,fgd->fgn", X, coef) + intercept).cpu().numpy()
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
