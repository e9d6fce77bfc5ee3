"""OpLogisticRegression: the binary and multinomial fits and prediction.

The port's counterpart of ``transmogrifai_tpu/impl/classification/logistic.py``
(reference: OpLogisticRegression.scala wrapping Spark's LogisticRegression:
regParam, elasticNetParam, maxIter, fitIntercept, family).  Binary fits
with an L1 share (``elastic_net_param > 0`` and ``reg_param > 0``) run the
FISTA solver of ``ops/linear.py`` (K-K) for at least 200 iterations; the
others (pure L2, the default constructor's reg 0 among them) run the
Newton solver (K-S) with ``l2 = reg_param`` for ``min(max(max_iter // 4,
10), 50)`` steps, as the JAX package does; multinomial fits
(``family="multinomial"``, or "auto" over more than two classes) run the
softmax FISTA solver (K-P) for ``max_iter`` iterations, every grid point;
prediction is a float32 product on the device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import linear as L
from ..feature._util import stage_device
from ..selector.predictor import PredictorEstimator, as_matrix, linear_head_program


def _newton_steps(max_iter: int) -> int:
    """The Newton solver's step count for ``max_iter`` (the JAX package's)."""
    return min(max(max_iter // 4, 10), 50)


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

    def _num_classes(self, y: np.ndarray) -> Optional[int]:
        """The class count of a multinomial fit, or None for a binary one."""
        family = self.get_param("family", "auto")
        num_classes = int(np.max(np.asarray(y))) + 1 if len(y) else 2
        if family == "multinomial" or (family == "auto" and num_classes > 2):
            return max(num_classes, 2)
        return None

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        reg = float(self.get_param("reg_param", 0.0))
        alpha = float(self.get_param("elastic_net_param", 0.0))
        k = self._num_classes(y)
        if k is not None:
            sw = np.ones(X.shape[0], np.float32) if w is None else np.asarray(w, np.float32)
            fit = L.fit_softmax(
                X, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
                torch.from_numpy(sw).to(dev), reg * (1.0 - alpha), num_classes=k,
                max_iter=int(self.get_param("max_iter", 100)),
                fit_intercept=bool(self.get_param("fit_intercept", True)), l1=reg * alpha)
            return {"coef": fit.coef.cpu().numpy(), "intercept": fit.intercept.cpu().numpy(),
                    "num_classes": k, "multinomial": True}
        sw = np.ones(X.shape[0], np.float32) if w is None else np.asarray(w, np.float32)
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        max_iter = int(self.get_param("max_iter", 100))
        fit_intercept = bool(self.get_param("fit_intercept", True))
        if alpha > 0.0 and reg > 0.0:
            fit = L.fit_logistic_fista(X, yd, torch.from_numpy(sw).to(dev), l1=reg * alpha,
                                       l2=reg * (1.0 - alpha), max_iter=max(max_iter, 200),
                                       fit_intercept=fit_intercept)
        else:
            fit = L.fit_logistic_newton(X, yd, torch.from_numpy(sw).to(dev), l2=reg,
                                        max_iter=_newton_steps(max_iter),
                                        fit_intercept=fit_intercept)
        return {"coef": fit.coef.cpu().numpy(), "intercept": fit.intercept.cpu().numpy(),
                "num_classes": 2, "multinomial": False}

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid block as one batch per solver, the solver picked
        per point as ``fit_arrays`` picks it: the pure-L2 points (l1 = 0) by
        ``ops/linear.fit_logistic_grid_folds_newton``, the elastic-net ones
        by ``fit_logistic_grid_folds_fista`` (a multinomial fit: every point
        by ``fit_softmax_grid_folds``); predictions on every row,
        ``[fold][grid]``."""
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
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        twd = torch.from_numpy(np.asarray(train_w, np.float32)).to(dev)
        k = self._num_classes(y)
        if k is not None:
            fit = L.fit_softmax_grid_folds(
                X, yd, twd, l1, l2, num_classes=k, max_iter=int(self.get_param("max_iter", 100)),
                fit_intercept=bool(self.get_param("fit_intercept", True)))
            raw, prob, pred = (a.cpu().numpy() for a in
                               L.predict_softmax_grid(X, fit.coef, fit.intercept))
            F, G = fit.coef.shape[:2]
            return [[(pred[f, c], raw[f, c], prob[f, c]) for c in range(G)] for f in range(F)]
        max_iter = int(self.get_param("max_iter", 100))
        fit_intercept = bool(self.get_param("fit_intercept", True))
        F, G, d = twd.shape[0], len(grids), X.shape[1]
        coef = torch.zeros((F, G, d), dtype=torch.float32, device=dev)
        intercept = torch.zeros((F, G, 1), dtype=torch.float32, device=dev)
        newton, fista = np.where(l1 == 0.0)[0], np.where(l1 != 0.0)[0]
        if len(newton):
            fit = L.fit_logistic_grid_folds_newton(X, yd, twd, l2[newton],
                                                   max_iter=_newton_steps(max_iter),
                                                   fit_intercept=fit_intercept)
            coef[:, newton], intercept[:, newton] = fit.coef, fit.intercept
        if len(fista):
            fit = L.fit_logistic_grid_folds_fista(X, yd, twd, l1[fista], l2[fista],
                                                  max_iter=max(max_iter, 200),
                                                  fit_intercept=fit_intercept)
            coef[:, fista], intercept[:, fista] = fit.coef, fit.intercept
        raw, prob, pred = (a.cpu().numpy() for a in
                           L.predict_binary_logistic_grid(X, coef, intercept))
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
        mode = "softmax" if dparams["multinomial"] else "binary"
        pred, raw, prob = L.predict_head(X, dparams["coef"], dparams["intercept"], mode)
        return pred.cpu().numpy(), raw.cpu().numpy(), prob.cpu().numpy()

    @classmethod
    def predict_program(cls, params: Dict[str, Any]):
        """``X -> (pred, raw, prob)`` on ``X``'s device through K-AF (binary
        or softmax), the parameters placed once per device."""
        return linear_head_program(params, "softmax" if params.get("multinomial") else "binary")
