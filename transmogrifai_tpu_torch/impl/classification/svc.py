"""OpLinearSVC: the linear support vector classifier.

The port's counterpart of ``transmogrifai_tpu/impl/classification/svc.py``
(reference: OpLinearSVC.scala wrapping Spark's LinearSVC: regParam,
maxIter, fitIntercept).  The fit is the JAX package's squared-hinge L2 SVC
by accelerated gradient steps (``ops/linear.fit_svc_grid_folds`` on K-T,
at least 200 steps); it emits raw margins and the hard prediction ``z >= 0``
but no probability, so an evaluator scores the 0/1 prediction.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import linear as L
from ..feature._util import stage_device
from ..selector.predictor import PredictorEstimator, as_matrix


class OpLinearSVC(PredictorEstimator):
    is_classifier = True

    def __init__(self, reg_param: float = 0.0, max_iter: int = 100, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True,
                 uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpLinearSVC", uid=uid,
                         reg_param=reg_param, max_iter=max_iter, tol=tol,
                         fit_intercept=fit_intercept, standardization=standardization,
                         **extra)

    def _steps(self) -> int:
        return max(int(self.get_param("max_iter", 100)), 200)

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        sw = np.ones(X.shape[0], np.float32) if w is None else np.asarray(w, np.float32)
        fit = L.fit_linear_svc(X, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
                               torch.from_numpy(sw).to(dev),
                               l2=float(self.get_param("reg_param", 0.0)),
                               max_iter=self._steps(),
                               fit_intercept=bool(self.get_param("fit_intercept", True)))
        return {"coef": fit.coef.cpu().numpy(), "intercept": fit.intercept.cpu().numpy()}

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid block as one batch (``reg_param`` is the only
        grid key): each candidate's hard predictions and raw margins on every
        row, no probability, ``[fold][grid]``."""
        for g in grids:
            for k in g:
                if k != "reg_param":
                    raise NotImplementedError(f"non-batchable SVC grid key {k}")
        X = as_matrix(X, stage_device(self))
        dev = X.device
        l2 = np.array([float(g.get("reg_param", self.get_param("reg_param", 0.0)))
                       for g in grids], np.float32)
        fit = L.fit_svc_grid_folds(
            X, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
            torch.from_numpy(np.asarray(train_w, np.float32)).to(dev), l2,
            max_iter=self._steps(), fit_intercept=bool(self.get_param("fit_intercept", True)))
        z = (torch.einsum("nd,fgd->fgn", X, fit.coef) + fit.intercept).cpu().numpy()
        pred = (z >= 0.0).astype(np.float32)
        raw = np.stack([-z, z], axis=-1)
        return [[(pred[f, c], raw[f, c], None) for c in range(len(grids))]
                for f in range(train_w.shape[0])]

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
                for k in ("coef", "intercept")}

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, None]:
        raw, pred = L.predict_svc(X, dparams["coef"], dparams["intercept"])
        return pred.cpu().numpy(), raw.cpu().numpy(), None
