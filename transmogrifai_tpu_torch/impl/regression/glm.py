"""OpGeneralizedLinearRegression: the IRLS GLM fits and prediction.

The port's counterpart of ``transmogrifai_tpu/impl/regression/glm.py``
(reference: OpGeneralizedLinearRegression.scala wrapping Spark's
GeneralizedLinearRegression: family, link, regParam, maxIter, tol,
fitIntercept, variancePower).  Fits run ``max_iter`` IRLS steps
(``ops/linear.fit_glm_irls``; no tolerance test, as the JAX package's), each
a weighted Gram from K-S in its GLM mode and a float64 solve; the fold x
grid block runs one ``fit_glm_grid_folds`` a (family, link, max_iter,
fit_intercept) group.  Prediction is the link's inverse of a float32
product on the device.  Two behaviours of the JAX package are kept: the link
is bound at construction to the family's default, so a copy that changes
only the family keeps it; and ``variance_power`` defaults to 0.0, so a
tweedie candidate without one in its grid has a Gaussian variance.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import linear as L
from ..feature._util import stage_device
from ..selector.predictor import PredictorEstimator, as_matrix


class OpGeneralizedLinearRegression(PredictorEstimator):
    is_classifier = False

    def __init__(self, family: str = "gaussian", link: Optional[str] = None,
                 reg_param: float = 0.0, max_iter: int = 25, tol: float = 1e-6,
                 fit_intercept: bool = True, variance_power: float = 0.0,
                 uid: Optional[str] = None, **extra):
        if family not in L.GLM_DEFAULT_LINK:
            raise ValueError(f"Unsupported GLM family {family!r}; one of "
                             f"{sorted(L.GLM_DEFAULT_LINK)}")
        link = link or L.GLM_DEFAULT_LINK[family]
        if link not in ("identity", "log", "logit", "inverse", "sqrt"):
            raise ValueError(f"Unsupported link {link!r}")
        super().__init__(operation_name="OpGeneralizedLinearRegression", uid=uid,
                         family=family, link=link, reg_param=reg_param,
                         max_iter=max_iter, tol=tol, fit_intercept=fit_intercept,
                         variance_power=variance_power, **extra)

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        sw = torch.from_numpy(np.ones(X.shape[0], np.float32) if w is None
                              else np.asarray(w, np.float32)).to(dev)
        fit = L.fit_glm_irls(
            X, torch.from_numpy(np.asarray(y, np.float32)).to(dev), sw,
            l2=float(self.get_param("reg_param", 0.0)), family=self.get_param("family"),
            link=self.get_param("link"), max_iter=int(self.get_param("max_iter", 25)),
            fit_intercept=bool(self.get_param("fit_intercept", True)),
            variance_power=float(self.get_param("variance_power", 0.0)))
        return {"coef": fit.coef.cpu().numpy(), "intercept": fit.intercept.cpu().numpy(),
                "link": self.get_param("link")}

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return {"coef": torch.tensor(np.asarray(params["coef"], np.float32), device=device),
                "intercept": torch.tensor(np.asarray(params["intercept"], np.float32),
                                          device=device),
                "link": params["link"]}

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        mu = L.predict_glm(X, dparams["coef"], dparams["intercept"], dparams["link"])
        return mu.cpu().numpy().astype(np.float64), None, None

    _GRID_KEYS = ("reg_param", "variance_power", "family", "link", "max_iter",
                  "fit_intercept")

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid block, one ``fit_glm_grid_folds`` a (family, link,
        max_iter, fit_intercept) group, as the JAX package batches it;
        predictions (the mean response) on every row, ``[fold][grid]``."""
        grids = [dict(g) for g in (grids or [{}])]
        for g in grids:
            for key in g:
                if key not in self._GRID_KEYS:
                    raise NotImplementedError(f"non-batchable GLM grid key {key}")
        candidates = [self.copy_with_params(g) for g in grids]
        n_folds = train_w.shape[0]
        out = [[None] * len(grids) for _ in range(n_folds)]
        groups: Dict[tuple, list] = {}
        for ci, cand in enumerate(candidates):
            fam = cand.get_param("family", "gaussian")
            link = cand.get_param("link") or L.GLM_DEFAULT_LINK[fam]
            groups.setdefault(
                (fam, link, int(cand.get_param("max_iter", 25)),
                 bool(cand.get_param("fit_intercept", True))), []).append(ci)
        X = as_matrix(X, stage_device(self))
        dev = X.device
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        twd = torch.from_numpy(np.asarray(train_w, np.float32)).to(dev)
        for (fam, link, mi, fi), cis in groups.items():
            l2s = [float(candidates[ci].get_param("reg_param", 0.0)) for ci in cis]
            vps = [float(candidates[ci].get_param("variance_power", 1.5)) for ci in cis]
            fit = L.fit_glm_grid_folds(X, yd, twd, l2s, vps, fam, link, max_iter=mi,
                                       fit_intercept=fi)
            mu = L.predict_glm_grid(X, fit.coef, fit.intercept, link).cpu().numpy()
            mu = mu.astype(np.float64)
            for gi, ci in enumerate(cis):
                for f in range(n_folds):
                    out[f][ci] = (mu[f, gi], None, None)
        return out
