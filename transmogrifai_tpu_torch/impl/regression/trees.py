"""Tree-ensemble regressors: RandomForest / DecisionTree / GBT / XGBoost.

The port's counterpart of ``transmogrifai_tpu/impl/regression/trees.py``
(reference: OpRandomForestRegressor, OpDecisionTreeRegressor, OpGBTRegressor,
OpXGBoostRegressor).
The classifiers' kernels serve: variance-impurity splits are the
second-order gain with g = -y, h = 1 (the forests) or the squared loss's
g = F - y, h = 1 (boosting, from the weighted label mean).  Prediction bins
the feature matrix with the fitted edges (K-A ``bin_rows``) and walks the
ensemble (K-B ``ensemble_walk``): the forest's mean leaf, or ``base + eta *
sum`` of the boosted trees, in float64 on the host.  Fitting: the forest
(``ops/trees.fit_forest`` on the JAX package's bootstrap and feature draws,
and the fold x grid sweep ``forest_grid_folds``) and the boosted models
(``ops/trees.fit_gbt`` with the squared loss, and ``boosted_grid_folds``
from each fold's label mean); the decision tree as a one-tree forest,
unbagged and on every feature.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import trees as Tr
from ..feature._util import stage_device
from ..selector.predictor import PredictorEstimator, as_matrix
from ..trees_common import (DEFAULT_MAX_FRONTIER, DEFAULT_MAX_FRONTIER_BOOSTED,
                            TreeParamsMixin, boosted_grid_folds, effective_trees_per_round,
                            forest_grid_folds, gbt_boost_params, tree_device_params,
                            tree_params, xgb_boost_params)

Preds = Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]


class _TreeRegressorBase(TreeParamsMixin, PredictorEstimator):
    is_classifier = False
    _auto_subset = "onethird"  # Spark's regression-forest default
    #: boosted subclasses override, so the refit grows the beam the sweep measured
    _max_frontier_default = DEFAULT_MAX_FRONTIER

    def _frontier(self, n: int, depth: int, mcw: float) -> int:
        return Tr.frontier_cap(
            n, depth, mcw, h_max=1.0,
            max_frontier=int(self.get_param("max_frontier", self._max_frontier_default)))

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return tree_device_params(params, device)


class OpRandomForestRegressor(_TreeRegressorBase):
    """Variance-impurity histogram forest with mean leaves."""

    def __init__(self, num_trees: int = 20, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 subsampling_rate: float = 1.0, feature_subset_strategy: str = "auto",
                 impurity: str = "variance", seed: int = 42, uid: Optional[str] = None,
                 **extra):
        super().__init__(operation_name="OpRandomForestRegressor", uid=uid,
                         num_trees=num_trees, max_depth=max_depth, max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, subsampling_rate=subsampling_rate,
                         feature_subset_strategy=feature_subset_strategy,
                         impurity=impurity, seed=seed, **extra)

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        n, d = X.shape
        n_bins = int(self.get_param("max_bins", 32))
        depth = int(self.get_param("max_depth", 5))
        n_trees = int(self.get_param("num_trees", 20))
        Xb, edges = Tr.quantize(X, n_bins)
        sw = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)
        kb, kf = Tr.rng_keys(int(self.get_param("seed", 42)))
        wt = Tr.bootstrap_weights(kb, n, n_trees, rate=float(self.get_param("subsampling_rate",
                                                                            1.0)), device=dev)
        wt = wt * torch.from_numpy(sw).to(dev)[None]
        fms = Tr.feature_masks(kf, d, n_trees, self._subset_frac(d), dev)
        g = torch.from_numpy(-np.asarray(y, np.float32)[:, None]).to(dev)
        mcw = float(self.get_param("min_instances_per_node", 1))
        forest = Tr.fit_forest(Xb, g, torch.ones(n, device=dev), wt, fms, max_depth=depth,
                               n_bins=n_bins, frontier=self._frontier(n, depth, mcw),
                               min_child_weight=mcw,
                               min_info_gain=float(self.get_param("min_info_gain", 0.0)))
        return tree_params(forest, edges=edges, max_depth=depth)

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid forest sweep (``trees_common.forest_grid_folds``):
        variance-gain trees with mean leaves."""
        return forest_grid_folds(
            self, as_matrix(X, stage_device(self)), y, train_w, grids, n_classes=1,
            convert=lambda dist, cand: (np.asarray(dist[:, 0], np.float64), None, None))

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor) -> Preds:
        Xb = Tr.bin_with_edges(X, dparams["edges"])
        pred = Tr.predict_forest(Xb, dparams["tree"], int(dparams["max_depth"]))[:, 0]
        return pred.cpu().numpy().astype(np.float64), None, None


class OpDecisionTreeRegressor(OpRandomForestRegressor):
    """Single variance tree: a one-tree forest, unbagged, on every feature."""

    #: the fold x grid sweep grows the same unbagged tree ``fit_arrays`` does
    _grid_bootstrap = False

    def __init__(self, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 seed: int = 42, uid: Optional[str] = None, **extra):
        # fixed by construction: dropped where copy_with_params passes them back
        for k in ("num_trees", "feature_subset_strategy", "subsampling_rate", "impurity"):
            extra.pop(k, None)
        super().__init__(num_trees=1, max_depth=max_depth, max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, feature_subset_strategy="all",
                         seed=seed, uid=uid, **extra)
        self.operation_name = "OpDecisionTreeRegressor"

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        n, d = X.shape
        n_bins = int(self.get_param("max_bins", 32))
        depth = int(self.get_param("max_depth", 5))
        Xb, edges = Tr.quantize(X, n_bins)
        sw = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)
        g = torch.from_numpy(-np.asarray(y, np.float32)[:, None]).to(dev)
        mcw = float(self.get_param("min_instances_per_node", 1))
        forest = Tr.fit_forest(Xb, g, torch.ones(n, device=dev),
                               torch.from_numpy(sw).to(dev)[None], torch.ones((1, d), device=dev),
                               max_depth=depth, n_bins=n_bins,
                               frontier=self._frontier(n, depth, mcw), min_child_weight=mcw,
                               min_info_gain=float(self.get_param("min_info_gain", 0.0)))
        return tree_params(forest, edges=edges, max_depth=depth)


class _BoostedRegressorBase(_TreeRegressorBase):
    """Boosted trees with the squared loss, from the weighted label mean."""

    _max_frontier_default = DEFAULT_MAX_FRONTIER_BOOSTED

    def _boost_params(self) -> Dict[str, Any]:
        raise NotImplementedError

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        bp = self._boost_params()
        X = as_matrix(X, stage_device(self))
        dev = X.device
        n, d = X.shape
        Xb, edges = Tr.quantize(X, bp["n_bins"])
        sw = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)
        ks, kf = Tr.rng_keys(int(self.get_param("seed", 42)))
        rw = Tr.subsample_weights(ks, n, bp["n_rounds"], bp["subsample"], dev)
        fms = Tr.feature_masks(kf, d, bp["n_rounds"], bp["colsample"], dev)
        base = float(np.average(y, weights=np.maximum(sw, 1e-12)))
        frontier = self._frontier(n, bp["max_depth"], bp["min_child_weight"])
        k_eff = effective_trees_per_round(bp.get("trees_per_round", 1), bp["n_rounds"])
        trees, _ = Tr.fit_gbt(
            Xb, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
            torch.from_numpy(sw).to(dev), rw, fms, loss="squared", n_rounds=bp["n_rounds"],
            max_depth=bp["max_depth"], n_bins=bp["n_bins"], frontier=frontier,
            eta=bp["eta"], reg_lambda=bp["reg_lambda"], gamma=bp["gamma"],
            min_child_weight=bp["min_child_weight"], base_score=base,
            min_info_gain=bp.get("min_info_gain", 0.0), trees_per_round=k_eff)
        return tree_params(trees, edges=edges, max_depth=bp["max_depth"],
                           eta=bp["eta"] / k_eff, base_score=base)

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid sweep: grids sharing static shape params grow as
        one tree batch from each fold's label mean
        (``trees_common.boosted_grid_folds``)."""
        return boosted_grid_folds(
            self, as_matrix(X, stage_device(self)), y, train_w, grids, loss="squared",
            n_classes=1, convert=lambda F: (np.asarray(F[:, 0], np.float64), None, None))

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor) -> Preds:
        Xb = Tr.bin_with_edges(X, dparams["edges"])
        F = Tr.predict_gbt(Xb, dparams["tree"], int(dparams["max_depth"]),
                           float(dparams["eta"]), base_score=float(dparams["base_score"]))
        return F[:, 0].cpu().numpy().astype(np.float64), None, None


class OpGBTRegressor(_BoostedRegressorBase):
    """Spark GBTRegressor analog (maxIter=20, stepSize=0.1)."""

    def __init__(self, max_iter: int = 20, max_depth: int = 5, max_bins: int = 32,
                 step_size: float = 0.1, subsampling_rate: float = 1.0,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 seed: int = 42, uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpGBTRegressor", uid=uid, max_iter=max_iter,
                         max_depth=max_depth, max_bins=max_bins, step_size=step_size,
                         subsampling_rate=subsampling_rate,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, seed=seed, **extra)

    def _boost_params(self):
        return gbt_boost_params(self)


class OpXGBoostRegressor(_BoostedRegressorBase):
    """XGBoost-parameterized boosting (eta/numRound/lambda/gamma/subsample)."""

    def __init__(self, num_round: int = 100, eta: float = 0.3, max_depth: int = 6,
                 max_bins: int = 32, reg_lambda: float = 1.0, gamma: float = 0.0,
                 min_child_weight: float = 1.0, subsample: float = 1.0,
                 colsample_bytree: float = 1.0, seed: int = 42,
                 uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpXGBoostRegressor", uid=uid,
                         num_round=num_round, eta=eta, max_depth=max_depth,
                         max_bins=max_bins, reg_lambda=reg_lambda, gamma=gamma,
                         min_child_weight=min_child_weight, subsample=subsample,
                         colsample_bytree=colsample_bytree, seed=seed, **extra)

    def _boost_params(self):
        return xgb_boost_params(self)
