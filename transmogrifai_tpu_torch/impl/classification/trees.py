"""Tree-ensemble classifiers: RandomForest / GBT / DecisionTree / XGBoost.

The port's counterpart of ``transmogrifai_tpu/impl/classification/trees.py``
(reference: OpRandomForestClassifier, OpGBTClassifier,
OpDecisionTreeClassifier, OpXGBoostClassifier).  Prediction: bin the
feature matrix with the fitted edges (K-A ``bin_rows``), walk the ensemble
(K-B ``ensemble_walk``), then turn the leaf means or margins into
predictions on the host in float64, exactly as the JAX package does.
Fitting: the random forest (``ops/trees.fit_forest`` on the JAX package's
bootstrap and feature draws, and the fold x grid sweep
``forest_grid_folds``): binary forests on one gradient channel, multiclass
forests on k -onehot channels with class-distribution leaves; and the
boosted models (GBT, XGBoost) with the logistic loss, or the softmax loss
over k class margins (multi-output trees, a leaf vector per class),
through ``ops/trees.fit_gbt`` (``fit_arrays``) and the fold x grid sweep
``boosted_grid_folds`` (``fit_grid_folds``); the decision tree as a
one-tree forest, unbagged and on every feature.
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


class _TreeClassifierBase(TreeParamsMixin, PredictorEstimator):
    is_classifier = True
    _auto_subset = "sqrt"  # Spark's classification-forest default
    #: boosted subclasses override, so the refit grows the beam the sweep measured
    _max_frontier_default = DEFAULT_MAX_FRONTIER

    def _n_classes(self, y: np.ndarray) -> int:
        return max(int(np.max(y)) + 1 if len(y) else 2, 2)

    @staticmethod
    def _class_grads(y: np.ndarray, k: int) -> np.ndarray:
        """The forests' gradient channels: binary forests grow on g = -y (the
        one-channel variance kernel; variance impurity is gini / 2 for 0/1
        labels, so the splits are gini's and a leaf's mean is p(class 1));
        multiclass forests on g = -onehot(y) (gini-equivalent gain,
        class-distribution leaves)."""
        if k == 2:
            return -np.asarray(y, np.float32)[:, None]
        return -np.eye(k, dtype=np.float32)[np.asarray(y, np.int64)]

    @staticmethod
    def _expand_binary_leaves(forest: Tr.Tree, k: int) -> Tr.Tree:
        """[..., 1] class-1 share leaves -> [..., 2] distributions."""
        if k != 2:
            return forest
        v = forest.leaf_val
        return forest._replace(leaf_val=torch.cat([1.0 - v, v], dim=-1))

    def _frontier(self, n: int, depth: int, mcw: float, h_max: float) -> int:
        return Tr.frontier_cap(
            n, depth, mcw, h_max=h_max,
            max_frontier=int(self.get_param("max_frontier", self._max_frontier_default)))

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return tree_device_params(params, device)


class OpRandomForestClassifier(_TreeClassifierBase):
    """Gini-equivalent histogram forest with class-distribution leaves."""

    def __init__(self, num_trees: int = 20, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 subsampling_rate: float = 1.0, feature_subset_strategy: str = "auto",
                 impurity: str = "gini", seed: int = 42, uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpRandomForestClassifier", uid=uid,
                         num_trees=num_trees, max_depth=max_depth, max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, subsampling_rate=subsampling_rate,
                         feature_subset_strategy=feature_subset_strategy,
                         impurity=impurity, seed=seed, **extra)

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        n, d = X.shape
        k = self._n_classes(y)
        G = self._class_grads(y, k)
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
        mcw = float(self.get_param("min_instances_per_node", 1))
        forest = Tr.fit_forest(Xb, torch.from_numpy(G).to(dev), torch.ones(n, device=dev),
                               wt, fms, max_depth=depth, n_bins=n_bins,
                               frontier=self._frontier(n, depth, mcw, 1.0),
                               min_child_weight=mcw,
                               min_info_gain=float(self.get_param("min_info_gain", 0.0)))
        forest = self._expand_binary_leaves(forest, k)
        return tree_params(forest, edges=edges, max_depth=depth, num_classes=k,
                           num_trees=n_trees)

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid forest sweep (``trees_common.forest_grid_folds``)."""
        k = self._n_classes(y)
        return forest_grid_folds(
            self, as_matrix(X, stage_device(self)), y, train_w, grids, n_classes=k,
            convert=lambda dist, cand: self._dist_to_preds(
                dist, int(cand.get_param("num_trees", 20))))

    @staticmethod
    def _dist_to_preds(dist: np.ndarray, num_trees: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        dist = np.clip(dist, 0.0, None)
        prob = dist / np.maximum(dist.sum(axis=1, keepdims=True), 1e-12)
        raw = dist * num_trees  # Spark rawPrediction = vote mass
        return prob.argmax(axis=1).astype(np.float64), raw, prob

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        Xb = Tr.bin_with_edges(X, dparams["edges"])
        dist = Tr.predict_forest(Xb, dparams["tree"], int(dparams["max_depth"]))
        return cls._dist_to_preds(dist.cpu().numpy(), int(dparams["num_trees"]))


class OpDecisionTreeClassifier(OpRandomForestClassifier):
    """Single gini tree: a one-tree forest, unbagged, on every feature."""

    #: the fold x grid sweep grows the same unbagged tree ``fit_arrays`` does
    _grid_bootstrap = False

    def __init__(self, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 impurity: str = "gini", seed: int = 42, uid: Optional[str] = None, **extra):
        # fixed by construction: dropped where copy_with_params passes them back
        for k in ("num_trees", "feature_subset_strategy", "subsampling_rate", "impurity"):
            extra.pop(k, None)
        super().__init__(num_trees=1, max_depth=max_depth, max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, subsampling_rate=1.0,
                         feature_subset_strategy="all", impurity=impurity, seed=seed, uid=uid,
                         **extra)
        self.operation_name = "OpDecisionTreeClassifier"

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        n, d = X.shape
        k = self._n_classes(y)
        n_bins = int(self.get_param("max_bins", 32))
        depth = int(self.get_param("max_depth", 5))
        Xb, edges = Tr.quantize(X, n_bins)
        sw = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)
        mcw = float(self.get_param("min_instances_per_node", 1))
        forest = Tr.fit_forest(Xb, torch.from_numpy(self._class_grads(y, k)).to(dev),
                               torch.ones(n, device=dev), torch.from_numpy(sw).to(dev)[None],
                               torch.ones((1, d), device=dev), max_depth=depth, n_bins=n_bins,
                               frontier=self._frontier(n, depth, mcw, 1.0),
                               min_child_weight=mcw,
                               min_info_gain=float(self.get_param("min_info_gain", 0.0)))
        forest = self._expand_binary_leaves(forest, k)
        return tree_params(forest, edges=edges, max_depth=depth, num_classes=k, num_trees=1)


class _BoostedClassifierBase(_TreeClassifierBase):
    """Boosted trees: binary logistic or multiclass softmax margins."""

    _max_frontier_default = DEFAULT_MAX_FRONTIER_BOOSTED

    def _boost_params(self) -> Dict[str, Any]:
        raise NotImplementedError

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        bp = self._boost_params()
        X = as_matrix(X, stage_device(self))
        dev = X.device
        n, d = X.shape
        k = self._n_classes(y)
        Xb, edges = Tr.quantize(X, bp["n_bins"])
        sw = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)
        ks, kf = Tr.rng_keys(int(self.get_param("seed", 42)))
        rw = Tr.subsample_weights(ks, n, bp["n_rounds"], bp["subsample"], dev)
        fms = Tr.feature_masks(kf, d, bp["n_rounds"], bp["colsample"], dev)
        loss = "logistic" if k == 2 else "softmax"
        frontier = self._frontier(n, bp["max_depth"], bp["min_child_weight"], 0.25)
        k_eff = effective_trees_per_round(bp.get("trees_per_round", 1), bp["n_rounds"])
        trees, _ = Tr.fit_gbt(
            Xb, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
            torch.from_numpy(sw).to(dev), rw, fms, loss=loss, n_rounds=bp["n_rounds"],
            max_depth=bp["max_depth"], n_bins=bp["n_bins"], frontier=frontier,
            eta=bp["eta"], reg_lambda=bp["reg_lambda"], gamma=bp["gamma"],
            min_child_weight=bp["min_child_weight"], n_classes=k,
            min_info_gain=bp.get("min_info_gain", 0.0), trees_per_round=k_eff)
        return tree_params(trees, edges=edges, max_depth=bp["max_depth"],
                           eta=bp["eta"] / k_eff, num_classes=k, loss=loss)

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid sweep: grids sharing static shape params grow as
        one tree batch (``trees_common.boosted_grid_folds``)."""
        k = self._n_classes(y)
        loss = "logistic" if k == 2 else "softmax"
        return boosted_grid_folds(self, as_matrix(X, stage_device(self)), y, train_w, grids,
                                  loss=loss, n_classes=k,
                                  convert=lambda F: self._margins_to_preds(loss, F))

    @staticmethod
    def _margins_to_preds(loss: str, F: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if loss == "logistic":
            z = np.asarray(F[:, 0], np.float64)
            p1 = 1.0 / (1.0 + np.exp(-z))
            raw = np.stack([-z, z], axis=1)
            prob = np.stack([1 - p1, p1], axis=1)
            return (p1 >= 0.5).astype(np.float64), raw, prob
        z = np.asarray(F, np.float64)
        ez = np.exp(z - z.max(axis=1, keepdims=True))
        prob = ez / ez.sum(axis=1, keepdims=True)
        return z.argmax(axis=1).astype(np.float64), z, prob

    @classmethod
    def margins(cls, dparams: Dict[str, Any], X: torch.Tensor) -> torch.Tensor:
        """F f32[n, c] = eta * sum of the trees' leaf values."""
        Xb = Tr.bin_with_edges(X, dparams["edges"])
        return Tr.predict_gbt(Xb, dparams["tree"], int(dparams["max_depth"]),
                              float(dparams["eta"]))

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        F = cls.margins(dparams, X)
        return cls._margins_to_preds(str(dparams["loss"]), F.cpu().numpy())


class OpGBTClassifier(_BoostedClassifierBase):
    """Spark GBTClassifier analog (maxIter=20, stepSize=0.1)."""

    def __init__(self, max_iter: int = 20, max_depth: int = 5, max_bins: int = 32,
                 step_size: float = 0.1, subsampling_rate: float = 1.0,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 seed: int = 42, uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpGBTClassifier", uid=uid, max_iter=max_iter,
                         max_depth=max_depth, max_bins=max_bins, step_size=step_size,
                         subsampling_rate=subsampling_rate,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, seed=seed, **extra)

    def _boost_params(self):
        return gbt_boost_params(self)


class OpXGBoostClassifier(_BoostedClassifierBase):
    """XGBoost-parameterized boosting (eta/numRound/lambda/gamma/subsample)."""

    def __init__(self, num_round: int = 100, eta: float = 0.3, max_depth: int = 6,
                 max_bins: int = 32, reg_lambda: float = 1.0, gamma: float = 0.0,
                 min_child_weight: float = 1.0, subsample: float = 1.0,
                 colsample_bytree: float = 1.0, seed: int = 42,
                 uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpXGBoostClassifier", uid=uid,
                         num_round=num_round, eta=eta, max_depth=max_depth,
                         max_bins=max_bins, reg_lambda=reg_lambda, gamma=gamma,
                         min_child_weight=min_child_weight, subsample=subsample,
                         colsample_bytree=colsample_bytree, seed=seed, **extra)

    def _boost_params(self):
        return xgb_boost_params(self)
