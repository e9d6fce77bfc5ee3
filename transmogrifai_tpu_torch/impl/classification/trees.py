"""Tree-ensemble classifiers on the scoring path.

The prediction halves of ``transmogrifai_tpu/impl/classification/trees.py``
(reference: OpRandomForestClassifier, OpGBTClassifier,
OpDecisionTreeClassifier, OpXGBoostClassifier): bin the feature matrix with
the fitted edges (K-A ``bin_rows``), walk the ensemble (K-B
``ensemble_walk``), then turn the leaf means or margins into predictions on
the host in float64, exactly as the JAX package does.  Fitting is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ...ops import trees as Tr
from ..selector.predictor import PredictorEstimator
from ..trees_common import tree_from_params


class _TreeClassifierBase(PredictorEstimator):
    is_classifier = True

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return {**params, "tree": tree_from_params(params, device),
                "edges": torch.tensor(np.ascontiguousarray(params["edges"], np.float32),
                                      device=device)}


class OpRandomForestClassifier(_TreeClassifierBase):
    """Histogram forest with class-distribution leaves."""

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
    """Single gini tree (a one-tree forest)."""


class _BoostedClassifierBase(_TreeClassifierBase):
    """Boosted trees: binary logistic or multiclass softmax margins."""

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
    """Spark GBTClassifier analog."""


class OpXGBoostClassifier(_BoostedClassifierBase):
    """XGBoost-parameterized boosting."""
