"""OpMultilayerPerceptronClassifier.

The port's counterpart of ``transmogrifai_tpu/impl/classification/mlp.py``
(reference: OpMultilayerPerceptronClassifier.scala wrapping Spark's MLP:
layers, maxIter, stepSize, seed; sigmoid hidden layers and a softmax
output).  The fit is the JAX package's full-batch Adam over a static
topology (``ops/mlp.py``: the gradients by K-U), the prediction K-U's
forward mode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import mlp as M
from ..feature._util import stage_device
from ..selector.predictor import PredictorEstimator, as_matrix


class OpMultilayerPerceptronClassifier(PredictorEstimator):
    is_classifier = True

    def __init__(self, hidden_layers: Tuple[int, ...] = (10,), max_iter: int = 200,
                 step_size: float = 0.03, seed: int = 42,
                 uid: Optional[str] = None, **extra):
        super().__init__(operation_name="OpMultilayerPerceptronClassifier", uid=uid,
                         hidden_layers=tuple(hidden_layers), max_iter=max_iter,
                         step_size=step_size, seed=seed, **extra)

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        dev = X.device
        k = max(int(np.max(y)) + 1 if len(y) else 2, 2)
        layers = (X.shape[1],) + tuple(int(h) for h in
                                       self.get_param("hidden_layers", (10,))) + (k,)
        sw = np.ones(len(y), np.float32) if w is None else np.asarray(w, np.float32)
        params = M.fit_mlp(X, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
                           torch.from_numpy(sw).to(dev), layers=layers,
                           max_iter=int(self.get_param("max_iter", 200)),
                           lr=float(self.get_param("step_size", 0.03)),
                           seed=int(self.get_param("seed", 42)))
        return {"weights": [(W.cpu().numpy(), b.cpu().numpy()) for W, b in params],
                "layers": layers, "num_classes": k}

    #: grid keys the batched sweep understands
    _GRID_KEYS = ("hidden_layers", "max_iter", "step_size", "seed")

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid MLP sweep: one batch of fits per (hidden_layers,
        max_iter) group (``ops/mlp.fit_mlp_grid_folds``), predictions on
        every row, ``[fold][grid]``."""
        grids = [dict(g) for g in (grids or [{}])]
        for g in grids:
            for key in g:
                if key not in self._GRID_KEYS:
                    raise NotImplementedError(f"non-batchable MLP grid key {key}")
        X = as_matrix(X, stage_device(self))
        dev = X.device
        candidates = [self.copy_with_params(g) for g in grids]
        k = max(int(np.max(y)) + 1 if len(y) else 2, 2)
        n_folds = train_w.shape[0]
        out = [[None] * len(grids) for _ in range(n_folds)]
        groups: Dict[tuple, list] = {}
        for ci, cand in enumerate(candidates):
            hl = tuple(int(h) for h in cand.get_param("hidden_layers", (10,)))
            groups.setdefault((hl, int(cand.get_param("max_iter", 200))), []).append(ci)
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        twd = torch.from_numpy(np.asarray(train_w, np.float32)).to(dev)
        for (hl, mi), cis in groups.items():
            layers = (X.shape[1],) + hl + (k,)
            lrs = [float(candidates[ci].get_param("step_size", 0.03)) for ci in cis]
            seeds = [int(candidates[ci].get_param("seed", 42)) for ci in cis]
            params = M.fit_mlp_grid_folds(X, yd, twd, lrs, seeds, layers=layers, max_iter=mi)
            z, prob, pred = (a.cpu().numpy() for a in M.predict_mlp_grid(params, X))
            for gi, ci in enumerate(cis):
                for f in range(n_folds):
                    out[f][ci] = (pred[f, gi], z[f, gi], prob[f, gi])
        return out

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return {"weights": [(torch.tensor(np.asarray(W, np.float32), device=device),
                             torch.tensor(np.asarray(b, np.float32), device=device))
                            for W, b in params["weights"]]}

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        z, prob, pred = M.predict_mlp(dparams["weights"], X)
        return pred.cpu().numpy(), z.cpu().numpy(), prob.cpu().numpy()
