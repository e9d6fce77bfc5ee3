"""Shared tree-model plumbing: parameters and the boosted sweep.

The port's counterpart of ``transmogrifai_tpu/impl/trees_common.py``:
``tree_params`` / ``tree_from_params`` (the carry-across between the saved
numpy parameters and the port's ``Tree`` of tensors, with every pool index
checked, since the walk kernel follows them without bounds checks), the
boosting parameter dicts, ``effective_trees_per_round`` and
``boosted_grid_folds``, the fold x grid sweep of the boosted models.  The
forest sweep is not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops import trees as Tr
from ..ops.trees import Tree

#: frontier cap of the boosted growers (``ops/trees.frontier_cap``),
#: overridable per stage through the ``max_frontier`` param
DEFAULT_MAX_FRONTIER = 256
DEFAULT_MAX_FRONTIER_BOOSTED = 256


def effective_trees_per_round(k: int, n_rounds: int) -> int:
    """Clamp a round-collapse factor to one the grower honors: K > 1, at
    most ``n_rounds`` and dividing it; 1 (no collapse) otherwise."""
    k = int(k)
    if k <= 1 or k > n_rounds or n_rounds % k:
        return 1
    return k


def gbt_boost_params(stage) -> Dict[str, Any]:
    """Spark GBT param dict (maxIter/stepSize/subsamplingRate...)."""
    return {"n_rounds": int(stage.get_param("max_iter", 20)),
            "max_depth": int(stage.get_param("max_depth", 5)),
            "n_bins": int(stage.get_param("max_bins", 32)),
            "eta": float(stage.get_param("step_size", 0.1)),
            "subsample": float(stage.get_param("subsampling_rate", 1.0)),
            "colsample": 1.0, "reg_lambda": 1e-6, "gamma": 0.0,
            "min_child_weight": float(stage.get_param("min_instances_per_node", 1)),
            "min_info_gain": float(stage.get_param("min_info_gain", 0.0)),
            "trees_per_round": int(stage.get_param("trees_per_round", 1))}


def xgb_boost_params(stage) -> Dict[str, Any]:
    """XGBoost param dict (numRound/eta/lambda/gamma/subsample/colsample);
    ``max_bins`` defaults to 32, the Spark MLlib maxBins default."""
    return {"n_rounds": int(stage.get_param("num_round", 100)),
            "max_depth": int(stage.get_param("max_depth", 6)),
            "n_bins": int(stage.get_param("max_bins", 32)),
            "eta": float(stage.get_param("eta", 0.3)),
            "subsample": float(stage.get_param("subsample", 1.0)),
            "colsample": float(stage.get_param("colsample_bytree", 1.0)),
            "reg_lambda": float(stage.get_param("reg_lambda", 1.0)),
            "gamma": float(stage.get_param("gamma", 0.0)),
            "min_child_weight": float(stage.get_param("min_child_weight", 1.0)),
            "trees_per_round": int(stage.get_param("trees_per_round", 1))}


#: boosting hyperparameters that are per-tree scalars of the grower: grids
#: varying only these train as one tree batch
_DYNAMIC_BOOST_KEYS = ("eta", "step_size", "reg_lambda", "gamma",
                       "min_child_weight", "min_instances_per_node",
                       "min_info_gain")
_STATIC_BOOST_KEYS = ("num_round", "max_iter", "max_depth", "max_bins", "subsample",
                      "subsampling_rate", "colsample_bytree", "trees_per_round")


def boosted_grid_folds(est, X, y, train_w, grids, loss: str, n_classes: int,
                       convert) -> list:
    """fold x grid sweep of a boosted model: grids grouped by their static
    shape params (rounds, depth, bins, subsample, colsample), each group's
    folds x candidates grown as one tree batch (``ops/trees.fit_gbt_batch``)
    on ``X``'s device; margins on every row become predictions by
    ``convert``.  Returns ``preds[fold][grid]``."""
    grids = [dict(g) for g in (grids or [{}])]
    candidates = [est.copy_with_params(g) for g in grids]
    bps = [c._boost_params() for c in candidates]
    for g in grids:
        for key in g:
            if key not in _DYNAMIC_BOOST_KEYS and key not in _STATIC_BOOST_KEYS:
                raise NotImplementedError(f"non-batchable boosting grid key {key}")
    dev = X.device
    n_folds = train_w.shape[0]
    n, d = X.shape
    out = [[None] * len(grids) for _ in range(n_folds)]
    groups: Dict[tuple, list] = {}
    for ci, bp in enumerate(bps):
        static = (bp["n_rounds"], bp["max_depth"], bp["n_bins"], bp["subsample"],
                  bp["colsample"],
                  effective_trees_per_round(bp.get("trees_per_round", 1), bp["n_rounds"]))
        groups.setdefault(static, []).append(ci)

    h_max = 0.25 if loss in ("logistic", "softmax") else 1.0
    for (n_rounds, max_depth, n_bins, subsample, colsample, k_eff), cis in groups.items():
        Xb, _ = Tr.quantize(X, n_bins)
        ks, kfm = Tr.rng_keys(int(est.get_param("seed", 42)))
        rw = Tr.subsample_weights(ks, n, n_rounds, subsample, dev)
        fms = Tr.feature_masks(kfm, d, n_rounds, colsample, dev)
        mcw_min = min(bps[ci]["min_child_weight"] for ci in cis)
        pairs = [(f, ci) for f in range(n_folds) for ci in cis]
        B = len(pairs)
        w_batch = np.empty((B, n), np.float32)
        hp = {k: np.zeros(B, np.float32) for k in ("eta", "lam", "gam", "mcw", "mig")}
        yf = np.asarray(y, np.float32)
        for bi, (f, ci) in enumerate(pairs):
            bp = bps[ci]
            w_batch[bi] = train_w[f]
            hp["eta"][bi] = bp["eta"]
            hp["lam"][bi] = max(bp["reg_lambda"], 1e-6)
            hp["gam"][bi] = bp["gamma"]
            hp["mcw"][bi] = bp["min_child_weight"]
            hp["mig"][bi] = bp.get("min_info_gain", 0.0)
        # frontier bound from the actual weight sums (balanced folds can sum
        # past 1.25 n); the subsample masks are <= 1
        w_sum_max = float(w_batch.sum(axis=1).max())
        frontier = Tr.frontier_cap(
            n, max_depth, mcw_min, h_max=h_max,
            max_frontier=int(est.get_param("max_frontier", DEFAULT_MAX_FRONTIER_BOOSTED)),
            total_weight=w_sum_max)
        exact_cap = Tr.frontier_is_exact(n, max_depth, mcw_min, h_max, frontier,
                                         total_weight=w_sum_max)
        F = Tr.fit_gbt_batch(
            Xb, torch.from_numpy(yf).to(dev), torch.from_numpy(w_batch).to(dev), rw, fms,
            loss=loss, n_rounds=n_rounds, max_depth=max_depth, n_bins=n_bins,
            frontier=frontier, eta_b=hp["eta"], reg_lambda_b=hp["lam"],
            gamma_b=hp["gam"], min_child_weight_b=hp["mcw"],
            n_classes=n_classes, min_info_gain_b=hp["mig"], exact_cap=exact_cap,
            trees_per_round=k_eff)
        F = F.cpu().numpy()
        for bi, (f, ci) in enumerate(pairs):
            out[f][ci] = convert(F[bi])
    return out


def tree_params(tree: Tree, **extra) -> Dict[str, Any]:
    """Flatten a ``Tree`` into a serializable params dict (numpy arrays, the
    JAX package's layout)."""
    return {"split_feat": tree.split_feat.cpu().numpy(),
            "split_bin": tree.split_bin.cpu().numpy(),
            "left": tree.left.cpu().numpy(), "right": tree.right.cpu().numpy(),
            "leaf_val": tree.leaf_val.cpu().numpy(), **extra}


def tree_from_params(params: Dict[str, Any], device) -> Tree:
    """The ``Tree`` of a params dict, on ``device``: pools i32[T, P] and
    leaf values f32[T, P, c]."""
    sf = np.asarray(params["split_feat"])
    if sf.ndim != 2:
        raise ValueError(f"split_feat must be [trees, pool], got shape {sf.shape}")
    T, P = sf.shape
    arrays = {}
    for name in ("split_feat", "split_bin", "left", "right"):
        a = np.asarray(params[name])
        if a.shape != (T, P) or a.dtype.kind not in "iu":
            raise ValueError(f"{name} must be integer[{T}, {P}], got {a.dtype}{a.shape}")
        arrays[name] = a.astype(np.int32)
    leaf = np.asarray(params["leaf_val"], np.float32)
    if leaf.ndim != 3 or leaf.shape[:2] != (T, P):
        raise ValueError(f"leaf_val must be [{T}, {P}, c], got shape {leaf.shape}")
    d = int(np.asarray(params["edges"]).shape[0]) if "edges" in params else None
    if d is not None and (sf.min(initial=-1) < -1 or sf.max(initial=-1) >= d):
        raise ValueError(f"split_feat out of range [-1, {d})")
    for name in ("left", "right"):
        a = arrays[name][sf >= 0]
        if a.size and (a.min() < 0 or a.max() >= P):
            raise ValueError(f"{name} child index out of range [0, {P})")
    dev = torch.device(device)
    # torch.tensor copies (the saved arrays may be read-only views of the
    # npz) but keeps a Fortran-ordered array's strides: make them C-ordered
    return Tree(*(torch.tensor(np.ascontiguousarray(arrays[k]), device=dev)
                  for k in ("split_feat", "split_bin", "left", "right")),
                torch.tensor(np.ascontiguousarray(leaf), device=dev))
