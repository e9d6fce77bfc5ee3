"""Shared tree-model plumbing: parameters and the boosted sweep.

The port's counterpart of ``transmogrifai_tpu/impl/trees_common.py``:
``tree_params`` / ``tree_from_params`` (the carry-across between the saved
numpy parameters and the port's ``Tree`` of tensors, with every pool index
checked, since the walk kernel follows them without bounds checks), the
boosting parameter dicts (the collapse factor defaulting to
``round_collapse_default``), ``effective_trees_per_round`` and
``boosted_grid_folds`` and ``forest_grid_folds``, the per-family fold x
grid sweeps of the boosted models and the forests (classifiers and
regressors), ``tree_device_params`` and ``TreeParamsMixin``, Spark's
featureSubsetStrategy.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..ops import trees as Tr
from ..ops.trees import Tree

#: frontier caps of the forest and boosted growers (``ops/trees.frontier_cap``),
#: overridable per stage through the ``max_frontier`` param
DEFAULT_MAX_FRONTIER = 256
DEFAULT_MAX_FRONTIER_BOOSTED = 256

_SUBSET_STRATEGIES = ("auto", "all", "sqrt", "log2", "onethird")


class TreeParamsMixin:
    """Spark featureSubsetStrategy: "auto" is ``_auto_subset`` (sqrt for
    classification forests)."""

    _auto_subset: str = "sqrt"

    def _subset_frac(self, d: int) -> float:
        strat = str(self.get_param("feature_subset_strategy", "auto")).lower()
        if strat == "auto":
            strat = self._auto_subset
        if strat == "all":
            return 1.0
        if strat == "sqrt":
            return math.sqrt(d) / d
        if strat == "log2":
            return max(math.log2(max(d, 2)), 1.0) / d
        if strat == "onethird":
            return 1.0 / 3.0
        try:
            frac = float(strat)
        except ValueError:
            raise ValueError(
                f"Unknown feature_subset_strategy {strat!r}; expected one of "
                f"{_SUBSET_STRATEGIES} or a fraction in (0, 1]") from None
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"feature_subset_strategy fraction must be in (0, 1], got {frac}")
        return frac


def round_collapse_default() -> int:
    """The default round-collapse factor K of the boosted models: the
    ``TMOG_GBT_ROUND_COLLAPSE`` environment variable (the JAX package's
    model setting, read as it reads it; unset, empty or not a number: 1, the
    per-round scan).  K > 1 grows K trees a boosting step on shared
    gradients at learning rate eta / K (``ops/trees.fit_gbt``)."""
    from ..utils.env import env_int

    return max(env_int("TMOG_GBT_ROUND_COLLAPSE", 1), 1)


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
            "trees_per_round": int(stage.get_param("trees_per_round",
                                                   round_collapse_default()))}


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
            "trees_per_round": int(stage.get_param("trees_per_round",
                                                   round_collapse_default()))}


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
    on ``X``'s device, from the margin 0 or, for the squared loss, from
    each fold's weighted label mean; margins on every
    row become predictions by ``convert``.  Returns ``preds[fold][grid]``."""
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
    fold_base = loss == "squared"  # regression starts from the fold's label mean
    for (n_rounds, max_depth, n_bins, subsample, colsample, k_eff), cis in groups.items():
        Xb, _ = Tr.quantize(X, n_bins)
        ks, kfm = Tr.rng_keys(int(est.get_param("seed", 42)))
        rw = Tr.subsample_weights(ks, n, n_rounds, subsample, dev)
        fms = Tr.feature_masks(kfm, d, n_rounds, colsample, dev)
        mcw_min = min(bps[ci]["min_child_weight"] for ci in cis)
        pairs = [(f, ci) for f in range(n_folds) for ci in cis]
        B = len(pairs)
        w_batch = np.empty((B, n), np.float32)
        hp = {k: np.zeros(B, np.float32) for k in ("eta", "lam", "gam", "mcw", "mig", "base")}
        yf = np.asarray(y, np.float32)
        for bi, (f, ci) in enumerate(pairs):
            bp = bps[ci]
            w_batch[bi] = train_w[f]
            hp["eta"][bi] = bp["eta"]
            hp["lam"][bi] = max(bp["reg_lambda"], 1e-6)
            hp["gam"][bi] = bp["gamma"]
            hp["mcw"][bi] = bp["min_child_weight"]
            hp["mig"][bi] = bp.get("min_info_gain", 0.0)
            if fold_base:
                wsum = max(float(train_w[f].sum()), 1e-12)
                hp["base"][bi] = float((yf * train_w[f]).sum() / wsum)
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
            gamma_b=hp["gam"], min_child_weight_b=hp["mcw"], base_score_b=hp["base"],
            n_classes=n_classes, min_info_gain_b=hp["mig"], exact_cap=exact_cap,
            trees_per_round=k_eff)
        F = F.cpu().numpy()
        for bi, (f, ci) in enumerate(pairs):
            out[f][ci] = convert(F[bi])
    return out


#: forest grid keys that batch (per-tree scalars or static group keys)
_FOREST_GRID_KEYS = ("max_depth", "num_trees", "min_instances_per_node",
                     "subsampling_rate", "feature_subset_strategy", "max_bins",
                     "impurity", "min_info_gain")


def forest_grid_folds(est, X, y, train_w, grids, n_classes: int, convert) -> list:
    """fold x grid forest sweep: per (max_depth, num_trees, max_bins) group,
    every (fold, candidate, tree) grows in one population
    (``ops/trees.fit_forest_chunked``) on one shared draw per (seed, rate,
    fraction, bagging), and each (fold, candidate)'s trees are walked and
    averaged on every row (``predict_forest_groups``).  ``convert(dist,
    candidate)`` maps a mean leaf vector (``n_classes`` 2: the class
    distribution [p0, p1] from one class-1 channel; above 2: the class
    distribution of the -onehot channels; 1, regression: the mean) to
    (pred, raw, prob).  Returns ``preds[fold][grid]``."""
    grids = [dict(g) for g in (grids or [{}])]
    for g in grids:
        for key in g:
            if key not in _FOREST_GRID_KEYS:
                raise NotImplementedError(f"non-batchable forest grid key {key}")
    candidates = [est.copy_with_params(g) for g in grids]
    dev = X.device
    n_folds = train_w.shape[0]
    n, d = X.shape
    out = [[None] * len(grids) for _ in range(n_folds)]
    groups: Dict[tuple, list] = {}
    for ci, cand in enumerate(candidates):
        static = (int(cand.get_param("max_depth", 5)), int(cand.get_param("num_trees", 20)),
                  int(cand.get_param("max_bins", 32)))
        groups.setdefault(static, []).append(ci)
    c = n_classes if n_classes > 2 else 1
    if c > 1:
        g_t = torch.from_numpy(-np.eye(c, dtype=np.float32)[np.asarray(y, np.int64)]).to(dev)
    else:
        g_t = torch.from_numpy(-np.asarray(y, np.float32)[:, None]).to(dev)
    h_t = torch.ones(n, dtype=torch.float32, device=dev)
    tw = torch.from_numpy(np.asarray(train_w, np.float32)).to(dev)
    for (max_depth, n_trees, n_bins), cis in groups.items():
        Xb, _ = Tr.quantize(X, n_bins)
        mcw_min = min(float(candidates[ci].get_param("min_instances_per_node", 1)) for ci in cis)
        pairs = [(f, ci) for f in range(n_folds) for ci in cis]
        draws: Dict[tuple, tuple] = {}
        w_parts, fm_parts, mcw, mig = [], [], [], []
        for f, ci in pairs:
            cand = candidates[ci]
            seed = int(cand.get_param("seed", 42))
            rate = float(cand.get_param("subsampling_rate", 1.0))
            frac = cand._subset_frac(d)
            bag = bool(getattr(cand, "_grid_bootstrap", True))
            dkey = (seed, rate, frac, bag)
            if dkey not in draws:
                kb, kf = Tr.rng_keys(seed)
                draws[dkey] = (Tr.bootstrap_weights(kb, n, n_trees, bag, rate, dev),
                               Tr.feature_masks(kf, d, n_trees, frac if bag else 1.0, dev))
            boot, fm = draws[dkey]
            w_parts.append(boot * tw[f][None])
            fm_parts.append(fm)
            mcw += [float(cand.get_param("min_instances_per_node", 1))] * n_trees
            mig += [float(cand.get_param("min_info_gain", 0.0))] * n_trees
        w_trees = torch.cat(w_parts)
        # frontier bound from the drawn per-tree weight sums
        w_sum_max = float(w_trees.sum(1).max())
        frontier = Tr.frontier_cap(
            n, max_depth, mcw_min, h_max=1.0,
            max_frontier=int(est.get_param("max_frontier", DEFAULT_MAX_FRONTIER)),
            total_weight=w_sum_max)
        exact_cap = Tr.frontier_is_exact(n, max_depth, mcw_min, 1.0, frontier,
                                         total_weight=w_sum_max)
        chunk = Tr.forest_batch_size(n, d, n_bins, frontier, c)
        forest = Tr.fit_forest_chunked(Xb, g_t, h_t, w_trees, torch.cat(fm_parts),
                                       np.asarray(mcw, np.float32), max_depth, n_bins, chunk,
                                       frontier, mig_trees=np.asarray(mig, np.float32),
                                       exact_cap=exact_cap)
        dist = Tr.predict_forest_groups(Xb, forest, max_depth, len(pairs)).cpu().numpy()
        if n_classes == 2:  # class-1 share -> [p0, p1]
            dist = np.concatenate([1.0 - dist, dist], axis=-1)
        for gi, (f, ci) in enumerate(pairs):
            out[f][ci] = convert(dist[gi], candidates[ci])
    return out


def tree_params(tree: Tree, **extra) -> Dict[str, Any]:
    """Flatten a ``Tree`` into a serializable params dict (numpy arrays, the
    JAX package's layout)."""
    return {"split_feat": tree.split_feat.cpu().numpy(),
            "split_bin": tree.split_bin.cpu().numpy(),
            "left": tree.left.cpu().numpy(), "right": tree.right.cpu().numpy(),
            "leaf_val": tree.leaf_val.cpu().numpy(), **extra}


def tree_device_params(params: Dict[str, Any], device) -> Dict[str, Any]:
    """A tree model's params with its ``Tree`` and bin edges on ``device``."""
    return {**params, "tree": tree_from_params(params, device),
            "edges": torch.tensor(np.ascontiguousarray(params["edges"], np.float32),
                                  device=device)}


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
