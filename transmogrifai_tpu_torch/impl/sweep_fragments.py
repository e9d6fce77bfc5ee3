"""From a selector candidate list to a fused sweep program.

The port's counterpart of ``transmogrifai_tpu/impl/sweep_fragments.py``:
``build_sweep_plan`` translates each family of the candidate list into a
static spec fragment and its hyperparameters in the float32 ``blob``, for
``ops/sweep.run_sweep``; the spec tuple is the JAX package's for the same
inputs.  Ported for the binary problem: OpLogisticRegression (its
elastic-net candidates: the "fista" fragment), OpRandomForestClassifier
("forest"), OpGBTClassifier and OpXGBoostClassifier ("gbt").  Any other
family, a pure-L2 logistic grid point (the JAX package's "newton"
fragment), another evaluator or a non-binary label returns None, as the
JAX package returns None for what it cannot fuse, and the validator keeps
its per-family path.  The partitioning for several devices
(``spec_units``, ``build_subspec``, ``run_sharded``, ``run_rowsharded``) is
not ported.

Frontier sizing: the bootstrap is drawn on the device inside the sweep, so
``build_sweep_plan`` bounds its weight sums (mean + 5 sigma of the Poisson total on
top of the fold's weight sum); ``exact_cap`` is claimed only under that
bound.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import trees as Tr
from ..ops.metrics import BINARY_METRICS
from .trees_common import (DEFAULT_MAX_FRONTIER, DEFAULT_MAX_FRONTIER_BOOSTED,
                           _DYNAMIC_BOOST_KEYS, _FOREST_GRID_KEYS, effective_trees_per_round)


class _Blob:
    """Append-only f32 parameter vector with static offsets."""

    def __init__(self):
        self.parts: List[np.ndarray] = []
        self.off = 0

    def add(self, values) -> int:
        arr = np.asarray(values, np.float32).ravel()
        off = self.off
        self.parts.append(arr)
        self.off += arr.size
        return off

    def pack(self) -> np.ndarray:
        if not self.parts:
            return np.zeros(1, np.float32)
        return np.concatenate(self.parts)


class SweepPlan:
    """A ready-to-run fused sweep: the spec, the arrays on their device, the
    host blob, and the metric names."""

    def __init__(self, spec, X: torch.Tensor, xbs: Tuple[torch.Tensor, ...], y: torch.Tensor,
                 blob: np.ndarray, problem):
        self.spec = spec
        self.X = X
        self.xbs = xbs
        self.y = y
        self.blob = blob
        self.problem = problem
        self.xb_bins = _spec_xb_bins(spec, len(xbs))
        self.metric_names = BINARY_METRICS

    def run(self, train_w: np.ndarray, val_mask: np.ndarray,
            timings: Optional[Dict[str, float]] = None) -> np.ndarray:
        """Execute; returns host metrics [F, C, M] (one pull)."""
        from ..ops.sweep import run_sweep

        out = run_sweep(self.spec, self.X, self.xbs, self.y,
                        np.asarray(train_w, np.float32), np.asarray(val_mask, np.float32),
                        self.blob, timings=timings)
        return out.cpu().numpy()


def _poisson_bound(fold_sum: float, rate: float, max_w: float) -> float:
    """Upper bound on a Poisson(rate)-bootstrapped fold weight sum: mean +
    5 sigma, with sigma^2 = rate * sum_i w_i^2 <= rate * max_w * sum_w."""
    mean = rate * fold_sum
    sigma = math.sqrt(max(rate * fold_sum * max(max_w, 1.0), 1.0))
    return mean + 5.0 * sigma + 5.0 * max(max_w, 1.0)


def _xb_index(xbs: List, X: torch.Tensor, n_bins: int, xb_cache: Dict[int, torch.Tensor]) -> int:
    """Index in ``xbs`` of X's binned matrix for ``n_bins``; ``xb_cache``
    (the caller's, for one X) bins X once per bin count across plans."""
    if n_bins not in xb_cache:
        xb_cache[n_bins] = Tr.quantize(X, n_bins)[0]
    xb = xb_cache[n_bins]
    for i, a in enumerate(xbs):
        if a is xb:
            return i
    xbs.append(xb)
    return len(xbs) - 1


def _spec_xb_bins(spec, n_xbs: int) -> Tuple[int, ...]:
    """Each ``xbs`` entry's bin count, from the spec's tree groups."""
    bins = [0] * n_xbs
    for frag in spec[1]:
        if frag[0] == "forest":
            for g in frag[2]:
                bins[g[3]] = g[4]
        elif frag[0] == "gbt":
            for g in frag[3]:
                bins[g[3]] = g[4]
    return tuple(bins)


def _lr_fragments(est, grids, pos: int, blob: _Blob, y) -> Optional[List]:
    base_mi = int(est.get_param("max_iter", 100))
    base_fi = bool(est.get_param("fit_intercept", True))
    family = est.get_param("family", "auto")
    num_classes = int(np.max(np.asarray(y))) + 1 if len(y) else 2
    if family == "multinomial" or (family == "auto" and num_classes > 2):
        return None
    for g in grids:
        for k in g:
            if k not in ("reg_param", "elastic_net_param"):
                return None
    reg = np.array([float(g.get("reg_param", est.get_param("reg_param", 0.0)))
                    for g in grids], np.float32)
    alpha = np.array([float(g.get("elastic_net_param", est.get_param("elastic_net_param", 0.0)))
                      for g in grids], np.float32)
    l1 = reg * alpha
    l2 = reg * (1.0 - alpha)
    if np.any(l1 == 0.0):
        return None  # pure-L2 points need the Newton fragment (K9), not ported
    fista = tuple(int(pos + i) for i in range(len(grids)))
    off_l1 = blob.add(l1)
    off_l2 = blob.add(l2)
    return [("fista", fista, max(base_mi, 200), base_fi, off_l1, off_l2)]


def _forest_fragment(est, grids, pos: int, blob: _Blob, xbs, X, train_w,
                     xb_cache) -> Optional[List]:
    for g in grids:
        for k in g:
            if k not in _FOREST_GRID_KEYS:
                return None
    n, d = X.shape
    cands = [est.copy_with_params(dict(g)) for g in grids]
    groups: Dict[tuple, List[int]] = {}
    for i, c in enumerate(cands):
        key = (int(c.get_param("max_depth", 5)),
               int(c.get_param("num_trees", 20)),
               int(c.get_param("max_bins", 32)),
               float(c._subset_frac(d)),
               float(c.get_param("subsampling_rate", 1.0)),
               bool(getattr(c, "_grid_bootstrap", True)),
               int(c.get_param("seed", 42)))
        groups.setdefault(key, []).append(i)
    tw = np.asarray(train_w, np.float32)
    fold_sum = float(tw.sum(axis=1).max())
    max_w = float(tw.max()) if tw.size else 1.0
    out_groups = []
    c = 1  # binary forests grow one class-1 channel
    for (depth, ntrees, n_bins, frac, rate, bag, seed), idxs in groups.items():
        mcw = [float(cands[i].get_param("min_instances_per_node", 1)) for i in idxs]
        mig = [float(cands[i].get_param("min_info_gain", 0.0)) for i in idxs]
        bound = _poisson_bound(fold_sum, rate, max_w) if bag else fold_sum
        mcw_min = min(mcw)
        frontier = Tr.frontier_cap(
            n, depth, mcw_min, h_max=1.0,
            max_frontier=int(est.get_param("max_frontier", DEFAULT_MAX_FRONTIER)),
            total_weight=bound)
        exact = Tr.frontier_is_exact(n, depth, mcw_min, 1.0, frontier, total_weight=bound)
        TT = train_w.shape[0] * len(idxs) * ntrees
        chunk = Tr.balanced_chunk(
            TT, Tr.forest_chunk_size(depth, n_bins, d, c, frontier, n_rows=n))
        out_groups.append((
            tuple(int(pos + i) for i in idxs), depth, ntrees,
            _xb_index(xbs, X, n_bins, xb_cache), n_bins, frac,
            rate if bag else 1.0, bag, seed, frontier, exact, chunk,
            blob.add(mcw), blob.add(mig)))
    return [("forest", c, tuple(out_groups))]


def _gbt_fragment(est, grids, pos: int, blob: _Blob, xbs, X, train_w, xb_cache,
                  loss: str) -> Optional[List]:
    static_keys = ("num_round", "max_iter", "max_depth", "max_bins",
                   "subsample", "subsampling_rate", "colsample_bytree",
                   "trees_per_round")
    for g in grids:
        for k in g:
            if k not in _DYNAMIC_BOOST_KEYS and k not in static_keys:
                return None
    n, d = X.shape
    cands = [est.copy_with_params(dict(g)) for g in grids]
    bps = [c._boost_params() for c in cands]
    groups: Dict[tuple, List[int]] = {}
    for i, bp in enumerate(bps):
        k_eff = effective_trees_per_round(int(bp.get("trees_per_round", 1)), bp["n_rounds"])
        key = (bp["n_rounds"], bp["max_depth"], bp["n_bins"],
               float(bp["subsample"]), float(bp["colsample"]),
               int(cands[i].get_param("seed", 42)), k_eff)
        groups.setdefault(key, []).append(i)
    fold_sum = float(np.asarray(train_w, np.float32).sum(axis=1).max())
    h_max = 0.25
    out_groups = []
    for (rounds, depth, n_bins, subsample, colsample, seed, k_eff), idxs in groups.items():
        mcw_min = min(bps[i]["min_child_weight"] for i in idxs)
        frontier = Tr.frontier_cap(
            n, depth, mcw_min, h_max=h_max,
            max_frontier=int(est.get_param("max_frontier", DEFAULT_MAX_FRONTIER_BOOSTED)),
            total_weight=fold_sum)
        exact = Tr.frontier_is_exact(n, depth, mcw_min, h_max, frontier, total_weight=fold_sum)
        out_groups.append((
            tuple(int(pos + i) for i in idxs), rounds, depth,
            _xb_index(xbs, X, n_bins, xb_cache), n_bins, subsample, colsample, seed,
            frontier, exact, False, k_eff,
            blob.add([bps[i]["eta"] for i in idxs]),
            blob.add([bps[i]["reg_lambda"] for i in idxs]),
            blob.add([bps[i]["gamma"] for i in idxs]),
            blob.add([bps[i]["min_child_weight"] for i in idxs]),
            blob.add([bps[i].get("min_info_gain", 0.0) for i in idxs])))
    return [("gbt", loss, 1, tuple(out_groups))]


def build_sweep_plan(candidates: Sequence[Tuple[Any, Sequence[Dict[str, Any]]]],
                     X: torch.Tensor, y: np.ndarray, train_w: np.ndarray,
                     evaluator, xb_cache: Optional[Dict[int, torch.Tensor]] = None
                     ) -> Optional[SweepPlan]:
    """Translate the candidate list into a fused program on X's device, or
    None: every family must be one the port fuses, the evaluator the binary
    one (or the factory's single-metric wrapper of it) with a default metric
    of ``BINARY_METRICS``, and the label 0/1 with both classes.  Plans of
    one X may share ``xb_cache``, its binned matrices by bin count."""
    from ..evaluators import _SingleMetric
    from ..evaluators.classification import OpBinaryClassificationEvaluator
    from .classification.logistic import OpLogisticRegression
    from .classification.trees import (OpGBTClassifier, OpRandomForestClassifier,
                                       OpXGBoostClassifier)

    # exact types only: a subclass may override the fit or the prediction
    fusable = (OpLogisticRegression, OpRandomForestClassifier, OpGBTClassifier,
               OpXGBoostClassifier)
    if any(type(est) not in fusable for est, _ in candidates):
        return None
    yv = np.asarray(y)
    binary = bool(np.isin(yv, (0.0, 1.0)).all()) and len(np.unique(yv)) == 2
    inner = evaluator.inner if type(evaluator) is _SingleMetric else evaluator
    if not (type(inner) is OpBinaryClassificationEvaluator and binary
            and evaluator.default_metric in BINARY_METRICS):
        return None

    X = X.to(torch.float32).contiguous()
    xb_cache = {} if xb_cache is None else xb_cache
    blob = _Blob()
    xbs: List = []
    frags: List = []
    strict: List[int] = []
    pos = 0
    for est, grids in candidates:
        grids = [dict(g) for g in (list(grids) or [{}])]
        if isinstance(est, OpLogisticRegression):
            fr = _lr_fragments(est, grids, pos, blob, yv)
            s = 0  # p >= 0.5
        elif isinstance(est, OpRandomForestClassifier):
            fr = _forest_fragment(est, grids, pos, blob, xbs, X, train_w, xb_cache)
            s = 1  # argmax([1 - p, p]) ties to class 0 => p > 0.5
        else:
            fr = _gbt_fragment(est, grids, pos, blob, xbs, X, train_w, xb_cache,
                               loss="logistic")
            s = 0  # p >= 0.5
        if fr is None:
            return None
        frags.extend(fr)
        strict.extend([s] * len(grids))
        pos += len(grids)
    spec = ("binary", tuple(frags), tuple(strict))
    yd = torch.from_numpy(np.ascontiguousarray(yv, np.float32)).to(X.device)
    return SweepPlan(spec, X, tuple(xbs), yd, blob.pack(), "binary")
