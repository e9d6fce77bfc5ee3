"""From a selector candidate list to a fused sweep program.

The port's counterpart of ``transmogrifai_tpu/impl/sweep_fragments.py``:
``build_sweep_plan`` translates each family of the candidate list into a
static spec fragment and its hyperparameters in the float32 ``blob``, for
``ops/sweep.run_sweep``; the spec tuple is the JAX package's for the same
inputs.  Ported for the binary problem: OpLogisticRegression (its
pure-L2 candidates: the "newton" fragment; its elastic-net candidates: the
"fista" fragment), OpLinearSVC ("svc"), OpMultilayerPerceptronClassifier
("mlp", p(class 1)), OpRandomForestClassifier and OpDecisionTreeClassifier
("forest"; a decision tree is a one-tree forest, unbagged and on every
feature), OpGBTClassifier and OpXGBoostClassifier ("gbt", logistic); for the
regression problem: OpLinearRegression (every candidate: "fista"),
OpRandomForestRegressor and OpDecisionTreeRegressor ("forest", mean
leaves), OpGBTRegressor and OpXGBoostRegressor ("gbt", squared, from each
fold's label mean); for the multiclass problem (``("multiclass", k)``, 3 <=
k <= 8, the multiclass evaluator): OpLogisticRegression (every candidate a
softmax fit: "fista"), OpMultilayerPerceptronClassifier ("mlp", the k class
probabilities), OpRandomForestClassifier and OpDecisionTreeClassifier
("forest" with k class-distribution channels), OpGBTClassifier and
OpXGBoostClassifier ("gbt", softmax over k class margins).  Naive Bayes is
not a fused family in either package.  Any other family, another
evaluator, a binary evaluator over a non-binary label or a multiclass score
block above the JAX package's 2e9-byte guard returns None, as the JAX
package returns None for what it cannot fuse, and the validator keeps its
per-family path.  The multiclass
evaluator over two classes raises.  The partitioning for several
devices (``spec_units``, ``build_subspec``, ``run_sharded``,
``run_rowsharded``) is not ported.

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
from ..ops.metrics import (BINARY_METRICS, MULTICLASS_MAX_CLASSES, MULTICLASS_METRICS,
                           REGRESSION_METRICS)
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
        self.metric_names = {"binary": BINARY_METRICS, "regression": REGRESSION_METRICS}.get(
            problem, MULTICLASS_METRICS)

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


def _penalties(est, grids) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The candidates' elastic-net (l1, l2) = (reg * alpha, reg * (1 -
    alpha)), float32, or None when a grid sets another key."""
    for g in grids:
        for k in g:
            if k not in ("reg_param", "elastic_net_param"):
                return None
    reg = np.array([float(g.get("reg_param", est.get_param("reg_param", 0.0)))
                    for g in grids], np.float32)
    alpha = np.array([float(g.get("elastic_net_param", est.get_param("elastic_net_param", 0.0)))
                      for g in grids], np.float32)
    return reg * alpha, reg * (1.0 - alpha)


def _fista_fragment(est, pos: int, blob: _Blob, l1, l2, min_iter: int,
                    cis: Optional[Tuple[int, ...]] = None) -> List:
    cis = tuple(int(pos + i) for i in range(len(l1))) if cis is None else cis
    off_l1 = blob.add(l1)
    off_l2 = blob.add(l2)
    return [("fista", cis, max(int(est.get_param("max_iter", 100)), min_iter),
             bool(est.get_param("fit_intercept", True)), off_l1, off_l2)]


def _lr_fragments(est, grids, pos: int, blob: _Blob, y) -> Optional[List]:
    """Binary logistic regression: the pure-L2 points (l1 = 0) in one
    "newton" fragment of ``min(max(max_iter // 4, 10), 50)`` steps, the
    elastic-net points in one "fista" fragment of at least 200, as the
    reference's ``fit_arrays`` picks the solver per point."""
    family = est.get_param("family", "auto")
    num_classes = int(np.max(np.asarray(y))) + 1 if len(y) else 2
    if family == "multinomial" or (family == "auto" and num_classes > 2):
        return None
    pen = _penalties(est, grids)
    if pen is None:
        return None
    l1, l2 = pen
    base_mi = int(est.get_param("max_iter", 100))
    frags: List = []
    newton = np.where(l1 == 0.0)[0]
    fista = np.where(l1 != 0.0)[0]
    if len(newton):
        frags.append(("newton", tuple(int(pos + i) for i in newton),
                      min(max(base_mi // 4, 10), 50), bool(est.get_param("fit_intercept", True)),
                      blob.add(l2[newton])))
    if len(fista):
        frags.extend(_fista_fragment(est, pos, blob, l1[fista], l2[fista], min_iter=200,
                                     cis=tuple(int(pos + i) for i in fista)))
    return frags


def _softmax_fragments(est, grids, pos: int, blob: _Blob) -> Optional[List]:
    """Multinomial logistic regression: every grid point is one softmax FISTA
    fit of ``max_iter`` steps (the JAX package's multinomial branch)."""
    pen = _penalties(est, grids)
    return None if pen is None else _fista_fragment(est, pos, blob, *pen, min_iter=0)


def _linreg_fragments(est, grids, pos: int, blob: _Blob) -> Optional[List]:
    """Every linear-regression candidate is one FISTA fit (l1 = 0 included:
    the fused sweep takes no ridge fragment)."""
    pen = _penalties(est, grids)
    return None if pen is None else _fista_fragment(est, pos, blob, *pen, min_iter=300)


def _svc_fragments(est, grids, pos: int, blob: _Blob) -> Optional[List]:
    """Every linear SVC candidate is one squared-hinge fit of at least 200
    steps (``reg_param`` is the only grid key)."""
    for g in grids:
        for k in g:
            if k != "reg_param":
                return None
    l2 = [float(g.get("reg_param", est.get_param("reg_param", 0.0))) for g in grids]
    cis = tuple(range(pos, pos + len(grids)))
    return [("svc", cis, max(int(est.get_param("max_iter", 100)), 200),
             bool(est.get_param("fit_intercept", True)), blob.add(l2))]


def _mlp_fragments(est, grids, pos: int, blob: _Blob, d: int,
                   n_classes: int = 2) -> Optional[List]:
    """One "mlp" fragment per (hidden_layers, max_iter) group; the step sizes
    and the init seeds (as float32) in the blob."""
    for g in grids:
        for k in g:
            if k not in ("hidden_layers", "max_iter", "step_size", "seed"):
                return None
    cands = [est.copy_with_params(dict(g)) for g in grids]
    groups: Dict[tuple, List[int]] = {}
    for i, c in enumerate(cands):
        hl = tuple(int(h) for h in c.get_param("hidden_layers", (10,)))
        groups.setdefault((hl, int(c.get_param("max_iter", 200))), []).append(i)
    frags = []
    for (hl, mi), idxs in groups.items():
        lrs = [float(cands[i].get_param("step_size", 0.03)) for i in idxs]
        seeds = [float(int(cands[i].get_param("seed", 42))) for i in idxs]
        frags.append(("mlp", tuple(int(pos + i) for i in idxs), (d,) + hl + (n_classes,), mi,
                      blob.add(lrs), blob.add(seeds)))
    return frags


def _forest_fragment(est, grids, pos: int, blob: _Blob, xbs, X, train_w,
                     xb_cache, n_classes: int = 1) -> Optional[List]:
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
    # binary forests grow one class-1 channel, regression forests the label,
    # multiclass forests one -onehot channel per class
    c = n_classes if n_classes > 2 else 1
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
                  loss: str, n_classes: int = 2) -> Optional[List]:
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
    h_max = 0.25 if loss in ("logistic", "softmax") else 1.0
    fold_base = loss == "squared"  # regression boosting starts from the fold's label mean
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
            frontier, exact, fold_base, k_eff,
            blob.add([bps[i]["eta"] for i in idxs]),
            blob.add([bps[i]["reg_lambda"] for i in idxs]),
            blob.add([bps[i]["gamma"] for i in idxs]),
            blob.add([bps[i]["min_child_weight"] for i in idxs]),
            blob.add([bps[i].get("min_info_gain", 0.0) for i in idxs])))
    return [("gbt", loss, n_classes if loss == "softmax" else 1, tuple(out_groups))]


def build_sweep_plan(candidates: Sequence[Tuple[Any, Sequence[Dict[str, Any]]]],
                     X: torch.Tensor, y: np.ndarray, train_w: np.ndarray,
                     evaluator, xb_cache: Optional[Dict[int, torch.Tensor]] = None
                     ) -> Optional[SweepPlan]:
    """Translate the candidate list into a fused program on X's device, or
    None: every family must be one the port fuses for the problem, the
    evaluator the binary one with a 0/1 label of both classes (default
    metric in ``BINARY_METRICS``), the regression one (default metric in
    ``REGRESSION_METRICS``) or the multiclass one over class labels 0 ..
    k - 1 (default metric in ``MULTICLASS_METRICS``), bare or in the
    factory's single-metric wrapper.  Plans of one X may share
    ``xb_cache``, its binned matrices by bin count."""
    from ..evaluators import _SingleMetric
    from ..evaluators.classification import (OpBinaryClassificationEvaluator,
                                             OpMultiClassificationEvaluator)
    from ..evaluators.regression import OpRegressionEvaluator
    from .classification.logistic import OpLogisticRegression
    from .classification.mlp import OpMultilayerPerceptronClassifier
    from .classification.svc import OpLinearSVC
    from .classification.trees import (OpDecisionTreeClassifier, OpGBTClassifier,
                                       OpRandomForestClassifier, OpXGBoostClassifier)
    from .regression.linear import OpLinearRegression
    from .regression.trees import (OpDecisionTreeRegressor, OpGBTRegressor,
                                   OpRandomForestRegressor, OpXGBoostRegressor)

    # exact types only: a subclass may override the fit or the prediction (the
    # decision trees are named although they subclass the forests)
    families = {
        "binary": (OpLogisticRegression, OpLinearSVC, OpMultilayerPerceptronClassifier,
                   OpRandomForestClassifier, OpDecisionTreeClassifier, OpGBTClassifier,
                   OpXGBoostClassifier),
        "regression": (OpLinearRegression, OpRandomForestRegressor, OpDecisionTreeRegressor,
                       OpGBTRegressor, OpXGBoostRegressor),
        "multiclass": (OpLogisticRegression, OpMultilayerPerceptronClassifier,
                       OpRandomForestClassifier, OpDecisionTreeClassifier, OpGBTClassifier,
                       OpXGBoostClassifier)}
    yv = np.asarray(y)
    binary = bool(np.isin(yv, (0.0, 1.0)).all()) and len(np.unique(yv)) == 2
    inner = evaluator.inner if type(evaluator) is _SingleMetric else evaluator
    n_classes = 0
    if type(inner) is OpBinaryClassificationEvaluator and binary:
        problem, kind, metrics = "binary", "binary", BINARY_METRICS
    elif type(inner) is OpRegressionEvaluator:
        problem, kind, metrics = "regression", "regression", REGRESSION_METRICS
    elif type(inner) is OpMultiClassificationEvaluator \
            and len(yv) and np.isin(yv, np.arange(64)).all():
        n_classes = max(int(yv.max()) + 1, 2)
        problem, kind, metrics = ("multiclass", n_classes), "multiclass", MULTICLASS_METRICS
    else:
        return None
    if evaluator.default_metric not in metrics:
        return None
    if kind == "multiclass":
        n_cand = sum(max(len(list(g) or [{}]), 1) for _, g in candidates)
        if 8 * n_cand * len(yv) * n_classes * 4 > 2e9:  # the JAX package's score guard
            return None
        if n_classes == 2:
            raise NotImplementedError(
                "the fused sweep of a two-class label under the multiclass evaluator is not "
                "ported (the JAX package trains the binary kernels and expands p to [1 - p, p])")
        if n_classes > MULTICLASS_MAX_CLASSES:
            raise NotImplementedError(
                f"the port's multiclass sweep takes at most {MULTICLASS_MAX_CLASSES} classes "
                f"(its kernels' limit), got {n_classes}")
    for est, _ in candidates:
        if type(est) not in families[kind]:
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
        s = 0  # p >= 0.5 (regression, multiclass: unused)
        if isinstance(est, OpLogisticRegression):
            fr = (_softmax_fragments(est, grids, pos, blob) if kind == "multiclass"
                  else _lr_fragments(est, grids, pos, blob, yv))
        elif isinstance(est, OpLinearRegression):
            fr = _linreg_fragments(est, grids, pos, blob)
        elif isinstance(est, OpLinearSVC):
            fr = _svc_fragments(est, grids, pos, blob)  # a 0/1 score: >= 0.5 is z >= 0
        elif isinstance(est, OpMultilayerPerceptronClassifier):
            fr = _mlp_fragments(est, grids, pos, blob, X.shape[1], max(n_classes, 2))
            if problem == "binary":
                s = 1  # argmax(prob) ties to class 0 => p > 0.5
        elif isinstance(est, (OpRandomForestClassifier, OpRandomForestRegressor)):
            fr = _forest_fragment(est, grids, pos, blob, xbs, X, train_w, xb_cache, n_classes)
            if problem == "binary":
                s = 1  # argmax([1 - p, p]) ties to class 0 => p > 0.5
        else:
            loss = {"binary": "logistic", "regression": "squared"}.get(kind, "softmax")
            fr = _gbt_fragment(est, grids, pos, blob, xbs, X, train_w, xb_cache, loss=loss,
                               n_classes=n_classes)
        if fr is None:
            return None
        frags.extend(fr)
        strict.extend([s] * len(grids))
        pos += len(grids)
    spec = (problem, tuple(frags), tuple(strict))
    yd = torch.from_numpy(np.ascontiguousarray(yv, np.float32)).to(X.device)
    return SweepPlan(spec, X, tuple(xbs), yd, blob.pack(), problem)
