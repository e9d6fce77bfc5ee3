"""The fused selector sweep: every family's fold x grid block, then the metrics.

The port's counterpart of the interpreter core of
``transmogrifai_tpu/ops/sweep.py`` (``_fista_scores``, ``_softmax_scores``,
``_newton_scores``, ``_svc_scores``, ``_mlp_scores``,
``_forest_group_scores``, ``_gbt_group_scores``, ``_frag_scores``,
``_all_scores``, ``_metrics_of``, ``run_sweep``).  A static ``spec`` built
by ``impl/sweep_fragments.py`` names every fragment and the hyperparameter
``blob`` holds their per-candidate values (grammar in the JAX package's
module docstring):

    spec = (problem, frags, strict)
    frag = ("fista", cis, max_iter, fit_intercept, off_l1, off_l2)
         | ("newton", cis, max_iter, fit_intercept, off_l2)
         | ("svc", cis, max_iter, fit_intercept, off_l2)
         | ("mlp", cis, layers, max_iter, off_lr, off_seed)
         | ("forest", out_c, groups) | ("gbt", loss, out_c, groups)

Each fragment scores its candidates on every row; the scores [F, C, n] go
to the binary metrics (K-L) or the regression metrics (K-O), the class
probabilities [F, C, n, k] of a ``("multiclass", k)`` problem to the
multiclass metrics (K-Q).  The work runs eagerly on the device of the
arrays, through the hand-written kernels: K-K for the logistic FISTA fits,
K-S for the pure-L2 logistic (Newton) fits, K-N for the linear-regression
fits, K-P for the multinomial (softmax) fits, K-T for the linear SVC fits
(their hard 0/1 predictions are the scores), K-U for the MLP fits (p(class
1), or the k class probabilities); K-E, K-F and K-G growing the
forests (one gradient channel, or k class channels with class-distribution
leaves) and boosted trees (one channel, or the softmax's k class margins),
K-H boosting (logistic, or squared from each fold's label mean), K-R the
softmax boosting, K-M reading the forests' leaves.  A forest group's trees grow in batches of
``ops/trees.forest_batch_size`` (the spec's ``chunk`` is the JAX
package's, kept for the spec's equality; trees are independent, so the
batching changes no result).  The binary, regression and multiclass
problems are ported, round-collapsed boosting (a gbt group's
``trees_per_round`` > 1: the collapse modes of K-H and K-R) and a
two-class label under the multiclass evaluator among them: there the
binary families' fragments score p(class 1), expanded to the planes
[1 - p, p] as the reference's ``_all_scores`` does.  The checkpoint,
hedge, ledger, trace, AOT-cache and mesh wrappers of the JAX package are
not ported.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import linear as L
from . import trees as Tr
from .metrics import (BINARY_METRICS, binary_grid_metrics, multiclass_grid_metrics,
                      regression_grid_metrics)

__all__ = ["run_sweep", "gbt_chain", "BINARY_METRICS"]


def _multiclass(problem) -> bool:
    """Whether ``problem`` is a ``("multiclass", k)`` spec problem."""
    return isinstance(problem, tuple) and problem[0] == "multiclass"


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _blob(blob: np.ndarray, off: int, k: int) -> np.ndarray:
    return blob[off:off + k]


def _fista_scores(frag, X, y, train_w, blob, classification: bool) -> torch.Tensor:
    """[F, G, n]: p(class 1) of the fragment's elastic-net logistic fits, or
    the predictions of its linear-regression fits."""
    _, cis, max_iter, fit_intercept, off_l1, off_l2 = frag
    G = len(cis)
    fit_fn = L.fit_logistic_grid_folds_fista if classification else L.fit_linear_grid_folds_fista
    fit = fit_fn(X, y, train_w, _blob(blob, off_l1, G), _blob(blob, off_l2, G),
                 max_iter=max_iter, fit_intercept=fit_intercept)
    z = torch.einsum("nd,fgd->fgn", X, fit.coef) + fit.intercept
    return L._sigmoid(z) if classification else z


def _newton_scores(frag, X, y, train_w, blob) -> torch.Tensor:
    """[F, G, n]: p(class 1) of the fragment's pure-L2 logistic fits
    (Newton, K-S)."""
    _, cis, max_iter, fit_intercept, off_l2 = frag
    fit = L.fit_logistic_grid_folds_newton(X, y, train_w, _blob(blob, off_l2, len(cis)),
                                           max_iter=max_iter, fit_intercept=fit_intercept)
    return L._sigmoid(torch.einsum("nd,fgd->fgn", X, fit.coef) + fit.intercept)


def _svc_scores(frag, X, y, train_w, blob) -> torch.Tensor:
    """[F, G, n]: the hard 0/1 predictions of the fragment's squared-hinge
    SVC fits (K-T).  The per-family path emits no probability for an SVC
    (Spark's LinearSVC has none), so its evaluator scores the prediction:
    the fused score is that 0/1 value."""
    _, cis, max_iter, fit_intercept, off_l2 = frag
    fit = L.fit_svc_grid_folds(X, y, train_w, _blob(blob, off_l2, len(cis)),
                               max_iter=max_iter, fit_intercept=fit_intercept)
    z = torch.einsum("nd,fgd->fgn", X, fit.coef) + fit.intercept
    return (z >= 0.0).to(torch.float32)


def _mlp_scores(frag, X, y, train_w, blob, full_prob: bool = False) -> torch.Tensor:
    """[F, G, n]: p(class 1) of the fragment's MLP fits (K-U), or with
    ``full_prob`` the class probabilities [F, G, n, k]."""
    from . import mlp as M

    _, cis, layers, max_iter, off_lr, off_seed = frag
    G = len(cis)
    seeds = _blob(blob, off_seed, G).astype(np.int32)
    params = M.fit_mlp_grid_folds(X, y, train_w, _blob(blob, off_lr, G), seeds, layers=layers,
                                  max_iter=max_iter)
    prob = M.predict_mlp_grid(params, X)[1]
    return prob if full_prob else prob[..., 1]


def _softmax_scores(frag, X, y, train_w, blob, k: int) -> torch.Tensor:
    """[F, G, n, k]: the class probabilities of the fragment's multinomial
    (softmax) fits."""
    _, cis, max_iter, fit_intercept, off_l1, off_l2 = frag
    G = len(cis)
    fit = L.fit_softmax_grid_folds(X, y, train_w, _blob(blob, off_l1, G),
                                   _blob(blob, off_l2, G), num_classes=k,
                                   max_iter=max_iter, fit_intercept=fit_intercept)
    return L.predict_softmax_grid(X, fit.coef, fit.intercept)[1]


def _forest_draws(seed: int, n: int, d: int, n_trees: int, bootstrap: bool, rate: float,
                  frac: float, dev, draws: Optional[Dict]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bootstrap weights f32[T, n], feature masks f32[T, d]) of a forest
    group, drawn once per distinct arguments within ``draws`` (the stock
    space's three forest groups share one draw, which XLA's common
    subexpression elimination also computes once in the reference's single
    program)."""
    key = (seed, n, d, n_trees, bootstrap, rate, frac)
    if draws is None or key not in draws:
        kb, kf = Tr.rng_keys(seed)
        out = (Tr.bootstrap_weights(kb, n, n_trees, bootstrap, rate, dev),
               Tr.feature_masks(kf, d, n_trees, frac, dev))
        if draws is None:
            return out
        draws[key] = out
    return draws[key]


def grow_forest_group(group, xbs, y, train_w, blob, draws: Optional[Dict] = None,
                      out_c: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grow one forest group: (leaf values f32[F Gc, T, P, out_c], each
    row's leaf i32[F Gc, T, n]).

    One bootstrap and feature-mask draw serves every (fold, candidate) of
    the group (``build_sweep_plan`` groups on all the draw depends on); tree
    (f, c, t) trains on ``boot[t] * train_w[f]`` with candidate c's
    min_child_weight and min_info_gain, on g = -y (``out_c`` 1) or g =
    -onehot(y) over ``out_c`` classes (class-distribution leaves)."""
    (cis, depth, n_trees, xb_idx, n_bins, frac, rate, bootstrap, seed,
     frontier, exact_cap, _chunk, off_mcw, off_mig) = group
    Xb = xbs[xb_idx]
    dev = Xb.device
    n, d = Xb.shape
    F = train_w.shape[0]
    Gc = len(cis)
    boot, fm = _forest_draws(seed, n, d, n_trees, bootstrap, rate, frac, dev, draws)
    mcw = _blob(blob, off_mcw, Gc)
    mig = _blob(blob, off_mig, Gc)
    TT = F * Gc * n_trees
    fold_t = np.repeat(np.arange(F), Gc * n_trees)                        # tree -> fold
    cand_t = np.tile(np.repeat(np.arange(Gc), n_trees), F)                # tree -> candidate
    tree_t = np.tile(np.arange(n_trees), F * Gc)                          # tree -> draw
    if out_c == 1:
        g = -y[:, None]
    else:
        g = -torch.nn.functional.one_hot(y.long(), out_c).to(torch.float32)
    h = torch.ones_like(y)
    batch = Tr.forest_batch_size(n, d, n_bins, frontier, out_c)
    leaves, nodes = [], []
    for lo in range(0, TT, batch):
        sl = slice(lo, min(lo + batch, TT))
        ti = torch.as_tensor(tree_t[sl], device=dev)
        fi = torch.as_tensor(fold_t[sl], device=dev)
        w = boot[ti] * train_w[fi]
        k = w.shape[0]
        tree, row_node = Tr.grow_forest(
            Xb, g, h, w, fm[ti], depth, n_bins, frontier,
            np.full(k, 1e-6, np.float32), np.zeros(k, np.float32), mcw[cand_t[sl]],
            mig[cand_t[sl]], exact_cap=exact_cap, return_row_node=True)
        leaves.append(tree.leaf_val)
        nodes.append(row_node)
    return (torch.cat(leaves).reshape(F * Gc, n_trees, -1, out_c),
            torch.cat(nodes).reshape(F * Gc, n_trees, n))


def _forest_group_scores(group, xbs, y, train_w, blob, out_c: int,
                         draws: Optional[Dict] = None) -> torch.Tensor:
    """One forest group -> the mean leaf value [F, Gc, n] (p(class 1), or the
    regression prediction) at ``out_c`` 1, else the class distributions
    [F, Gc, n, out_c]; the leaves read by K-M."""
    leaf, row_node = grow_forest_group(group, xbs, y, train_w, blob, draws, out_c)
    mean = Tr.forest_leaf_mean(leaf[..., 0] if out_c == 1 else leaf, row_node)
    return mean.reshape((train_w.shape[0], len(group[0])) + tuple(mean.shape[1:]))


def _gbt_group_scores(group, xbs, y, train_w, blob, loss: str, out_c: int) -> torch.Tensor:
    """One boosting group -> the final margins [F, Gc, n] (fold x candidate
    batch, one tree per round each, or ``trees_per_round`` trees a
    round-collapsed step), or [F, Gc, n, out_c] class margins for the
    softmax loss, from 0 or, with ``fold_base``, from each fold's weighted
    label mean (float32 on the device, as the reference's)."""
    (cis, rounds, depth, xb_idx, n_bins, subsample, colsample, seed,
     frontier, exact_cap, fold_base, trees_per_round, off_eta, off_lam,
     off_gam, off_mcw, off_mig) = group
    Xb = xbs[xb_idx]
    dev = Xb.device
    n, d = Xb.shape
    F = train_w.shape[0]
    Gc = len(cis)
    ks, kf = Tr.rng_keys(seed)
    rw = Tr.subsample_weights(ks, n, rounds, subsample, dev)
    fms = Tr.feature_masks(kf, d, rounds, colsample, dev)
    hp = {k: np.tile(_blob(blob, off, Gc), F) for k, off in (
        ("eta", off_eta), ("lam", off_lam), ("gam", off_gam), ("mcw", off_mcw),
        ("mig", off_mig))}
    w_b = train_w.repeat_interleave(Gc, dim=0)                            # [F * Gc, n]
    if fold_base:
        base_f = (y[None] * train_w).sum(1) / torch.clamp_min(train_w.sum(1), 1e-12)
    else:
        base_f = torch.zeros(F, dtype=torch.float32, device=dev)
    Fm = Tr.fit_gbt_batch(Xb, y, w_b, rw, fms, loss=loss, n_rounds=rounds, max_depth=depth,
                          n_bins=n_bins, frontier=frontier, eta_b=hp["eta"],
                          reg_lambda_b=np.maximum(hp["lam"], np.float32(1e-6)),
                          gamma_b=hp["gam"], min_child_weight_b=hp["mcw"],
                          base_score_b=base_f.repeat_interleave(Gc), n_classes=out_c,
                          min_info_gain_b=hp["mig"], exact_cap=exact_cap,
                          trees_per_round=trees_per_round)
    return Fm.reshape(F, Gc, n, -1) if loss == "softmax" else Fm[..., 0].reshape(F, Gc, n)


def gbt_chain(spec) -> Optional[Dict[str, int]]:
    """The longest sequential boosting chain of ``spec``: {"steps",
    "levels"}, the boosting steps and dependent tree levels after the round
    collapse (a gbt group's ``trees_per_round``), as the reference's
    ``_spec_gbt_chain``; None without a gbt fragment."""
    steps = levels = 0
    for frag in spec[1]:
        if frag[0] != "gbt":
            continue
        for g in frag[3]:
            s = -(-int(g[1]) // max(int(g[11]), 1))
            steps = max(steps, s)
            levels = max(levels, s * int(g[2]))
    return {"steps": steps, "levels": levels} if steps else None


def _frag_scores(frag, X, xbs, y, train_w, blob, problem):
    """(candidate positions, scores [F, Gf, n]) of one fragment: class-1
    scores of a binary problem, predictions of a regression; class
    probabilities [F, Gf, n, k] of a multiclass one."""
    kind = frag[0]
    multiclass = _multiclass(problem)
    if not multiclass and problem not in ("binary", "regression"):
        raise NotImplementedError(f"{problem!r} sweeps are not ported")
    if kind == "fista":
        if multiclass:
            return frag[1], _softmax_scores(frag, X, y, train_w, blob, problem[1])
        return frag[1], _fista_scores(frag, X, y, train_w, blob, problem == "binary")
    if kind == "newton":
        return frag[1], _newton_scores(frag, X, y, train_w, blob)
    if kind == "svc":
        return frag[1], _svc_scores(frag, X, y, train_w, blob)
    if kind == "mlp":
        return frag[1], _mlp_scores(frag, X, y, train_w, blob, full_prob=multiclass)
    if kind == "forest":
        _, out_c, groups = frag
        cis, outs, draws = [], [], {}
        for grp in groups:
            # multiclass keeps the class-distribution leaves (argmax-equivalent
            # to the normalized probabilities); one channel is the score
            outs.append(_forest_group_scores(grp, xbs, y, train_w, blob, out_c, draws))
            cis.extend(grp[0])
        return cis, torch.cat(outs, dim=1)
    if kind == "gbt":
        _, loss, out_c, groups = frag
        cis, outs = [], []
        for grp in groups:
            Fm = _gbt_group_scores(grp, xbs, y, train_w, blob, loss, out_c)
            if loss == "softmax":  # the class probabilities, as jax.nn.softmax writes them
                outs.append(L._softmax(Fm))
            else:  # squared: the margin is the prediction
                outs.append(L._sigmoid(Fm) if loss == "logistic" else Fm)
            cis.extend(grp[0])
        return cis, torch.cat(outs, dim=1)
    raise NotImplementedError(f"sweep fragment {kind!r} is not ported")


def _all_scores(spec, X, xbs, y, train_w, blob,
                timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
    problem, frags, strict = spec
    n = y.shape[0]
    F = train_w.shape[0]
    shape = (F, len(strict), n) + ((problem[1],) if _multiclass(problem) else ())
    scores = torch.zeros(shape, dtype=torch.float32, device=X.device)
    for frag in frags:
        t0 = time.perf_counter()
        cis, sc = _frag_scores(frag, X, xbs, y, train_w, blob, problem)
        if _multiclass(problem) and sc.ndim == 3:
            # a binary family under a two-class multiclass evaluator: the
            # class-1 score becomes the planes [1 - p, p]
            sc = torch.stack([1.0 - sc, sc], dim=-1)
        scores[:, torch.as_tensor(cis, device=X.device)] = sc
        if timings is not None:
            _sync(scores)
            timings[frag[0]] = timings.get(frag[0], 0.0) + time.perf_counter() - t0
    return scores


def _metrics_of(spec, y, scores, val_w) -> torch.Tensor:
    problem, _, strict = spec
    if problem == "binary":
        return binary_grid_metrics(y, scores, val_w, strict)
    if problem == "regression":
        return regression_grid_metrics(y, scores, val_w)
    if _multiclass(problem):
        return multiclass_grid_metrics(y, scores, val_w)
    raise NotImplementedError(f"{problem!r} sweep metrics are not ported")


def run_sweep(spec, X: torch.Tensor, xbs: Tuple[torch.Tensor, ...], y: torch.Tensor,
              train_w, val_w, blob, timings: Optional[Dict[str, float]] = None
              ) -> torch.Tensor:
    """Run a fused sweep on X's device; returns the metrics f32[F, C, M]
    (``BINARY_METRICS``, ``REGRESSION_METRICS`` or ``MULTICLASS_METRICS``
    order).  ``train_w`` / ``val_w`` [F, n] are the
    folds' training weights and 0/1 validation masks, ``blob`` the host
    float32 hyperparameter vector.  With ``timings``,
    adds each fragment kind's and the metrics' host seconds (each
    synchronized with the device) to it."""
    dev = X.device
    as_t = (lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
            if not isinstance(a, torch.Tensor) else a.to(dev, torch.float32))
    train_w, val_w = as_t(train_w).contiguous(), as_t(val_w)
    blob = np.asarray(blob.cpu() if isinstance(blob, torch.Tensor) else blob, np.float32)
    scores = _all_scores(spec, X, xbs, y, train_w, blob, timings)
    t0 = time.perf_counter()
    out = _metrics_of(spec, y, scores, val_w)
    if timings is not None:
        _sync(out)
        timings["metrics"] = timings.get("metrics", 0.0) + time.perf_counter() - t0
    return out
