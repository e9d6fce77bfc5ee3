"""The port's regression modules and their kernels' plain versions against
the JAX package, on the CPU, at small sizes.

- K-N (``ops/linear.py::linear_fista_grad``): the batched FISTA
  linear-regression fits against ``fit_linear_grid_folds_fista``
  (coefficients within ``COEF_RTOL`` relative: float32 sums in another
  order than XLA's over 300 steps), the plain gradient against float64.
- K-O (``ops/metrics.py::regression_metrics``): against
  ``_regression_grid_metrics``, a constant-label fold (ss_tot = 0) and an
  empty fold included, within ``METRIC_RTOL`` (the port sums in float64 and
  rounds once; XLA sums in float32).
- K-H squared (``ops/trees.py::boost_step``): bit-equal to ``_grad_hess``'s
  squared branch times the weights.
- K-E's data-sized fixed-point scale: 2^32 wherever it fits (bit-equal on
  every binary path), fewer bits for targets around 1e6.
- One regression forest group and one squared GBT group (from the fold
  label means) against the JAX package's interpreter; the spec, blob and
  binned matrices of the stock regression space; the estimators' fits
  and the per-family sweep; the evaluator and the ridge fits' refusal.

The forests and boosted trees are not bit-equal on real targets: K-E sums
w*g in fixed point where XLA sums float32, so leaf values move in the last
bits (``TREE_RTOL``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import Evaluators as JE
from transmogrifai_tpu.evaluators.regression import OpRegressionEvaluator as JRegEval
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.regression.linear import OpLinearRegression as JLinR
from transmogrifai_tpu.impl.regression.trees import OpGBTRegressor as JGBTR
from transmogrifai_tpu.impl.regression.trees import OpRandomForestRegressor as JRFR
from transmogrifai_tpu.impl.regression.trees import OpXGBoostRegressor as JXGBR
from transmogrifai_tpu.impl.selector.factories import RegressionModelSelector as JRS
from transmogrifai_tpu.impl.tuning.validators import OpCrossValidation as JCV
from transmogrifai_tpu.impl.tuning.validators import ValidationSummary as JVS
from transmogrifai_tpu.ops import linear as JL
from transmogrifai_tpu.ops import sweep as JSW
from transmogrifai_tpu.ops import trees as JT
from transmogrifai_tpu.ops.metrics import _regression_grid_metrics

from transmogrifai_tpu_torch.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.evaluators.regression import OpRegressionEvaluator as PRegEval
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.regression.linear import OpLinearRegression as PLinR
from transmogrifai_tpu_torch.impl.regression.trees import OpGBTRegressor as PGBTR
from transmogrifai_tpu_torch.impl.regression.trees import OpRandomForestRegressor as PRFR
from transmogrifai_tpu_torch.impl.regression.trees import OpXGBoostRegressor as PXGBR
from transmogrifai_tpu_torch.impl.selector.factories import RegressionModelSelector as PRS
from transmogrifai_tpu_torch.impl.tuning.validators import OpCrossValidation as PCV
from transmogrifai_tpu_torch.impl.tuning.validators import ValidationSummary as PVS
from transmogrifai_tpu_torch.ops import linear as PL
from transmogrifai_tpu_torch.ops import metrics as PM
from transmogrifai_tpu_torch.ops import sweep as PSW
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

#: FISTA coefficients, relative to the largest: float32 gradient sums in
#: another order than XLA's over 300 steps
COEF_RTOL = 2e-5
#: regression metrics, relative: float64 sums rounded once against XLA's
#: float32 sums of 2,000 rows
METRIC_RTOL = 2e-6
#: forest and boosted predictions, relative to the label scale: fixed-point
#: histogram sums against XLA's float32 sums
TREE_RTOL = 1e-5
#: the share of a group's predictions a near-tied split flip may move past
#: ``TREE_RTOL``, and how far (relative to the label scale): one tree of the
#: group takes the other side of a tie
FLIP_SHARE, FLIP_RTOL = 0.01, 0.01


def _assert_trees_close(got, want, scale):
    off = np.abs(got - want) > TREE_RTOL * scale
    assert off.mean() <= FLIP_SHARE, f"{off.sum()} of {off.size} predictions moved"
    np.testing.assert_allclose(got, want, rtol=0, atol=FLIP_RTOL * scale)


def _data(n, d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 1] = rng.integers(0, 3, n)
    X[:, 2] *= 100.0  # unstandardized, as Boston's tax
    y = (scale * (2.0 * X[:, 0] - X[:, 1] + 0.01 * X[:, 2] + rng.normal(size=n) + 20.0)
         ).astype(np.float32)
    return X, y


def _folds(n, F, seed):
    rng = np.random.default_rng(seed)
    assign = rng.permutation(n) % F
    vm = np.stack([(assign == f) for f in range(F)]).astype(np.float32)
    return 1.0 - vm, vm


# ---------------------------------------------------------------------------
# K-N: the linear FISTA fits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_linear_fista_grid_folds_match_jax(fit_intercept):
    X, y = _data(400, 6)
    tw, _ = _folds(400, 2, 1)
    tw[1] *= np.random.default_rng(2).integers(1, 4, 400)  # integer fold weights
    l1 = np.array([0.0001, 0.005, 0.1, 0.0], np.float32)
    l2 = np.array([0.0009, 0.005, 0.1, 0.2], np.float32)
    want = JL.fit_linear_grid_folds_fista(X, y, tw, l1, l2, max_iter=300,
                                          fit_intercept=fit_intercept)
    got = PL.fit_linear_grid_folds_fista(torch.from_numpy(X), torch.from_numpy(y),
                                         torch.from_numpy(tw), l1, l2, max_iter=300,
                                         fit_intercept=fit_intercept)
    assert tuple(got.coef.shape) == (2, 4, 6) and tuple(got.intercept.shape) == (2, 4, 1)
    for a, b in ((got.coef, want.coef), (got.intercept, want.intercept)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=COEF_RTOL * np.abs(b).max() + 1e-7)


def test_linear_fista_single_fit_and_estimator_match_jax():
    X, y = _data(300, 5, seed=3)
    jp = JLinR(reg_param=0.01, elastic_net_param=0.1, max_iter=50).fit_arrays(X, y)
    pp = PLinR(reg_param=0.01, elastic_net_param=0.1, max_iter=50).to("cpu") \
        .fit_arrays(torch.from_numpy(X), y)
    assert pp.keys() == jp.keys()
    for k in ("coef", "intercept"):
        assert pp[k].shape == jp[k].shape and pp[k].dtype == jp[k].dtype == np.float32
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=COEF_RTOL * np.abs(jp[k]).max())
    jpred = JLinR.predict_arrays(jp, X)
    ppred = PLinR.predict_arrays(pp, torch.from_numpy(X))
    assert ppred[1] is None and ppred[2] is None and jpred[1] is None
    np.testing.assert_allclose(ppred[0], jpred[0], rtol=1e-5, atol=1e-4)


def test_linear_fista_grad_plain_is_the_gradient():
    X, y = _data(200, 4, seed=5)
    X1 = np.concatenate([X, np.ones((200, 1), np.float32)], 1)
    w = np.stack([np.ones(200), (np.arange(200) % 3 == 0)]).astype(np.float32)
    z = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32) * 0.1
    fold = np.array([0, 1, 1], np.int32)
    l2v = np.full((3, 5), 0.02, np.float32)
    l2v[:, -1] = 0.0
    wsum = w.sum(1)[fold]
    got = PL.linear_fista_grad(*(torch.from_numpy(a)
                                 for a in (X1, y, w, fold, z, l2v, wsum))).numpy()
    X64 = X1.astype(np.float64)
    for c in range(3):
        ref = X64.T @ (w[fold[c]] * (X64 @ z[c] - y)) / wsum[c] + l2v[c] * z[c]
        np.testing.assert_allclose(got[c], ref, rtol=1e-5, atol=1e-3)


def test_ridge_fits_raise():
    """The L1-free fits (reg 0.1 / alpha 0, and reg 0 / alpha 0.5) no longer
    raise: they fit in closed form (``fit_ridge``, K-S), as the JAX
    package's do, in the refit and in the fold x grid batch."""
    X, y = _data(50, 3)
    tw = np.ones((1, 50), np.float32)
    for reg, alpha in ((0.1, 0.0), (0.0, 0.5)):
        est = PLinR(reg_param=reg, elastic_net_param=alpha).to("cpu")
        got = est.fit_arrays(torch.from_numpy(X), y)
        want = JLinR(reg_param=reg, elastic_net_param=alpha).fit_arrays(X, y)
        np.testing.assert_allclose(got["coef"], np.asarray(want["coef"]), rtol=1e-5, atol=1e-5)
        pg = est.fit_grid_folds(torch.from_numpy(X), y, tw, [{}])
        jg = JLinR(reg_param=reg, elastic_net_param=alpha).fit_grid_folds(X, y, tw, [{}])
        np.testing.assert_allclose(pg[0][0][0], jg[0][0][0], rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# K-O: the regression metrics
# ---------------------------------------------------------------------------
def _metric_case(name):
    rng = np.random.default_rng(7)
    F, C, n = 3, 5, 2000
    y = (30.0 + 9.0 * rng.normal(size=n)).astype(np.float32)
    preds = (y + rng.normal(size=(F, C, n)) * np.arange(1, C + 1)[:, None]).astype(np.float32)
    _, vm = _folds(n, F, 8)
    if name == "constant_label":  # fold 1's validation labels are all equal: ss_tot = 0
        y[vm[1] > 0] = 21.5
    elif name == "empty_fold":
        vm[2] = 0.0
    elif name == "weighted":  # non-0/1 validation weights
        vm = vm * rng.integers(1, 4, size=(F, n)).astype(np.float32)
    return y, preds, vm


@pytest.mark.parametrize("name", ["random", "constant_label", "empty_fold", "weighted"])
def test_regression_metrics_match_jax(name):
    y, preds, vm = _metric_case(name)
    want = np.asarray(_regression_grid_metrics(jnp.asarray(y), jnp.asarray(preds),
                                               jnp.asarray(vm)))
    got = PM.regression_grid_metrics(torch.from_numpy(y), torch.from_numpy(preds),
                                     torch.from_numpy(vm)).numpy()
    assert got.shape == want.shape == (3, 5, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=1e-30)
    if name == "constant_label":
        assert (got[1, :, 2] == 0.0).all() and (want[1, :, 2] == 0.0).all()
    if name == "empty_fold":
        assert (got[2] == 0.0).all()


def test_regression_metrics_keep_ties_and_check_inputs():
    y, preds, vm = _metric_case("random")
    preds[:, 3] = preds[:, 1]  # two candidates with equal predictions tie exactly
    got = PM.regression_grid_metrics(torch.from_numpy(y), torch.from_numpy(preds),
                                     torch.from_numpy(vm)).numpy()
    np.testing.assert_array_equal(got[:, 3], got[:, 1])
    p2 = torch.from_numpy(preds.reshape(15, -1))
    with pytest.raises(ValueError, match="vm must be"):
        PM.regression_metrics(p2, torch.from_numpy(y), torch.from_numpy(vm), 4)
    with pytest.raises(ValueError, match="y must be"):
        PM.regression_metrics(p2, torch.from_numpy(y[:-1]), torch.from_numpy(vm), 5)


def test_regression_evaluator_matches_jax():
    y, preds, _ = _metric_case("random")
    want = JRegEval().evaluate_arrays(y, preds[0, 0])
    got = PRegEval().evaluate_arrays(y, preds[0, 0])
    assert got == want
    assert (PE.Regression.rmse().default_metric, PE.Regression.rmse().is_larger_better) == \
        (JE.Regression.rmse().default_metric, JE.Regression.rmse().is_larger_better)


# ---------------------------------------------------------------------------
# K-H squared and K-E's scale
# ---------------------------------------------------------------------------
def test_boost_step_squared_matches_jax():
    rng = np.random.default_rng(9)
    T, n, P = 4, 300, 7
    F0 = (20.0 + rng.normal(size=(T, n))).astype(np.float32)
    y = (20.0 + 3.0 * rng.normal(size=n)).astype(np.float32)
    w = rng.integers(0, 3, size=(T, n)).astype(np.float32)
    eta = np.full(T, 0.1, np.float32)
    leaf = rng.normal(size=(T, P)).astype(np.float32)
    node = rng.integers(0, P, size=(T, n)).astype(np.int32)
    F = torch.from_numpy(F0.copy())
    ghw = torch.empty((T, n, 2))
    PT.boost_step(F, torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(eta),
                  torch.from_numpy(leaf), torch.from_numpy(node), ghw, loss="squared")
    Fj = jnp.asarray(F0) + eta[:, None] * jnp.take_along_axis(jnp.asarray(leaf),
                                                              jnp.asarray(node), axis=1)
    np.testing.assert_array_equal(F.numpy(), np.asarray(Fj))
    for t in range(T):
        g, h = JT._grad_hess("squared", Fj[t][:, None], jnp.asarray(y), None)
        np.testing.assert_array_equal(ghw[t, :, 0].numpy(), np.asarray(g[:, 0] * w[t]))
        np.testing.assert_array_equal(ghw[t, :, 1].numpy(), np.asarray(h * w[t]))
    with pytest.raises(ValueError, match="loss must be"):
        PT.boost_step(F, torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(eta),
                      ghw=ghw, loss="softmax")


@pytest.mark.parametrize("n,big,bits", [(891, 4.0, 32), (1 << 18, 400.0, 32),
                                        (1 << 12, 1e6, 30), (2, 2.0 ** 30, 31),
                                        (1 << 20, 3e9, 10)])
def test_hist_scale_bits_fit_the_data(n, big, bits):
    assert PT.hist_scale_bits(n, big) == bits
    assert n * big * 2.0 ** bits <= 2.0 ** 62 or bits == PT.HIST_SCALE_BITS


def test_level_hist_takes_large_targets():
    """Targets around 1e6 at 2^12 rows (n x max |w*g| above 2^31): K-E picks
    fewer scale bits instead of raising, and its sums stay within a few
    quanta (2^-30) of the float64 sums, far inside float32's rounding."""
    rng = np.random.default_rng(10)
    n, d, B, m = 1 << 12, 5, 16, 4
    Xb = torch.from_numpy(rng.integers(0, B, size=(n, d)).astype(np.int8))
    y = (1e6 * (1.0 + 0.2 * rng.normal(size=n))).astype(np.float32)
    w = rng.integers(0, 3, size=n).astype(np.float32)
    ghw = torch.from_numpy(np.stack([-y * w, w], 1)[None].astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, m, size=(1, n)).astype(np.int32))
    assert PT.hist_scale_bits(n, float(ghw.abs().max())) < PT.HIST_SCALE_BITS
    got = PT.level_hist(Xb, ghw, ids, m, B).numpy()
    want = np.zeros((1, m, 2, d, B))
    g64 = ghw.numpy().astype(np.float64)
    for r in range(n):
        s = ids[0, r].item()
        if s >= 0:
            for j in range(d):
                want[0, s, :, j, Xb[r, j].item()] += g64[0, r]
    # one float32 rounding of the exact sum (|sum| < 2^34: an ulp is 2^11)
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=1e-3)


def test_level_hist_keeps_2_32_on_binary_gradients():
    """Binary gradients (|w*g| <= max weight) keep the 2^32 scale: the
    binary paths' histograms stay bit-equal to the fixed 2^32 ones."""
    rng = np.random.default_rng(11)
    n, d, B = 5000, 4, 8
    Xb = torch.from_numpy(rng.integers(0, B, size=(n, d)).astype(np.int8))
    ghw = torch.from_numpy(rng.uniform(-3, 3, size=(2, n, 2)).astype(np.float32))
    ids = torch.zeros((2, n), dtype=torch.int32)
    assert PT.hist_scale_bits(n, 3.0) == PT.HIST_SCALE_BITS
    assert torch.equal(PT.level_hist(Xb, ghw, ids, 1, B),
                       PT.level_hist_plain(Xb, ghw, ids, 1, B, scale_bits=32))


# ---------------------------------------------------------------------------
# The forest and GBT groups, the spec and the sweep
# ---------------------------------------------------------------------------
def _stock_plans(n=300, d=8, seed=12):
    X, y = _data(n, d, seed=seed)
    tw, vm = _folds(n, 3, seed + 1)
    jp = JSF.build_sweep_plan(JRS._default_models(), X, y, tw, JE.Regression.rmse())
    pp = PSF.build_sweep_plan(PRS._default_models(), torch.from_numpy(X), y, tw,
                              PE.Regression.rmse())
    return X, y, tw, vm, jp, pp


def test_stock_regression_spec_equals_jax():
    X, y, tw, _, jp, pp = _stock_plans()
    assert pp.spec == jp.spec and pp.spec[0] == "regression"
    assert [f[0] for f in pp.spec[1]] == ["fista", "forest", "gbt"]
    assert pp.spec[1][2][1] == "squared" and all(g[10] for g in pp.spec[1][2][3])
    np.testing.assert_array_equal(pp.blob, jp.blob)
    assert pp.xb_bins == jp.xb_bins == (32,)
    np.testing.assert_array_equal(pp.xbs[0].numpy(), np.asarray(jp.xbs[0]))
    assert pp.metric_names == PM.REGRESSION_METRICS
    # a binary evaluator over a real label, or a classifier in a regression
    # candidate list, builds no plan
    Xt = torch.from_numpy(X)
    assert PSF.build_sweep_plan(PRS._default_models(), Xt, y, tw,
                                PE.BinaryClassification.auPR()) is None
    from transmogrifai_tpu_torch.impl.classification.trees import OpRandomForestClassifier
    assert PSF.build_sweep_plan([(OpRandomForestClassifier(), [{}])], Xt, y, tw,
                                PE.Regression.rmse()) is None


@pytest.mark.parametrize("gi", [0, 1])
def test_forest_group_scores_match_jax(gi):
    X, y, tw, _, jp, pp = _stock_plans()
    group = pp.spec[1][1][2][gi]
    small = (group[0][:2], *group[1:2], 10, *group[3:])  # 10 trees of the group
    want = np.asarray(JSW._forest_group_scores(small, jp.xbs, jp.y, jnp.asarray(tw),
                                               jnp.asarray(jp.blob), 1))[..., 0]
    got = PSW._forest_group_scores(small, pp.xbs, pp.y, torch.from_numpy(tw), pp.blob, 1).numpy()
    assert got.shape == want.shape == (3, 2, 300)
    _assert_trees_close(got, want, np.abs(y).max())


@pytest.mark.parametrize("gi", [0, 2])
def test_gbt_group_scores_match_jax(gi):
    """A squared GBT group from the fold label means (5 rounds)."""
    X, y, tw, _, jp, pp = _stock_plans()
    group = pp.spec[1][2][3][gi]
    small = (group[0][:2], 5, *group[2:])
    assert small[10]  # fold_base
    want = np.asarray(JSW._gbt_group_scores(small, jp.xbs, jp.y, jnp.asarray(tw),
                                            jnp.asarray(jp.blob), "squared", 1))[..., 0]
    got = PSW._gbt_group_scores(small, pp.xbs, pp.y, torch.from_numpy(tw), pp.blob,
                                "squared", 1).numpy()
    assert got.shape == want.shape == (3, 2, 300)
    _assert_trees_close(got, want, np.abs(y).max())


def test_run_sweep_regression_matches_jax():
    """LinReg (as stocked) and the RF and GBT groups cut to 5 trees and 3
    rounds through both interpreters: the metrics within the trees' gap."""
    X, y = _data(300, 8, seed=14)
    tw, vm = _folds(300, 2, 15)
    space = lambda lin, rf, gbt: [  # noqa: E731
        (lin(max_iter=50), [{"reg_param": r, "elastic_net_param": a}
                            for r in (0.001, 0.2) for a in (0.1, 0.5)]),
        (rf(), [{"max_depth": dd, "min_instances_per_node": m, "num_trees": 5}
                for dd in (3, 6) for m in (10, 100)]),
        (gbt(), [{"max_depth": dd, "max_iter": 3, "min_info_gain": g}
                 for dd in (3, 6) for g in (0.001, 0.1)])]
    jp = JSF.build_sweep_plan(space(JLinR, JRFR, JGBTR), X, y, tw, JE.Regression.rmse())
    pp = PSF.build_sweep_plan(space(PLinR, PRFR, PGBTR), torch.from_numpy(X), y, tw,
                              PE.Regression.rmse())
    assert pp.spec == jp.spec
    want = np.asarray(jp.run(tw, vm))
    timings = {}
    got = pp.run(tw, vm, timings=timings)
    assert got.shape == want.shape == (2, 12, 4)
    assert set(timings) == {"fista", "forest", "gbt", "metrics"}
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=2e-5)
    # the trees' R2 is near 0 for the weak candidates: absolute there
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# The estimators and the per-family sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["rf", "gbt", "xgb"])
def test_tree_regressors_fit_and_predict_like_jax(family):
    X, y = _data(300, 6, seed=16)
    w = np.random.default_rng(17).integers(1, 3, 300).astype(np.float32)
    cls = {"rf": (JRFR, PRFR, dict(num_trees=6, max_depth=4)),
           "gbt": (JGBTR, PGBTR, dict(max_iter=4, max_depth=4)),
           "xgb": (JXGBR, PXGBR, dict(num_round=4, max_depth=3))}
    jcls, pcls, kw = cls[family]
    jp = jcls(**kw).fit_arrays(X, y, w)
    pp = pcls(**kw).to("cpu").fit_arrays(torch.from_numpy(X), y, w)
    assert sorted(pp) == sorted(jp)
    for k in ("split_feat", "split_bin", "left", "right"):
        np.testing.assert_array_equal(pp[k], jp[k], err_msg=k)
    np.testing.assert_allclose(pp["leaf_val"], jp["leaf_val"], rtol=0,
                               atol=TREE_RTOL * np.abs(y).max())
    if family != "rf":
        assert pp["base_score"] == jp["base_score"]
    jpred, ppred = jcls.predict_arrays(jp, X)[0], pcls.predict_arrays(pp, torch.from_numpy(X))[0]
    assert ppred.dtype == jpred.dtype == np.float64
    np.testing.assert_allclose(ppred, jpred, rtol=0, atol=TREE_RTOL * np.abs(y).max())


@pytest.mark.parametrize("family", ["linreg", "rf", "gbt"])
def test_per_family_regression_sweep_matches_jax(family, monkeypatch):
    """The port's per-family sweep (``fit_grid_folds``) against the JAX
    package's (``_sweep`` with ``TMOG_FUSED_SWEEP=0``) on the same matrix
    and folds: fold RMSE within 2e-5 relative."""
    X, y = _data(400, 6, seed=18)
    grids = {"linreg": (JLinR, PLinR, [{"reg_param": 0.01, "elastic_net_param": a}
                                       for a in (0.1, 0.5)]),
             "rf": (JRFR, PRFR, [{"num_trees": 4, "max_depth": dd, "min_instances_per_node": 10}
                                 for dd in (3, 5)]),
             "gbt": (JGBTR, PGBTR, [{"max_iter": 3, "max_depth": dd} for dd in (3, 5)])}
    jcls, pcls, grid = grids[family]
    jv, pv = JCV(JE.Regression.rmse(), seed=42), PCV(PE.Regression.rmse(), seed=42)
    train_w, val_mask = pv.make_folds(400, None)
    js = JVS("cv", "rmse", "RootMeanSquaredError", False)
    ps = PVS("cv", "rmse", "RootMeanSquaredError", False)
    monkeypatch.setenv("TMOG_FUSED_SWEEP", "0")
    jv._sweep([(jcls(), grid)], X, y, train_w, val_mask, js)
    pv._family_sweep([(pcls().to("cpu"), grid)], torch.from_numpy(X), y, train_w, val_mask, ps)
    assert len(ps.results) == len(js.results) == len(grid)
    for a, b in zip(ps.results, js.results):
        assert a.grid == b.grid and a.error is None
        np.testing.assert_allclose(a.fold_metrics, b.fold_metrics, rtol=2e-5)


def test_regression_selector_defaults_match_jax():
    jm, pm = JRS._default_models(), PRS._default_models()
    assert [type(e).__name__ for e, _ in pm] == [type(e).__name__ for e, _ in jm]
    assert [g for _, g in pm] == [g for _, g in jm]
    assert [e._params for e, _ in pm] == [e._params for e, _ in jm]
    assert type(PRS._default_splitter()).__name__ == type(JRS._default_splitter()).__name__
    assert PRS._default_splitter().reserve_test_fraction == 0.1
    assert PRS.problem_type == JRS.problem_type == "Regression"
    assert PRFR()._subset_frac(16) == JRFR()._subset_frac(16) == 1.0 / 3.0
    assert math.isclose(PRFR(feature_subset_strategy="sqrt")._subset_frac(16), 0.25)
