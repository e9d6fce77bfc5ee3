"""The Newton logistic and ridge fits (K-S and its solvers) on the port
against the JAX package's, on the CPU.

- ``weighted_gram_plain`` (K-S's plain version) in both modes against a
  float64 numpy Gram: within float32 rounding (both sum in float64 and
  round once).
- ``fit_logistic_newton`` / ``fit_logistic_grid_folds_newton`` and
  ``fit_ridge`` / ``fit_ridge_grid_folds`` against the JAX package's, at
  reg 0 and reg > 0, with and without the intercept: coefficients within
  ``COEF_TOL`` where reg > 0 or the Gram is regular; the scores (margins,
  predictions) within ``SCORE_TOL`` wherever the reference's are finite.
  On a one-hot pivot beside the intercept the Gram is singular but for the
  1e-8 (Newton) or 1e-9 (ridge) ridge: there the coefficients along the
  null direction are the two packages' rounding noise and are compared
  only from reg 0.01 on, the scores of rows that respect the pivot always;
  at reg 0 the reference's Newton and ridge fits break down (NaN) on a
  fold where the port's stay finite, a stated gap.
- the binary sweep's "newton" fragment: ``_lr_fragments`` over a grid of
  mixed l1 = 0 and l1 > 0 points has the JAX package's spec and blob, and
  its scores through ``run_sweep`` match.
- the default constructors: ``OpLogisticRegression().fit_arrays`` and
  ``OpLinearRegression().fit_arrays`` train now, as the JAX package's do.
- K-L's metrics of NaN scores (a Newton fit that breaks down scores NaN):
  the reference sorts NaN last and ranks all NaN scores as one tie group,
  with no AuPR step of their own; the port's equal its metrics.
- on the CPU K-S's wrapper takes the plain path; the Titanic and Boston
  entry points without ``device`` raise and name ``device="cpu"``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.evaluators import Evaluators as JE
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
from transmogrifai_tpu.impl.regression.linear import OpLinearRegression as JLinR
from transmogrifai_tpu.ops import linear as JL
from transmogrifai_tpu.ops.metrics import _binary_grid_metrics

from transmogrifai_tpu_torch.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.impl.regression.linear import OpLinearRegression as PLinR
from transmogrifai_tpu_torch.ops import linear as PL
from transmogrifai_tpu_torch.ops import metrics as PM

torch.set_num_threads(1)

#: coefficients of regular fits: float32 Gram sums in another order,
#: through 12-25 Newton steps or one solve
COEF_TOL = 2e-5
#: margins and predictions, relative to their scale
SCORE_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _data(n=400, d=5, seed=0, pivot=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    if pivot:  # two one-hot columns that sum to the intercept's
        cat = rng.integers(0, 2, n)
        X[:, -2], X[:, -1] = cat == 0, cat == 1
    z = X @ rng.standard_normal(d) * 0.8
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    yr = (z * 3 + 10 + rng.standard_normal(n)).astype(np.float32)
    tw = (rng.random((3, n)) < 0.67).astype(np.float32)
    return X, y, yr, tw


@pytest.mark.parametrize("newton", [True, False])
def test_weighted_gram_plain_matches_a_float64_gram(newton):
    rng = np.random.default_rng(3)
    n, p, F = 3000, 7, 2
    X1 = np.concatenate([rng.standard_normal((n, p - 1)), np.ones((n, 1))], 1).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.integers(0, 3, (F, n)).astype(np.float32)
    fold = np.array([0, 1, 1], np.int32)
    beta = (rng.standard_normal((3, p)) * 0.5).astype(np.float32) if newton else None
    H, g = PL.weighted_gram(_t(X1), _t(y), _t(w), _t(fold), None if beta is None else _t(beta))
    X64 = X1.astype(np.float64)
    for c, f in enumerate(fold):
        if newton:
            mu = 1 / (1 + np.exp(-(X64 @ beta[c].astype(np.float64))))
            v = np.maximum(mu * (1 - mu), 1e-6) * w[f]
            u = w[f] * (mu - y)
        else:
            v, u = w[f].astype(np.float64), (w[f] * y).astype(np.float64)
        np.testing.assert_allclose(H[c].numpy(), (X64.T * v) @ X64, rtol=2e-6, atol=1e-3)
        np.testing.assert_allclose(g[c].numpy(), X64.T @ u, rtol=2e-6, atol=1e-3)
        assert torch.equal(H[c], H[c].T)
    with pytest.raises(ValueError, match="at most 64 coefficients"):
        PL.weighted_gram(torch.zeros((4, 65)), torch.zeros(4), torch.zeros((1, 4)),
                         torch.zeros(1, dtype=torch.int32))


def test_weighted_gram_takes_the_plain_path_on_the_cpu():
    X1, y = torch.ones((10, 3)), torch.zeros(10)
    w, fold = torch.ones((1, 10)), torch.zeros(1, dtype=torch.int32)
    before = PL.weighted_gram.launches
    H, g = PL.weighted_gram(X1, y, w, fold)
    assert PL.weighted_gram.launches == before
    assert torch.equal(H, torch.full((1, 3, 3), 10.0)) and torch.equal(g, torch.zeros((1, 3)))


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("pivot", [False, True])
def test_newton_grid_folds_match_jax(fit_intercept, pivot):
    X, y, _, tw = _data(pivot=pivot)
    l2s = np.array([0.0, 0.01, 0.2], np.float32)
    j = JL.fit_logistic_grid_folds_newton(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw),
                                          jnp.asarray(l2s), max_iter=12,
                                          fit_intercept=fit_intercept)
    p = PL.fit_logistic_grid_folds_newton(_t(X), _t(y), _t(tw), l2s, max_iter=12,
                                          fit_intercept=fit_intercept)
    jc, ji = np.asarray(j.coef), np.asarray(j.intercept)
    assert p.coef.shape == jc.shape and p.intercept.shape == ji.shape
    singular = pivot and fit_intercept
    for g in range(3):
        if not singular or l2s[g] >= 0.01:
            np.testing.assert_allclose(p.coef[:, g].numpy(), jc[:, g], rtol=COEF_TOL,
                                       atol=COEF_TOL)
            np.testing.assert_allclose(p.intercept[:, g].numpy(), ji[:, g], rtol=COEF_TOL,
                                       atol=COEF_TOL)
    zj = np.einsum("nd,fgd->fgn", X, jc) + ji
    zp = np.einsum("nd,fgd->fgn", X, p.coef.numpy()) + p.intercept.numpy()
    finite = np.isfinite(zj).all(-1)
    # the reference breaks down only at reg 0 on the singular Gram (one fold
    # of three here), where its rounding tips the null direction; the
    # port's float64 Gram stays finite there: the stated gap
    assert finite.all() or (singular and finite[:, 1:].all())
    assert np.isfinite(zp).all()
    np.testing.assert_allclose(zp[finite], zj[finite], rtol=0,
                               atol=SCORE_TOL * np.abs(zj[finite]).max())


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("pivot", [False, True])
def test_ridge_grid_folds_match_jax(fit_intercept, pivot):
    X, _, yr, tw = _data(seed=1, pivot=pivot)
    l2s = np.array([0.0, 0.001, 0.2], np.float32)
    j = JL.fit_ridge_grid_folds(jnp.asarray(X), jnp.asarray(yr), jnp.asarray(tw),
                                jnp.asarray(l2s), fit_intercept=fit_intercept)
    p = PL.fit_ridge_grid_folds(_t(X), _t(yr), _t(tw), l2s, fit_intercept=fit_intercept)
    jc, ji = np.asarray(j.coef), np.asarray(j.intercept)
    singular = pivot and fit_intercept
    for g in range(3):
        if not singular or l2s[g] >= 0.01:
            np.testing.assert_allclose(p.coef[:, g].numpy(), jc[:, g], rtol=COEF_TOL,
                                       atol=COEF_TOL)
    zj = np.einsum("nd,fgd->fgn", X, jc) + ji
    zp = np.einsum("nd,fgd->fgn", X, p.coef.numpy()) + p.intercept.numpy()
    # as the Newton fits: the reference's reg-0 solve of the singular Gram
    # may give NaN, where the port's stays finite (the stated gap)
    finite = np.isfinite(zj).all(-1)
    assert finite.all() or (singular and finite[:, 1:].all())
    assert np.isfinite(zp).all()
    np.testing.assert_allclose(zp[finite], zj[finite], rtol=0,
                               atol=SCORE_TOL * np.abs(zj[finite]).max())


def test_single_newton_and_ridge_fits_match_jax():
    X, y, yr, tw = _data(seed=2)
    for l2 in (0.0, 0.1):
        j = JL.fit_logistic_newton(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw[0]), l2,
                                   max_iter=25)
        p = PL.fit_logistic_newton(_t(X), _t(y), _t(tw[0]), l2, max_iter=25)
        np.testing.assert_allclose(p.coef.numpy(), np.asarray(j.coef), rtol=COEF_TOL,
                                   atol=COEF_TOL)
        assert p.intercept.shape == (1,)
        j = JL.fit_ridge(jnp.asarray(X), jnp.asarray(yr), jnp.asarray(tw[0]), l2)
        p = PL.fit_ridge(_t(X), _t(yr), _t(tw[0]), l2)
        np.testing.assert_allclose(p.coef.numpy(), np.asarray(j.coef), rtol=COEF_TOL,
                                   atol=COEF_TOL)
        np.testing.assert_allclose(p.intercept.numpy(), np.asarray(j.intercept), rtol=COEF_TOL)


def test_default_constructors_fit_as_the_jax_packages_do():
    X, y, yr, tw = _data(seed=4)
    jp = JLR().fit_arrays(X, y)
    pp = PLR().to("cpu").fit_arrays(_t(X), y)
    np.testing.assert_allclose(pp["coef"], np.asarray(jp["coef"]), rtol=COEF_TOL, atol=COEF_TOL)
    assert not pp["multinomial"] and pp["num_classes"] == 2
    jp = JLinR().fit_arrays(X, yr, tw[0])
    pp = PLinR().to("cpu").fit_arrays(_t(X), yr, tw[0])
    np.testing.assert_allclose(pp["coef"], np.asarray(jp["coef"]), rtol=COEF_TOL, atol=COEF_TOL)
    np.testing.assert_allclose(pp["intercept"], np.asarray(jp["intercept"]), rtol=COEF_TOL)
    # the fold x grid batches of both, with mixed l1 = 0 / l1 > 0 points
    grids = [{}, {"reg_param": 0.1, "elastic_net_param": 0.5}, {"reg_param": 0.05}]
    jg = JLR().fit_grid_folds(X, y, tw, grids)
    pg = PLR().to("cpu").fit_grid_folds(_t(X), y, tw, grids)
    for f in range(3):
        for c in range(3):
            np.testing.assert_allclose(pg[f][c][2], jg[f][c][2], rtol=0, atol=1e-5)
    jg = JLinR().fit_grid_folds(X, yr, tw, grids)
    pg = PLinR().to("cpu").fit_grid_folds(_t(X), yr, tw, grids)
    for f in range(3):
        for c in range(3):
            np.testing.assert_allclose(pg[f][c][0], jg[f][c][0], rtol=1e-5, atol=1e-4)


def test_newton_fragment_spec_and_scores_equal_the_jax_packages():
    X, y, _, tw = _data(n=300, seed=5)
    vm = 1.0 - tw
    grids = [{"reg_param": r, "elastic_net_param": a} for r in (0.0, 0.01, 0.2)
             for a in (0.0, 0.1)]
    jplan = JSF.build_sweep_plan([(JLR(max_iter=50), grids)], X, y, tw,
                                 JE.BinaryClassification.auPR())
    pplan = PSF.build_sweep_plan([(PLR(max_iter=50), grids)], _t(X), y, tw,
                                 PE.BinaryClassification.auPR())
    assert pplan.spec == jplan.spec
    assert [f[0] for f in pplan.spec[1]] == ["newton", "fista"]
    assert pplan.spec[1][0][1:4] == ((0, 1, 2, 4), 12, True)
    np.testing.assert_array_equal(pplan.blob, np.asarray(jplan.blob))
    want = np.asarray(jplan.run(tw, vm))
    got = pplan.run(tw, vm)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["all_nan", "some_nan", "nan_and_inf"])
def test_binary_metrics_of_nan_scores_equal_the_references(case):
    rng = np.random.default_rng(7)
    n, F, C = 120, 2, 3
    y = (rng.random(n) < 0.4).astype(np.float32)
    vm = (rng.random((F, n)) < 0.5).astype(np.float32)
    s = rng.random((F, C, n)).astype(np.float32)
    if case == "all_nan":
        s[:, 0] = np.nan
    elif case == "some_nan":
        s[:, :, ::3] = np.nan
        s[:, 1, ::2] = np.float32(0.5)
    else:
        s[:, :, ::4] = np.nan
        s[:, :, 1::5] = np.inf
        s[:, 2, 2::5] = -np.inf
    strict = np.array([0, 1, 0], np.float32)
    want = np.asarray(_binary_grid_metrics(jnp.asarray(y), jnp.asarray(s), jnp.asarray(vm),
                                           jnp.asarray(strict)))
    got = PM.binary_grid_metrics(_t(y), _t(s), _t(vm), strict).numpy()
    # AuROC and the thresholded metrics bit for bit; AuPR within the 1-2
    # ulps of K-L's exact sum against the reference's float32 one
    np.testing.assert_array_equal(got[..., [0, 2, 3, 4, 5]], want[..., [0, 2, 3, 4, 5]])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0, atol=2.5e-7)
    if case == "all_nan":
        np.testing.assert_array_equal(got[:, 0, :2], [[0.5, 0.0]] * F)


@pytest.mark.parametrize("app", ["titanic", "boston"])
def test_entry_points_raise_without_a_card_unless_cpu_is_asked(app):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is available")
    from transmogrifai_tpu_torch.apps import boston, titanic

    if app == "titanic":
        with pytest.raises(RuntimeError, match='device="cpu"'):
            titanic.train_titanic(titanic.titanic_data(60, 3),
                                  models_and_parameters=[(PLR(), [{}])])
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            boston.train_boston(boston.boston_data(60, 3),
                                models_and_parameters=[(PLinR(), [{}])])
