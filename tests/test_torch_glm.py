"""The GLM (IRLS on K-S's GLM mode) on the port against the JAX package's, on the CPU.

``transmogrifai_tpu_torch/ops/linear.py`` ports ``fit_glm_irls``,
``fit_glm_grid_folds``, ``predict_glm`` and ``predict_glm_grid``: each IRLS
step forms the rows' IRLS weights and working responses, the weighted Gram
and moments (``weighted_gram`` in GLM mode; its plain version on the CPU,
float64 sums rounded once) and solves the system in float64, where the
reference solves it in float32.  Every case below runs both packages on the
same numpy inputs (n = 300, d = 5, well-conditioned, three folds, three
regularizations) for each family and link the reference supports on such
data.  Tolerances:

- coefficients: ``COEF_RTOL`` relative to the largest one (the float32
  reference solve against the float64 one; 8e-7 measured);
- mean responses: ``MU_RTOL`` relative to the largest one;
- one IRLS step from the reference's start (``max_iter=1``), assembled from
  ``weighted_gram_plain`` in GLM mode: ``COEF_RTOL``.

``impl/regression/glm.py``'s ``OpGeneralizedLinearRegression`` keeps the
reference's two quirks (the link bound at construction to the default
family's; ``variance_power`` 0.0 by default, so a tweedie candidate without
one has a Gaussian variance) and its errors for an unknown family or link.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.impl.regression.glm import OpGeneralizedLinearRegression as JGLM
from transmogrifai_tpu.ops import linear as JL

from transmogrifai_tpu_torch.impl.regression.glm import OpGeneralizedLinearRegression as PGLM
from transmogrifai_tpu_torch.ops import linear as PL

torch.set_num_threads(1)

#: coefficients of the port's float64 solves against the reference's float32
#: ones, relative to the largest coefficient
COEF_RTOL = 1e-5
#: mean responses, relative to the largest one
MU_RTOL = 1e-5

N, D, FOLDS = 300, 5, 3
REGS = np.array([0.001, 0.01, 0.1], np.float32)
#: (family, link, variance power): every pair the reference fits on such data
CASES = [("gaussian", "identity", 0.0), ("gaussian", "log", 0.0), ("binomial", "logit", 0.0),
         ("poisson", "log", 0.0), ("poisson", "sqrt", 0.0), ("gamma", "inverse", 0.0),
         ("gamma", "log", 0.0), ("tweedie", "log", 1.2), ("tweedie", "log", 1.5)]
IDS = [f"{f}-{lk}-{vp}" for f, lk, vp in CASES]


def _data(family, link, seed=0):
    """(X f32[N, D], y f32[N] of the family's support, fold weights f32[3, N])."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    eta = X @ (rng.normal(size=D) * 0.3) + 1.0
    y = {("gaussian", "identity"): lambda: eta + rng.normal(size=N) * 0.3,
         ("gaussian", "log"): lambda: np.exp(eta * 0.5) + rng.normal(size=N) * 0.1,
         ("binomial", "logit"): lambda: rng.random(N) < 1.0 / (1.0 + np.exp(-eta)),
         ("poisson", "log"): lambda: rng.poisson(np.exp(eta * 0.5)),
         ("poisson", "sqrt"): lambda: rng.poisson((eta * 0.3 + 2.0) ** 2),
         ("gamma", "inverse"): lambda: rng.gamma(2.0, 1.0 / (2.0 * (0.5 + 0.1 * np.abs(eta)))),
         ("gamma", "log"): lambda: rng.gamma(2.0, np.exp(eta * 0.3) / 2.0),
         ("tweedie", "log"): lambda: rng.gamma(1.5, np.exp(eta * 0.3) / 1.5)}[(family, link)]()
    tw = (rng.random((FOLDS, N)) < 0.67).astype(np.float32)
    return X, np.asarray(y, np.float32), tw


def _beta(coef, intercept):
    return np.concatenate([np.asarray(coef), np.asarray(intercept)], -1).astype(np.float64)


def _close(got, want, rtol, what):
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    assert np.isfinite(got).all() and gap <= rtol, f"{what}: {gap} relative, above {rtol}"


@pytest.mark.parametrize("family,link,vp", CASES, ids=IDS)
def test_fit_glm_grid_folds_matches_jax(family, link, vp):
    X, y, tw = _data(family, link)
    vps = np.full(len(REGS), vp, np.float32)
    jf = JL.fit_glm_grid_folds(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw),
                               jnp.asarray(REGS), jnp.asarray(vps), family=family, link=link)
    pf = PL.fit_glm_grid_folds(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(tw),
                               REGS, vps, family, link)
    assert tuple(pf.coef.shape) == (FOLDS, len(REGS), D)
    assert tuple(pf.intercept.shape) == (FOLDS, len(REGS), 1)
    _close(_beta(pf.coef, pf.intercept), _beta(jf.coef, jf.intercept), COEF_RTOL, "coef")
    jm = np.asarray(JL.predict_glm_grid(jnp.asarray(X), jf.coef, jf.intercept, link=link))
    pm = PL.predict_glm_grid(torch.from_numpy(X), pf.coef, pf.intercept, link).numpy()
    _close(pm, jm, MU_RTOL, "mu")


@pytest.mark.parametrize("family,link,vp", CASES, ids=IDS)
def test_fit_glm_irls_and_predict_glm_match_jax(family, link, vp):
    X, y, _ = _data(family, link, seed=1)
    sw = np.random.default_rng(2).uniform(0.5, 2.0, N).astype(np.float32)
    jf = JL.fit_glm_irls(jnp.asarray(X), jnp.asarray(y), jnp.asarray(sw), 0.01, family=family,
                         link=link, variance_power=vp)
    pf = PL.fit_glm_irls(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(sw), 0.01,
                         family, link, variance_power=vp)
    assert tuple(pf.coef.shape) == (D,) and tuple(pf.intercept.shape) == (1,)
    _close(_beta(pf.coef, pf.intercept), _beta(jf.coef, jf.intercept), COEF_RTOL, "coef")
    jm = np.asarray(JL.predict_glm(jnp.asarray(X), jf.coef, jf.intercept, link=link))
    pm = PL.predict_glm(torch.from_numpy(X), pf.coef, pf.intercept, link).numpy()
    _close(pm, jm, MU_RTOL, "mu")


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_fit_without_intercept_and_fewer_steps_match_jax(fit_intercept):
    X, y, tw = _data("poisson", "log", seed=3)
    jf = JL.fit_glm_grid_folds(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw),
                               jnp.asarray(REGS), jnp.zeros(3), family="poisson", link="log",
                               max_iter=4, fit_intercept=fit_intercept)
    pf = PL.fit_glm_grid_folds(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(tw),
                               REGS, np.zeros(3, np.float32), "poisson", "log", max_iter=4,
                               fit_intercept=fit_intercept)
    np.testing.assert_array_equal(pf.intercept.numpy() == 0.0, not fit_intercept)
    _close(_beta(pf.coef, pf.intercept), _beta(jf.coef, jf.intercept), COEF_RTOL, "coef")


@pytest.mark.parametrize("family,link,vp", CASES, ids=IDS)
def test_weighted_gram_plain_glm_mode_is_one_jax_irls_step(family, link, vp):
    """One IRLS step from the reference's start (the weighted mean response
    through the link, as the intercept), with the Gram and moments from
    ``weighted_gram_plain`` in GLM mode, against ``fit_glm_irls(max_iter=1)``."""
    X, y, tw = _data(family, link, seed=4)
    w = tw[0]
    reg = 0.01
    jf = JL.fit_glm_irls(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), reg, family=family,
                         link=link, max_iter=1, variance_power=vp)
    X1 = torch.from_numpy(np.concatenate([X, np.ones((N, 1), np.float32)], 1))
    wt, yt = torch.from_numpy(w), torch.from_numpy(y)
    mu0 = torch.clamp_min((yt * wt).sum() / torch.clamp_min(wt.sum(), 1e-12), 1e-6)
    if family == "binomial":
        mu0 = torch.clamp(mu0, 1e-6, 1.0 - 1e-6)
    beta0 = torch.zeros((1, D + 1))
    beta0[0, -1] = PL._GLM_LINKS[link][0](mu0)
    H, g = PL.weighted_gram_plain(X1, yt, wt[None], torch.zeros(1, dtype=torch.int32), beta0,
                                  (family, link, torch.tensor([vp], dtype=torch.float32)))
    assert tuple(H.shape) == (1, D + 1, D + 1) and torch.equal(H, H.transpose(1, 2))
    ws = float(wt.sum())
    A = H[0].double() / ws + torch.diag(torch.tensor([reg] * D + [0.0], dtype=torch.float64)) \
        + 1e-8 * torch.eye(D + 1, dtype=torch.float64)
    beta1 = torch.linalg.solve(A, g[0].double() / ws).numpy()
    _close(beta1, _beta(jf.coef, jf.intercept), COEF_RTOL, "one step")


def test_weighted_gram_checks_its_glm_arguments():
    X1 = torch.ones((4, 3))
    args = (X1, torch.ones(4), torch.ones((1, 4)), torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="unknown GLM family"):
        PL.weighted_gram(*args, ("normal", "identity", torch.zeros(1)))
    with pytest.raises(ValueError, match="vp must be"):
        PL.weighted_gram(*args, ("gaussian", "identity", torch.zeros(2)))
    with pytest.raises(ValueError, match="needs beta"):
        PL.weighted_gram(*args[:4], None, ("gaussian", "identity", torch.zeros(1)))


def test_the_link_is_bound_at_construction():
    for GLM in (JGLM, PGLM):
        est = GLM().copy_with_params({"family": "poisson"})
        assert est.get_param("family") == "poisson" and est.get_param("link") == "identity"
        assert GLM(family="poisson").get_param("link") == "log"
        assert GLM(family="gamma").get_param("link") == "inverse"
        assert GLM().get_param("variance_power") == 0.0


def test_a_tweedie_candidate_without_a_variance_power_is_gaussian():
    """``variance_power`` defaults to 0.0, so the grid fit's fallback of 1.5
    is never read: a tweedie candidate without one fits a Gaussian variance
    (``max(mu, 1e-10) ** 0`` is 1), in both packages."""
    X, y, tw = _data("tweedie", "log", seed=5)
    grids = [{"family": "tweedie", "link": "log", "reg_param": 0.01},
             {"family": "tweedie", "link": "log", "reg_param": 0.01, "variance_power": 0.0},
             {"family": "gaussian", "link": "log", "reg_param": 0.01},
             {"family": "tweedie", "link": "log", "reg_param": 0.01, "variance_power": 1.5}]
    jo = JGLM().fit_grid_folds(X, y, tw, grids)
    po = PGLM().to("cpu").fit_grid_folds(torch.from_numpy(X), y, tw, grids)
    for f in range(FOLDS):
        np.testing.assert_array_equal(jo[f][0][0], jo[f][1][0])
        np.testing.assert_array_equal(po[f][0][0], po[f][1][0])
        assert not np.array_equal(po[f][0][0], po[f][3][0])
        for c in range(len(grids)):
            assert po[f][c][1] is None and po[f][c][2] is None
            _close(po[f][c][0], jo[f][c][0], MU_RTOL, f"fold {f} candidate {c}")
    np.testing.assert_allclose(po[0][0][0], po[0][2][0], rtol=1e-5)


@pytest.mark.parametrize("kw,message", [
    ({"family": "normal"}, "Unsupported GLM family 'normal'"),
    ({"family": "gaussian", "link": "probit"}, "Unsupported link 'probit'")])
def test_unknown_family_and_link_raise_as_in_jax(kw, message):
    errors = []
    for GLM in (JGLM, PGLM):
        with pytest.raises(ValueError, match=message) as e:
            GLM(**kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(NotImplementedError, match="non-batchable GLM grid key tol"):
        PGLM().fit_grid_folds(np.zeros((3, 2), np.float32), np.zeros(3), np.ones((1, 3)),
                              [{"tol": 1e-3}])


def test_estimator_fit_and_predict_match_jax():
    X, y, _ = _data("gamma", "log", seed=6)
    sw = np.random.default_rng(7).uniform(0.5, 2.0, N).astype(np.float32)
    kw = {"family": "gamma", "link": "log", "reg_param": 0.01, "max_iter": 10}
    jp = JGLM(**kw).fit_arrays(X, y, sw)
    pp = PGLM(**kw).to("cpu").fit_arrays(torch.from_numpy(X), y, sw)
    assert pp["link"] == jp["link"] == "log"
    _close(_beta(pp["coef"], pp["intercept"]), _beta(jp["coef"], jp["intercept"]), COEF_RTOL,
           "coef")
    jm = JGLM.predict_arrays(jp, X)
    pm = PGLM.predict_arrays(pp, torch.from_numpy(X))
    assert pm[1] is None and pm[2] is None and pm[0].dtype == np.float64
    _close(pm[0], np.asarray(jm[0]), MU_RTOL, "mu")
    # the JAX package's parameters score alike through the port
    _close(PGLM.predict_arrays(jp, torch.from_numpy(X))[0], np.asarray(jm[0]), 1e-6, "jax params")


def test_per_family_sweep_over_groups_matches_jax():
    """A grid of three (family, link) groups through each package's
    cross-validation (GLM has no fused fragment: the per-family path),
    the same fold RMSE and winner."""
    from transmogrifai_tpu.evaluators.regression import OpRegressionEvaluator as JEv
    from transmogrifai_tpu.impl.tuning.validators import OpCrossValidation as JCV

    from transmogrifai_tpu_torch.evaluators.regression import OpRegressionEvaluator as PEv
    from transmogrifai_tpu_torch.impl.tuning.validators import OpCrossValidation as PCV

    X, y, _ = _data("poisson", "log", seed=8)
    grid = [{"family": f, "link": lk, "reg_param": r, "variance_power": vp}
            for f, lk, vp in (("gaussian", "identity", 0.0), ("poisson", "log", 0.0),
                              ("tweedie", "log", 1.5)) for r in (0.001, 0.1)]
    js = JCV(JEv(), num_folds=3, seed=1).validate([(JGLM(), grid)], X, y)
    ps = PCV(PEv(), num_folds=3, seed=1).validate([(PGLM().to("cpu"), grid)],
                                                  torch.from_numpy(X), y)
    assert len(ps.results) == len(grid)
    for a, b in zip(js.results, ps.results):
        assert a.grid == b.grid and a.error is None and b.error is None
        np.testing.assert_allclose(b.fold_metrics, a.fold_metrics, rtol=MU_RTOL)
    assert js.best_index == ps.best_index
