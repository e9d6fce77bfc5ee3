"""K-S, K-P and K-T past 64 coefficients: the Newton, ridge, GLM, softmax and
SVC fits of the port against the JAX package's at p = 85 (the text flow's
vector and its intercept) and p = 300, on the CPU.

The wrappers take their plain versions here (CPU tensors), which no longer
refuse past 64 coefficients; on the card the same calls launch the kernels'
wide entries (``tests/test_torch_cuda.py`` holds those to the plain
versions).  Tolerances are the narrow tests' (``test_torch_newton_ridge.py``,
``test_torch_glm.py``, ``test_torch_svc.py``, ``test_torch_multiclass.py``),
with the gap measured at these widths beside each.  The ridge and GLM
solves are float64 in the port and float32 in the JAX package; at p = 300
the reference's own float32 solve moves its coefficients by more than those
tolerances (2.0e-4 at a ridge intercept of 4.6, 6e-5 relative for the GLM),
so there the port is held to the JAX package run in float64
(``jax.enable_x64``) within the narrow tolerance, and to the float32 run
within that tolerance plus the float32 run's own distance from the float64
one.

The end-to-end case trains the 891-row text flow (``build_workflow(
text_embeddings=True)``, 84 features) over the default
``OpLogisticRegression()`` Newton grid and ``linear_svc_grid()``: the port
picks the JAX package's winner, its fold AuPR within ``NEWTON_AUPR_TOL`` /
``SVC_AUPR_TOL`` of the JAX sweep's, kept in ``fixtures/titanic_text/wide.npz``
(``python tests/test_torch_wide_linear.py --write`` makes it with the JAX
package).
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.ops import linear as JL

from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.ops import linear as PL

torch.set_num_threads(1)

#: Newton and ridge coefficients, absolute plus relative
#: (``test_torch_newton_ridge.COEF_TOL``; measured at p = 85 / 300: Newton
#: 1.6e-7 / 6.3e-7 absolute, ridge against the float64 reference 1.8e-6 /
#: 2.1e-5 at an intercept of 4.6)
COEF_TOL = 2e-5
#: GLM coefficients relative to the largest (``test_torch_glm.COEF_RTOL``;
#: measured against the float64 reference 4.4e-7 / 4.6e-6)
GLM_COEF_RTOL = 1e-5
#: FISTA-stepped coefficients, softmax and SVC (``test_torch_multiclass`` and
#: ``test_torch_svc``'s ``COEF_ATOL``; measured 1.2e-6 / 3.1e-7 softmax,
#: 1.0e-6 / 2.4e-6 SVC)
FISTA_COEF_ATOL = 2e-5
#: a gradient relative to its largest entry (the narrow tests' ``GRAD_RTOL``)
GRAD_RTOL = 1e-6

WIDTHS = [85, 300]
WIDE = os.path.join(os.path.dirname(FX.__file__), "titanic_text", "wide.npz")


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(p, seed, n=1200, F=3):
    """Features of p - 1 columns (a few dense, the rest sparse 0/1 as one-hot
    and hashed text columns are), 0/1 labels, a positive response and three
    folds' weights."""
    rng = np.random.default_rng(seed)
    d = p - 1
    X = (rng.random((n, d)) < 0.15).astype(np.float32)
    X[:, :6] = rng.normal(size=(n, 6))
    z = X @ (rng.normal(size=d) * 0.3) - 0.4
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    yr = (z + 5.0 + 0.3 * rng.normal(size=n)).astype(np.float32)
    yc = np.clip(np.floor(z + 1.5), 0, 2).astype(np.float32)
    tw = (rng.random((F, n)) < 0.67).astype(np.float32)
    return X, y, yr, yc, tw


def _gap(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def _close(got, want, tol):
    """As the narrow Newton and ridge tests: within ``tol`` absolute plus
    ``tol`` relative."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _x64(fn, *arrays, **kw):
    """``fn`` of the JAX package on float64 copies of ``arrays``, in float64."""
    with jax.enable_x64(True):
        out = fn(*(jnp.asarray(a, jnp.float64) for a in arrays), **kw)
        return [np.asarray(a) for a in out]


def _held(got, j32, j64, tol, scale=None):
    """The port within ``tol`` of the float64 reference, and of the float32
    one within ``tol`` plus that run's own distance from the float64 one
    (``scale`` makes ``tol`` relative to the largest entry, as the GLM's)."""
    got, j32, j64 = (np.asarray(a, np.float64) for a in (got, j32, j64))
    if scale is None:
        bound = tol + tol * np.abs(j64)
    else:
        bound = tol * np.abs(j64).max() * np.ones_like(j64)
    assert (np.abs(got - j64) <= bound).all(), float(np.abs(got - j64).max())
    assert (np.abs(got - j32) <= bound + np.abs(j32 - j64).max()).all()


@pytest.mark.parametrize("p", WIDTHS)
def test_weighted_gram_plain_past_64_matches_a_float64_gram(p):
    X, y, _, _, tw = _data(p, 1, n=700)
    X1 = np.concatenate([X, np.ones((len(X), 1), np.float32)], 1)
    beta = (np.random.default_rng(2).normal(size=(2, p)) * 0.05).astype(np.float32)
    fold = np.array([0, 2], np.int32)
    H, g = PL.weighted_gram(_t(X1), _t(y), _t(tw), _t(fold), _t(beta))
    assert tuple(H.shape) == (2, p, p) and PL.weighted_gram.launches == 0
    X64 = X1.astype(np.float64)
    for c, f in enumerate(fold):
        mu = 1 / (1 + np.exp(-(X64 @ beta[c].astype(np.float64))))
        v = np.maximum(mu * (1 - mu), 1e-6) * tw[f]
        np.testing.assert_allclose(H[c].numpy(), (X64.T * v) @ X64, rtol=2e-6, atol=1e-3)
        np.testing.assert_allclose(g[c].numpy(), X64.T @ (tw[f] * (mu - y)), rtol=2e-6,
                                   atol=1e-3)


@pytest.mark.parametrize("p", WIDTHS)
def test_newton_grid_folds_past_64_match_jax(p):
    X, y, _, _, tw = _data(p, 3)
    l2s = np.array([0.01, 0.1], np.float32)
    j = JL.fit_logistic_grid_folds_newton(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw),
                                          jnp.asarray(l2s), max_iter=12)
    q = PL.fit_logistic_grid_folds_newton(_t(X), _t(y), _t(tw), l2s, max_iter=12)
    _close(q.coef, j.coef, COEF_TOL)
    _close(q.intercept, j.intercept, COEF_TOL)
    one = PL.fit_logistic_newton(_t(X), _t(y), _t(tw[1]), 0.1, max_iter=12)
    _close(one.coef, np.asarray(j.coef)[1, 1], COEF_TOL)


@pytest.mark.parametrize("p", WIDTHS)
def test_ridge_past_64_matches_jax(p):
    X, _, yr, _, tw = _data(p, 4)
    l2s = np.array([0.001, 0.2], np.float32)
    j = JL.fit_ridge_grid_folds(jnp.asarray(X), jnp.asarray(yr), jnp.asarray(tw),
                                jnp.asarray(l2s))
    j64 = _x64(JL.fit_ridge_grid_folds, X, yr, tw, l2s)
    q = PL.fit_ridge_grid_folds(_t(X), _t(yr), _t(tw), l2s)
    _held(q.coef, j.coef, j64[0], COEF_TOL)
    _held(q.intercept, j.intercept, j64[1], COEF_TOL)
    if p == 85:   # the narrow tolerance holds against the float32 run itself
        _close(q.coef, j.coef, COEF_TOL)
        _close(q.intercept, j.intercept, COEF_TOL)
    pf = PL.fit_ridge(_t(X), _t(yr), _t(tw[0]), 0.2)
    _held(pf.coef, np.asarray(j.coef)[0, 1], j64[0][0, 1], COEF_TOL)


@pytest.mark.parametrize("family,link", [("poisson", "log"), ("gaussian", "identity")])
@pytest.mark.parametrize("p", WIDTHS)
def test_glm_past_64_matches_jax(p, family, link):
    X, _, yr, _, tw = _data(p, 5)
    y = np.asarray(np.random.default_rng(6).poisson(np.exp(0.2 * (yr - 5.0))), np.float32) \
        if family == "poisson" else yr
    regs = np.array([0.01, 0.1], np.float32)
    vps = np.zeros(2, np.float32)
    jf = JL.fit_glm_grid_folds(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw), jnp.asarray(regs),
                               jnp.asarray(vps), family=family, link=link)
    j64 = _x64(JL.fit_glm_grid_folds, X, y, tw, regs, vps, family=family, link=link)
    pf = PL.fit_glm_grid_folds(_t(X), _t(y), _t(tw), regs, vps, family, link)
    want = np.concatenate([np.asarray(jf.coef), np.asarray(jf.intercept)], -1)
    got = np.concatenate([pf.coef.numpy(), pf.intercept.numpy()], -1)
    _held(got, want, np.concatenate(j64, -1), GLM_COEF_RTOL, scale=True)
    if p == 85:
        assert _gap(got, want) <= GLM_COEF_RTOL * np.abs(want).max()
    po = PL.fit_glm_irls(_t(X), _t(y), _t(tw[2]), 0.01, family, link)
    _held(po.coef, np.asarray(jf.coef)[2, 0], j64[0][2, 0], GLM_COEF_RTOL, scale=True)


@pytest.mark.parametrize("p", WIDTHS)
def test_softmax_past_64_matches_jax(p):
    X, _, _, yc, tw = _data(p, 7)
    n = len(X)
    X1 = np.concatenate([X, np.ones((n, 1), np.float32)], 1)
    rng = np.random.default_rng(8)
    B = (0.05 * rng.normal(size=(p, 3))).astype(np.float32)
    fold = np.zeros(1, np.int32)
    l2m = np.full((1, p, 3), 0.02, np.float32)
    want = (X1.T.astype(np.float64) @ (tw[0][:, None] * (np.exp(X1 @ B) / np.exp(X1 @ B).sum(
        1, keepdims=True) - np.eye(3)[yc.astype(int)])) / tw[0].sum() + 0.02 * B)
    got = PL.softmax_fista_grad(_t(X1), _t(yc), _t(tw), _t(fold), _t(B[None]), _t(l2m),
                                torch.tensor([float(tw[0].sum())])).numpy()[0]
    assert _gap(got, want) <= GRAD_RTOL * np.abs(want).max()
    l1, l2 = np.array([0.0, 0.001], np.float32), np.array([0.01, 0.05], np.float32)
    jf = JL.fit_softmax_grid_folds(jnp.asarray(X), jnp.asarray(yc), jnp.asarray(tw),
                                   jnp.asarray(l1), jnp.asarray(l2), num_classes=3, max_iter=50)
    pf = PL.fit_softmax_grid_folds(_t(X), _t(yc), _t(tw), l1, l2, num_classes=3, max_iter=50)
    assert _gap(pf.coef, jf.coef) <= FISTA_COEF_ATOL
    assert _gap(pf.intercept, jf.intercept) <= FISTA_COEF_ATOL
    one = PL.fit_softmax(_t(X), _t(yc), _t(tw[0]), 0.01, 3, max_iter=50)
    assert _gap(one.coef, np.asarray(jf.coef)[0, 0]) <= FISTA_COEF_ATOL


@pytest.mark.parametrize("p", WIDTHS)
def test_linear_svc_past_64_matches_jax(p):
    X, y, _, _, tw = _data(p, 9)
    l2s = np.array([0.01, 0.1], np.float32)
    jf = JL.fit_svc_grid_folds(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw), jnp.asarray(l2s),
                               max_iter=200)
    pf = PL.fit_svc_grid_folds(_t(X), _t(y), _t(tw), l2s, max_iter=200)
    assert _gap(pf.coef, jf.coef) <= FISTA_COEF_ATOL
    assert _gap(pf.intercept, jf.intercept) <= FISTA_COEF_ATOL
    one = PL.fit_linear_svc(_t(X), _t(y), _t(tw[1]), 0.1)
    assert _gap(one.coef, np.asarray(jf.coef)[1, 1]) <= FISTA_COEF_ATOL


def test_limits_are_1024_coefficients():
    assert PL.GRAM_MAX_COEFS == PL.SOFTMAX_MAX_COEFS == PL.FISTA_MAX_COEFS == 1024
    p = PL.GRAM_MAX_COEFS + 1
    with pytest.raises(ValueError, match="at most 1024 coefficients"):
        PL.weighted_gram(torch.zeros((4, p)), torch.zeros(4), torch.zeros((1, 4)),
                         torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="1024 coefficients"):
        PL.softmax_fista_grad(torch.zeros((4, p)), torch.zeros(4), torch.zeros((1, 4)),
                              torch.zeros(1, dtype=torch.int32), torch.zeros((1, p, 3)),
                              torch.zeros((1, p, 3)), torch.ones(1))


# ---------------------------------------------------------------------------
# end to end: the text flow's 85-wide vector through Newton (K-S) and SVC (K-T)
# ---------------------------------------------------------------------------
def wide_space(lr, svc):
    """The default ``OpLogisticRegression()`` over its Newton (pure-L2)
    points and ``OpLinearSVC()`` over ``linear_svc_grid()``."""
    if lr.__module__.startswith("transmogrifai_tpu_torch"):
        from transmogrifai_tpu_torch.impl.selector import defaults as D
    else:
        from transmogrifai_tpu.impl.selector import defaults as D
    return [(lr(), D.grid(reg_param=[0.001, 0.01, 0.1, 0.2], elastic_net_param=[0.0])),
            (svc(), D.linear_svc_grid())]


def write_fixture(path=WIDE):
    """The JAX package's 891-row text-flow train over ``wide_space``: each
    candidate's name, grid and fold AuPR, and the winner."""
    import json

    from test_torch_text_slice import frame, jax_workflow

    from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
    from transmogrifai_tpu.impl.classification.svc import OpLinearSVC as JSVC
    from transmogrifai_tpu_torch.apps import titanic as PTitanic

    model = jax_workflow(wide_space(JLR, JSVC)).set_input_dataset(
        frame(PTitanic.text_columns()), key="PassengerId").train()
    summ = model.stages[-1].summary
    res = summ.validation_results
    np.savez_compressed(path, names=np.array([r["modelName"] for r in res]),
                        grids=np.array([json.dumps(r["grid"], sort_keys=True) for r in res]),
                        folds=np.array([r["foldMetrics"] for r in res], np.float64),
                        best=np.int64([(r["modelName"], r["grid"]) for r in res].index(
                            (summ.best_model_name, summ.best_grid))))


def test_text_flow_newton_and_svc_pick_the_jax_winner():
    from transmogrifai_tpu_torch.apps import titanic as PTitanic
    from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
    from transmogrifai_tpu_torch.impl.classification.svc import OpLinearSVC

    before = PL.weighted_gram.launches, PL.svc_grad.launches
    model, _ = PTitanic.train_titanic(PTitanic.text_columns(), device="cpu",
                                      text_embeddings=True,
                                      models_and_parameters=wide_space(OpLogisticRegression,
                                                                       OpLinearSVC))
    assert (PL.weighted_gram.launches, PL.svc_grad.launches) == before   # plain on the CPU
    found = FX.check_titanic_text_wide_train(model)
    assert found["width"] == 85
    assert found["max_gap"]["OpLogisticRegression"] <= FX.NEWTON_AUPR_TOL
    assert found["max_gap"]["OpLinearSVC"] <= FX.SVC_AUPR_TOL


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_fixture()
