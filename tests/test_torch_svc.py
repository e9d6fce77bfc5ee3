"""The linear SVC (K-T ``svc_grad`` and ``OpLinearSVC``) on the port against the JAX
package's, on the CPU.

The same seeded numpy inputs go through the reference's squared-hinge fits
(``fit_svc_grid_folds``, ``OpLinearSVC``) and the port's, whose K-T wrapper
runs its plain version on CPU tensors:

- the gradient at given points against the reference's ``grad_fn`` within
  ``GRAD_RTOL`` (float32 sums in other orders);
- the fitted coefficients within ``COEF_ATOL`` after 200 Nesterov steps;
- the hard predictions equal on every row whose margin is above
  ``BOUNDARY`` (a row within rounding of 0 may flip; their count is
  printed), the raw margins within ``MARGIN_ATOL``;
- no probability, as the reference (Spark's LinearSVC has none).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.impl.classification import svc as JS
from transmogrifai_tpu.ops import linear as JL

from transmogrifai_tpu_torch.impl.classification import svc as PS
from transmogrifai_tpu_torch.ops import linear as PL

torch.set_num_threads(1)

#: the gradient, relative to its largest entry
GRAD_RTOL = 1e-6
#: the coefficients after 200 steps: FISTA's 2e-5 (float32 sums in another
#: order, carried through the momentum)
COEF_ATOL = 2e-5
#: margins of the fitted models, absolute
MARGIN_ATOL = 2e-4
#: predictions may differ only where the margin is this close to 0
BOUNDARY = 1e-5


def _data(seed=0, n=900, d=10, F=3):
    """Titanic-like features (0/1 columns, an age and an unscaled fare, as
    the Titanic fits converge slowly on), 0/1 labels, three folds."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.integers(0, 2, (n, d - 3)), rng.integers(1, 7, (n, 1)),
                        rng.uniform(1, 80, (n, 1)), rng.uniform(5, 100, (n, 1))],
                       1).astype(np.float32)
    y = ((X[:, 0] > 0) | (rng.random(n) < 0.2)).astype(np.float32)
    tw = np.ones((F, n), np.float32)
    for f in range(F):
        tw[f, f::F] = 0.0
    return X, y, tw


def test_grad_matches_the_references():
    X, y, tw = _data()
    n, d = X.shape
    X1 = np.concatenate([X, np.ones((n, 1), np.float32)], 1)
    rng = np.random.default_rng(1)
    C = 6
    fold = (np.arange(C) % 3).astype(np.int32)
    z = (rng.normal(size=(C, d + 1)) * 0.05).astype(np.float32)
    l2 = np.array([0.0, 0.001, 0.01, 0.1, 0.2, 0.5], np.float32)
    pen = np.ones(d + 1, np.float32)
    pen[-1] = 0.0
    l2v = (l2[:, None] * pen).astype(np.float32)
    wsum = tw.sum(1)[fold].astype(np.float32)

    @jax.jit
    def ref(X1, y, w, beta, l2_vec, w_sum):  # the reference's grad_fn
        ypm = 2.0 * y - 1.0
        active = jnp.maximum(1.0 - ypm * (X1 @ beta), 0.0)
        return X1.T @ (w * (-2.0 * ypm * active)) / w_sum + l2_vec * beta

    want = np.stack([np.asarray(ref(X1, y, tw[fold[c]], z[c], l2v[c], wsum[c]))
                     for c in range(C)])
    got = PL.svc_grad(*(torch.from_numpy(a) for a in (X1, y, tw, fold, z, l2v, wsum))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max())
    assert PL.svc_grad.launches == 0


def test_grid_fits_match_the_references():
    X, y, tw = _data(seed=2)
    l2s = np.array([0.001, 0.01, 0.1, 0.2], np.float32)
    jf = JL.fit_svc_grid_folds(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw),
                               jnp.asarray(l2s), max_iter=200)
    pf = PL.fit_svc_grid_folds(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(tw),
                               l2s, max_iter=200)
    assert pf.coef.shape == (3, 4, 10) and pf.intercept.shape == (3, 4, 1)
    np.testing.assert_allclose(pf.coef.numpy(), np.asarray(jf.coef), rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(pf.intercept.numpy(), np.asarray(jf.intercept), rtol=0,
                               atol=COEF_ATOL)
    one = PL.fit_linear_svc(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(tw[1]),
                            0.01)
    np.testing.assert_allclose(one.coef.numpy(), np.asarray(jf.coef)[1, 1], rtol=0,
                               atol=COEF_ATOL)


def test_estimator_matches_the_references():
    X, y, tw = _data(seed=3)
    grids = [{"reg_param": r} for r in (0.001, 0.01, 0.1, 0.2)]
    je, pe = JS.OpLinearSVC(), PS.OpLinearSVC()
    pe.device = torch.device("cpu")
    jp, pp = je.fit_grid_folds(X, y, tw, grids), pe.fit_grid_folds(X, y, tw, grids)
    near = 0
    for f in range(3):
        for c in range(4):
            (pj, rj, qj), (pq, rq, qq) = jp[f][c], pp[f][c]
            assert qj is None and qq is None
            np.testing.assert_allclose(rq, rj, rtol=0, atol=MARGIN_ATOL)
            off = np.abs(rj[:, 1]) > BOUNDARY
            np.testing.assert_array_equal(pq[off], pj[off])
            near += int((~off).sum())
    print(f"rows within {BOUNDARY} of the boundary: {near}")
    params_j = je.fit_arrays(X, y, tw[0])
    params_p = pe.fit_arrays(torch.from_numpy(X), y, tw[0])
    np.testing.assert_allclose(params_p["coef"], params_j["coef"], rtol=0, atol=COEF_ATOL)
    pred_j, raw_j, prob_j = JS.OpLinearSVC.predict_arrays(params_j, X)
    pred_p, raw_p, prob_p = PS.OpLinearSVC.predict_arrays(params_p, torch.from_numpy(X))
    assert prob_j is None and prob_p is None
    np.testing.assert_allclose(raw_p, raw_j, rtol=0, atol=MARGIN_ATOL)
    off = np.abs(raw_j[:, 1]) > BOUNDARY
    np.testing.assert_array_equal(pred_p[off], pred_j[off])
    with pytest.raises(NotImplementedError, match="grid key"):
        pe.fit_grid_folds(X, y, tw, [{"max_iter": 5}])
