"""The logistic grid sweep of ``parallel/sweep.py`` on the port against the
JAX package's, on the CPU.

- ``make_fold_weights``: the (train, validation) masks bit for bit, plain
  and stratified.
- ``eval_logistic_grid_folds_plain`` (K-AE's plain version) against the JAX
  package's ``eval_logistic_grid_folds`` on the same fits: equal but at rows
  whose margin lies within float32 rounding of 0, where the two products may
  round to either side; the test counts those rows (from a float64 margin)
  and allows exactly them, each moving a (fold, candidate)'s error by one
  row's weight over the fold's.
- ``sharded_logistic_sweep`` against the JAX package's on one device: the
  mean errors as above, the Newton coefficients within 2e-5
  (``tests/test_torch_newton_ridge.py``'s ``COEF_TOL`` for the fold x grid
  Newton fits: the port solves in float64, the reference in float32).
- A mesh of more than one device raises.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.parallel import sweep as JS

from transmogrifai_tpu_torch.impl.tuning import validators as PV
from transmogrifai_tpu_torch.parallel import sweep as PS

torch.set_num_threads(1)

#: Newton coefficients and intercepts against the JAX package's, absolute
#: (tests/test_torch_newton_ridge.py's COEF_TOL)
COEF_ATOL = 2e-5


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 0.8 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("n,folds,stratify", [(801, 3, True), (801, 3, False), (50, 5, True),
                                              (7, 2, False)])
def test_make_fold_weights_is_the_jax_packages(n, folds, stratify):
    y = (np.random.default_rng(n).random(n) < 0.3).astype(np.float32)
    lab = y if stratify else None
    for a, b in zip(PS.make_fold_weights(n, folds, 42, lab), JS.make_fold_weights(n, folds, 42,
                                                                                  lab)):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    assert PV.make_fold_weights is PS.make_fold_weights  # one copy in the port


def _near_zero_rows(X, coef, intercept, val_w, dcoef=0.0, dintercept=0.0):
    """Per (fold, candidate), the validation weight of rows whose margin is
    within float32 rounding of 0 (a float64 margin against the rounding of
    a d-term float32 dot product and the intercept), or within the margin
    that two fits differing by ``dcoef`` / ``dintercept`` move."""
    X64 = X.astype(np.float64)
    z = np.einsum("nd,fgd->fgn", X64, coef.astype(np.float64)) + intercept.astype(np.float64)
    scale = np.einsum("nd,fgd->fgn", np.abs(X64), np.abs(coef.astype(np.float64))) \
        + np.abs(intercept.astype(np.float64))
    moved = np.einsum("nd,fgd->fgn", np.abs(X64), np.abs(np.broadcast_to(dcoef, coef.shape))) \
        + np.abs(np.broadcast_to(dintercept, intercept.shape))
    near = np.abs(z) <= (X.shape[1] + 2) * 2.0 ** -23 * scale + moved
    return (near * val_w[:, None, :]).sum(-1), int(near.sum())


@pytest.mark.parametrize("n,d,seed", [(2000, 11, 0), (997, 37, 1), (3000, 5, 2)])
def test_eval_plain_equals_the_jax_function(n, d, seed):
    X, y = _data(n, d, seed)
    rng = np.random.default_rng(seed + 10)
    F, G = 3, 8
    _, val_w = PS.make_fold_weights(n, F, 7, y)
    coef = rng.normal(size=(F, G, d)).astype(np.float32) * 0.5
    intercept = rng.normal(size=(F, G, 1)).astype(np.float32) * 0.1
    # margins at exactly 0 and within an ulp of it: the rows the test allows
    coef[0, 0, :] = 0.0
    intercept[0, 0, 0] = 0.0
    want = np.asarray(JS.eval_logistic_grid_folds(jnp.asarray(X), jnp.asarray(y),
                                                  jnp.asarray(val_w), jnp.asarray(coef),
                                                  jnp.asarray(intercept)))
    t = torch.from_numpy
    got = PS.eval_logistic_grid_folds(t(X), t(y), t(val_w), t(coef), t(intercept)).numpy()
    plain = PS.eval_logistic_grid_folds_plain(t(X), t(y), t(val_w), t(coef), t(intercept))
    np.testing.assert_array_equal(got, plain.numpy())  # a CPU tensor takes the plain version
    allowed, count = _near_zero_rows(X, coef, intercept, val_w)
    den = np.maximum(val_w.sum(-1), 1.0)[:, None]
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (gap <= allowed / den + 1e-7).all(), (gap.max(), count)
    assert got.dtype == np.float32 and got.shape == (F, G)
    assert (got[0, 0] == want[0, 0])  # z == 0 predicts 1 in both


def test_eval_checks_its_shapes():
    X, y = _data(20, 3, 0)
    t = torch.from_numpy
    vw = torch.ones((2, 20))
    with pytest.raises(ValueError, match=r"coef must be float32\[2, g, 3\]"):
        PS.eval_logistic_grid_folds(t(X), t(y), vw, torch.zeros((2, 4, 5)), torch.zeros((2, 4, 1)))
    with pytest.raises(ValueError, match=r"intercept must be float32\[2, 4, 1\]"):
        PS.eval_logistic_grid_folds(t(X), t(y), vw, torch.zeros((2, 4, 3)), torch.zeros((2, 4)))


@pytest.mark.parametrize("n,d,folds,seed", [(2000, 11, 3, 0), (1500, 24, 3, 1), (600, 6, 4, 2)])
def test_sharded_logistic_sweep_matches_the_jax_packages(n, d, folds, seed):
    X, y = _data(n, d, seed)
    l2 = np.array([0.0, 0.001, 0.01, 0.05, 0.1, 0.2, 0.5, 1.0], np.float32)
    mj, cj, bj = JS.sharded_logistic_sweep(X, y, l2, n_folds=folds)
    mp, cp, bp = PS.sharded_logistic_sweep(X, y, l2, n_folds=folds, device="cpu")
    assert cp.shape == np.asarray(cj).shape == (folds, len(l2), d)
    assert bp.shape == np.asarray(bj).shape == (folds, len(l2), 1)
    np.testing.assert_allclose(cp, np.asarray(cj), rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(bp, np.asarray(bj), rtol=0, atol=COEF_ATOL)
    _, val_w = PS.make_fold_weights(n, folds, 42, y)
    cj, bj = np.asarray(cj), np.asarray(bj)
    allowed, _ = _near_zero_rows(X, cj, bj, val_w, np.abs(cp - cj), np.abs(bp - bj))
    den = np.maximum(val_w.sum(-1), 1.0)[:, None]
    # the mean over folds of per-fold errors that may differ by the allowed rows
    bound = (allowed / den).mean(0) + 1e-7
    assert (np.abs(mp.astype(np.float64) - np.asarray(mj, np.float64)) <= bound).all()
    assert mp.dtype == np.float32 and mp.shape == (len(l2),)


def test_a_mesh_of_several_devices_raises():
    X, y = _data(100, 4, 0)
    l2 = np.array([0.1], np.float32)
    mesh = types.SimpleNamespace(devices=np.array([["cuda:0", "cuda:1"]], dtype=object))
    with pytest.raises(NotImplementedError, match="one device"):
        PS.sharded_logistic_sweep(X, y, l2, mesh=mesh, device="cpu")
    one = types.SimpleNamespace(devices=np.array([["cpu"]], dtype=object))
    err, coef, _ = PS.sharded_logistic_sweep(X, y, l2, mesh=one, device="cpu")
    assert err.shape == (1,) and coef.shape == (3, 1, 4)
