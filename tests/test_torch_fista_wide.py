"""The port's FISTA fits above 64 coefficients against the JAX package's,
on the CPU.

A Titanic vector with Word2Vec and LDA features is about 86 columns wide
(and the reference's real-CSV flow, whose names hash into 64 buckets, is
wider too), so K-K (logistic) and K-N (linear) take up to
``FISTA_MAX_COEFS`` coefficients on the card.  Here the wrappers take their
plain versions (CPU tensors); ``tests/test_torch_cuda.py`` holds the wide
kernel to them on the card.  Coefficients within ``COEF_ATOL``: float32
gradient sums in another order than XLA's over the steps.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.ops import linear as JL

from transmogrifai_tpu_torch.ops import linear as PL

torch.set_num_threads(1)

#: FISTA coefficients (as ``tests/test_torch_sweep.py``'s)
COEF_ATOL = 2e-5


def _wide(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, : d // 2] = (X[:, : d // 2] > 0.8)                 # sparse one-hot-like columns
    beta = rng.normal(size=d) / np.sqrt(d)
    z = X @ beta + 0.3 * rng.normal(size=n)
    tw = (rng.random((3, n)) < 0.67).astype(np.float32)
    return X, z.astype(np.float32), tw


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_logistic_fista_at_100_coefficients_matches_jax(fit_intercept):
    X, z, tw = _wide(600, 99, 0)
    y = (z > 0).astype(np.float32)
    l1 = np.array([0.0001, 0.001], np.float32)
    l2 = np.array([0.0009, 0.009], np.float32)
    want = JL.fit_logistic_grid_folds_fista(X, y, tw, l1, l2, max_iter=100,
                                            fit_intercept=fit_intercept)
    got = PL.fit_logistic_grid_folds_fista(torch.from_numpy(X), torch.from_numpy(y),
                                           torch.from_numpy(tw), l1, l2, max_iter=100,
                                           fit_intercept=fit_intercept)
    assert tuple(got.coef.shape) == (3, 2, 99)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(got.intercept.numpy(), np.asarray(want.intercept), rtol=0,
                               atol=COEF_ATOL)


def test_linear_fista_at_100_coefficients_matches_jax():
    X, z, tw = _wide(600, 99, 1)
    y = (3.0 + 2.0 * z).astype(np.float32)
    l1 = np.array([0.001], np.float32)
    l2 = np.array([0.01], np.float32)
    want = JL.fit_linear_grid_folds_fista(X, y, tw, l1, l2, max_iter=100)
    got = PL.fit_linear_grid_folds_fista(torch.from_numpy(X), torch.from_numpy(y),
                                         torch.from_numpy(tw), l1, l2, max_iter=100)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(got.intercept.numpy(), np.asarray(want.intercept), rtol=0,
                               atol=COEF_ATOL)
