"""Naive Bayes (K-V ``nb_tables`` and ``OpNaiveBayes``) on the port against the JAX
package's, on the CPU.

The same seeded numpy inputs go through the reference's ``_nb_grid_z`` and
``OpNaiveBayes`` and through the port's (whose K-V wrappers run their plain
versions on CPU tensors).  The masses of 0/1 columns under integer weights
are exact in both; the real columns' float32 sums in XLA's order differ
from the port's correctly rounded ones in the last bits, so the masses are
held within ``MASS_RTOL``, the joint log-likelihoods within ``Z_ATOL``, the
fit's tables within ``TABLE_RTOL``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.impl.classification import naive_bayes as JNB

from transmogrifai_tpu_torch.impl.classification import naive_bayes as PNB

torch.set_num_threads(1)

#: the masses, relative: float32 sums of a few hundred real values in
#: another order
MASS_RTOL = 2e-6
#: the joint log-likelihoods, absolute (values of tens): the tables' last
#: bits and the dot products' order
Z_ATOL = 2e-4
#: the refit's log tables, relative
TABLE_RTOL = 1e-5
#: the class probabilities: a probability moves by at most p (1 - p) <= 1/4
#: times the gap of the two classes' log-likelihoods, at most 2 Z_ATOL
PROB_ATOL = 0.5 * Z_ATOL


def _data(seed=0, n=600, d=7, k=2):
    """Non-negative features: three 0/1 columns, two small integers, two
    reals (an age and a fare); integer weights over three folds."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.integers(0, 2, (n, 3)), rng.integers(0, 5, (n, 2)),
                        rng.uniform(1, 80, (n, 1)), rng.uniform(5, 100, (n, 1))],
                       axis=1).astype(np.float32)[:, :d]
    y = rng.integers(0, k, n).astype(np.float32)
    tw = np.ones((3, n), np.float32)
    for f in range(3):
        tw[f, f::3] = 0.0
    return X, y, tw


@pytest.mark.parametrize("k", [2, 3])
def test_masses_match_the_reference(k):
    X, y, tw = _data(k=k)
    Y = np.eye(k, dtype=np.float32)[y.astype(int)]
    cls_j = np.asarray(jnp.einsum("fn,nk->fk", tw, Y))
    feat_j = np.asarray(jnp.einsum("fn,nk,nd->fkd", tw, Y, X))
    cls, feat = PNB.nb_tables_mass(torch.from_numpy(X), torch.from_numpy(y),
                                   torch.from_numpy(tw), k)
    np.testing.assert_array_equal(cls.numpy(), cls_j)
    # the 0/1 and integer columns exactly, the real ones within MASS_RTOL
    np.testing.assert_array_equal(feat.numpy()[..., :5], feat_j[..., :5])
    np.testing.assert_allclose(feat.numpy(), feat_j, rtol=MASS_RTOL, atol=0)
    assert PNB.nb_tables_mass.launches == 0


@pytest.mark.parametrize("bernoulli", [False, True])
def test_grid_scores_match_the_references(bernoulli):
    X, y, tw = _data(seed=1)
    Xd = (X > 0).astype(np.float32) if bernoulli else X
    sm = np.array([1.0, 0.5, 2.0], np.float32)
    zj = np.asarray(JNB._nb_grid_z(jnp.asarray(Xd), jnp.asarray(np.eye(2, dtype=np.float32)[
        y.astype(int)]), jnp.asarray(tw), jnp.asarray(sm), bernoulli))
    zp = PNB._nb_grid_z(torch.from_numpy(Xd), torch.from_numpy(y), torch.from_numpy(tw), sm,
                        bernoulli, 2).numpy()
    assert zp.shape == zj.shape == (3, 3, len(y), 2)
    np.testing.assert_allclose(zp, zj, rtol=0, atol=Z_ATOL)
    assert PNB.nb_tables_score.launches == 0


@pytest.mark.parametrize("model_type", ["multinomial", "bernoulli"])
def test_fit_grid_folds_and_refit_match_the_reference(model_type):
    X, y, tw = _data(seed=2)
    grids = [{"smoothing": 1.0}, {"smoothing": 0.25, "model_type": model_type}]
    je = JNB.OpNaiveBayes(model_type=model_type)
    pe = PNB.OpNaiveBayes(model_type=model_type)
    pe.device = torch.device("cpu")
    jp, pp = je.fit_grid_folds(X, y, tw, grids), pe.fit_grid_folds(X, y, tw, grids)
    for f in range(3):
        for c in range(2):
            (pj, zj, qj), (pq, zq, qq) = jp[f][c], pp[f][c]
            np.testing.assert_allclose(zq, zj, rtol=0, atol=Z_ATOL)
            np.testing.assert_allclose(qq, qj, rtol=0, atol=PROB_ATOL)
            margin = np.abs(zj[:, 1] - zj[:, 0])
            np.testing.assert_array_equal(pq[margin > 1e-3], pj[margin > 1e-3])
    params_j = je.fit_arrays(X, y, tw[0])
    params_p = pe.fit_arrays(torch.from_numpy(X), y, tw[0])
    for key in ("pi", "theta") + (("theta_neg",) if model_type == "bernoulli" else ()):
        np.testing.assert_allclose(params_p[key], params_j[key], rtol=TABLE_RTOL, atol=1e-6)
    assert params_p["num_classes"] == 2 and params_p["model_type"] == model_type
    pred_j, raw_j, prob_j = JNB.OpNaiveBayes.predict_arrays(params_j, X)
    pred_p, raw_p, prob_p = PNB.OpNaiveBayes.predict_arrays(params_p, torch.from_numpy(X))
    np.testing.assert_allclose(raw_p, raw_j, rtol=0, atol=Z_ATOL)
    np.testing.assert_allclose(prob_p, prob_j, rtol=0, atol=PROB_ATOL)
    margin = np.abs(raw_j[:, 1] - raw_j[:, 0])
    np.testing.assert_array_equal(pred_p[margin > 1e-3], pred_j[margin > 1e-3])


def test_negative_features_are_refused():
    X, y, tw = _data()
    X[3, 6] = -1.0
    pe = PNB.OpNaiveBayes()
    pe.device = torch.device("cpu")
    with pytest.raises(ValueError, match="non-negative"):
        pe.fit_arrays(torch.from_numpy(X), y)
    with pytest.raises(ValueError, match="non-negative"):
        pe.fit_grid_folds(X, y, tw, [{}])
    with pytest.raises(NotImplementedError, match="grid key"):
        pe.fit_grid_folds(np.abs(X), y, tw, [{"max_iter": 3}])
