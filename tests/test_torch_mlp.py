"""The multilayer perceptron (K-U ``mlp_grad`` / ``mlp_forward`` and
``OpMultilayerPerceptronClassifier``) on the port against the JAX package's, on the CPU.

The same seeded numpy inputs go through the reference's ``ops/mlp.py`` and
the port's, whose K-U wrappers run their plain versions on CPU tensors:

- the Glorot init bit for bit (``jax.random``'s threefry draws replayed,
  the uniform's affine map one fused multiply-add as XLA contracts it);
- the gradient at given parameters against ``jax.grad`` of the reference's
  loss within ``GRAD_RTOL``, the forward pass within ``PROB_ATOL``;
- the fits after 10 Adam steps within ``FIT_ATOL_10``; after 200 steps the
  probabilities within ``DRIFT_PROB_ATOL``: Adam's normalized step turns
  the float32 order differences of small gradients (and XLA's own exp)
  into differences of the step, so the parameters drift apart, as the
  reference's own single and batched programs do from each other.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.impl.classification import mlp as JMC
from transmogrifai_tpu.ops import mlp as JM

from transmogrifai_tpu_torch.impl.classification import mlp as PMC
from transmogrifai_tpu_torch.ops import mlp as PM

torch.set_num_threads(1)

#: the gradient, relative to its largest entry
GRAD_RTOL = 1e-5
#: logits and probabilities of the same parameters
PROB_ATOL = 1e-6
#: the parameters after 10 Adam steps (2.4e-7 measured)
FIT_ATOL_10 = 1e-6
#: the probabilities after 200 Adam steps: the drift.  On these inputs the
#: port's are 0.034 from the reference's batched fits, and the reference's
#: own single fits (``fit_mlp``) 0.10 from its batched ones
DRIFT_PROB_ATOL = 0.1


def _data(seed=0, n=600, k=2):
    """Titanic-like features: 0/1 columns, an age and an unscaled fare."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.integers(0, 2, (n, 6)), rng.uniform(1, 80, (n, 2)),
                        rng.uniform(5, 100, (n, 2))], 1).astype(np.float32)
    y = (((X[:, 0] > 0) | (rng.random(n) < 0.2)).astype(np.float32) if k == 2
         else rng.integers(0, k, n).astype(np.float32))
    tw = np.ones((3, n), np.float32)
    for f in range(3):
        tw[f, f::3] = 0.0
    return X, y, tw


def _gap(jparams, pparams):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for (Wj, bj), (Wp, bp) in zip(jparams, pparams) for a, b in ((Wj, Wp), (bj, bp)))


@pytest.mark.parametrize("layers,seed", [((10, 10, 2), 42), ((8, 10, 3), 7),
                                         ((6, 8, 5, 3), 0)])
def test_init_is_bit_equal(layers, seed):
    X = np.zeros((4, layers[0]), np.float32)
    jp = JM.fit_mlp(jnp.asarray(X), jnp.zeros(4), jnp.ones(4), layers=layers, max_iter=0,
                    seed=seed)
    pp = PM.init_params(seed, layers)
    for (Wj, bj), (Wp, bp) in zip(jp, pp):
        np.testing.assert_array_equal(Wp.numpy(), np.asarray(Wj))
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))


@pytest.mark.parametrize("layers,k", [((10, 10, 2), 2), ((10, 6, 4, 3), 3)])
def test_grad_and_forward_match_the_references(layers, k):
    X, y, tw = _data(k=k)
    rng = np.random.default_rng(1)
    C = 3
    fold = np.arange(C).astype(np.int32)
    flat = torch.stack([PM.flatten(PM.init_params(s, layers)) for s in range(C)])
    flat = flat + torch.from_numpy((rng.normal(size=tuple(flat.shape)) * 0.1).astype(np.float32))
    wsum = np.maximum(tw.sum(1), 1e-12)[fold].astype(np.float32)
    got = PM.mlp_grad(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(tw),
                      torch.from_numpy(fold), torch.from_numpy(wsum), flat, layers).numpy()
    Y = jax.nn.one_hot(jnp.asarray(y, jnp.int32), k)

    def loss(p, w, w_sum):  # the reference's loss_fn
        ll = jax.nn.log_softmax(JM.forward(p, jnp.asarray(X)), axis=-1)
        return -(w[:, None] * Y * ll).sum() / w_sum

    grad = jax.jit(jax.grad(loss))
    for c in range(C):
        ps = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy()))
              for W, b in PM.unflatten(flat[c], layers)]
        want = PM.flatten([(torch.from_numpy(np.array(W)), torch.from_numpy(np.array(b)))
                           for W, b in grad(ps, jnp.asarray(tw[c]), wsum[c])]).numpy()
        np.testing.assert_allclose(got[c], want, rtol=0, atol=GRAD_RTOL * np.abs(want).max())
        jz, jprob, _ = JM.predict_mlp(ps, jnp.asarray(X))
        z, prob = PM.mlp_forward(torch.from_numpy(X), flat[c:c + 1], layers)
        np.testing.assert_allclose(z[0].numpy(), np.asarray(jz), rtol=1e-6, atol=PROB_ATOL)
        np.testing.assert_allclose(prob[0].numpy(), np.asarray(jprob), rtol=0, atol=PROB_ATOL)
    assert PM.mlp_grad.launches == 0 and PM.mlp_forward.launches == 0


def test_grid_fits_match_the_references():
    X, y, tw = _data(seed=2)
    layers = (10, 10, 2)
    lrs, seeds = np.array([0.03, 0.01], np.float32), np.array([42, 3], np.int32)
    out = {}
    for steps in (10, 200):
        jp = JM.fit_mlp_grid_folds(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw),
                                   jnp.asarray(lrs), jnp.asarray(seeds), layers=layers,
                                   max_iter=steps)
        pp = PM.fit_mlp_grid_folds(torch.from_numpy(X), torch.from_numpy(y),
                                   torch.from_numpy(tw), lrs, seeds, layers=layers,
                                   max_iter=steps)
        assert pp[0][0].shape == (3, 2, 10, 10) and pp[1][1].shape == (3, 2, 2)
        _, jprob, _ = JM.predict_mlp_grid(jp, jnp.asarray(X))
        _, prob, pred = PM.predict_mlp_grid(pp, torch.from_numpy(X))
        assert prob.shape == (3, 2, len(y), 2) and pred.shape == (3, 2, len(y))
        out[steps] = (_gap(jp, pp), float(np.abs(prob.numpy() - np.asarray(jprob)).max()))
    assert out[10][0] <= FIT_ATOL_10 and out[10][1] <= PROB_ATOL
    assert out[200][1] <= DRIFT_PROB_ATOL


def test_estimator_groups_and_matches_the_references():
    X, y, tw = _data(seed=3, k=3)
    grids = [{"step_size": 0.03, "max_iter": 30}, {"hidden_layers": (4,), "max_iter": 30},
             {"step_size": 0.01, "seed": 5, "max_iter": 30}]
    je, pe = JMC.OpMultilayerPerceptronClassifier(), PMC.OpMultilayerPerceptronClassifier()
    pe.device = torch.device("cpu")
    jp, pp = je.fit_grid_folds(X, y, tw, grids), pe.fit_grid_folds(X, y, tw, grids)
    for f in range(3):
        for c in range(3):
            (pj, rj, qj), (pq, rq, qq) = jp[f][c], pp[f][c]
            np.testing.assert_allclose(qq, qj, rtol=0, atol=1e-4)
            margin = np.sort(qj, axis=1)[:, -1] - np.sort(qj, axis=1)[:, -2]
            np.testing.assert_array_equal(pq[margin > 1e-3], pj[margin > 1e-3])
    est_j = je.copy_with_params({"max_iter": 20})
    est_p = pe.copy_with_params({"max_iter": 20})
    params_j, params_p = est_j.fit_arrays(X, y, tw[0]), est_p.fit_arrays(torch.from_numpy(X), y,
                                                                         tw[0])
    assert params_p["layers"] == params_j["layers"] == (10, 10, 3)
    assert _gap(params_j["weights"], [(torch.from_numpy(W), torch.from_numpy(b))
                                      for W, b in params_p["weights"]]) <= 1e-4
    pred_j, raw_j, prob_j = JMC.OpMultilayerPerceptronClassifier.predict_arrays(params_j, X)
    pred_p, raw_p, prob_p = PMC.OpMultilayerPerceptronClassifier.predict_arrays(
        params_p, torch.from_numpy(X))
    np.testing.assert_allclose(prob_p, prob_j, rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="grid key"):
        pe.fit_grid_folds(X, y, tw, [{"tol": 1e-3}])


def test_kernel_limits_are_named():
    """K-U's bounds: 8 hidden layers, features and hidden widths up to
    4,096, 2 .. 128 classes; one ValueError just past each, on either
    device (the plain version's CPU branch checks the same)."""
    for layers in ((128, 64, 64, 8), (32, 128, 64, 26), (450, 128, 64, 32, 2), (2100, 10, 2),
                   (4096,) * 9 + (128,), (5, 2)):
        PM._check_net(layers)
    for layers in ((4097, 10, 2), (4, 4097, 2), (4, 10, 129), (4, 10, 1),
                   (4,) + (8,) * 9 + (2,)):
        with pytest.raises(ValueError, match="hidden layers"):
            PM._check_net(layers)
    X = torch.zeros((3, 4))
    with pytest.raises(ValueError, match=r"\(4, 10, 129\)"):
        PM.mlp_forward(X, torch.zeros((1, PM.param_count((4, 10, 129)))), (4, 10, 129))
