"""Round-collapsed boosting (``trees_per_round`` = K > 1) on the port against
the JAX package's, on the CPU.

The port's counterpart of ``tests/test_round_collapse.py``: K trees a
boosting step grown on the same gradients (each with its own round's
subsample and colsample draw), the margins moved by ``(eta / K) * sum_k
leaf_k``, in ``n_rounds / K`` steps.  Held here:

- ``effective_trees_per_round``'s clamping and the ``TMOG_GBT_ROUND_COLLAPSE``
  default (junk included) equal the JAX package's, and the boosted models'
  parameter dicts default to it;
- the stored trees at ``eta / K`` reproduce the training margins, K = 1 is
  the per-round program, and the batch fit equals the single fit at K = 4
  bit for bit;
- ``fit_gbt`` and ``fit_gbt_batch`` against the JAX package's at K = 2 and 4
  for the logistic, squared and softmax (c = 3) losses, with draws at 1.0
  and at 0.8 (at 1.0 a step's K trees are identical, so a wrong draw index
  would show only below 1): tree structure equal, leaves and margins within
  1e-6 (the histogram sums follow XLA's float32 order; the logistic and
  softmax gradients carry the host's ``exp``, an ulp from XLA's);
- the replay: the JAX package's own collapsed trees, replayed from its base
  score through the collapse mode's plain version (K-H for the logistic and
  squared losses, K-R for the softmax), give its final margins bit for bit
  (the K leaves summed in XLA's order, ``eta / K`` as a product with the
  float32 reciprocal, one fused multiply-add), for K = 2, 3, 4, 8 and 12.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.impl import trees_common as JC
from transmogrifai_tpu.impl.classification import trees as JTr
from transmogrifai_tpu.ops import trees as JT

from transmogrifai_tpu_torch.impl import trees_common as PC
from transmogrifai_tpu_torch.impl.classification import trees as PTr
from transmogrifai_tpu_torch.impl.regression import trees as PRTr
from transmogrifai_tpu_torch.ops import metrics as PM
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

#: tree leaves and margins against the JAX package's (absolute; margins also
#: relative): the host's ``exp`` in the gradients (measured 4.0e-7 and 4.8e-7
#: on the CPU)
LEAF_ATOL = 1e-6
MARGIN_TOL = 1e-6


# ---------------------------------------------------------------------------
# the collapse factor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,rounds,want", [
    (1, 8, 1), (4, 8, 4), (8, 8, 8), (2, 200, 2),
    (3, 8, 1),     # does not divide
    (16, 8, 1),    # exceeds rounds
    (0, 8, 1), (-2, 8, 1),
])
def test_clamping_equals_the_jax_packages(k, rounds, want):
    assert PC.effective_trees_per_round(k, rounds) == want
    assert JC.effective_trees_per_round(k, rounds) == want


@pytest.mark.parametrize("value", [None, "", "4", " 2 ", "1e1", "2.7", "junk", "0", "-3"])
def test_environment_default_equals_the_jax_packages(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("TMOG_GBT_ROUND_COLLAPSE", raising=False)
    else:
        monkeypatch.setenv("TMOG_GBT_ROUND_COLLAPSE", value)
    want = {None: 1, "": 1, "4": 4, " 2 ": 2, "1e1": 10, "2.7": 2, "junk": 1, "0": 1,
            "-3": 1}[value]
    assert PC.round_collapse_default() == JC.round_collapse_default() == want


def test_boost_params_default_to_the_environment(monkeypatch):
    monkeypatch.setenv("TMOG_GBT_ROUND_COLLAPSE", "4")
    for P_, J_ in ((PTr.OpXGBoostClassifier, JTr.OpXGBoostClassifier),
                   (PTr.OpGBTClassifier, JTr.OpGBTClassifier)):
        assert P_()._boost_params()["trees_per_round"] == 4
        assert P_()._boost_params() == J_()._boost_params()
        assert P_(trees_per_round=2)._boost_params()["trees_per_round"] == 2
    assert PRTr.OpGBTRegressor()._boost_params()["trees_per_round"] == 4
    monkeypatch.setenv("TMOG_GBT_ROUND_COLLAPSE", "junk")
    assert PTr.OpXGBoostClassifier()._boost_params()["trees_per_round"] == 1


# ---------------------------------------------------------------------------
# the fits
# ---------------------------------------------------------------------------
def _inputs(loss, frac, seed=0, n=400, d=6, R=8, n_bins=16):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, (n, d)).astype(np.int8)
    z = Xb[:, 0].astype(np.float32) - 0.6 * Xb[:, 1] + rng.standard_normal(n) * 2
    if loss == "logistic":
        y = (z > 0).astype(np.float32)
    elif loss == "softmax":
        y = np.digitize(z, [-1.0, 1.0]).astype(np.float32)
    else:
        y = (z * 0.3 + 1.0).astype(np.float32)
    rw = (rng.random((R, n)) < frac).astype(np.float32)
    fm = (rng.random((R, d)) < frac).astype(np.float32)
    fm[:, 0] = 1.0
    w = rng.integers(1, 3, n).astype(np.float32)
    return Xb, y, w, rw, fm


def _args(loss):
    c = 3 if loss == "softmax" else 1
    return dict(loss=loss, n_rounds=8, max_depth=3, n_bins=16, frontier=8, eta=0.3,
                n_classes=c)


def _port_fit(Xb, y, w, rw, fm, K, **kw):
    t = torch.from_numpy
    return PT.fit_gbt(t(Xb), t(y), t(w), t(rw), t(fm), kw["loss"], kw["n_rounds"],
                      kw["max_depth"], kw["n_bins"], kw["frontier"], eta=kw["eta"],
                      base_score=kw.get("base_score", 0.0), n_classes=kw["n_classes"],
                      trees_per_round=K)


def _jax_fit(Xb, y, w, rw, fm, K, **kw):
    return JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(rw),
                      jnp.asarray(fm), kw["loss"], kw["n_rounds"], kw["max_depth"],
                      kw["n_bins"], kw["frontier"], eta=kw["eta"],
                      base_score=kw.get("base_score", 0.0), n_classes=kw["n_classes"],
                      trees_per_round=K)


@pytest.mark.parametrize("loss", ["logistic", "squared", "softmax"])
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("frac", [1.0, 0.8])
def test_fit_gbt_matches_the_jax_packages(loss, K, frac):
    Xb, y, w, rw, fm = _inputs(loss, frac)
    kw = _args(loss)
    if loss == "squared":
        kw["base_score"] = float(np.float32(y.mean()))
    tj, Fj = _jax_fit(Xb, y, w, rw, fm, K, **kw)
    tp, Fp = _port_fit(Xb, y, w, rw, fm, K, **kw)
    assert tp.leaf_val.shape[0] == 8  # the flat [n_rounds, ...] tree axis
    for k in ("split_feat", "split_bin", "left", "right"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(tj, k)), k)
    assert (np.asarray(tj.split_feat) >= 0).sum() > 8  # the trees do split
    np.testing.assert_allclose(tp.leaf_val.numpy(), np.asarray(tj.leaf_val).reshape(
        tp.leaf_val.shape), rtol=0, atol=LEAF_ATOL)
    np.testing.assert_allclose(Fp.numpy(), np.asarray(Fj).reshape(Fp.shape), rtol=MARGIN_TOL,
                               atol=MARGIN_TOL)


@pytest.mark.parametrize("loss", ["logistic", "squared", "softmax"])
@pytest.mark.parametrize("K", [2, 4])
def test_fit_gbt_batch_matches_the_jax_packages(loss, K):
    Xb, y, _, rw, fm = _inputs(loss, 0.8, seed=4)
    n = len(y)
    kw = _args(loss)
    rng = np.random.default_rng(5)
    B = 4
    w_b = np.stack([(rng.random(n) < 0.67).astype(np.float32) for _ in range(B)])
    # softmax: min_child_weight 5, as tests/test_torch_softmax_boost.py's
    # batch test, away from the stated float32 boundary of the class-mean
    # hessian sums at 10 (test_min_child_weight_boundary_is_a_stated_gap)
    m2 = 5.0 if loss == "softmax" else 10.0
    mcw = np.array([1.0, m2, 1.0, m2], np.float32)
    eta = np.array([0.3, 0.3, 0.1, 0.1], np.float32)
    lam, gam = np.ones(B, np.float32), np.full(B, 0.2, np.float32)
    base = (np.full(B, np.float32(y.mean()), np.float32) if loss == "squared"
            else np.zeros(B, np.float32))
    Fj = JT.fit_gbt_batch(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w_b), jnp.asarray(rw),
                          jnp.asarray(fm), loss, 8, 3, 16, 8, jnp.asarray(eta),
                          jnp.asarray(lam), jnp.asarray(gam), jnp.asarray(mcw),
                          base_score_b=jnp.asarray(base), n_classes=kw["n_classes"],
                          trees_per_round=K)
    t = torch.from_numpy
    Fp = PT.fit_gbt_batch(t(Xb), t(y), t(w_b), t(rw), t(fm), loss, 8, 3, 16, 8, eta, lam, gam,
                          mcw, base_score_b=base, n_classes=kw["n_classes"],
                          trees_per_round=K)
    np.testing.assert_allclose(Fp.numpy(), np.asarray(Fj).reshape(Fp.shape), rtol=MARGIN_TOL,
                               atol=MARGIN_TOL)


def test_stored_trees_reproduce_training_margins():
    """``predict_gbt`` over the stacked [n_rounds, ...] trees at the stored
    per-tree eta (eta / K) reproduces the final margins (the reference's
    ``fit_arrays`` contract)."""
    Xb, y, w, rw, fm = _inputs("logistic", 0.8, seed=1)
    K = 4
    tree, F = _port_fit(Xb, y, w, rw, fm, K, **_args("logistic"))
    pred = PT.predict_gbt(torch.from_numpy(Xb), tree, 3, 0.3 / K)
    np.testing.assert_allclose(pred.numpy(), F.numpy(), rtol=0, atol=1e-5)


def test_collapse_one_is_the_per_round_program():
    Xb, y, w, rw, fm = _inputs("logistic", 0.8, seed=2)
    kw = _args("logistic")
    t1, F1 = _port_fit(Xb, y, w, rw, fm, 1, **kw)
    tn, Fn = _port_fit(Xb, y, w, rw, fm, 0, **kw)  # K <= 1: no collapse
    t = torch.from_numpy
    td, Fd = PT.fit_gbt(t(Xb), t(y), t(w), t(rw), t(fm), "logistic", 8, 3, 16, 8, eta=0.3)
    for a, b, c in zip(t1, tn, td):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), c.numpy())
    np.testing.assert_array_equal(F1.numpy(), Fd.numpy())
    np.testing.assert_array_equal(Fn.numpy(), Fd.numpy())


@pytest.mark.parametrize("loss", ["logistic", "softmax"])
def test_batch_equals_single_at_k4(loss):
    Xb, y, w, rw, fm = _inputs(loss, 0.8, seed=3)
    kw = _args(loss)
    _, F_single = _port_fit(Xb, y, w, rw, fm, 4, **kw)
    B = 2
    ones = np.ones(B, np.float32)
    t = torch.from_numpy
    F_batch = PT.fit_gbt_batch(t(Xb), t(y), t(np.stack([w] * B)), t(rw), t(fm), loss, 8, 3,
                               16, 8, 0.3 * ones, ones, 0.0 * ones, ones,
                               n_classes=kw["n_classes"], trees_per_round=4)
    for b in range(B):
        np.testing.assert_array_equal(F_batch[b].numpy(), F_single.numpy())


def test_collapse_factor_must_divide_the_rounds():
    Xb, y, w, rw, fm = _inputs("logistic", 1.0)
    with pytest.raises(ValueError, match="trees_per_round=3 must divide n_rounds=8"):
        _port_fit(Xb, y, w, rw, fm, 3, **_args("logistic"))
    with pytest.raises(ValueError, match="must divide"):
        t = torch.from_numpy
        PT.fit_gbt_batch(t(Xb), t(y), t(w[None]), t(rw), t(fm), "logistic", 8, 3, 16, 8,
                         [0.3], [1.0], [0.0], [1.0], trees_per_round=5)


# ---------------------------------------------------------------------------
# the replay: the reference's own trees through the collapse mode's plain version
# ---------------------------------------------------------------------------
def _replay_frame(loss, K, seed=3, n=3000, d=6, n_bins=16):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, (n, d)).astype(np.int8)
    z = Xb[:, 0].astype(np.float32) - 0.6 * Xb[:, 1] + rng.standard_normal(n) * 2
    y = {"logistic": (z > 0).astype(np.float32),
         "squared": (z * 3.7 + 20.0).astype(np.float32),
         "softmax": np.digitize(z, [-1.0, 1.0]).astype(np.float32)}[loss]
    R = 2 * K if K > 4 else 12
    rng = np.random.default_rng(9)
    rw = (rng.random((R, n)) < 0.8).astype(np.float32)
    fm = (rng.random((R, d)) < 0.8).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    c = 3 if loss == "softmax" else 1
    base = float(np.float32(y.mean())) if loss == "squared" else 0.0
    eta = 0.1 if loss == "squared" else 0.3
    trees, Fj = JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(rw),
                           jnp.asarray(fm), loss, R, 3, n_bins, 8, eta=eta, base_score=base,
                           trees_per_round=K, n_classes=c)
    tree = PT.Tree(*(torch.from_numpy(np.array(a)) for a in trees))
    _, leaves = PT.ensemble_walk_plain(torch.from_numpy(Xb), tree, 3, return_leaves=True)
    return (np.asarray(Fj), tree, leaves.T.contiguous(), y, w, rw, base, eta, R, c)


def _replay(loss, K, fused_squared=None):
    """(the reference's final margins, the port's replayed margins) through
    the collapse mode's plain version, or, with ``fused_squared``, through
    the collapse sum and ``metrics.fma`` (True) or two roundings (False)."""
    ref, tree, leaves, y, w, rw, base, eta, R, c = _replay_frame(loss, K)
    n = ref.shape[0]
    F = torch.full((1, n, c) if loss == "softmax" else (1, n), base, dtype=torch.float32)
    yt, wt = torch.from_numpy(y), torch.from_numpy(w)[None]
    eta_t = torch.tensor([eta], dtype=torch.float32)
    lv_all = tree.leaf_val if loss == "softmax" else tree.leaf_val[..., 0]
    for s in range(R // K):
        sl = slice(s * K, (s + 1) * K)
        rwk = torch.from_numpy(rw[sl])
        if fused_squared is not None:
            lv = lv_all[sl].gather(1, leaves[sl].long())
            S = PT.collapse_leaf_sum(lv[None])
            a = PT.collapse_scale(eta_t, K).expand_as(S)
            F = PM.fma(a, S, F) if fused_squared else F + a * S
        elif loss == "softmax":
            PT.softmax_boost_step_plain(F, yt, wt, eta_t, lv_all[sl], leaves[sl], None, rwk)
        else:
            PT.boost_step_plain(F, yt, wt, eta_t, lv_all[sl], leaves[sl], None, loss, rwk)
    return ref.reshape(F.shape[1:]), F[0].numpy()


@pytest.mark.parametrize("K", [2, 3, 4, 8, 12])
def test_logistic_collapse_update_replays_the_reference_bit_for_bit(K):
    ref, got = _replay("logistic", K)
    differ = int(np.sum(got != ref))
    assert differ == 0, f"{differ} of {ref.size} margins differ from the reference's"


@pytest.mark.parametrize("K", [2, 4])
def test_softmax_collapse_update_replays_the_reference_bit_for_bit(K):
    ref, got = _replay("softmax", K)
    differ = int(np.sum(got != ref))
    assert differ == 0, f"{differ} of {ref.size} margins differ from the reference's"


@pytest.mark.parametrize("K", [2, 4])
def test_squared_collapse_update_replays_the_reference_bit_for_bit(K):
    """The reference's squared collapsed update is one fused multiply-add
    (its K = 1 update as well, which K-H takes as one FMA too since every
    step runs on the collapse kernel): the collapse mode's plain version
    replays it bit for bit, as does the collapse sum through
    ``metrics.fma``; rounding twice misses rows."""
    ref, plain = _replay("squared", K)
    assert int(np.sum(plain != ref)) == 0
    _, fused = _replay("squared", K, fused_squared=True)
    np.testing.assert_array_equal(fused, ref)
    _, two = _replay("squared", K, fused_squared=False)
    assert int(np.sum(two != ref)) > 0


def test_collapse_leaf_sum_order():
    """Powers of two halve pairwise (k with k + K / 2), other K sum in
    order: at K = 4, (l0 + l2) + (l1 + l3)."""
    v = torch.tensor([[1.0, 2.0 ** -24, -1.0, 2.0 ** -24]], dtype=torch.float32)[..., None]
    assert PT.collapse_leaf_sum(v).item() == np.float32(2.0 ** -23)
    seq = torch.tensor([[1.0, 2.0 ** -24, 2.0 ** -24]], dtype=torch.float32)[..., None]
    assert PT.collapse_leaf_sum(seq).item() == np.float32(1.0)


def test_collapse_mode_checks_its_shapes():
    F = torch.zeros((2, 5))
    y, w, eta = torch.zeros(5), torch.ones((2, 5)), torch.full((2,), 0.3)
    rw = torch.ones((3, 5))
    with pytest.raises(ValueError, match=r"leaf must be float32\[6, P\]"):
        PT.boost_step(F, y, w, eta, torch.zeros((2, 7)), torch.zeros((2, 5), dtype=torch.int32),
                      None, "logistic", rw)
    with pytest.raises(ValueError, match=r"ghw must be float32\[6, 5, 2\]"):
        PT.boost_step(F, y, w, eta, None, None, torch.zeros((2, 5, 2)), "logistic", rw)
    with pytest.raises(ValueError, match=r"rw must be float32\[K, 5\]"):
        PT.boost_step(F, y, w, eta, None, None, None, "logistic", torch.ones((3, 4)))
