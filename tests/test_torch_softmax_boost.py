"""Softmax boosting (K-R and the boosting loops over it) on the port against the JAX
package's, on the CPU.

- ``softmax_boost_step_plain`` (K-R's plain version) against the
  reference's margin update and ``_grad_hess("softmax")`` at k = 3 and 5:
  the update bit for bit (a fused multiply-add, as XLA contracts it, but
  on one channel of three at k = 3, which XLA rounds twice); the gradients within 2.4e-7
  (``GRAD_ATOL``: the host's ``exp`` and XLA's differ in the last bit of a
  probability on a few percent of the rows); the hessian bit for bit given
  the reference's probabilities (``softmax_hessian``: XLA's CPU code
  computes ``(p * (1 - p)).mean(-1)`` as one rounded product, fused
  multiply-adds in channel order and a product by float32(1 / k); a plain
  float32 sum and division differ on about a third of the rows).
- ``fit_gbt`` and ``fit_gbt_batch`` with the softmax loss against the
  reference's on small frames: the first round's tree bit for bit at k =
  4 (p = 1/4: dyadic gradients and hessian, so K-E's fixed-point sums are
  XLA's float32 sums exactly), margins within ``MARGIN_ATOL`` after
  several rounds at k = 3.
- the multiclass plan's softmax "gbt" fragment: spec and blob equal to the
  JAX package's; and a cut Iris boosting sweep through ``run_sweep``: every
  fold Error equal.
- on the CPU the wrappers take the plain path, and the entry points
  without ``device`` raise and name ``device="cpu"``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.evaluators import Evaluators as JE
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification.trees import OpGBTClassifier as JGBT
from transmogrifai_tpu.impl.classification.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.ops import trees as JT

from transmogrifai_tpu_torch.apps import iris as PI
from transmogrifai_tpu_torch.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.classification.trees import OpGBTClassifier as PGBT
from transmogrifai_tpu_torch.impl.classification.trees import OpXGBoostClassifier as PXGB
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

#: K-R's gradients against the reference's: 2 ulp of 1.0 (exp differs)
GRAD_ATOL = 2.4e-7
#: boosted margins after several rounds: leaf values from fixed-point
#: against float32 histogram sums, added over the rounds
MARGIN_ATOL = 2e-6


def _step_case(k, seed=0, T=3, n=4000, P=15):
    rng = np.random.default_rng(seed)
    F = (rng.standard_normal((T, n, k)) * 2).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.float32)
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    eta = np.array([0.3, 0.02, 1.0][:T], np.float32)
    leaf = rng.standard_normal((T, P, k)).astype(np.float32)
    node = rng.integers(0, P, (T, n)).astype(np.int32)
    return F, y, w, eta, leaf, node


@pytest.mark.parametrize("k", [3, 5])
def test_softmax_boost_step_plain_matches_the_reference(k):
    F0, y, w, eta, leaf, node = _step_case(k)
    T, n = w.shape
    F = torch.from_numpy(F0.copy())
    ghw = torch.empty((T, n, k + 1))
    PT.softmax_boost_step(F, torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(eta),
                          torch.from_numpy(leaf), torch.from_numpy(node), ghw)
    upd = jax.jit(lambda F, lv, nd, e: F + e[:, None, None] * jnp.take_along_axis(
        lv, nd[..., None].repeat(lv.shape[2], axis=2), axis=1))
    Fj = upd(jnp.asarray(F0), jnp.asarray(leaf), jnp.asarray(node), jnp.asarray(eta))
    # XLA contracts the update into fused multiply-adds, but at k = 3 for one
    # channel of the three, which it rounds twice: that channel's last bit
    same = (F.numpy() == np.asarray(Fj)).all(axis=(0, 1))
    assert same.sum() >= k - (k == 3), same
    np.testing.assert_allclose(F.numpy(), np.asarray(Fj), rtol=2e-7, atol=0)
    Y = jax.nn.one_hot(y.astype(np.int32), k, dtype=jnp.float32)
    grad_hess = jax.jit(lambda F: JT._grad_hess("softmax", F, jnp.asarray(y), Y))
    for t in range(T):
        g, h = grad_hess(Fj[t])
        np.testing.assert_allclose(ghw[t, :, :k].numpy(), np.asarray(g) * w[t][:, None],
                                   rtol=0, atol=GRAD_ATOL * 2)
        np.testing.assert_allclose(ghw[t, :, k].numpy(), np.asarray(h) * w[t], rtol=0,
                                   atol=GRAD_ATOL * 2)


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_softmax_hessian_is_bit_equal_given_the_references_probabilities(k):
    rng = np.random.default_rng(k)
    F = (rng.standard_normal((20000, k)) * 3).astype(np.float32)
    y = rng.integers(0, k, 20000).astype(np.float32)
    Y = jax.nn.one_hot(y.astype(np.int32), k, dtype=jnp.float32)
    _, h = jax.jit(lambda F: JT._grad_hess("softmax", F, jnp.asarray(y), Y))(jnp.asarray(F))
    p = np.asarray(jax.jit(lambda F: jax.nn.softmax(F, axis=-1))(jnp.asarray(F)))
    np.testing.assert_array_equal(PT.softmax_hessian(torch.from_numpy(p.copy())).numpy(),
                                  np.asarray(h))


def test_softmax_boost_step_refuses_what_it_cannot_take():
    F0, y, w, eta, leaf, node = _step_case(3, n=50)
    args = (torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(eta))
    with pytest.raises(ValueError, match="2 <= k <= 128"):
        PT.softmax_boost_step(torch.zeros((3, 50, 129)), *args)
    with pytest.raises(ValueError, match="ghw must be"):
        PT.softmax_boost_step(torch.from_numpy(F0), *args, ghw=torch.empty((3, 50, 3)))
    with pytest.raises(ValueError, match="leaf must be"):
        PT.softmax_boost_step(torch.from_numpy(F0), *args, torch.from_numpy(leaf[..., :2]),
                              torch.from_numpy(node))
    before = PT.softmax_boost_step.launches
    PT.softmax_boost_step(torch.from_numpy(F0), *args, ghw=torch.empty((3, 50, 4)))
    assert PT.softmax_boost_step.launches == before  # CPU tensors: the plain version


def _frame(k, n=240, d=5, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = ((X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int) * (k - 2)
         + rng.integers(0, 2, n)) % k
    Xb = np.asarray(JT.quantize(jnp.asarray(X), 16)[0])
    return Xb, y.astype(np.float32)


def test_first_softmax_round_is_bit_equal_at_dyadic_gradients():
    """k = 4: p = 1/4 on every row, so the gradients (-3/4 or 1/4) and the
    hessian (3/16) are dyadic and the histogram sums exact in both."""
    k = 4
    Xb, y = _frame(k)
    n, d = Xb.shape
    ones_r, ones_f = np.ones((1, n), np.float32), np.ones((1, d), np.float32)
    w = np.ones(n, np.float32)
    jt, jF = JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(ones_r),
                        jnp.asarray(ones_f), "softmax", 1, 3, 16, 8, eta=0.3, n_classes=k)
    pt, pF = PT.fit_gbt(torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(w),
                        torch.from_numpy(ones_r), torch.from_numpy(ones_f), "softmax", 1, 3,
                        16, 8, eta=0.3, n_classes=k)
    for name in ("split_feat", "split_bin", "left", "right"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(jt, name)))
    np.testing.assert_array_equal(pt.leaf_val.numpy(), np.asarray(jt.leaf_val))
    np.testing.assert_array_equal(pF.numpy(), np.asarray(jF))
    assert pF.shape == (n, k) and pt.leaf_val.shape[-1] == k


@pytest.mark.parametrize("batch", [False, True])
def test_softmax_boosting_matches_the_reference(batch):
    """k = 3, four rounds of depth 3 (the batch: two folds x two
    hyperparameter points): margins within ``MARGIN_ATOL``."""
    k = 3
    Xb, y = _frame(k, seed=5)
    n, d = Xb.shape
    R = 4
    rng = np.random.default_rng(6)
    rw = (rng.random((R, n)) < 0.8).astype(np.float32)
    fm = np.ones((R, d), np.float32)
    if not batch:
        w = np.ones(n, np.float32)
        jt, jF = JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(rw),
                            jnp.asarray(fm), "softmax", R, 3, 16, 8, eta=0.3,
                            min_child_weight=1.0, n_classes=k)
        pt, pF = PT.fit_gbt(torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(w),
                            torch.from_numpy(rw), torch.from_numpy(fm), "softmax", R, 3, 16, 8,
                            eta=0.3, min_child_weight=1.0, n_classes=k)
        np.testing.assert_allclose(pF.numpy(), np.asarray(jF), rtol=0, atol=MARGIN_ATOL)
        assert pt.leaf_val.shape == (R,) + tuple(np.asarray(jt.leaf_val).shape[1:])
        return
    tw = np.ones((2, n), np.float32)
    tw[0, :80], tw[1, 80:160] = 0.0, 0.0
    w_b = np.repeat(tw, 2, axis=0)
    eta = np.array([0.3, 0.1, 0.3, 0.1], np.float32)
    lam = np.ones(4, np.float32)
    gam = np.zeros(4, np.float32)
    mcw = np.array([1.0, 5.0, 1.0, 5.0], np.float32)
    Fj = JT.fit_gbt_batch(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w_b), jnp.asarray(rw),
                          jnp.asarray(fm), "softmax", R, 3, 16, 8, eta, lam, gam, mcw,
                          n_classes=k)
    Fp = PT.fit_gbt_batch(torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(w_b),
                          torch.from_numpy(rw), torch.from_numpy(fm), "softmax", R, 3, 16, 8,
                          eta, lam, gam, mcw, n_classes=k)
    assert Fp.shape == (4, n, k)
    np.testing.assert_allclose(Fp.numpy(), np.asarray(Fj), rtol=0, atol=MARGIN_ATOL)


def _boost_candidates(pkg, rounds=3):
    GBT, XGB = (JGBT, JXGB) if pkg == "jax" else (PGBT, PXGB)
    return [(GBT(), [{"max_depth": 3, "min_instances_per_node": m, "max_iter": rounds}
                     for m in (1, 10)]),
            (XGB(), [{"num_round": rounds, "max_depth": 3, "min_child_weight": m, "eta": 0.3}
                     for m in (1.0, 10.0)])]


@pytest.fixture(scope="module")
def iris_plans():
    """Both packages' plans of a cut boosting space on the Iris flow's own
    sweep inputs (the stock fixture's: 135 rows after ``DataCutter``, its
    stratified folds)."""
    from transmogrifai_tpu_torch import fixtures as FX

    sweep = FX.load_sweep(FX.IRIS_STOCK + "/sweep.npz")
    X, y, tw, vm = (sweep[k] for k in ("X", "y", "train_w", "val_mask"))
    jplan = JSF.build_sweep_plan(_boost_candidates("jax"), X, y, tw,
                                 JE.MultiClassification.error())
    pplan = PSF.build_sweep_plan(_boost_candidates("port"), torch.from_numpy(X), y, tw,
                                 PE.MultiClassification.error())
    return tw, vm.astype(np.float32), jplan, pplan


def test_softmax_gbt_fragment_spec_and_blob_equal_the_jax_packages(iris_plans):
    _, _, jplan, pplan = iris_plans
    assert pplan.spec == jplan.spec
    assert [f[:3] for f in pplan.spec[1]] == [("gbt", "softmax", 3)] * 2
    np.testing.assert_array_equal(pplan.blob, np.asarray(jplan.blob))
    for a, b in zip(pplan.xbs, jplan.xbs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cut_iris_boosting_sweep_fold_errors_equal_the_jax_packages(iris_plans):
    tw, vm, jplan, pplan = iris_plans
    want = np.asarray(jplan.run(tw, vm))
    got = pplan.run(tw, vm)
    assert got.shape == want.shape == (3, 4, 4)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])  # Error
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[..., 3].min() < 0.2  # the boosted models learned the classes


def test_iris_entry_point_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is available")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PI.train_iris(models_and_parameters=[(PXGB(), [{"num_round": 2}])])


def test_min_child_weight_boundary_is_a_stated_gap():
    """Where a child's hessian sum lands within float32 rounding of
    ``min_child_weight``, K-E's exact fixed-point sum and XLA's float32 sum
    can fall on either side of it, and the split is taken in one package
    only.  The softmax's first round makes it easy to meet: p = 1/3 on
    every row, so every row's hessian is the same 0.22222221, and 45 rows
    sum to 9.9999994 exactly but to 10.000003 in float32 order, against
    min_child_weight 10.  (On random folds of the 150-row Iris frame the
    GBT and XGB candidates at min_child_weight 10 move their margins by up
    to 0.98 for that reason; on the Iris flow's own folds every fold Error
    stays equal, above.)"""
    h = PT.softmax_hessian(torch.full((1, 3), 1.0 / 3.0))[0]
    Y = jax.nn.one_hot(jnp.zeros(1, jnp.int32), 3, dtype=jnp.float32)
    assert float(h) == float(JT._grad_hess("softmax", jnp.zeros((1, 3)), jnp.zeros(1), Y)[1][0])
    exact = float(h) * 45
    running = np.float32(0.0)
    for _ in range(45):
        running = np.float32(running + np.float32(h))
    assert exact < 10.0 <= float(running)
