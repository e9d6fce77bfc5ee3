"""The port's fused sweep and its three kernels' plain versions against the
JAX package, on the CPU, at small sizes.

- K-K (``ops/linear.py``): the batched FISTA logistic fits against
  ``fit_logistic_grid_folds_fista`` (coefficients within ``COEF_ATOL``:
  float32 sums in another order than XLA's over 200 steps).
- K-L (``ops/metrics.py``): the binary metrics against
  ``_binary_grid_metrics`` on ``tests/test_device_metrics.py``'s cases
  (ties, one class, an empty fold, the strict flag): the count-based
  metrics and AuROC equal, AuPR within ``AUPR_ATOL`` (the port sums the
  AuPR steps exactly and rounds once; XLA sums them in float32).
- K-M (``ops/trees.py::forest_leaf_mean``): bit-equal to the reference's
  ``take_along_axis`` + ``mean`` over the trees (at the tree counts where
  ``MEAN_WINDOW`` is XLA's order: the stock forests' 50, the cut slice's 5).
- The forests (``grow_forest``, ``fit_forest_chunked``): trees and row
  leaves bit-equal to the JAX package's on its own draws (the weights are
  integers, so every histogram sum is exact).
- The spec: ``build_sweep_plan``'s spec, blob and binned matrices equal the
  JAX package's for the stock binary space; ``run_sweep`` on a cut space
  gives the JAX package's metrics (AuPR within ``AUPR_ATOL``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import Evaluators as JE
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
from transmogrifai_tpu.impl.classification.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.impl.selector.factories import BinaryClassificationModelSelector as JB
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.tuning import validators as JV
from transmogrifai_tpu.ops import linear as JL
from transmogrifai_tpu.ops import trees as JT
from transmogrifai_tpu.ops.metrics import _binary_grid_metrics

from transmogrifai_tpu_torch.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.impl.classification.trees import OpRandomForestClassifier as PRF
from transmogrifai_tpu_torch.impl.selector.factories import BinaryClassificationModelSelector as PB
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.tuning import validators as PV
from transmogrifai_tpu_torch.ops import linear as PL
from transmogrifai_tpu_torch.ops import metrics as PM
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

#: FISTA coefficients: float32 gradient sums in another order than XLA's
COEF_ATOL = 2e-5
#: AuPR: the port's exact sum of the steps against XLA's float32 sum (a
#: few ulps of the result)
AUPR_ATOL = 2.5e-7


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 1] = rng.integers(0, 3, n)
    y = ((X[:, 0] + 0.5 * X[:, 2] + rng.normal(size=n)) > 0.2).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# K-K: the FISTA fits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_fista_grid_folds_match_jax(fit_intercept):
    X, y = _data(400, 6)
    rng = np.random.default_rng(1)
    tw = (rng.random((2, 400)) < 0.7).astype(np.float32)
    tw[1] *= rng.integers(1, 4, 400)                      # integer fold weights
    l1 = np.array([0.001, 0.005, 0.05], np.float32)
    l2 = np.array([0.009, 0.005, 0.05], np.float32)
    want = JL.fit_logistic_grid_folds_fista(X, y, tw, l1, l2, max_iter=200,
                                            fit_intercept=fit_intercept)
    got = PL.fit_logistic_grid_folds_fista(torch.from_numpy(X), torch.from_numpy(y),
                                           torch.from_numpy(tw), l1, l2, max_iter=200,
                                           fit_intercept=fit_intercept)
    assert tuple(got.coef.shape) == (2, 3, 6) and tuple(got.intercept.shape) == (2, 3, 1)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(got.intercept.numpy(), np.asarray(want.intercept), rtol=0,
                               atol=COEF_ATOL)


def test_fista_single_fit_and_estimator_match_jax():
    X, y = _data(300, 5, seed=3)
    w = np.ones(300, np.float32)
    want = JL.fit_logistic_fista(X, y, w, 0.01 * 0.1, 0.01 * 0.9, max_iter=200)
    got = PL.fit_logistic_fista(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
                                0.01 * 0.1, 0.01 * 0.9, max_iter=200)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), atol=COEF_ATOL, rtol=0)
    jp = JLR(reg_param=0.01, elastic_net_param=0.1, max_iter=50).fit_arrays(X, y)
    pest = PLR(reg_param=0.01, elastic_net_param=0.1, max_iter=50).to("cpu")
    pp = pest.fit_arrays(torch.from_numpy(X), y)
    assert pp["coef"].shape == jp["coef"].shape and pp["intercept"].shape == jp["intercept"].shape
    assert pp["coef"].dtype == jp["coef"].dtype == np.float32
    np.testing.assert_allclose(pp["coef"], jp["coef"], atol=COEF_ATOL, rtol=0)
    assert {k: pp[k] for k in ("num_classes", "multinomial")} == \
        {k: jp[k] for k in ("num_classes", "multinomial")}


def test_fista_grad_plain_is_the_gradient():
    X, y = _data(200, 4, seed=5)
    X1 = np.concatenate([X, np.ones((200, 1), np.float32)], 1)
    w = np.stack([np.ones(200), (np.arange(200) % 3 == 0)]).astype(np.float32)
    z = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32)
    fold = np.array([0, 1, 1], np.int32)
    l2v = np.full((3, 5), 0.02, np.float32)
    l2v[:, -1] = 0.0
    wsum = w.sum(1)[fold]
    got = PL.fista_grad(*(torch.from_numpy(a) for a in (X1, y, w, fold, z, l2v, wsum))).numpy()
    X64 = X1.astype(np.float64)
    for c in range(3):
        p = 1.0 / (1.0 + np.exp(-(X64 @ z[c])))
        ref = X64.T @ (w[fold[c]] * (p - y)) / wsum[c] + l2v[c] * z[c]
        np.testing.assert_allclose(got[c], ref, rtol=1e-5, atol=1e-6)


def test_pure_l2_and_multinomial_fits_raise():
    """Neither raises now: the binary pure-L2 fit is Newton's (K-S), as the
    JAX package's; the multinomial fit is ported (K-P) and fits a [d, k]
    coefficient matrix."""
    X, y = _data(50, 3)
    got = PLR(reg_param=0.1, elastic_net_param=0.0).to("cpu").fit_arrays(torch.from_numpy(X), y)
    want = JLR(reg_param=0.1, elastic_net_param=0.0).fit_arrays(X, y)
    np.testing.assert_allclose(got["coef"], np.asarray(want["coef"]), rtol=1e-5, atol=1e-6)
    assert not got["multinomial"]
    params = PLR(reg_param=0.1, elastic_net_param=0.5).to("cpu").fit_arrays(
        torch.from_numpy(X), np.arange(50) % 3)
    assert params["multinomial"] and params["num_classes"] == 3
    assert params["coef"].shape == (3, 3) and params["intercept"].shape == (3,)


# ---------------------------------------------------------------------------
# K-L: the binary metrics
# ---------------------------------------------------------------------------
def _metric_case(name):
    rng = np.random.default_rng(0)
    if name == "ties":               # test_device_metrics.py's binary case
        n, F, C = 257, 3, 5
        y = rng.integers(0, 2, n).astype(np.float32)
        scores = np.round(rng.random((F, C, n)), 2).astype(np.float32)
        vm = (rng.random((F, n)) > 0.35).astype(np.float32)
        return y, scores, vm, np.array([0, 1, 0, 1, 0], np.float32)
    if name == "one_class":          # every validation row positive
        n = 64
        return (np.ones(n, np.float32), rng.random((1, 2, n)).astype(np.float32),
                np.ones((1, n), np.float32), np.zeros(2, np.float32))
    if name == "negatives_only":
        n = 64
        return (np.zeros(n, np.float32), rng.random((1, 1, n)).astype(np.float32),
                np.ones((1, n), np.float32), np.zeros(1, np.float32))
    if name == "empty_fold":         # a fold with no validation rows
        n = 90
        vm = (rng.random((2, n)) < 0.4).astype(np.float32)
        vm[1] = 0.0
        return (rng.integers(0, 2, n).astype(np.float32), rng.random((2, 3, n)).astype(np.float32),
                vm, np.array([1, 0, 1], np.float32))
    if name == "strict_at_half":     # scores exactly 0.5 decide by the strict flag
        n = 120
        s = np.full((1, 2, n), 0.5, np.float32)
        s[:, :, ::3] = 0.75
        s[:, :, 1::7] = 0.25
        return rng.integers(0, 2, n).astype(np.float32), s, np.ones((1, n), np.float32), \
            np.array([0, 1], np.float32)
    n = 2500                         # many rows, few ties
    return (rng.integers(0, 2, n).astype(np.float32), rng.random((1, 4, n)).astype(np.float32),
            (rng.random((1, n)) < 0.33).astype(np.float32), np.array([0, 0, 1, 1], np.float32))


@pytest.mark.parametrize("name", ["ties", "one_class", "negatives_only", "empty_fold",
                                  "strict_at_half", "large"])
def test_binary_metrics_match_jax(name):
    y, scores, vm, strict = _metric_case(name)
    want = np.asarray(_binary_grid_metrics(y, scores, vm, strict))
    got = PM.binary_grid_metrics(torch.from_numpy(y), torch.from_numpy(scores),
                                 torch.from_numpy(vm), strict).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    for i, m in enumerate(PM.BINARY_METRICS):
        if m == "AuPR":
            np.testing.assert_allclose(got[..., i], want[..., i], rtol=0, atol=AUPR_ATOL)
        else:
            np.testing.assert_array_equal(got[..., i], want[..., i], err_msg=m)


def test_binary_metrics_kernel_inputs_are_checked():
    y, scores, vm, strict = _metric_case("ties")
    with pytest.raises(ValueError, match="0/1"):
        PM.binary_grid_metrics(torch.from_numpy(y), torch.from_numpy(scores),
                               torch.from_numpy(vm * 0.5), strict)
    ss, order = PM.sort_scores(torch.from_numpy(scores), torch.from_numpy(vm))
    with pytest.raises(ValueError, match="strict"):
        PM.binary_metrics(ss, order, torch.from_numpy(y), torch.from_numpy(vm),
                          torch.zeros(5, dtype=torch.int64), 5)


# ---------------------------------------------------------------------------
# K-M and the forests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [5, 16, 50, 64, 300])
def test_forest_leaf_mean_matches_jax_mean(T):
    rng = np.random.default_rng(T)
    G, P, n = 3, 40, 500
    leaf = (rng.integers(0, 90, (G * T, P)) / rng.integers(1, 97, (G * T, P))).astype(np.float32)
    node = rng.integers(0, P, (G * T, n)).astype(np.int32)

    @jax.jit
    def ref(lv, rn):   # ops/sweep.py:259-264: take_along_axis, then the tree mean
        preds = jnp.take_along_axis(lv[:, :, None], rn[:, :, None], axis=1)
        return preds.reshape(1, G, T, n, -1).mean(axis=2)[0, :, :, 0]

    want = np.asarray(ref(leaf, node))
    got = PT.forest_leaf_mean(torch.from_numpy(leaf).reshape(G, T, P),
                              torch.from_numpy(node).reshape(G, T, n)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def forest_inputs():
    X, y = _data(300, 8, seed=7)
    Xb, _ = JT.quantize(X, 32)
    kb, kf = JT.rng_keys(42)
    T = 12
    boot = np.asarray(JT.bootstrap_weights(kb, 300, T))
    fm = np.asarray(JT.feature_masks(kf, 8, T, np.sqrt(8) / 8))
    tw = (np.random.default_rng(8).random(300) < 0.7).astype(np.float32)
    return np.array(Xb), y, boot * tw[None], fm


@pytest.mark.parametrize("depth,mcw,mig,exact", [(3, 10.0, 0.001, True), (6, 1.0, 0.01, False),
                                                 (9, 10.0, 0.1, True)])
def test_forest_group_trees_match_jax(forest_inputs, depth, mcw, mig, exact):
    Xb, y, wt, fm = forest_inputs
    T = wt.shape[0]
    fr = JT.frontier_cap(300, depth, mcw, 1.0, 256, total_weight=float(wt.sum(1).max()))
    mcw_t = np.full(T, mcw, np.float32)
    mcw_t[::3] = 100.0                                   # per-tree hyperparameters
    grow = jax.jit(lambda *a: JT.grow_forest(*a[:5], depth, 32, fr, reg_lambda_t=a[5],
                                             gamma_t=a[6], mcw_t=a[7], mig_t=a[8],
                                             exact_cap=exact, return_row_node=True))
    jt, jn = grow(Xb, -y[:, None], np.ones(300, np.float32), wt, fm,
                  np.full(T, 1e-6, np.float32), np.zeros(T, np.float32), mcw_t,
                  np.full(T, mig, np.float32))
    pt = PT.fit_forest_chunked(torch.from_numpy(Xb), torch.from_numpy(-y[:, None]),
                               torch.ones(300), torch.from_numpy(wt), torch.from_numpy(fm),
                               mcw_t, depth, 32, 5, fr, mig_trees=np.full(T, mig, np.float32),
                               exact_cap=exact)
    for k in jt._fields:
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(getattr(jt, k)), k)
    _, pn = PT.grow_forest(torch.from_numpy(Xb), torch.from_numpy(-y[:, None]), torch.ones(300),
                           torch.from_numpy(wt), torch.from_numpy(fm), depth, 32, fr,
                           np.full(T, 1e-6, np.float32), np.zeros(T, np.float32), mcw_t,
                           np.full(T, mig, np.float32), exact_cap=exact, return_row_node=True)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))


def test_random_forest_fit_arrays_matches_jax():
    X, y = _data(250, 6, seed=9)
    w = np.random.default_rng(4).integers(0, 3, 250).astype(np.float32)
    grid = dict(num_trees=7, max_depth=4, min_instances_per_node=5, min_info_gain=0.01)
    jp = JRF(**grid).fit_arrays(X, y, w)
    pp = PRF(**grid).to("cpu").fit_arrays(torch.from_numpy(X), y, w)
    assert sorted(pp) == sorted(jp)
    for k in ("split_feat", "split_bin", "left", "right", "leaf_val", "edges"):
        assert pp[k].dtype == jp[k].dtype, k
        np.testing.assert_array_equal(pp[k], jp[k], k)
    assert {k: pp[k] for k in ("max_depth", "num_classes", "num_trees")} == \
        {k: jp[k] for k in ("max_depth", "num_classes", "num_trees")}


@pytest.mark.parametrize("args", [(3, 32, 10, 1, 8, 3e9, 891), (12, 32, 10, 1, 128, 3e9, 262144),
                                  (6, 64, 23, 1, 64, 1e9, 5000)])
def test_forest_chunk_sizing_matches_jax(args):
    assert PT.forest_chunk_size(*args[:5], budget_bytes=args[5], n_rows=args[6]) == \
        JT.forest_chunk_size(*args[:5], budget_bytes=args[5], n_rows=args[6])
    for total in (1, 300, 301, 5000):
        assert PT.balanced_chunk(total, 37) == JT.balanced_chunk(total, 37)


# ---------------------------------------------------------------------------
# The spec and the sweep
# ---------------------------------------------------------------------------
def test_stock_spec_equals_jax():
    X, y = _data(891, 10, seed=11)
    tw = (np.random.default_rng(12).random((1, 891)) < 0.67).astype(np.float32)
    jp = JSF.build_sweep_plan(JB._default_models(), X, y, tw, JE.BinaryClassification.auPR())
    pp = PSF.build_sweep_plan(PB._default_models(), torch.from_numpy(X), y, tw,
                              PE.BinaryClassification.auPR())
    assert pp.spec == jp.spec
    assert [f[0] for f in pp.spec[1]] == ["fista", "forest", "gbt"]
    np.testing.assert_array_equal(pp.blob, jp.blob)
    assert len(pp.xbs) == len(jp.xbs) == 1 and pp.xb_bins == jp.xb_bins == (32,)
    np.testing.assert_array_equal(pp.xbs[0].numpy(), np.asarray(jp.xbs[0]))
    assert PSF._poisson_bound(594.0, 1.0, 3.0) == JSF._poisson_bound(594.0, 1.0, 3.0)


def test_unfusable_candidates_build_no_plan():
    X, y = _data(100, 4)
    tw = np.ones((1, 100), np.float32)
    ev = PE.BinaryClassification.auPR()
    Xt = torch.from_numpy(X)
    # a pure-L2 point fuses now, as the JAX package's "newton" fragment
    newton = PSF.build_sweep_plan([(PLR(), [{"reg_param": 0.1}])], Xt, y, tw, ev)
    assert [f[0] for f in newton.spec[1]] == ["newton"]
    assert PSF.build_sweep_plan([(PLR(), [{"tol": 1e-3}])], Xt, y, tw, ev) is None
    assert PSF.build_sweep_plan([(PRF(), [{"seed": 3}])], Xt, y, tw, ev) is None
    assert PSF.build_sweep_plan([(PRF(), [{}])], Xt, np.arange(100) % 3, tw, ev) is None

    class MyForest(PRF):
        pass

    assert PSF.build_sweep_plan([(MyForest(), [{}])], Xt, y, tw, ev) is None
    assert PSF.build_sweep_plan([(PRF(), [{}])], Xt, y, tw, ev) is not None


def test_candidate_chunks_match_jax():
    cands = [("a", [{"i": i} for i in range(8)]), ("b", [{"j": j} for j in range(18)]),
             ("c", [])]
    for k in (1, 5, 8, 26, 100):
        assert PV._chunk_candidates(cands, k) == JV._chunk_candidates(cands, k)


def test_run_sweep_matches_jax():
    """LR (as stocked) and two RF groups (5 trees) through both interpreters."""
    X, y = _data(400, 7, seed=13)
    rng = np.random.default_rng(14)
    tw = (rng.random((2, 400)) < 0.67).astype(np.float32)
    vm = 1.0 - tw
    rf_grid = [{"max_depth": dd, "min_instances_per_node": m, "num_trees": 5}
               for dd in (3, 6) for m in (10, 100)]
    lr_grid = [{"reg_param": r, "elastic_net_param": a} for r in (0.001, 0.1) for a in (0.1, 0.5)]
    jp = JSF.build_sweep_plan([(JLR(max_iter=50), lr_grid), (JRF(), rf_grid)], X, y, tw,
                              JE.BinaryClassification.auPR())
    pp = PSF.build_sweep_plan([(PLR(max_iter=50), lr_grid), (PRF(), rf_grid)],
                              torch.from_numpy(X), y, tw, PE.BinaryClassification.auPR())
    assert pp.spec == jp.spec
    want = jp.run(tw, vm)
    timings = {}
    got = pp.run(tw, vm, timings=timings)
    assert got.shape == want.shape == (2, 8, 6)
    assert set(timings) == {"fista", "forest", "metrics"}
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0, atol=AUPR_ATOL)
    # the forests' scores are bit-equal, so every metric of them is too
    np.testing.assert_array_equal(got[:, 4:, [0, 2, 3, 4, 5]], want[:, 4:, [0, 2, 3, 4, 5]])
