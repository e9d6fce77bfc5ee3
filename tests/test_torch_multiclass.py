"""The port's multiclass modules and their kernels' plain versions against
the JAX package, on the CPU, at small sizes.

- K-P (``ops/linear.py::softmax_fista_grad``): the plain gradient against
  the first step of the JAX package's ``fit_softmax`` and against its body's
  formula at random coefficients (within ``GRAD_RTOL`` of the largest
  entry: float32 products in another order); the batched softmax fits
  against ``fit_softmax_grid_folds`` (``COEF_ATOL``) and their class
  probabilities.
- K-Q (``ops/metrics.py::multiclass_grid_metrics``): bit-equal to
  ``_multiclass_grid_metrics`` on 0/1 masks, with tied probabilities.
- K-E / K-F over c = 3 class channels (``ops/trees.py::grow_forest`` on
  -onehot gradients and integer bootstrap weights): node pools, leaves and
  the rows' nodes bit-equal to the JAX package's ``grow_forest`` at depth 3,
  6 and 12.
- K-M over channels (``forest_leaf_mean`` at T = 50, c = 3): bit-equal to
  the reference's tree mean.
- ``DataCutter``, ``OpMultiClassificationEvaluator`` (``ThresholdMetrics``
  included), the stratified folds over three classes, the multiclass sweep
  plan's spec and blob, one multiclass forest group through the
  interpreter, and the multiclass estimators' fits and per-family sweep:
  equal to the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import Evaluators as JE
from transmogrifai_tpu.evaluators.classification import OpMultiClassificationEvaluator as JMEval
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
from transmogrifai_tpu.impl.classification.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.impl.selector import factories as JFac
from transmogrifai_tpu.impl.tuning.splitters import DataCutter as JCutter
from transmogrifai_tpu.ops import linear as JL
from transmogrifai_tpu.ops import sweep as JSW
from transmogrifai_tpu.ops import trees as JT
from transmogrifai_tpu.ops.metrics import _multiclass_grid_metrics
from transmogrifai_tpu.parallel.sweep import make_fold_weights as jax_fold_weights

from transmogrifai_tpu_torch.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.evaluators.classification import \
    OpMultiClassificationEvaluator as PMEval
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.impl.classification.trees import OpRandomForestClassifier as PRF
from transmogrifai_tpu_torch.impl.selector import factories as PFac
from transmogrifai_tpu_torch.impl.tuning.splitters import DataCutter as PCutter
from transmogrifai_tpu_torch.impl.tuning.validators import OpCrossValidation as PCV
from transmogrifai_tpu_torch.ops import linear as PL
from transmogrifai_tpu_torch.ops import metrics as PM
from transmogrifai_tpu_torch.ops import sweep as PSW
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

#: the plain K-P gradient against the reference's, relative to the largest
#: entry: float32 products summed in another order
GRAD_RTOL = 1e-6
#: the softmax fits' coefficients after 50 steps (measured 1.6e-6 at |B| 0.6)
COEF_ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


def _data(n=135, d=8, k=3, seed=0):
    """Iris-like clusters: k Gaussian classes in d dimensions."""
    rng = np.random.default_rng(seed)
    y = np.repeat(np.arange(k), -(-n // k))[:n]
    X = (rng.normal(size=(n, d)) + y[:, None] * rng.normal(size=d)[None]).astype(np.float32)
    return X, y.astype(np.float32)


# ---------------------------------------------------------------------------
# K-P: the softmax FISTA gradient and the batched fits
# ---------------------------------------------------------------------------
def test_softmax_fista_grad_matches_one_fit_softmax_step():
    """From zero coefficients, ``fit_softmax``'s first FISTA step with no L1
    term is ``B1 = -step * grad(0)``: the plain K-P gradient at 0 gives the
    same step."""
    X, y = _data()
    n, d = X.shape
    k = 3
    w = np.random.default_rng(1).integers(0, 3, n).astype(np.float32)
    l2 = 0.05
    B1 = JL.fit_softmax(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), l2, num_classes=k,
                        max_iter=1)
    B1 = np.concatenate([np.asarray(B1.coef), np.asarray(B1.intercept)[None]])  # [p, k]
    X1 = np.concatenate([X, np.ones((n, 1), np.float32)], 1)
    L = 0.5 * float((X1 * X1 * w[:, None]).sum(dtype=np.float64)) / w.sum() + l2 + 1e-6
    l2m = np.full((1, d + 1, k), l2, np.float32)
    l2m[:, -1] = 0.0
    got = PL.softmax_fista_grad(_t(X1), _t(y), _t(w[None]), torch.zeros(1, dtype=torch.int32),
                                torch.zeros((1, d + 1, k)), _t(l2m),
                                torch.tensor([float(w.sum())])).numpy()[0]
    want = -B1.astype(np.float64) * L  # the step 1 / L rounds once in float32
    assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max()


def test_softmax_fista_grad_matches_the_reference_body():
    rng = np.random.default_rng(2)
    X, y = _data(200, 8, 3, seed=2)
    n, d = X.shape
    X1 = np.concatenate([X, np.ones((n, 1), np.float32)], 1)
    C, F, k = 6, 3, 3
    w = rng.integers(0, 3, (F, n)).astype(np.float32)
    fold = np.arange(C, dtype=np.int32) % F
    z = (0.3 * rng.normal(size=(C, d + 1, k))).astype(np.float32)
    l2m = np.full((C, d + 1, k), 0.02, np.float32)
    l2m[:, -1] = 0.0
    wsum = w.sum(1)[fold]

    @jax.jit
    def body(B, wt, ws, l2):  # ops/linear.py:177-180, fit_softmax's grad_fn
        Y = jax.nn.one_hot(jnp.asarray(y).astype(jnp.int32), k, dtype=jnp.float32)
        mu = jax.nn.softmax(jnp.asarray(X1) @ B, axis=-1)
        return jnp.asarray(X1).T @ (wt[:, None] * (mu - Y)) / ws + l2 * B

    want = np.stack([np.asarray(body(z[c], w[fold[c]], wsum[c], l2m[c])) for c in range(C)])
    got = PL.softmax_fista_grad(*(_t(a) for a in (X1, y, w, fold, z, l2m, wsum))).numpy()
    assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max()


def test_fit_softmax_grid_folds_matches_jax():
    X, y = _data(135, 8, 3, seed=3)
    rng = np.random.default_rng(3)
    tw = (rng.random((3, 135)) < 0.67).astype(np.float32)
    reg = np.array([0.001, 0.01, 0.1, 0.2], np.float32).repeat(2)
    alpha = np.tile(np.array([0.1, 0.5], np.float32), 4)
    l1, l2 = reg * alpha, reg * (1 - alpha)
    jf = JL.fit_softmax_grid_folds(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw),
                                   jnp.asarray(l1), jnp.asarray(l2), num_classes=3, max_iter=50)
    pf = PL.fit_softmax_grid_folds(_t(X), _t(y), _t(tw), l1, l2, num_classes=3, max_iter=50)
    assert pf.coef.shape == (3, 8, 8, 3) and pf.intercept.shape == (3, 8, 3)
    np.testing.assert_allclose(pf.coef.numpy(), np.asarray(jf.coef), rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(pf.intercept.numpy(), np.asarray(jf.intercept), rtol=0,
                               atol=COEF_ATOL)
    # the sweep's scores: the probabilities of the same fits
    jr, jp, jpred = JL.predict_softmax_grid(jnp.asarray(X), jf.coef, jf.intercept)
    pr, pp, ppred = PL.predict_softmax_grid(_t(X), _t(np.asarray(jf.coef)),
                                            _t(np.asarray(jf.intercept)))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ppred.numpy(), np.asarray(jpred))


def test_multinomial_logistic_fit_and_grid_match_jax():
    X, y = _data(90, 5, 3, seed=4)
    w = np.random.default_rng(4).integers(1, 3, 90).astype(np.float32)
    jp = JLR(reg_param=0.01, elastic_net_param=0.5, max_iter=50).fit_arrays(X, y, w)
    pp = PLR(reg_param=0.01, elastic_net_param=0.5, max_iter=50).to("cpu").fit_arrays(
        _t(X), y, w)
    assert {k: pp[k] for k in ("num_classes", "multinomial")} == \
        {k: jp[k] for k in ("num_classes", "multinomial")}
    np.testing.assert_allclose(pp["coef"], jp["coef"], rtol=0, atol=COEF_ATOL)
    pred, raw, prob = PLR.predict_arrays(pp, _t(X))
    jpred, _, jprob = JLR.predict_arrays(jp, X)
    np.testing.assert_allclose(prob, jprob, rtol=0, atol=1e-5)
    tw = (np.random.default_rng(5).random((3, 90)) < 0.67).astype(np.float32)
    grids = [{"reg_param": 0.01, "elastic_net_param": 0.1}, {"reg_param": 0.2}]
    jg = JLR(max_iter=50).fit_grid_folds(X, y, tw, grids)
    pg = PLR(max_iter=50).to("cpu").fit_grid_folds(_t(X), y, tw, grids)
    for f in range(3):
        for c in range(2):
            np.testing.assert_allclose(pg[f][c][2], jg[f][c][2], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# K-Q: the multiclass metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [3, 5])
def test_multiclass_grid_metrics_bit_equal_to_jax(k):
    rng = np.random.default_rng(k)
    F, C, n = 3, 26, 500
    probs = (rng.integers(0, 5, (F, C, n, k)) / 4).astype(np.float32)   # ties
    probs[:, :5] = rng.random((F, 5, n, k)).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.float32)
    vm = (rng.random((F, n)) < 0.33).astype(np.float32)
    vm[2] = 0.0  # an empty fold: nv clamps to 1
    y1 = np.eye(k, dtype=np.float32)[y.astype(int)]
    want = np.asarray(_multiclass_grid_metrics(jnp.asarray(y1), jnp.asarray(probs),
                                               jnp.asarray(vm)))
    got = PM.multiclass_grid_metrics(_t(y), _t(probs), _t(vm)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_multiclass_metrics_refuse_what_they_cannot_count():
    probs = torch.full((1, 1, 4, 3), 0.5)
    with pytest.raises(ValueError, match="class labels"):
        PM.multiclass_grid_metrics(torch.tensor([0.0, 1.0, 3.0, 2.0]), probs, torch.ones(1, 4))
    with pytest.raises(ValueError, match="0/1"):
        PM.multiclass_grid_metrics(torch.zeros(4), probs, torch.full((1, 4), 0.5))
    with pytest.raises(ValueError, match="2 to 8 classes"):
        PM.multiclass_metrics(torch.zeros((1, 4, 9)), torch.zeros(4), torch.ones(1, 4), 1)


# ---------------------------------------------------------------------------
# K-E / K-F / K-M over class channels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("depth,wmax,exact", [(3, 3, True), (6, 3, False), (12, 3, True),
                                              (6, 4000, False)])
def test_grow_forest_over_class_channels_bit_equal_to_jax(depth, wmax, exact):
    """-onehot gradients over three classes with integer weights (Poisson
    bootstrap counts, or large ones whose squared sums round in float32):
    the same trees, leaves and row nodes."""
    rng = np.random.default_rng(depth + wmax)
    n, d, B, k, T = 300, 8, 32, 3, 12
    X, y = _data(n, d, k, seed=depth)
    Xb = np.asarray(JT.quantize(X, B)[0])
    g = -np.eye(k, dtype=np.float32)[y.astype(int)]
    w = rng.integers(0, wmax + 1, (T, n)).astype(np.float32)
    fm = (rng.random((T, d)) < 0.4).astype(np.float32)
    hp = (np.full(T, 1e-6, np.float32), np.zeros(T, np.float32),
          np.tile(np.float32([10, 100, 1]), T // 3), np.tile(np.float32([0.001, 0.01]), T // 2))
    front = PT.frontier_cap(n, depth, 1.0, 1.0, 16, total_weight=float(w.sum(1).max()))
    grow = jax.jit(JT.grow_forest, static_argnums=(5, 6, 7),
                   static_argnames=("exact_cap", "return_row_node"))
    jt, jrn = grow(jnp.asarray(Xb), jnp.asarray(g), jnp.ones(n), jnp.asarray(w),
                   jnp.asarray(fm), depth, B, front, *hp, exact_cap=exact, return_row_node=True)
    pt, prn = PT.grow_forest(_t(Xb), _t(g), torch.ones(n), _t(w), _t(fm), depth, B, front,
                             *hp, exact_cap=exact, return_row_node=True)
    assert pt.leaf_val.shape[-1] == k
    for name, a, b in zip(pt._fields, pt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(prn.numpy(), np.asarray(jrn))


def test_class_channel_limits_raise():
    Xb = torch.zeros((4, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="at most 8 gradient channels"):
        PT.level_hist(Xb, torch.zeros((1, 4, 10)), torch.zeros((1, 4), dtype=torch.int32), 1, 4)
    with pytest.raises(ValueError, match="at most 8 gradient channels"):
        PT.split_scan(torch.zeros((1, 1, 10, 2, 4)), torch.ones((1, 2)), torch.ones((1, 4)),
                      torch.ones(1, dtype=torch.int32), torch.zeros((1, 7, 4), dtype=torch.int32),
                      torch.zeros((1, 7, 9)), 0, 1, 2, PT.CAP_NONE, True)
    with pytest.raises(ValueError, match="1 <= c <= 8"):
        PT.grow_forest(Xb, torch.zeros((4, 9)), torch.ones(4), torch.ones((1, 4)),
                       torch.ones((1, 2)), 2, 4, 4, [1e-6], [0.0], [1.0], [0.0])


def test_forest_leaf_mean_over_class_channels_bit_equal_to_jax():
    rng = np.random.default_rng(50)
    G, T, P, n, c = 4, 50, 40, 300, 3
    leaf = (rng.integers(0, 90, (G * T, P, c)) / rng.integers(1, 97, (G * T, P, c))) \
        .astype(np.float32)
    node = rng.integers(0, P, (G * T, n)).astype(np.int32)

    @jax.jit
    def ref(lv, rn):   # ops/sweep.py:259-270 with c channels
        preds = jnp.take_along_axis(lv, rn[:, :, None].repeat(c, axis=2), axis=1)
        return preds.reshape(1, G, T, n, -1).mean(axis=2)[0]

    want = np.asarray(ref(leaf, node))
    got = PT.forest_leaf_mean(_t(leaf).reshape(G, T, P, c), _t(node).reshape(G, T, n)).numpy()
    assert got.shape == (G, n, c)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# the host modules: DataCutter, the evaluator, the folds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"max_label_categories": 2},
                                {"min_label_fraction": 0.2}])
def test_data_cutter_matches_jax(kw):
    rng = np.random.default_rng(6)
    y = rng.choice([0.0, 1.0, 2.0, 3.0], 200, p=[0.5, 0.3, 0.15, 0.05])
    j, p = JCutter(**kw), PCutter(**kw)
    assert p.pre_validation_prepare(y).to_json() == j.pre_validation_prepare(y).to_json()
    np.testing.assert_array_equal(p.prepare_weights(y), j.prepare_weights(y))
    np.testing.assert_array_equal(p.prepare_indices(y), j.prepare_indices(y))
    np.testing.assert_array_equal(np.concatenate(p.split(200, y)),
                                  np.concatenate(j.split(200, y)))
    with pytest.raises(ValueError, match="min_label_fraction"):
        PCutter(min_label_fraction=0.5)


def test_multiclass_evaluator_matches_jax():
    rng = np.random.default_rng(7)
    n, k = 300, 4
    y = rng.integers(0, k, n).astype(np.float64)
    prob = rng.dirichlet(np.ones(k), n)
    prob[:20] = 1.0 / k  # ties: the first class ranks first
    pred = prob.argmax(1).astype(np.float64)
    y[:5] = 7  # a label the model never predicts
    for ev_p, ev_j in ((PMEval(), JMEval()), (PMEval(top_ns=[2], thresholds=np.linspace(0, 1, 5)),
                                               JMEval(top_ns=[2],
                                                      thresholds=np.linspace(0, 1, 5)))):
        assert ev_p.evaluate_arrays(y, pred, prob) == ev_j.evaluate_arrays(y, pred, prob)
    assert PMEval().evaluate_arrays(y, pred) == JMEval().evaluate_arrays(y, pred)
    for name in ("f1", "precision", "recall", "error"):
        pe, je = getattr(PE.MultiClassification, name)(), getattr(JE.MultiClassification, name)()
        assert (pe.name, pe.default_metric, pe.is_larger_better) == \
            (je.name, je.default_metric, je.is_larger_better)


def test_stratified_folds_over_three_classes_equal_jax():
    y = np.repeat([0.0, 1.0, 2.0], 45)[np.random.default_rng(8).permutation(135)]
    tw, vm = PCV(PE.MultiClassification.error(), num_folds=3, seed=42,
                 stratify=True).make_folds(135, y)
    jtw, jvm = jax_fold_weights(135, 3, seed=42, stratify_labels=y)
    np.testing.assert_array_equal(tw, jtw)
    np.testing.assert_array_equal(vm, np.asarray(jvm) > 0)


# ---------------------------------------------------------------------------
# the plan, the interpreter and the selector
# ---------------------------------------------------------------------------
def _stock_candidates(pkg):
    fac = (PFac if pkg == "port" else JFac).MultiClassificationModelSelector
    return fac._default_models()


@pytest.fixture(scope="module")
def plans():
    X, y = _data(135, 8, 3, seed=9)
    tw = (np.random.default_rng(9).random((3, 135)) < 0.67).astype(np.float32)
    jplan = JSF.build_sweep_plan(_stock_candidates("jax"), X, y, tw,
                                 JE.MultiClassification.error())
    pplan = PSF.build_sweep_plan(_stock_candidates("port"), _t(X), y, tw,
                                 PE.MultiClassification.error())
    return X, y, tw, jplan, pplan


def test_multiclass_sweep_plan_equals_jax(plans):
    X, y, tw, jplan, pplan = plans
    assert pplan.spec == jplan.spec and pplan.spec[0] == ("multiclass", 3)
    assert [f[0] for f in pplan.spec[1]] == ["fista", "forest"]
    assert pplan.spec[1][1][1] == 3  # class-distribution leaves
    np.testing.assert_array_equal(pplan.blob, np.asarray(jplan.blob))
    for a, b in zip(pplan.xbs, jplan.xbs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pplan.metric_names == jplan.metric_names


def test_multiclass_forest_group_matches_jax(plans):
    """The depth-3 forest group (six candidates, 50 trees, three folds):
    the class-distribution scores bit-equal."""
    X, y, tw, jplan, pplan = plans
    group = pplan.spec[1][1][2][0]
    want = np.asarray(JSW._forest_group_scores(group, jplan.xbs, jnp.asarray(y),
                                               jnp.asarray(tw), jnp.asarray(jplan.blob), 3))
    got = PSW._forest_group_scores(group, pplan.xbs, pplan.y, _t(tw), pplan.blob, 3).numpy()
    assert got.shape == (3, 6, 135, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_multiclass_plan_refusals():
    X, y = _data(60, 4, 3)
    tw = np.ones((3, 60), np.float32)
    ev = PE.MultiClassification.error()
    from transmogrifai_tpu_torch.impl.classification.trees import OpXGBoostClassifier
    with pytest.raises(NotImplementedError, match="softmax boosting"):
        PSF.build_sweep_plan([(OpXGBoostClassifier(), [{}])], _t(X), y, tw, ev)
    with pytest.raises(NotImplementedError, match="two-class label"):
        PSF.build_sweep_plan([(PRF(), [{}])], _t(X), (y > 0).astype(np.float32), tw, ev)
    with pytest.raises(NotImplementedError, match="at most 8 classes"):
        PSF.build_sweep_plan([(PRF(), [{}])], _t(X), np.arange(60.0) % 9, tw, ev)
    # the F1 metric is on the device too; a label outside 0..63 is not
    assert PSF.build_sweep_plan([(PRF(), [{}])], _t(X), y, tw,
                                PE.MultiClassification.f1()) is not None
    assert PSF.build_sweep_plan([(PRF(), [{}])], _t(X), y + 100, tw, ev) is None


def test_multiclass_forest_fit_and_family_sweep_match_jax():
    """The forest refit (class-distribution leaves, normalized
    probabilities) and the per-family fold x grid sweep."""
    X, y = _data(120, 6, 3, seed=10)
    est_kw = dict(num_trees=20, max_depth=4, min_instances_per_node=5)
    jp = JRF(**est_kw).fit_arrays(X, y)
    pp = PRF(**est_kw).to("cpu").fit_arrays(_t(X), y)
    for k in ("split_feat", "split_bin", "left", "right", "leaf_val"):
        np.testing.assert_array_equal(pp[k], np.asarray(jp[k]), err_msg=k)
    assert pp["num_classes"] == jp["num_classes"] == 3
    jpred, jraw, jprob = JRF.predict_arrays(jp, X)
    ppred, praw, pprob = PRF.predict_tensors(PRF.device_params(pp, "cpu"), _t(X))
    np.testing.assert_array_equal(ppred, jpred)
    np.testing.assert_allclose(pprob, jprob, rtol=0, atol=1e-6)
    tw = (np.random.default_rng(10).random((3, 120)) < 0.67).astype(np.float32)
    grids = [{"max_depth": 3}, {"max_depth": 3, "min_info_gain": 0.01}]
    jg = JRF(num_trees=20).fit_grid_folds(X, y, tw, grids)
    pg = PRF(num_trees=20).to("cpu").fit_grid_folds(_t(X), y, tw, grids)
    for f in range(3):
        for c in range(2):
            np.testing.assert_array_equal(pg[f][c][0], jg[f][c][0])
            np.testing.assert_allclose(pg[f][c][2], jg[f][c][2], rtol=0, atol=1e-6)
