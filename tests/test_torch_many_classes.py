"""The multiclass selector past 8 classes on the port against the JAX package,
on the CPU.

K-E, K-F, K-P, K-Q and K-R (and their plain versions) take up to 128
classes (``ops/trees.MAX_CHANNELS``, ``ops/linear.SOFTMAX_MAX_CLASSES``,
``ops/metrics.MULTICLASS_MAX_CLASSES``).  At 9 to 100 classes:

- ``grow_forest`` over -onehot gradient channels, bit for bit (K-E sums in
  fixed point; K-F's channel sum of squares is one square, then one fused
  multiply-add a channel in channel order, as XLA's CPU code contracts it);
- K-Q's plain version: Error bit for bit at every k (integer counts); F1,
  Precision and Recall bit for bit at 9 and 10 classes and within
  ``FX.MANY_CLASS_METRIC_ULPS`` ulps above, where XLA's CPU code vectorizes
  the class sums in an order that depends on the host and on the grid's
  shape and the port rounds the float64 sum once (PERF.md, K-Q's class
  order);
- ``softmax_hessian`` given the reference's probabilities, bit for bit (past
  32 classes XLA splits the class mean into windows of 32: replayed);
  ``softmax_boost_step`` and its collapse mode against the reference's
  update and gradients;
- ``fit_softmax_grid_folds`` within ``COEF_ATOL``;
- the multiclass sweep plan's spec and blob at 26 classes;
- trains of a Letter-Recognition-shaped flow (``FX.letters_data``): the
  fused sweep at 26 and 64 classes and the per-family sweep at 70 (labels
  past the fused sweep's bound of 64), on ``FX.many_space``, and softmax
  boosting at 10 classes (``trees_per_round`` 1 and 4), each against the
  JAX package's winner and fold metrics in ``fixtures/many_class``; the
  JAX-saved 26-class stock model (``fixtures/letters_stock``) scored by the
  port, and a port-saved one by both packages.

The full-width 26-class stock train against ``letters_stock`` and the
full-width boosting grid are ``slow``.  Regenerate the fixtures with
``python tests/test_torch_many_classes.py --write`` (the JAX package on the
CPU, about five minutes).
"""
import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JTy
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import OpWorkflow as JWorkflow
from transmogrifai_tpu.evaluators import Evaluators as JE
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
from transmogrifai_tpu.impl.classification.trees import OpGBTClassifier as JGBT
from transmogrifai_tpu.impl.classification.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.impl.classification.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.impl.selector import factories as JFac
from transmogrifai_tpu.impl.selector.factories import MultiClassificationModelSelector as JMS
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction
from transmogrifai_tpu.ops import linear as JL
from transmogrifai_tpu.ops import trees as JT
from transmogrifai_tpu.ops.metrics import _multiclass_grid_metrics

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.impl.classification.trees import OpRandomForestClassifier as PRF
from transmogrifai_tpu_torch.impl.selector import factories as PFac
from transmogrifai_tpu_torch.ops import linear as PL
from transmogrifai_tpu_torch.ops import metrics as PM
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

#: the softmax fits' coefficients after 50 steps (tests/test_torch_multiclass.py)
COEF_ATOL = 2e-5
#: K-R's gradients against the reference's: 2 ulp of 1.0 (exp differs;
#: tests/test_torch_softmax_boost.py)
GRAD_ATOL = 2.4e-7
K_LETTERS = 26


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


def _frame(cols):
    return pd.DataFrame(cols)


# ---------------------------------------------------------------------------
# the JAX package's flow, built with its own DSL
# ---------------------------------------------------------------------------
def jax_workflow(models_and_parameters=None, **kw):
    label = JFB("label", JTy.RealNN).extract(field="label").as_response()
    feats = [JFB(f, JTy.Integral).extract(field=f).as_predictor() for f in FX.LETTER_FEATURES]
    kw = {"num_folds": 3, "seed": 42, **kw}
    pred = JMS.with_cross_validation(models_and_parameters=models_and_parameters, **kw) \
        .set_input(label, feats[0].vectorize(*feats[1:])).get_output()
    return JWorkflow().set_result_features(pred), pred


RUNS = FX.MANY_RUNS


def run_space(pkg, space):
    if pkg == "port":
        return FX.port_many_run_space(space)
    return FX.many_run_space(space, JLR, JRF, JXGB, JGBT, JD.xgboost_grid)


def fold_metrics(model):
    summ = model.stages[-1].summary
    return np.array([r["foldMetrics"] for r in summ.validation_results], np.float64)


def best_index(model):
    summ = model.stages[-1].summary
    return [(r["modelName"], r["grid"]) for r in summ.validation_results].index(
        (summ.best_model_name, summ.best_grid))


# ---------------------------------------------------------------------------
# the fixture writer
# ---------------------------------------------------------------------------
def make_requests(model, k, n=256, seed=0):
    """Letter-schema request columns from ``seed``: a null in every attribute
    now and then, and values outside the training range."""
    rng = np.random.default_rng(seed)
    cols = FX.letters_data(n, k, seed + 100)
    cols["id"] = np.arange(10_000, 10_000 + n)
    for f in FX.LETTER_FEATURES:
        cols[f][rng.random(n) < 0.05] = np.nan
        cols[f][rng.random(n) < 0.02] = 20.0
    return cols


def jax_answers(model, cols, k):
    name = model.result_features[0].name
    pred, prob, raw = FX.multiclass_predictions(JBatchScoreFunction(model)(FX.records(cols)),
                                                name, k)
    np.testing.assert_array_equal(model.score(_frame(cols))[name].prediction, pred)
    return {"prediction": pred, "probability": prob, "rawPrediction": raw}


def forest_draws(rows, features):
    kb, kf = JT.rng_keys(42)
    return (np.asarray(JT.bootstrap_weights(kb, rows, 50)),
            np.asarray(JT.feature_masks(kf, features, 50, np.sqrt(features) / features)))


def write_fixtures(seed=0):
    import tempfile

    calls, rows, nvs = [], [], []
    run = JSF.SweepPlan.run

    def recording_run(self, train_w, val_mask):
        out = run(self, train_w, val_mask)
        calls.append(np.asarray(out))
        rows.append(self.X_host.shape)
        nvs.append(np.asarray(val_mask).sum(1))
        return out

    JSF.SweepPlan.run = recording_run
    try:
        wf, _ = jax_workflow()
        model = wf.set_input_dataset(_frame(FX.letters_data()), key="id").train()
        stock_calls, stock_shape = list(calls), rows[0]
        many = {}
        for name, (k, n, space) in RUNS.items():
            calls.clear()
            nvs.clear()
            wf, _ = jax_workflow(run_space("jax", space))
            m = wf.set_input_dataset(_frame(FX.letters_data(n, k, 1)), key="id").train()
            many[f"{name}_folds"] = fold_metrics(m)
            many[f"{name}_best"] = np.int64(best_index(m))
            many[f"{name}_calls"] = np.int64(len(calls))
            if calls:
                many[f"{name}_metrics"] = np.stack(calls)
                many[f"{name}_nv"] = np.stack(nvs)
    finally:
        JSF.SweepPlan.run = run
    path = FX.LETTERS_STOCK
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    boot, masks = forest_draws(*stock_shape)
    np.savez_compressed(os.path.join(path, "sweep.npz"), metrics=np.stack(stock_calls),
                        shape=np.int64(stock_shape), bootstrap=boot, feature_masks=masks)
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(model, K_LETTERS, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(model, cols, K_LETTERS))
    os.makedirs(FX.MANY_CLASS, exist_ok=True)
    np.savez_compressed(os.path.join(FX.MANY_CLASS, "sweep.npz"), **many)


def _stock_shape():
    """(training rows after the stratified holdout, vector width: the 16
    attributes and their null indicators) of the letters_stock sweep."""
    rows, width = FX.load_sweep(os.path.join(FX.LETTERS_STOCK, "sweep.npz"))["shape"]
    assert width == 2 * len(FX.LETTER_FEATURES)
    return int(rows), int(width)


def _summary():
    with open(os.path.join(FX.LETTERS_STOCK, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k", [(5, 26), (600, 26), (1000, 64), (200, 100)])
def test_letters_data_has_the_schema(n, k):
    cols = FX.letters_data(n, k, 3)
    assert list(cols) == list(FX.LETTER_FEATURES) + ["label", "id"]
    X = np.stack([cols[f] for f in FX.LETTER_FEATURES], 1)
    assert X.min() >= 0 and X.max() <= 15 and np.array_equal(X, np.rint(X))
    lab = cols["label"].astype(int)
    assert lab.min() == 0 and lab.max() == min(n, k) - 1 and np.array_equal(cols["id"],
                                                                            np.arange(n))
    again = FX.letters_data(n, k, 3)
    for c in cols:
        np.testing.assert_array_equal(cols[c], again[c])


# ---------------------------------------------------------------------------
# K-E / K-F: grow_forest over many class channels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c,depth,wmax", [(9, 3, 3), (10, 6, 4000), (16, 6, 3), (26, 3, 4000),
                                          (26, 6, 3), (64, 6, 4000), (64, 3, 3), (100, 3, 3)])
def test_grow_forest_past_8_classes_bit_equal_to_jax(c, depth, wmax):
    """-onehot gradients over c classes with integer weights (Poisson-like
    bootstrap counts, or large ones whose squared sums round in float32):
    the same trees, leaves and row nodes."""
    rng = np.random.default_rng(c + depth + wmax)
    n, d, B, T = 240, 8, 32, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, c, n)
    X[:, :2] += y[:, None] * 0.05
    Xb = np.asarray(JT.quantize(X, B)[0])
    g = -np.eye(c, dtype=np.float32)[y]
    w = rng.integers(0, wmax + 1, (T, n)).astype(np.float32)
    fm = (rng.random((T, d)) < 0.6).astype(np.float32)
    hp = (np.full(T, 1e-6, np.float32), np.zeros(T, np.float32),
          np.float32([1, 10, 1, 3]), np.float32([0.0, 0.001, 0.01, 0.0]))
    front = PT.frontier_cap(n, depth, 1.0, 1.0, 16, total_weight=float(w.sum(1).max()))
    grow = jax.jit(JT.grow_forest, static_argnums=(5, 6, 7),
                   static_argnames=("exact_cap", "return_row_node"))
    jt, jrn = grow(jnp.asarray(Xb), jnp.asarray(g), jnp.ones(n), jnp.asarray(w),
                   jnp.asarray(fm), depth, B, front, *hp, return_row_node=True)
    pt, prn = PT.grow_forest(_t(Xb), _t(g), torch.ones(n), _t(w), _t(fm), depth, B, front,
                             *hp, return_row_node=True)
    assert pt.leaf_val.shape[-1] == c
    for name, a, b in zip(pt._fields, pt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(prn.numpy(), np.asarray(jrn))


def test_the_class_ceiling_is_one_on_both_devices_and_every_kernel():
    """128 classes go through; 129 raise the same ValueError naming the
    ceiling, from the plain versions (the wrappers check before they pick a
    route, so a CUDA tensor meets the same check)."""
    assert PT.MAX_CHANNELS == PL.SOFTMAX_MAX_CLASSES == PM.MULTICLASS_MAX_CLASSES == 128
    Xb = torch.zeros((4, 2), dtype=torch.int8)
    ids = torch.zeros((1, 4), dtype=torch.int32)
    assert PT.level_hist(Xb, torch.zeros((1, 4, 129)), ids, 1, 4).shape == (1, 1, 129, 2, 4)
    with pytest.raises(ValueError, match="at most 128 gradient channels"):
        PT.level_hist(Xb, torch.zeros((1, 4, 130)), ids, 1, 4)
    PM.multiclass_metrics(torch.rand((1, 4, 128)), torch.zeros(4), torch.ones(1, 4), 1)
    with pytest.raises(ValueError, match="2 to 128 classes"):
        PM.multiclass_metrics(torch.rand((1, 4, 129)), torch.zeros(4), torch.ones(1, 4), 1)
    with pytest.raises(ValueError, match="2 <= k <= 128"):
        PT.softmax_boost_step(torch.zeros((1, 4, 129)), torch.zeros(4), torch.ones((1, 4)),
                              torch.ones(1))
    args = lambda k: (torch.ones((4, 3)), torch.zeros(4), torch.ones((1, 4)),  # noqa: E731
                      torch.zeros(1, dtype=torch.int32), torch.zeros((1, 3, k)),
                      torch.zeros((1, 3, k)), torch.ones(1))
    assert PL.softmax_fista_grad(*args(128)).shape == (1, 3, 128)
    with pytest.raises(ValueError, match="at most 128 classes"):
        PL.softmax_fista_grad(*args(129))


# ---------------------------------------------------------------------------
# K-Q: the multiclass metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [9, 10, 16, 26, 64, 100])
def test_multiclass_metrics_past_8_classes_match_jax(k):
    rng = np.random.default_rng(k)
    F, C, n = 3, 8, 900
    probs = rng.random((F, C, n, k)).astype(np.float32)
    probs[:, ::3] = np.round(probs[:, ::3] * 4) / 4  # ties: the first class wins
    y = rng.integers(0, k, n).astype(np.float32)
    vm = (rng.random((F, n)) < 0.34).astype(np.float32)
    y1 = np.eye(k, dtype=np.float32)[y.astype(int)]
    want = np.asarray(_multiclass_grid_metrics(jnp.asarray(y1), jnp.asarray(probs),
                                               jnp.asarray(vm)))
    got = PM.multiclass_grid_metrics(_t(y), _t(probs), _t(vm)).numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])  # Error: counts, exact
    ulps = FX.ulps(got[..., :3], want[..., :3])
    assert ulps <= (0 if k <= 10 else FX.MANY_CLASS_METRIC_ULPS), ulps


# ---------------------------------------------------------------------------
# K-R: the softmax boosting step
# ---------------------------------------------------------------------------
def _step_case(k, seed=0, T=2, n=3000, P=15):
    rng = np.random.default_rng(seed + k)
    F = (rng.standard_normal((T, n, k)) * 2).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.float32)
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    eta = np.array([0.3, 0.02], np.float32)[:T]
    leaf = rng.standard_normal((T, P, k)).astype(np.float32)
    node = rng.integers(0, P, (T, n)).astype(np.int32)
    return F, y, w, eta, leaf, node


@pytest.mark.parametrize("k", [9, 10, 16, 26, 33, 64, 100, 128])
def test_softmax_hessian_past_8_classes_given_the_references_probabilities(k):
    """Bit for bit: fused multiply-adds in channel order up to 32 classes,
    past them XLA's windows of 32 (``PT.xla_windows``)."""
    rng = np.random.default_rng(k)
    F = (rng.standard_normal((20000, k)) * 3).astype(np.float32)
    y = rng.integers(0, k, 20000).astype(np.float32)
    Y = jax.nn.one_hot(y.astype(np.int32), k, dtype=jnp.float32)
    _, h = jax.jit(lambda F: JT._grad_hess("softmax", F, jnp.asarray(y), Y))(jnp.asarray(F))
    p = np.asarray(jax.jit(lambda F: jax.nn.softmax(F, axis=-1))(jnp.asarray(F)))
    got = PT.softmax_hessian(torch.from_numpy(p.copy())).numpy()
    np.testing.assert_array_equal(got, np.asarray(h))


@pytest.mark.parametrize("k", [9, 10, 16, 26, 64])
def test_softmax_boost_step_past_8_classes_matches_the_reference(k):
    F0, y, w, eta, leaf, node = _step_case(k)
    T, n = w.shape
    F = torch.from_numpy(F0.copy())
    ghw = torch.empty((T, n, k + 1))
    PT.softmax_boost_step(F, torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(eta),
                          torch.from_numpy(leaf), torch.from_numpy(node), ghw)
    upd = jax.jit(lambda F, lv, nd, e: F + e[:, None, None] * jnp.take_along_axis(
        lv, nd[..., None].repeat(lv.shape[2], axis=2), axis=1))
    Fj = np.asarray(upd(jnp.asarray(F0), jnp.asarray(leaf), jnp.asarray(node), jnp.asarray(eta)))
    np.testing.assert_array_equal(F.numpy(), Fj)  # one fused multiply-add a channel
    Y = jax.nn.one_hot(y.astype(np.int32), k, dtype=jnp.float32)
    grad_hess = jax.jit(lambda F: JT._grad_hess("softmax", F, jnp.asarray(y), Y))
    for t in range(T):
        g, h = grad_hess(jnp.asarray(Fj[t]))
        np.testing.assert_allclose(ghw[t, :, :k].numpy(), np.asarray(g) * w[t][:, None],
                                   rtol=0, atol=GRAD_ATOL * 2)
        np.testing.assert_allclose(ghw[t, :, k].numpy(), np.asarray(h) * w[t], rtol=0,
                                   atol=GRAD_ATOL * 2)


def _collapse_replay(k, K, n=1500, d=5, n_bins=16, R=8):
    """The reference's softmax fit at ``trees_per_round`` K over k classes,
    and its own trees replayed through the collapse mode's plain version."""
    rng = np.random.default_rng(k + K)
    Xb = rng.integers(0, n_bins, (n, d)).astype(np.int8)
    z = Xb[:, 0].astype(np.float32) - 0.6 * Xb[:, 1] + rng.standard_normal(n) * 2
    y = np.clip(np.rint((z + 10.0) / 20.0 * (k - 1)), 0, k - 1).astype(np.float32)
    y[:k] = np.arange(k)
    rw = (rng.random((R, n)) < 0.8).astype(np.float32)
    fm = (rng.random((R, d)) < 0.8).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    trees, Fj = JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(rw),
                           jnp.asarray(fm), "softmax", R, 3, n_bins, 8, eta=0.3,
                           trees_per_round=K, n_classes=k)
    tree = PT.Tree(*(torch.from_numpy(np.array(a)) for a in trees))
    _, leaves = PT.ensemble_walk_plain(torch.from_numpy(Xb), tree, 3, return_leaves=True)
    leaves = leaves.T.contiguous()
    F = torch.zeros((1, n, k))
    eta_t = torch.tensor([0.3])
    ghw = torch.empty((K, n, k + 1))
    for s in range(R // K):
        sl = slice(s * K, (s + 1) * K)
        PT.softmax_boost_step_plain(F, torch.from_numpy(y), torch.from_numpy(w)[None], eta_t,
                                    tree.leaf_val[sl], leaves[sl], ghw,
                                    torch.from_numpy(rw[sl]))
    return np.asarray(Fj), F[0].numpy(), ghw, y, w, rw[R - K:]


@pytest.mark.parametrize("k,K", [(10, 2), (10, 4), (26, 4)])
def test_softmax_collapse_mode_past_8_classes_replays_the_reference(k, K):
    """The K leaves summed by pairwise halving, ``eta * float32(1 / K)``, one
    fused multiply-add a channel: the reference's own collapsed trees give
    its final margins bit for bit; the last step's K gradient planes are the
    reference's gradients at the margins before it, times w * rw."""
    ref, got, ghw, y, w, rw = _collapse_replay(k, K)
    assert int(np.sum(got != ref)) == 0
    assert ghw.shape == (K, ref.shape[0], k + 1)
    assert torch.isfinite(ghw).all()
    np.testing.assert_array_equal((ghw[..., k] == 0).numpy(), (w[None] * rw) == 0)


# ---------------------------------------------------------------------------
# K-P: the softmax fits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [10, 26])
def test_fit_softmax_grid_folds_past_8_classes_matches_jax(k):
    cols = FX.letters_data(300, k, 5)
    X = np.stack([cols[f] for f in FX.LETTER_FEATURES], 1).astype(np.float32) / 15.0
    y = cols["label"].astype(np.float32)
    rng = np.random.default_rng(k)
    tw = (rng.random((3, 300)) < 0.67).astype(np.float32)
    reg = np.array([0.001, 0.01, 0.1, 0.2], np.float32).repeat(2)
    alpha = np.tile(np.array([0.1, 0.5], np.float32), 4)
    l1, l2 = reg * alpha, reg * (1 - alpha)
    jf = JL.fit_softmax_grid_folds(jnp.asarray(X), jnp.asarray(y), jnp.asarray(tw),
                                   jnp.asarray(l1), jnp.asarray(l2), num_classes=k, max_iter=50)
    pf = PL.fit_softmax_grid_folds(_t(X), _t(y), _t(tw), l1, l2, num_classes=k, max_iter=50)
    assert pf.coef.shape == (3, 8, 16, k)
    np.testing.assert_allclose(pf.coef.numpy(), np.asarray(jf.coef), rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(pf.intercept.numpy(), np.asarray(jf.intercept), rtol=0,
                               atol=COEF_ATOL)


# ---------------------------------------------------------------------------
# the fused sweep's plan
# ---------------------------------------------------------------------------
def test_multiclass_sweep_plan_at_26_classes_equals_jax():
    cols = FX.letters_data(300, K_LETTERS, 2)
    X = np.stack([cols[f] for f in FX.LETTER_FEATURES], 1).astype(np.float32)
    y = cols["label"]
    tw = (np.random.default_rng(2).random((3, 300)) < 0.67).astype(np.float32)
    jplan = JSF.build_sweep_plan(JFac.MultiClassificationModelSelector._default_models(), X, y,
                                 tw, JE.MultiClassification.error())
    pplan = PSF.build_sweep_plan(PFac.MultiClassificationModelSelector._default_models(),
                                 _t(X), y, tw, PE.MultiClassification.error())
    assert pplan.spec == jplan.spec and pplan.spec[0] == ("multiclass", K_LETTERS)
    assert [f[0] for f in pplan.spec[1]] == ["fista", "forest"]
    assert pplan.spec[1][1][1] == K_LETTERS
    np.testing.assert_array_equal(pplan.blob, np.asarray(jplan.blob))
    for a, b in zip(pplan.xbs, jplan.xbs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # labels past 63 and the score guard leave the fused sweep, as in the reference
    for yy in (np.arange(300.0) % 70, ):
        assert PSF.build_sweep_plan(FX.many_space(PLR, PRF), _t(X), yy, tw,
                                    PE.MultiClassification.error()) is None
        assert JSF.build_sweep_plan(FX.many_space(JLR, JRF), X, yy, tw,
                                    JE.MultiClassification.error()) is None


# ---------------------------------------------------------------------------
# the trains, against the JAX package's (fixtures/many_class)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def many():
    return FX.load_sweep(os.path.join(FX.MANY_CLASS, "sweep.npz"))


def _port_train(name):
    k, n, space = RUNS[name]
    calls = []
    run = PSF.SweepPlan.run

    def recording_run(plan, train_w, val_mask, timings=None):
        out = run(plan, train_w, val_mask, timings)
        calls.append(out)
        return out

    PSF.SweepPlan.run = recording_run
    try:
        wf, _ = FX.letters_workflow(run_space("port", space))
        model = wf.set_input_dataset(FX.letters_data(n, k, 1), key="id").train(device="cpu")
    finally:
        PSF.SweepPlan.run = run
    return model, calls


@pytest.mark.parametrize("name", ["fused26", "fused64", "family70"])
def test_many_class_train_matches_the_jax_packages(name, many):
    """The same winner; forests' fold metrics bit for bit; LR fold Errors
    equal (``FX.check_many_class_train``)."""
    model, calls = _port_train(name)
    found = FX.check_many_class_train(model, name, calls)
    assert found["calls"] == (0 if name == "family70" else 1)
    # the per-family train keeps labels past the fused sweep's bound of 64
    assert found["classes"] > (64 if name == "family70" else RUNS[name][0] - 1)


@pytest.mark.parametrize("name", ["boost10_k1", "boost10_k4"])
def test_many_class_boosting_matches_the_jax_packages(name, many):
    """Softmax boosting over 10 class margins through K-R's step (K = 1) and
    collapse (K = 4) modes: the same winner, the fold Errors within
    ``FX.MANY_FLIP_ROWS`` rows (K-E sums the real-valued gradients in XLA's
    float32 row order; the softmax's ``exp``, an ulp from XLA's, can still
    flip a near-tied split: a standing gap, ROADMAP)."""
    model, calls = _port_train(name)
    found = FX.check_many_class_train(model, name, calls)
    assert found["calls"] == 1


@pytest.mark.slow
def test_full_width_boosting_grid_matches_the_jax_packages(many):
    model, calls = _port_train("boost10_full")
    FX.check_many_class_train(model, "boost10_full", calls)


# ---------------------------------------------------------------------------
# the letters_stock fixture
# ---------------------------------------------------------------------------
def test_fixture_holds_the_26_class_stock_sweep():
    summ = _summary()
    assert summ["problemType"] == "MultiClassification"
    assert summ["evaluationMetric"] == "Error"
    assert [r["grid"] for r in summ["validationResults"]] == \
        JD.logistic_regression_grid() + JD.random_forest_grid()
    assert summ["dataPrepResults"]["labelsKept"] == [float(j) for j in range(K_LETTERS)]
    sweep = FX.load_sweep(os.path.join(FX.LETTERS_STOCK, "sweep.npz"))
    assert sweep["metrics"].shape == (1, 3, 26, 4)
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(sweep["metrics"][0, :, :, 3].T, folds)
    boot, masks = forest_draws(*_stock_shape())
    np.testing.assert_array_equal(sweep["bootstrap"], boot)
    np.testing.assert_array_equal(sweep["feature_masks"], masks)
    kb, kf = PT.rng_keys(42)
    rows, feats = _stock_shape()
    np.testing.assert_array_equal(PT.bootstrap_weights(kb, rows, 50).numpy(), boot)
    np.testing.assert_array_equal(
        PT.feature_masks(kf, feats, 50, np.sqrt(feats) / feats).numpy(), masks)


def test_jax_reproduces_the_letters_fixture_answers():
    model = J.OpWorkflowModel.load(FX.LETTERS_STOCK)
    cols = FX.load_columns(os.path.join(FX.LETTERS_STOCK, "requests.npz"))
    got = jax_answers(model, cols, K_LETTERS)
    expected = FX.load_expected(os.path.join(FX.LETTERS_STOCK, "expected.npz"))
    for key in expected:
        np.testing.assert_array_equal(got[key], expected[key], err_msg=key)


def test_port_scores_the_26_class_fixture_model():
    model = P.load_model(FX.LETTERS_STOCK, device="cpu")
    found = FX.check_letters_answers(model)
    assert found["rows"] == 256


def test_port_saved_26_class_model_scores_alike_in_both_packages(tmp_path):
    model, _ = _port_train("fused26")
    model.save(str(tmp_path))
    cols = FX.load_columns(os.path.join(FX.LETTERS_STOCK, "requests.npz"))
    jl = J.OpWorkflowModel.load(str(tmp_path))
    pl = P.load_model(str(tmp_path), device="cpu")
    jp = jl.score(_frame(cols))[jl.result_features[0].name]
    pp = pl.score(cols)[pl.result_features[0].name]
    np.testing.assert_array_equal(pp.prediction, jp.prediction)
    np.testing.assert_allclose(pp.probability, jp.probability, rtol=0, atol=FX.IRIS_PROB_ATOL)
    assert np.asarray(pp.probability).shape == (256, K_LETTERS)


@pytest.mark.slow
def test_full_width_letters_stock_train_matches_the_fixture():
    calls = []
    run = PSF.SweepPlan.run

    def recording_run(plan, train_w, val_mask, timings=None):
        out = run(plan, train_w, val_mask, timings)
        calls.append(out)
        return out

    PSF.SweepPlan.run = recording_run
    try:
        wf, _ = FX.letters_workflow()
        model = wf.set_input_dataset(FX.letters_data(), key="id").train(device="cpu")
    finally:
        PSF.SweepPlan.run = run
    found = FX.check_letters_train(model, np.stack(calls))
    assert found["candidates"] == 26


# ---------------------------------------------------------------------------
# the MLP and naive Bayes take 128 classes, as the other families do
# ---------------------------------------------------------------------------
def test_mlp_and_naive_bayes_keep_8_classes_and_name_the_queue():
    """The old 8-class limit of K-U and K-V is gone: both take 128 classes
    (and K-V 65,536 features) and raise one ValueError naming the size
    just past that, on either device."""
    from transmogrifai_tpu_torch.impl.classification import naive_bayes as NB
    from transmogrifai_tpu_torch.ops import mlp as M

    M._check_net((16, 8, 9))
    M._check_net((16, 8, 128))
    NB._check_limits(16, 9)
    NB._check_limits(65_536, 128)
    with pytest.raises(ValueError, match="129"):
        M._check_net((16, 8, 129))
    with pytest.raises(ValueError, match="129 classes"):
        NB._check_limits(16, 129)
    with pytest.raises(ValueError, match="65537 features"):
        NB._check_limits(65_537, 2)
    X = torch.ones((3, 4))
    with pytest.raises(ValueError, match="129 classes"):
        NB.nb_tables_score(X, torch.zeros((1, 129)), torch.zeros((1, 129, 4)))


def class_order_table(ks=range(2, 129), grids=((3, 4, 700), (3, 26, 1500), (1, 8, 400))):
    """{k: (float64 rounded once, class-order FMA)}: the largest ulp gap of
    F1 / Precision / Recall to the JAX package's over the (F, C, n) grids,
    random probabilities; Error is asserted bit-equal on the way."""
    out = {}
    for k in ks:
        gaps = [0, 0]
        for F, C, n in grids:
            rng = np.random.default_rng(k * 1000 + C)
            y = rng.integers(0, k, n).astype(np.float32)
            probs = rng.random((F, C, n, k)).astype(np.float32)
            vm = (rng.random((F, n)) < 0.4).astype(np.float32)
            want = np.asarray(_multiclass_grid_metrics(
                jnp.asarray(np.eye(k, dtype=np.float32)[y.astype(int)]), jnp.asarray(probs),
                jnp.asarray(vm)))
            for i, fma_up_to in enumerate((PM.MULTICLASS_FMA_CLASSES, 128)):
                old, PM.MULTICLASS_FMA_CLASSES = PM.MULTICLASS_FMA_CLASSES, fma_up_to
                try:
                    got = PM.multiclass_grid_metrics(_t(y), _t(probs), _t(vm)).numpy()
                finally:
                    PM.MULTICLASS_FMA_CLASSES = old
                assert np.array_equal(got[..., 3], want[..., 3])
                gaps[i] = max(gaps[i], FX.ulps(got[..., :3], want[..., :3]))
        out[k] = tuple(gaps)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixtures")
    ap.add_argument("--class-order", action="store_true",
                    help="print K-Q's F1 / P / R ulp gaps to the JAX package's at 2 .. 128 "
                         "classes, float64 rounded once and class-order FMA")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if args.class_order:
        table = class_order_table()
        print(json.dumps({"ulps_float64": {k: v[0] for k, v in table.items()},
                          "ulps_class_order_fma": {k: v[1] for k, v in table.items()},
                          "max": [max(v[0] for v in table.values()),
                                  max(v[1] for v in table.values())]}))
    elif args.write:
        write_fixtures(seed=args.seed)
        print(f"wrote {FX.LETTERS_STOCK} and {FX.MANY_CLASS}")
    else:
        ap.error("nothing to do: pass --write or --class-order")
