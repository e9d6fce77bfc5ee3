"""The Iris workflow's stock multiclass selector (softmax LR + RF) on the port
against the JAX package's, on the CPU.

The Iris flow (``transmogrifai_tpu_torch/apps/iris.py``, the port's copy of
``helloworld/iris.py``) trains over the multiclass selector's stock space:
8 elastic-net multinomial logistic regressions (softmax FISTA, 50 steps)
and 18 random forests of 50 trees with class-distribution leaves (three
-onehot gradient channels), 3-fold CV on the 135 training rows of the
150-row frame after ``DataCutter``, the Error metric, all in one fused
sweep.  The full 26-candidate train is held to the committed fixture
``transmogrifai_tpu_torch/fixtures/iris_stock/`` (the JAX package's sweep
inputs and metrics, draws, saved model and its answers for 256 requests):
the same winner, every fold Error bit-equal (nine candidates tie at the
best mean Error, so a flipped row would change the winner), the forests'
fold F1 / Precision / Recall bit-equal and the softmax candidates' within
``FX.IRIS_SOFTMAX_METRIC_TOL``, the same holdout metrics and
``ThresholdMetrics``, the same ``DataCutter`` summary.  The models the two
packages save load and score alike in the other, and the port's re-saves to
byte-equal files.

Regenerate the fixture with ``python tests/test_torch_iris_slice.py
--write`` (trains with the JAX package on the CPU, about 15 seconds).
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
sys.path.insert(0, os.path.join(ROOT, "helloworld"))

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction
from transmogrifai_tpu.ops import trees as JT

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import iris as PI
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.selector import defaults as PD
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

FIXTURE = FX.IRIS_STOCK
K = 3
TRAIN_ROWS = 135  # 150 less the stratified 10% holdout
FEATURES = 8      # four reals and their null indicators
CANDIDATES = 26
LR = slice(0, 8)
RF = slice(8, 26)


def _frame(cols):
    return pd.DataFrame(cols)


def make_requests(model, n=256, seed=0):
    """Iris-schema request columns from ``seed``: NaN in every real feature
    and values exactly on the model's bin edges."""
    rng = np.random.default_rng(seed)
    cols = PI.iris_data(n, seed + 100)
    cols["id"] = np.arange(10_000, 10_000 + n)
    for f in PI.REAL_FEATURES:
        cols[f][rng.random(n) < 0.1] = np.nan
    params = model.stages[-1].model_params
    stage = model.stages[-1]
    full = model.score(_frame(cols), keep_intermediate_features=True)
    meta = full[stage.inputs[-1].name].metadata
    for j, cm in enumerate(meta.columns):
        if cm.indicator_value is None and cm.parent_feature_name[0] in PI.REAL_FEATURES:
            rows = rng.choice(n, 8, replace=False)
            cols[cm.parent_feature_name[0]][rows] = \
                params["edges"][j, rng.integers(0, params["edges"].shape[1], 8)]
    return cols


def jax_answers(model, cols):
    """The JAX package's answers for the request columns, through its
    ``BatchScoreFunction`` and its ``score``."""
    name = model.result_features[0].name
    pred, prob, raw = FX.multiclass_predictions(JBatchScoreFunction(model)(FX.records(cols)),
                                                name, K)
    np.testing.assert_array_equal(model.score(_frame(cols))[name].prediction, pred)
    return {"prediction": pred, "probability": prob, "rawPrediction": raw}


def forest_draws():
    """The stock forests' K8 draws in the sweep: bootstrap [50, 135] and
    feature masks [50, 8] (the classifier's sqrt subsets: 3 of 8)."""
    kb, kf = JT.rng_keys(42)
    return (np.asarray(JT.bootstrap_weights(kb, TRAIN_ROWS, 50)),
            np.asarray(JT.feature_masks(kf, FEATURES, 50, np.sqrt(FEATURES) / FEATURES)))


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    from iris import build_workflow, iris_data

    calls = []
    run = JSF.SweepPlan.run

    def recording_run(self, train_w, val_mask):
        out = run(self, train_w, val_mask)
        calls.append((self, np.asarray(train_w, np.float32), np.asarray(val_mask), out))
        return out

    JSF.SweepPlan.run = recording_run
    try:
        wf, _ = build_workflow()
        model = wf.set_input_dataset(iris_data(), key="id").train()
    finally:
        JSF.SweepPlan.run = run
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    boot, masks = forest_draws()
    plan, train_w, val_mask, _ = calls[0]
    np.savez_compressed(os.path.join(path, "sweep.npz"),
                        metrics=np.stack([c[-1] for c in calls]), X=plan.X_host,
                        y=plan.y_host, train_w=train_w, val_mask=val_mask,
                        bootstrap=boot, feature_masks=masks)
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(model, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(model, cols))


def _summary():
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


# ---------------------------------------------------------------------------
# the frame and the fixture
# ---------------------------------------------------------------------------
def test_iris_data_is_helloworlds():
    from iris import iris_data

    ref = iris_data()
    cols = PI.iris_data()
    assert list(cols) == list(ref.columns)
    for k in cols:
        np.testing.assert_array_equal(cols[k], ref[k].to_numpy(), err_msg=k)


@pytest.mark.parametrize("n", [3, 10, 1000])
def test_iris_data_scales_by_the_same_formula(n):
    cols = PI.iris_data(n, 3)
    counts = np.bincount(cols["label"].astype(int), minlength=3)
    assert counts.tolist() == [n // 3, n // 3, n - 2 * (n // 3)]
    assert (cols["species"][cols["label"] == 2] == "virginica").all()
    rng = np.random.default_rng(3)
    first = rng.normal(PI.CENTERS["setosa"], PI.SPREAD, size=(n // 3, 4))
    np.testing.assert_array_equal(cols["sepal_length"][:n // 3], first[:, 0])


def test_fixture_holds_the_stock_multiclass_sweep():
    summ = _summary()
    assert summ["problemType"] == "MultiClassification"
    assert summ["evaluationMetric"] == "Error"
    assert summ["bestModelName"] == "OpRandomForestClassifier"
    assert summ["bestGrid"] == {"max_depth": 3, "min_info_gain": 0.001,
                                "min_instances_per_node": 10, "num_trees": 50}
    assert [r["modelName"] for r in summ["validationResults"]] == \
        ["OpLogisticRegression"] * 8 + ["OpRandomForestClassifier"] * 18
    assert [r["grid"] for r in summ["validationResults"]] == \
        JD.logistic_regression_grid() + JD.random_forest_grid()
    assert PD.random_forest_grid() == JD.random_forest_grid()
    assert summ["dataPrepResults"] == {"labelsKept": [0.0, 1.0, 2.0], "labelsDropped": []}
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    assert sweep["metrics"].shape == (1, 3, CANDIDATES, 4)
    assert sweep["X"].shape == (TRAIN_ROWS, FEATURES) and sweep["train_w"].shape == (3, 135)
    # the Error column is the summary's fold metric
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(sweep["metrics"][0, :, :, 3].T, folds)
    # nine candidates tie at the best mean Error: the first index wins
    means = [r["metricValue"] for r in summ["validationResults"]]
    assert sum(m == min(means) for m in means) == 9
    assert means.index(min(means)) == 8


def test_jax_draws_equal_the_fixture_and_the_port():
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    boot, masks = forest_draws()
    np.testing.assert_array_equal(sweep["bootstrap"], boot)
    np.testing.assert_array_equal(sweep["feature_masks"], masks)
    kb, kf = PT.rng_keys(42)
    np.testing.assert_array_equal(PT.bootstrap_weights(kb, TRAIN_ROWS, 50).numpy(), boot)
    np.testing.assert_array_equal(
        PT.feature_masks(kf, FEATURES, 50, np.sqrt(FEATURES) / FEATURES).numpy(), masks)


def test_jax_reproduces_the_fixture_answers():
    model = J.OpWorkflowModel.load(FIXTURE)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    got = jax_answers(model, cols)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    for k in expected:
        np.testing.assert_array_equal(got[k], expected[k], err_msg=k)


def test_port_scores_the_fixture_model():
    """The JAX package's saved model, scored by the port: the same
    predictions, probabilities within ``FX.IRIS_PROB_ATOL`` (float32 means
    over 50 trees summed in another order), through ``BatchScoreFunction``,
    ``ScoreFunction`` and ``score``."""
    model = P.load_model(FIXTURE, device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    name = model.result_features[0].name
    pred, prob, raw = FX.multiclass_predictions(
        P.BatchScoreFunction(model)(FX.records(cols)), name, K)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    np.testing.assert_array_equal(pred, expected["prediction"])
    np.testing.assert_allclose(prob, expected["probability"], rtol=0, atol=FX.IRIS_PROB_ATOL)
    np.testing.assert_allclose(raw, expected["rawPrediction"], rtol=0,
                               atol=50 * FX.IRIS_PROB_ATOL)
    one = P.ScoreFunction(model)(FX.records(cols)[0])[name]
    assert one["prediction"] == pred[0]
    np.testing.assert_array_equal(model.score(cols)[name].prediction, pred)


# ---------------------------------------------------------------------------
# the full-width train
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(port model, port save dir, port timings, the sweep calls' metrics)."""
    calls = []
    run = PSF.SweepPlan.run

    def recording_run(plan, train_w, val_mask, timings=None):
        out = run(plan, train_w, val_mask, timings)
        calls.append(out)
        return out

    PSF.SweepPlan.run = recording_run
    try:
        pm, wf = PI.train_iris(device="cpu")
    finally:
        PSF.SweepPlan.run = run
    tmp = tmp_path_factory.mktemp("iris")
    pm.save(str(tmp / "port"))
    return pm, str(tmp / "port"), wf.train_timings, np.stack(calls)


def test_full_width_iris_train_matches_the_fixture(trained):
    pm, _, timings, metrics = trained
    found = FX.check_iris_train(pm)
    assert found["tied_at_best"] == 9 and found["candidates"] == CANDIDATES
    ref = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))["metrics"]
    assert metrics.shape == ref.shape
    # the forests' metrics bit for bit; every Error bit for bit
    np.testing.assert_array_equal(metrics[..., RF, :], ref[..., RF, :])
    np.testing.assert_array_equal(metrics[..., 3], ref[..., 3])
    np.testing.assert_allclose(metrics[..., LR, :3], ref[..., LR, :3], rtol=0,
                               atol=FX.IRIS_SOFTMAX_METRIC_TOL)
    # one fused sweep ran: its parts' host seconds are in the breakdown
    assert {"cv_sweep_fista", "cv_sweep_forest", "cv_sweep_metrics"} <= set(timings)


def test_refit_forest_equals_the_fixture_model(trained):
    """The winner's refit on the 135 prepared rows: the same trees (pools
    and class-distribution leaves bit for bit) and bin edges."""
    pm, _, _, _ = trained
    mine = pm.stages[-1].model_params
    theirs = J.OpWorkflowModel.load(FIXTURE).stages[-1].model_params
    for k in ("split_feat", "split_bin", "left", "right", "leaf_val", "edges"):
        np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(theirs[k]), err_msg=k)
    assert np.asarray(mine["leaf_val"]).shape[-1] == K
    assert (mine["num_classes"], mine["num_trees"], mine["max_depth"]) == (K, 50, 3)


def test_port_saved_model_scores_alike_in_both_packages(trained):
    pm, port_dir, _, _ = trained
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    jl = J.OpWorkflowModel.load(port_dir)
    pl = P.load_model(port_dir, device="cpu")
    name = pl.result_features[0].name
    jp = jl.score(_frame(cols))[jl.result_features[0].name]
    pp = pl.score(cols)[name]
    np.testing.assert_array_equal(pp.prediction, jp.prediction)
    np.testing.assert_allclose(pp.probability, jp.probability, rtol=0, atol=FX.IRIS_PROB_ATOL)
    np.testing.assert_array_equal(pm.score(cols)[name].prediction, pp.prediction)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    np.testing.assert_array_equal(pp.prediction, expected["prediction"])


def test_port_saved_model_resaves_byte_equal(trained, tmp_path):
    _, port_dir, _, _ = trained
    P.load_model(port_dir, device="cpu").save(str(tmp_path))
    with open(os.path.join(port_dir, "op_model.json"), "rb") as a, \
            open(tmp_path / "op_model.json", "rb") as b:
        assert a.read() == b.read()
    with np.load(os.path.join(port_dir, "op_model_arrays.npz")) as za, \
            np.load(tmp_path / "op_model_arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k
    mp = json.load(open(os.path.join(port_dir, "op_model.json")))
    mj = json.load(open(os.path.join(FIXTURE, "op_model.json")))
    assert [s["class"] for s in mp["stages"]] == [s["class"] for s in mj["stages"]]
    assert [sorted(s["state"]) for s in mp["stages"]] == [sorted(s["state"]) for s in mj["stages"]]
    assert mp["stages"][-1]["state"]["predictor_class"] == \
        {"__class_ref__": "transmogrifai_tpu.impl.classification.trees:OpRandomForestClassifier"}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
