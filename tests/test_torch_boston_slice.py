"""The Boston workflow's stock regression selector (LinReg + RF + GBT) on the
port against the JAX package's, on the CPU.

The Boston flow (``transmogrifai_tpu_torch/apps/boston.py``, the port's copy
of ``helloworld/boston.py``) trains over the regression selector's stock
space: 8 elastic-net linear regressions (FISTA, 300 steps), 18 random
forests of 50 trees and 18 GBT regressors of 20 rounds, 3-fold CV on the
455 training rows of the 506-row frame, all in one fused sweep.  The full
44-candidate train is held to the committed fixture
``transmogrifai_tpu_torch/fixtures/boston_stock/`` (the JAX package's sweep
metrics, draws, saved model and its predictions for 256 requests): the
same winner, and each family's fold RMSE within ``FX.BOSTON_RMSE_RTOL``
(relative).  K-E sums the real-valued gradients in XLA's float32 row order,
so the forests and GBT follow the JAX package's splits; their fold RMSE
differ in the last bits through the metrics' and the trees' sums in another
order (measured on the CPU: 6.6e-8 RF, 8.0e-8 GBT).  The models the two packages save load and score alike in
the other, and the port's re-saves to byte-equal files.

Regenerate the fixture with ``python tests/test_torch_boston_slice.py
--write`` (trains with the JAX package on the CPU, about half a minute).
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
from transmogrifai_tpu_torch.apps import boston as PBoston
from transmogrifai_tpu_torch.impl.selector import defaults as PD
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

FIXTURE = FX.BOSTON_STOCK
#: the holdout metrics of the refit GBT winner, relative
HOLDOUT_RTOL = 1e-5
TRAIN_ROWS = 455  # 506 less the 10% holdout


def _frame(cols):
    return pd.DataFrame(cols)


def make_requests(model, n=256, seed=0):
    """Boston-schema request columns from ``seed``: NaN in every real
    feature, an unseen ``chas`` value, and values exactly on the model's
    bin edges."""
    rng = np.random.default_rng(seed)
    cols = PBoston.boston_data(n, seed + 100)
    cols["id"] = np.arange(10_000, 10_000 + n)
    cols["chas"] = rng.choice([0, 1, 2], n, p=[0.8, 0.1, 0.1])
    for f in PBoston.REAL_FEATURES:
        cols[f][rng.random(n) < 0.1] = np.nan
    params = model.stages[-1].model_params
    stage = model.stages[-1]
    full = model.score(_frame(cols), keep_intermediate_features=True)
    meta = full[stage.inputs[-1].name].metadata
    for j, cm in enumerate(meta.columns):
        if cm.indicator_value is None and cm.parent_feature_name[0] in PBoston.REAL_FEATURES:
            rows = rng.choice(n, 8, replace=False)
            cols[cm.parent_feature_name[0]][rows] = \
                params["edges"][j, rng.integers(0, params["edges"].shape[1], 8)]
    return cols


def jax_answers(model, cols):
    """The JAX package's predictions for the request columns, through its
    ``BatchScoreFunction`` and its ``score``."""
    name = model.result_features[0].name
    pred = FX.regression_predictions(JBatchScoreFunction(model)(FX.records(cols)), name)
    np.testing.assert_array_equal(model.score(_frame(cols))[name].prediction, pred)
    return {"prediction": pred}


def forest_draws():
    """The stock forests' K8 draws in the sweep: bootstrap [50, 455] and
    feature masks [50, 16] (the regressor's one-third subsets)."""
    kb, kf = JT.rng_keys(42)
    return (np.asarray(JT.bootstrap_weights(kb, TRAIN_ROWS, 50)),
            np.asarray(JT.feature_masks(kf, 16, 50, 1.0 / 3.0)))


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    from boston import boston_data, build_workflow

    calls = []
    run = JSF.SweepPlan.run

    def recording_run(self, train_w, val_mask):
        out = run(self, train_w, val_mask)
        calls.append(out)
        return out

    JSF.SweepPlan.run = recording_run
    try:
        wf, _ = build_workflow()
        model = wf.set_input_dataset(boston_data(), key="id").train()
    finally:
        JSF.SweepPlan.run = run
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    boot, masks = forest_draws()
    np.savez_compressed(os.path.join(path, "sweep.npz"), metrics=np.stack(calls),
                        bootstrap=boot, feature_masks=masks)
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(model, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(model, cols))


def _summary():
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------
def test_boston_data_is_helloworlds():
    from boston import boston_data

    ref = boston_data()
    cols = PBoston.boston_data()
    assert list(cols) == list(ref.columns)
    for k in cols:
        np.testing.assert_array_equal(cols[k], ref[k].to_numpy(), err_msg=k)


def test_fixture_holds_the_stock_regression_sweep():
    summ = _summary()
    assert summ["problemType"] == "Regression"
    assert summ["bestModelName"] == "OpGBTRegressor"
    assert summ["bestGrid"] == {"max_depth": 12, "min_info_gain": 0.1,
                                "min_instances_per_node": 10, "max_iter": 20, "step_size": 0.1}
    assert [r["modelName"] for r in summ["validationResults"]] == \
        ["OpLinearRegression"] * 8 + ["OpRandomForestRegressor"] * 18 + ["OpGBTRegressor"] * 18
    assert [r["grid"] for r in summ["validationResults"]] == \
        JD.linear_regression_grid() + JD.random_forest_grid() + JD.gbt_grid()
    assert PD.linear_regression_grid() == JD.linear_regression_grid()
    assert PD.gbt_grid() == JD.gbt_grid()
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    assert sweep["metrics"].shape == (1, 3, 44, 4)
    # the RMSE column is the summary's fold metric
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(sweep["metrics"][0, :, :, 0].T, folds)
    # the two depth-6 GBT candidates at min_info_gain 0.001 and 0.01 tie
    # exactly; the winner leads the runner-up by 0.40%
    means = [r["metricValue"] for r in summ["validationResults"]]
    assert means[32] == means[34]
    ranked = sorted(means)
    assert ranked[0] == means[42] and (ranked[1] - ranked[0]) / ranked[0] > 4e-3


def test_jax_draws_equal_the_fixture_and_the_port():
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    boot, masks = forest_draws()
    np.testing.assert_array_equal(sweep["bootstrap"], boot)
    np.testing.assert_array_equal(sweep["feature_masks"], masks)
    kb, kf = PT.rng_keys(42)
    np.testing.assert_array_equal(PT.bootstrap_weights(kb, TRAIN_ROWS, 50).numpy(), boot)
    np.testing.assert_array_equal(PT.feature_masks(kf, 16, 50, 1.0 / 3.0).numpy(), masks)


def test_jax_reproduces_the_fixture_answers():
    model = J.OpWorkflowModel.load(FIXTURE)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    got = jax_answers(model, cols)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    np.testing.assert_array_equal(got["prediction"], expected["prediction"])


def test_port_scores_the_fixture_model():
    """The JAX package's saved model, scored by the port: predictions within
    ``FX.PRED_RTOL`` (float32 sums over 20 trees in another order)."""
    model = P.load_model(FIXTURE, device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    name = model.result_features[0].name
    pred = FX.regression_predictions(P.BatchScoreFunction(model)(FX.records(cols)), name)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))["prediction"]
    np.testing.assert_allclose(pred, expected, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL)
    np.testing.assert_array_equal(model.score(cols)[name].prediction, pred)
    assert model.score(cols)[name].probability is None


# ---------------------------------------------------------------------------
# the full-width train
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(port model, port save dir, port timings)."""
    pm, wf = PBoston.train_boston(device="cpu")
    tmp = tmp_path_factory.mktemp("boston")
    pm.save(str(tmp / "port"))
    return pm, str(tmp / "port"), wf.train_timings


def test_full_width_boston_train_matches_the_fixture(trained):
    pm, _, timings = trained
    gaps = FX.check_boston_train(pm)
    assert set(gaps) == set(FX.BOSTON_RMSE_RTOL)
    assert all(g <= 1e-3 for g in gaps.values())
    summ = pm.stages[-1].summary
    means = [r["metricValue"] for r in summ.validation_results]
    assert means[32] == means[34]  # the fixture's tie stays a tie
    # one fused sweep ran: its parts' host seconds are in the breakdown
    assert {"cv_sweep_fista", "cv_sweep_forest", "cv_sweep_gbt", "cv_sweep_metrics"} <= \
        set(timings)


def test_refit_and_holdout_match_the_fixture(trained):
    pm, _, _ = trained
    ref = _summary()
    summ = pm.stages[-1].summary
    assert summ.problem_type == "Regression"
    for key in ("RootMeanSquaredError", "MeanSquaredError", "R2", "MeanAbsoluteError"):
        np.testing.assert_allclose(summ.holdout_evaluation[key],
                                   ref["holdoutEvaluation"][key], rtol=HOLDOUT_RTOL)
    assert summ.holdout_evaluation["SignedPercentageErrorHistogram"] == \
        ref["holdoutEvaluation"]["SignedPercentageErrorHistogram"]
    assert summ.data_prep_parameters == ref["dataPrepParameters"]
    # the refit starts from the same float64 label mean
    jp = J.OpWorkflowModel.load(FIXTURE).stages[-1].model_params
    assert pm.stages[-1].model_params["base_score"] == jp["base_score"]
    assert pm.stages[-1].model_params["eta"] == jp["eta"]


def test_port_saved_model_scores_alike_in_both_packages(trained):
    pm, port_dir, _ = trained
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    jl = J.OpWorkflowModel.load(port_dir)
    pl = P.load_model(port_dir, device="cpu")
    name = pl.result_features[0].name
    jp = jl.score(_frame(cols))[jl.result_features[0].name].prediction
    pp = pl.score(cols)[name].prediction
    np.testing.assert_allclose(pp, jp, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL)
    np.testing.assert_array_equal(pm.score(cols)[name].prediction, pp)
    # against the JAX package's own model: the refit's trees may differ in
    # near-tied splits, so the predictions are compared by their error
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))["prediction"]
    assert np.sqrt(np.mean((pp - expected) ** 2)) < 0.05 * np.std(expected)


def test_port_saved_model_resaves_byte_equal(trained, tmp_path):
    _, port_dir, _ = trained
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
        {"__class_ref__": "transmogrifai_tpu.impl.regression.trees:OpGBTRegressor"}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
