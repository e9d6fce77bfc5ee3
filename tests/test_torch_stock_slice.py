"""The stock LR + RF + XGBoost model-selection sweep of the port against the
JAX package's, on the CPU.

The Titanic flow (``transmogrifai_tpu_torch/apps/titanic.py``) with the
binary selector's stock space cut to size (logistic regression as stocked:
8 elastic-net candidates; random forest's 18 candidates at 5 trees;
XGBoost's 2 at 8 rounds and depth 4) trains on the 891-row synthetic frame
in both packages, each on its default route: the fused sweep.  They must
agree on the winner, every candidate's fold AuPR (logistic regression
within ``FX.LR_AUPR_TOL``: FISTA's float32 sums in another order; random
forest within ``FX.RF_AUPR_TOL``: the forests are bit-equal and only the
AuPR's own sum differs; XGBoost within ``XGB_AUPR_TOL``: the histograms are
summed in fixed point against XLA's float32), the refit's coefficients and
the holdout metrics; the model the port saves loads and scores alike in
both packages and re-saves to byte-equal files.

The full-width run (the stock grids) is held to the committed fixture
``transmogrifai_tpu_torch/fixtures/titanic_stock/`` (marked ``slow``):
the JAX package's three fused-sweep calls' metrics, its draws, its saved
model and that model's answers for 256 requests.  Regenerate the fixture
with ``python tests/test_torch_stock_slice.py --write`` (trains with the
JAX package on the CPU, about a minute).
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
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "helloworld"))

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
from transmogrifai_tpu.impl.classification.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.impl.classification.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction
from transmogrifai_tpu.ops import trees as JT

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
from transmogrifai_tpu_torch.impl.classification.trees import (OpRandomForestClassifier,
                                                               OpXGBoostClassifier)
from transmogrifai_tpu_torch.impl.selector import defaults as PD
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

FIXTURE = FX.TITANIC_STOCK
#: the cut XGBoost candidates' fold AuPR (8 rounds: the fixed-point
#: histogram sums can move a near-tied split)
XGB_AUPR_TOL = 1e-4
#: the holdout metrics of the refit logistic regression
HOLDOUT_TOL = 1e-5
#: the refit's coefficients (FISTA, 200 steps, float32 sums in another order)
COEF_ATOL = 2e-5


def cut_space(lr, rf, xgb):
    """The stock space cut to size: LR as stocked, RF at 5 trees, XGBoost
    at 8 rounds and depth 4 (``lr``, ``rf``, ``xgb``: each package's
    classes)."""
    rf_grid = [dict(g, num_trees=5) for g in PD.random_forest_grid()]
    xgb_grid = [dict(g, num_round=8, max_depth=4) for g in PD.xgboost_grid()]
    return [(lr(max_iter=50), PD.logistic_regression_grid()), (rf(), rf_grid), (xgb(), xgb_grid)]


def _frame(cols):
    return pd.DataFrame({k: (list(v) if v.dtype == object else v) for k, v in cols.items()})


def family_gaps(mine, ref):
    """Largest fold-AuPR gap per family between two summaries' results."""
    gaps = {}
    for a, b in zip(mine, ref):
        assert (a["modelName"], a["grid"]) == (b["modelName"], b["grid"])
        g = max(abs(x - y) for x, y in zip(a["foldMetrics"], b["foldMetrics"]))
        gaps[a["modelName"]] = max(gaps.get(a["modelName"], 0.0), g)
    return gaps


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX model, port model, port save dir, JAX save dir, port timings)."""
    from test_torch_fixture import build_titanic
    from titanic import titanic_data

    jm = build_titanic(models_and_parameters=cut_space(JLR, JRF, JXGB)) \
        .set_input_dataset(titanic_data(), key="PassengerId").train()
    pm, wf = PTitanic.train_titanic(
        device="cpu",
        models_and_parameters=cut_space(OpLogisticRegression, OpRandomForestClassifier,
                                        OpXGBoostClassifier))
    tmp = tmp_path_factory.mktemp("stock")
    pm.save(str(tmp / "port"))
    jm.save(str(tmp / "jax"))
    return jm, pm, str(tmp / "port"), str(tmp / "jax"), wf.train_timings


def test_sweep_winner_and_fold_metrics_match_jax(trained):
    jm, pm, _, _, timings = trained
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert len(ps.validation_results) == len(js.validation_results) == 28
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name, js.best_grid)
    gaps = family_gaps(ps.validation_results, js.validation_results)
    assert gaps["OpLogisticRegression"] <= FX.LR_AUPR_TOL, gaps
    assert gaps["OpRandomForestClassifier"] <= FX.RF_AUPR_TOL, gaps
    assert gaps["OpXGBoostClassifier"] <= XGB_AUPR_TOL, gaps
    # the fused route ran: its parts' host seconds are in the breakdown
    assert {"cv_sweep_fista", "cv_sweep_forest", "cv_sweep_gbt", "cv_sweep_metrics"} <= \
        set(timings)


def test_refit_and_holdout_match_jax(trained):
    jm, pm, _, _, _ = trained
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert ps.best_model_name == "OpLogisticRegression"
    jp, pp = jm.stages[-1].model_params, pm.stages[-1].model_params
    for k in ("coef", "intercept"):
        assert pp[k].shape == jp[k].shape and pp[k].dtype == jp[k].dtype
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=COEF_ATOL)
    for key in ("AuPR", "AuROC", "Error", "F1"):
        assert abs(ps.holdout_evaluation[key] - js.holdout_evaluation[key]) <= HOLDOUT_TOL, key
    assert ps.data_prep_results == js.data_prep_results


def test_port_saved_model_scores_alike_in_both_packages(trained):
    _, pm, port_dir, _, _ = trained
    cols = PTitanic.titanic_data(300, 11)
    cols["Age"][::9] = np.nan
    cols["Embarked"][::13] = None
    jl = J.OpWorkflowModel.load(port_dir)
    pl = P.load_model(port_dir, device="cpu")
    name = pl.result_features[0].name
    jp = jl.score(_frame(cols))[jl.result_features[0].name]
    pp = pl.score(cols)[name]
    np.testing.assert_allclose(pp.probability, jp.probability, rtol=0, atol=FX.PROB_ATOL)
    off = np.abs(jp.raw_prediction[:, 1]) >= FX.BOUNDARY
    np.testing.assert_array_equal(pp.prediction[off], jp.prediction[off])
    np.testing.assert_array_equal(pm.score(cols)[name].probability, pp.probability)


def test_port_saved_model_resaves_byte_equal(trained, tmp_path):
    _, _, port_dir, jax_dir, _ = trained
    P.load_model(port_dir, device="cpu").save(str(tmp_path))
    with open(os.path.join(port_dir, "op_model.json"), "rb") as a, \
            open(tmp_path / "op_model.json", "rb") as b:
        assert a.read() == b.read()
    with np.load(os.path.join(port_dir, "op_model_arrays.npz")) as za, \
            np.load(tmp_path / "op_model_arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k
    mp, mj = (json.load(open(os.path.join(d, "op_model.json"))) for d in (port_dir, jax_dir))
    assert [s["class"] for s in mp["stages"]] == [s["class"] for s in mj["stages"]]
    assert [sorted(s["state"]) for s in mp["stages"]] == [sorted(s["state"]) for s in mj["stages"]]
    assert mp["stages"][-1]["state"]["predictor_class"] == \
        {"__class_ref__": "transmogrifai_tpu.impl.classification.logistic:OpLogisticRegression"}


@pytest.mark.parametrize("family", ["OpRandomForestClassifier", "OpXGBoostClassifier"])
def test_other_winning_families_refit_and_save(family, tmp_path):
    """A forest or boosted winner: the refit, the holdout evaluation, the
    summary, the save/load in both packages and the byte-equal re-save work
    for it too."""
    space = [(e, g[:2]) for e, g in cut_space(OpLogisticRegression, OpRandomForestClassifier,
                                               OpXGBoostClassifier)
             if type(e).__name__ == family]
    pm, _ = PTitanic.train_titanic(PTitanic.titanic_data(400, 5), device="cpu",
                                   models_and_parameters=space)
    summ = pm.stages[-1].summary
    assert summ.best_model_name == family and summ.holdout_evaluation["AuPR"] > 0.5
    pm.save(str(tmp_path))
    cols = PTitanic.titanic_data(50, 6)
    jl = J.OpWorkflowModel.load(str(tmp_path))
    pl = P.load_model(str(tmp_path), device="cpu")
    jp = jl.score(_frame(cols))[jl.result_features[0].name]
    pp = pl.score(cols)[pl.result_features[0].name]
    np.testing.assert_allclose(pp.probability, jp.probability, rtol=0, atol=1e-5)
    pl.save(str(tmp_path / "again"))
    with open(tmp_path / "op_model.json", "rb") as a, \
            open(tmp_path / "again" / "op_model.json", "rb") as b:
        assert a.read() == b.read()
    with np.load(tmp_path / "op_model_arrays.npz") as za, \
            np.load(tmp_path / "again" / "op_model_arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert all(np.array_equal(za[k], zb[k]) and za[k].dtype == zb[k].dtype for k in za.files)


# ---------------------------------------------------------------------------
# the committed full-width fixture
# ---------------------------------------------------------------------------
def lr_answers(model, cols):
    """The JAX package's answers for request columns (prediction,
    probability, rawPrediction) and the logistic margins as ``F``."""
    name = model.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(JBatchScoreFunction(model)(FX.records(cols)), name)
    full = model.score(pd.DataFrame(cols))
    np.testing.assert_array_equal(full[name].probability, prob)
    return {"prediction": pred, "probability": prob, "rawPrediction": raw,
            "F": raw[:, 1:2].astype(np.float32)}


def stock_draws():
    """The stock forests' K8 draws in each sweep call: bootstrap [50, 891]
    and feature masks [50, 10]."""
    kb, kf = JT.rng_keys(42)
    return (np.asarray(JT.bootstrap_weights(kb, 891, 50)),
            np.asarray(JT.feature_masks(kf, 10, 50, np.sqrt(10) / 10)))


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    from test_torch_fixture import make_requests, train_titanic

    calls = []
    run = JSF.SweepPlan.run

    def recording_run(self, train_w, val_mask):
        out = run(self, train_w, val_mask)
        calls.append(out)
        return out

    JSF.SweepPlan.run = recording_run
    try:
        with tempfile.TemporaryDirectory() as tmp:
            train_titanic(tmp)
            os.makedirs(path, exist_ok=True)
            for f in ("op_model.json", "op_model_arrays.npz"):
                shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    finally:
        JSF.SweepPlan.run = run
    boot, masks = stock_draws()
    np.savez_compressed(os.path.join(path, "sweep.npz"), metrics=np.stack(calls),
                        bootstrap=boot, feature_masks=masks)
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(model, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **lr_answers(model, cols))


def test_fixture_holds_the_stock_sweep():
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        summ = FX.stage_summary(json.load(fh))
    assert summ["bestModelName"] == "OpLogisticRegression"
    assert summ["bestGrid"] == {"reg_param": 0.001, "elastic_net_param": 0.1}
    assert [r["modelName"] for r in summ["validationResults"]] == \
        ["OpLogisticRegression"] * 8 + ["OpRandomForestClassifier"] * 18 + \
        ["OpXGBoostClassifier"] * 2
    assert [r["grid"] for r in summ["validationResults"]] == \
        JD.logistic_regression_grid() + JD.random_forest_grid() + JD.xgboost_grid()
    sweep = FX.load_sweep()
    assert sweep["metrics"].shape == (3, 1, 28, 6)
    # each call's AuPR column is the summary's fold metric of that call
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(sweep["metrics"][:, 0, :, 1].T, folds)


def test_jax_draws_equal_the_fixture_and_the_port():
    sweep = FX.load_sweep()
    boot, masks = stock_draws()
    np.testing.assert_array_equal(sweep["bootstrap"], boot)
    np.testing.assert_array_equal(sweep["feature_masks"], masks)
    kb, kf = PT.rng_keys(42)
    np.testing.assert_array_equal(PT.bootstrap_weights(kb, 891, 50).numpy(), boot)
    np.testing.assert_array_equal(PT.feature_masks(kf, 10, 50, np.sqrt(10) / 10).numpy(), masks)


def test_jax_reproduces_the_fixture_answers():
    model = J.OpWorkflowModel.load(FIXTURE)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    got = lr_answers(model, cols)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    for k, v in expected.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_scores_the_fixture_model():
    model = P.load_model(FIXTURE, device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    name = model.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(P.BatchScoreFunction(model)(FX.records(cols)), name)
    FX.compare(FX.load_expected(os.path.join(FIXTURE, "expected.npz")), pred, prob, raw)


@pytest.mark.slow
def test_full_width_stock_train_matches_the_fixture(tmp_path):
    model, _ = PTitanic.train_titanic(device="cpu")
    gaps = FX.check_stock_train(model, xgb_tol=XGB_AUPR_TOL)
    assert gaps["OpLogisticRegression"] <= FX.LR_AUPR_TOL
    model.save(str(tmp_path))
    loaded = P.load_model(str(tmp_path), device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    name = loaded.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(P.BatchScoreFunction(loaded)(FX.records(cols)), name)
    FX.compare(FX.load_expected(os.path.join(FIXTURE, "expected.npz")), pred, prob, raw)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
