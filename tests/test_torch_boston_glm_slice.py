"""The GLM family in the Boston workflow's regression selector, on the port
against the JAX package's, on the CPU.

``apps/boston.glm_space()`` is ``[(OpGeneralizedLinearRegression(), grid)]``
over gaussian / identity, poisson / log, gamma / log and tweedie / log
(variance power 1.5), each x ``reg_param`` {0.001, 0.01, 0.1}: 12
candidates.  The GLM has no fused fragment, so both packages take the
per-family sweep: one ``fit_grid_folds`` a (family, link) group (K-S in GLM
mode for the port's IRLS steps), the refit of the winner by ``fit_arrays``,
the holdout evaluation, and ``OpWorkflowModel.save`` in the format both
packages read.  The train on the 506-row frame is held to the committed
fixture ``transmogrifai_tpu_torch/fixtures/boston_glm/`` by
``FX.check_boston_glm_train``: the same winner (gaussian / identity, reg
0.001, 0.0066 of mean fold RMSE ahead of reg 0.01), all 36 fold RMSE
within ``FX.GLM_RMSE_RTOL`` (relative; the reference solves each IRLS step
in float32, the port in float64), the holdout metrics within
``FX.GLM_PRED_RTOL``; the JAX-saved winner scores the fixture's 256
requests through the port within ``FX.PRED_RTOL``; the port's refit scores
them within ``FX.GLM_PRED_RTOL`` where ``chas`` is a seen category and
within ``FX.GLM_UNSEEN_ATOL`` where it is not (the pivot's near-null
direction, ``FX.compare_glm_predictions``); and the port-saved winner
loads in the JAX package and scores alike.

Regenerate the fixture with ``python tests/test_torch_boston_glm_slice.py
--write`` (trains with the JAX package on the CPU, the 2^18-row train
included: about a quarter of a minute).
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
import transmogrifai_tpu.types as JTy
from transmogrifai_tpu.impl.regression.glm import OpGeneralizedLinearRegression as JGLM
from transmogrifai_tpu.impl.selector.factories import RegressionModelSelector as JRS
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import boston as PBoston
from transmogrifai_tpu_torch.impl.regression.glm import OpGeneralizedLinearRegression as PGLM

torch.set_num_threads(1)

FIXTURE = FX.BOSTON_GLM
#: the JAX package's scale train, held by ``chip_smoke.py`` on the card
SCALE_ROWS, SCALE_SEED = 1 << 18, 0


def jax_space():
    """``apps/boston.glm_space()`` with the JAX package's estimator."""
    (_, grid), = PBoston.glm_space()
    return [(JGLM(), grid)]


def jax_train(cols):
    """The JAX package's Boston flow (``helloworld/boston.py``'s features and
    selector) over the GLM space."""
    medv = J.FeatureBuilder("medv", JTy.RealNN).extract(field="medv").as_response()
    nums = [J.FeatureBuilder(n, JTy.Real).extract(field=n).as_predictor()
            for n in PBoston.REAL_FEATURES]
    chas = J.FeatureBuilder("chas", JTy.PickList).extract(field="chas").as_predictor()
    features = nums[0].vectorize(*nums[1:]).combine(chas.pivot(min_support=1))
    pred = JRS.with_cross_validation(num_folds=3, seed=42, models_and_parameters=jax_space()) \
        .set_input(medv, features).get_output()
    return J.OpWorkflow().set_result_features(pred).set_input_dataset(
        pd.DataFrame(cols), key="id").train()


def make_requests(n=256, seed=0):
    """Boston-schema request columns from ``seed``: NaN in every real
    feature and an unseen ``chas`` value."""
    rng = np.random.default_rng(seed)
    cols = PBoston.boston_data(n, seed + 100)
    cols["id"] = np.arange(10_000, 10_000 + n)
    cols["chas"] = rng.choice([0, 1, 2], n, p=[0.8, 0.1, 0.1])
    for f in PBoston.REAL_FEATURES:
        cols[f][rng.random(n) < 0.1] = np.nan
    return cols


def jax_answers(model, cols):
    name = model.result_features[0].name
    pred = FX.regression_predictions(JBatchScoreFunction(model)(FX.records(cols)), name)
    np.testing.assert_array_equal(model.score(pd.DataFrame(cols))[name].prediction, pred)
    return {"prediction": pred}


def _folds(model):
    summ = model.stages[-1].summary
    best = [(r["modelName"], r["grid"]) for r in summ.validation_results].index(
        (summ.best_model_name, summ.best_grid))
    return np.array([r["foldMetrics"] for r in summ.validation_results], np.float64), best


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    from boston import boston_data

    model = jax_train(boston_data())
    scale, scale_best = _folds(jax_train(PBoston.boston_data(SCALE_ROWS, SCALE_SEED)))
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    folds, best = _folds(model)
    np.savez_compressed(os.path.join(path, "sweep.npz"), fold_rmse=folds, best=best,
                        scale_fold_rmse=scale, scale_best=scale_best, scale_rows=SCALE_ROWS,
                        scale_seed=SCALE_SEED)
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(model, cols))


def _summary():
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


def test_fixture_holds_the_glm_train():
    summ = _summary()
    (_, grid), = PBoston.glm_space()
    assert summ["problemType"] == "Regression"
    assert summ["bestModelName"] == "OpGeneralizedLinearRegression"
    assert summ["bestGrid"] == {"family": "gaussian", "link": "identity",
                                "variance_power": 0.0, "reg_param": 0.001}
    assert [r["grid"] for r in summ["validationResults"]] == grid
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]])
    np.testing.assert_array_equal(sweep["fold_rmse"], folds)
    assert int(sweep["best"]) == 0 and int(sweep["scale_best"]) == 0
    assert sweep["scale_fold_rmse"].shape == (12, 3) and int(sweep["scale_rows"]) == SCALE_ROWS
    assert np.isfinite(sweep["scale_fold_rmse"]).all()
    means = folds.mean(1)
    assert all(r["error"] is None for r in summ["validationResults"])
    assert (means[1] - means[0]) / means[0] > 10 * FX.GLM_RMSE_RTOL
    # the log-link families trail the linear medv by more than 1.4 RMSE
    assert means[3:].min() - means[0] > 1.4


def test_jax_reproduces_the_fixture_answers():
    model = J.OpWorkflowModel.load(FIXTURE)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    got = jax_answers(model, cols)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    np.testing.assert_array_equal(got["prediction"], expected["prediction"])


def test_port_scores_the_fixture_model():
    model = P.load_model(FIXTURE, device="cpu")
    assert model.stages[-1].predictor_class is PGLM
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    name = model.result_features[0].name
    pred = FX.regression_predictions(P.BatchScoreFunction(model)(FX.records(cols)), name)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))["prediction"]
    np.testing.assert_allclose(pred, expected, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL)
    np.testing.assert_array_equal(model.score(cols)[name].prediction, pred)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    model, wf = PBoston.train_boston(device="cpu", models_and_parameters=PBoston.glm_space())
    tmp = tmp_path_factory.mktemp("boston_glm")
    model.save(str(tmp))
    return model, wf, str(tmp)


def test_glm_train_matches_the_fixture(trained):
    model, wf, _ = trained
    found = FX.check_boston_glm_train(model)
    assert found["holdout"]["R2"] > 0.9
    # the per-family path, one fit_grid_folds call for the family
    assert "cv_sweep_OpGeneralizedLinearRegression" in wf.train_timings
    assert all(r["error"] is None for r in model.stages[-1].summary.validation_results)


def test_glm_refit_predicts_like_the_fixture_in_both_packages(trained):
    model, _, port_dir = trained
    params = model.stages[-1].model_params
    assert params["link"] == "identity" and params["coef"].shape == (16,)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))["prediction"]
    pl = P.load_model(port_dir, device="cpu")
    name = pl.result_features[0].name
    pred = FX.regression_predictions(P.BatchScoreFunction(pl)(FX.records(cols)), name)
    gaps = FX.compare_glm_predictions(pred, cols, expected)
    assert gaps["seen_rows"] > 200 and gaps["unseen_rows"] > 10
    jl = J.OpWorkflowModel.load(port_dir)
    jp = jl.score(pd.DataFrame(cols))[jl.result_features[0].name].prediction
    np.testing.assert_allclose(jp, pred, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
