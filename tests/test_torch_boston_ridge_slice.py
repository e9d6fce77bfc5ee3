"""The closed-form ridge fits in the Boston workflow's regression selector, on
the port against the JAX package's, on the CPU.

``OpLinearRegression`` refits every point without an L1 share (the default
constructor's reg 0 among them) in closed form: the weighted normal
equations ``(X1^T W X1 / sum(w) + diag(l2) + 1e-9 I) beta = X1^T W y /
sum(w)``, their products from K-S (``ops/linear.fit_ridge``); the
per-family path fits such grids by ``fit_ridge_grid_folds``.  The fused
sweep fits every linear-regression point by FISTA (K-N), as the JAX
package's does, so the sweep's fold RMSE (~9.6) and the closed-form
refit's holdout RMSE (~2.7) differ: that is the reference's behaviour,
kept.

The Boston flow (``transmogrifai_tpu_torch/apps/boston.py``) over
``[(OpLinearRegression(), grid(reg_param=[0, 0.001, 0.01, 0.1, 0.2],
elastic_net_param=[0]))]`` is held to the committed fixture
``transmogrifai_tpu_torch/fixtures/boston_ridge/`` by
``FX.check_boston_ridge_train``: the same winner (reg 0, 2e-6 of mean
fold RMSE ahead of reg 0.001), every fold RMSE within
``FX.RIDGE_RMSE_RTOL`` (relative), the refit's holdout metrics and the
saved model's predictions for the fixture's 256 requests with a seen
``chas`` category within ``FX.RIDGE_PRED_RTOL``.  The gap is stated, not
closed, for the requests with an unseen ``chas`` value: at reg 0 only the
1e-9 ridge conditions the ``chas`` pivot's null direction, so both
packages put amplified rounding noise there, and such a request reads it
(``FX.compare_ridge_predictions``).

Regenerate the fixture with ``python tests/test_torch_boston_ridge_slice.py
--write`` (trains with the JAX package on the CPU, a few seconds).
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
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.regression.linear import OpLinearRegression as JLinReg
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.impl.selector.factories import RegressionModelSelector as JRS
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import boston as PBoston
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.regression.linear import OpLinearRegression as PLinReg
from transmogrifai_tpu_torch.impl.selector import defaults as PD

torch.set_num_threads(1)

FIXTURE = FX.BOSTON_RIDGE
REGS = [0.0, 0.001, 0.01, 0.1, 0.2]


def _frame(cols):
    return pd.DataFrame(cols)


def space(pkg):
    LinReg, D = (JLinReg, JD) if pkg == "jax" else (PLinReg, PD)
    return [(LinReg(), D.grid(reg_param=REGS, elastic_net_param=[0.0]))]


def jax_train(models):
    """The JAX package's Boston flow (``helloworld/boston.py``'s features and
    selector) over ``models``."""
    from boston import boston_data

    medv = J.FeatureBuilder("medv", JTy.RealNN).extract(field="medv").as_response()
    nums = [J.FeatureBuilder(n, JTy.Real).extract(field=n).as_predictor()
            for n in PBoston.REAL_FEATURES]
    chas = J.FeatureBuilder("chas", JTy.PickList).extract(field="chas").as_predictor()
    features = nums[0].vectorize(*nums[1:]).combine(chas.pivot(min_support=1))
    pred = JRS.with_cross_validation(num_folds=3, seed=42, models_and_parameters=models) \
        .set_input(medv, features).get_output()
    return J.OpWorkflow().set_result_features(pred).set_input_dataset(
        boston_data(), key="id").train()


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
    np.testing.assert_array_equal(model.score(_frame(cols))[name].prediction, pred)
    return {"prediction": pred}


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    calls = []
    run = JSF.SweepPlan.run

    def recording_run(self, train_w, val_mask):
        out = run(self, train_w, val_mask)
        calls.append(out)
        return out

    JSF.SweepPlan.run = recording_run
    try:
        model = jax_train(space("jax"))
    finally:
        JSF.SweepPlan.run = run
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    np.savez_compressed(os.path.join(path, "sweep.npz"), metrics=np.stack(calls))
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(model, cols))


def _summary():
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


def test_fixture_holds_the_ridge_train():
    summ = _summary()
    assert summ["problemType"] == "Regression"
    assert summ["bestModelName"] == "OpLinearRegression"
    assert summ["bestGrid"] == {"reg_param": 0.0, "elastic_net_param": 0.0}
    assert [r["grid"] for r in summ["validationResults"]] == \
        JD.grid(reg_param=REGS, elastic_net_param=[0.0])
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    assert sweep["metrics"].shape == (1, 3, 5, 4)
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(sweep["metrics"][0, :, :, 0].T, folds)
    means = folds.astype(np.float64).mean(1)
    assert 0 < (means[1] - means[0]) / means[0] < 5e-6
    # the sweep's FISTA fits against the closed-form refit on the holdout
    assert means[0] > 9.0 and summ["holdoutEvaluation"]["RootMeanSquaredError"] < 3.0


def test_jax_reproduces_the_fixture_answers():
    model = J.OpWorkflowModel.load(FIXTURE)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    got = jax_answers(model, cols)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    np.testing.assert_array_equal(got["prediction"], expected["prediction"])


def test_port_scores_the_fixture_model():
    model = P.load_model(FIXTURE, device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    name = model.result_features[0].name
    pred = FX.regression_predictions(P.BatchScoreFunction(model)(FX.records(cols)), name)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))["prediction"]
    np.testing.assert_allclose(pred, expected, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL)
    np.testing.assert_array_equal(model.score(cols)[name].prediction, pred)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    calls = []
    run = PSF.SweepPlan.run

    def recording_run(plan, train_w, val_mask, timings=None):
        out = run(plan, train_w, val_mask, timings)
        calls.append((plan.spec, out))
        return out

    PSF.SweepPlan.run = recording_run
    try:
        model, _ = PBoston.train_boston(device="cpu", models_and_parameters=space("port"))
    finally:
        PSF.SweepPlan.run = run
    tmp = tmp_path_factory.mktemp("boston_ridge")
    model.save(str(tmp))
    return model, calls, str(tmp)


def test_ridge_train_matches_the_fixture(trained):
    model, calls, _ = trained
    found = FX.check_boston_ridge_train(model)
    assert found["holdout"]["R2"] > 0.9
    # one sweep call, the five points one FISTA fragment (K-N), as the JAX package's
    assert len(calls) == 1 and [f[0] for f in calls[0][0][1]] == ["fista"]
    ref = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))["metrics"][0]
    np.testing.assert_allclose(calls[0][1][..., :2], ref[..., :2], rtol=2 * FX.RIDGE_RMSE_RTOL)


def test_ridge_refit_predicts_like_the_fixture_in_both_packages(trained):
    model, _, port_dir = trained
    assert model.stages[-1].model_params["coef"].shape == (16,)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))["prediction"]
    pl = P.load_model(port_dir, device="cpu")
    name = pl.result_features[0].name
    pred = FX.regression_predictions(P.BatchScoreFunction(pl)(FX.records(cols)), name)
    gaps = FX.compare_ridge_predictions(pred, cols, expected)
    assert gaps["seen_rows"] > 200 and gaps["unseen_rows"] > 10
    jl = J.OpWorkflowModel.load(port_dir)
    jp = jl.score(_frame(cols))[jl.result_features[0].name].prediction
    np.testing.assert_allclose(jp, pred, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL)


def test_the_default_linear_regression_trains_on_the_per_family_path():
    """``OpLinearRegression()`` alone, its one grid point through
    ``fit_grid_folds`` (the ridge batch) and the refit through
    ``fit_ridge``, under a wrapped evaluator that builds no fused plan: the
    same fold RMSE as the JAX package's per-family path."""
    from transmogrifai_tpu.impl.tuning.validators import OpCrossValidation as JCV
    from transmogrifai_tpu.evaluators.regression import OpRegressionEvaluator as JEv

    from transmogrifai_tpu_torch.evaluators.regression import OpRegressionEvaluator as PEv
    from transmogrifai_tpu_torch.impl.tuning.validators import OpCrossValidation as PCV

    class JWrapped(JEv):
        pass

    class PWrapped(PEv):
        pass

    rng = np.random.default_rng(4)
    X = rng.standard_normal((240, 6)).astype(np.float32)
    X[:, 5] = (X[:, 4] > 0).astype(np.float32)
    y = (X @ rng.standard_normal(6) + 3.0 + 0.3 * rng.standard_normal(240)).astype(np.float32)
    cands = [{"reg_param": 0.0}, {"reg_param": 0.1}]
    js = JCV(JWrapped(), num_folds=3, seed=1).validate([(JLinReg(), cands)], X, y)
    ps = PCV(PWrapped(), num_folds=3, seed=1).validate([(PLinReg().to("cpu"), cands)],
                                                       torch.from_numpy(X), y)
    for a, b in zip(js.results, ps.results):
        np.testing.assert_allclose(b.fold_metrics, a.fold_metrics, rtol=1e-5)
        assert a.error is None and b.error is None
    assert js.best_index == ps.best_index


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
