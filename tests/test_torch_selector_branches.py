"""The selectors' branches that slice 12 ports, on the port against the JAX
package's, on the CPU.

- A two-class label under the multiclass evaluator: the Titanic flow with
  ``MultiClassificationModelSelector`` (3-fold CV, the Error metric,
  ``DataCutter``) over the binary selector's stock space.  The fused sweep
  trains the binary families' models (the LR elastic-net points are the
  "fista" fragment, which a multiclass problem fits by softmax over the two
  classes, as the reference's interpreter does; the forests and XGBoost
  their one-channel binary kernels) and expands each class-1 score p to the
  planes [1 - p, p] before K-Q's metrics.
- ``OpTrainValidationSplit`` and ``with_train_validation_split``: its masks
  bit-equal to the JAX package's, and the Titanic flow with the binary
  selector's split (one 75 / 25 fold).
- ``OpBinScoreEvaluator``, ``OpLogLoss`` and ``OpForecastEvaluator`` on the
  same arrays within 1e-12 relative, and on a train's scores.

A cut space (two points a family, few trees and rounds) trains through both
packages in tier 1; the full-width trains (the stock space, 28 candidates)
are held to ``transmogrifai_tpu_torch/fixtures/titanic_branches/`` by
``FX.check_titanic_branches_train`` (``slow`` here; ``chip_smoke.py`` runs
them on the card).  Regenerate the fixture with ``python
tests/test_torch_selector_branches.py --write`` (the JAX package on the CPU,
about two minutes).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "helloworld"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JTy
from transmogrifai_tpu import evaluators as JE
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification import logistic as JLo
from transmogrifai_tpu.impl.classification import trees as JTr
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.impl.selector import factories as JF
from transmogrifai_tpu.impl.tuning import validators as JV

from transmogrifai_tpu_torch import evaluators as PE
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.classification import logistic as PLo
from transmogrifai_tpu_torch.impl.classification import trees as PTr
from transmogrifai_tpu_torch.impl.selector import defaults as PD
from transmogrifai_tpu_torch.impl.tuning import validators as PV

torch.set_num_threads(1)

FIXTURE = FX.TITANIC_BRANCHES
#: the evaluators' metrics against the JAX package's, relative (both float64
#: numpy on the same arrays)
EVAL_RTOL = 1e-12


def recorded(module, train, *args):
    """(train(*args), the metrics of each fused-sweep call it made, the
    masks (train_w, val_mask) of the first)."""
    calls, masks = [], []
    run = module.SweepPlan.run

    def recording_run(self, train_w, val_mask, *a, **k):
        out = run(self, train_w, val_mask, *a, **k)
        calls.append(np.asarray(out))
        masks.append((np.asarray(train_w), np.asarray(val_mask)))
        return out

    module.SweepPlan.run = recording_run
    try:
        out = train(*args)
    finally:
        module.SweepPlan.run = run
    return out, np.stack(calls), masks[0]


def stock_space(pkg):
    Lo, Tr, D = (JLo, JTr, JD) if pkg == "jax" else (PLo, PTr, PD)
    return [(Lo.OpLogisticRegression(max_iter=50), D.logistic_regression_grid()),
            (Tr.OpRandomForestClassifier(), D.random_forest_grid()),
            (Tr.OpXGBoostClassifier(), D.xgboost_grid())]


def cut_space(pkg):
    """Two points a family: an elastic-net and a pure-L2 LR, forests of 5
    trees, XGBoost of 4 rounds at depth 3."""
    Lo, Tr, D = (JLo, JTr, JD) if pkg == "jax" else (PLo, PTr, PD)
    return [(Lo.OpLogisticRegression(max_iter=50),
             [{"reg_param": 0.01, "elastic_net_param": 0.1},
              {"reg_param": 0.1, "elastic_net_param": 0.0}]),
            (Tr.OpRandomForestClassifier(num_trees=5),
             D.grid(max_depth=[3, 6], min_info_gain=[0.001], min_instances_per_node=[10])),
            (Tr.OpXGBoostClassifier(),
             D.grid(num_round=[4], eta=[0.3], min_child_weight=[1.0, 10.0], max_depth=[3]))]


#: the JAX package's selectors by the port's names (``apps/titanic.SELECTORS``)
JAX_SELECTORS = {
    "split": (JF.BinaryClassificationModelSelector, "with_train_validation_split",
              {"seed": 42}),
    "multiclass": (JF.MultiClassificationModelSelector, "with_cross_validation",
                   {"num_folds": 3, "seed": 42}),
}


def jax_titanic(selector, models):
    """The JAX package's Titanic flow (``tests/test_torch_fixture.build_titanic``'s
    features) under ``selector``, trained on its synthetic frame."""
    from titanic import titanic_data

    F = J.FeatureBuilder
    survived = F("Survived", JTy.RealNN).extract(field="Survived").as_response()
    pclass = F("Pclass", JTy.PickList).extract(field="Pclass").as_predictor()
    name = F("Name", JTy.Text).extract(field="Name").as_predictor()
    sex = F("Sex", JTy.PickList).extract(field="Sex").as_predictor()
    age = F("Age", JTy.Real).extract(field="Age").as_predictor()
    sib_sp = F("SibSp", JTy.Integral).extract(field="SibSp").as_predictor()
    par_ch = F("Parch", JTy.Integral).extract(field="Parch").as_predictor()
    fare = F("Fare", JTy.Real).extract(field="Fare").as_predictor()
    embarked = F("Embarked", JTy.PickList).extract(field="Embarked").as_predictor()
    family_size = (sib_sp + par_ch + 1).alias("family_size")
    features = family_size.vectorize(age, fare, label=survived).combine(
        sex.pivot(pclass, embarked, top_k=10, min_support=1),
        name.smart_vectorize(max_cardinality=10, num_hashes=64, min_support=1))
    checked = features.sanity_check(survived)
    factory, method, args = JAX_SELECTORS[selector]
    pred = getattr(factory, method)(models_and_parameters=models, **args) \
        .set_input(survived, checked).get_output()
    return J.OpWorkflow().set_result_features(pred).set_input_dataset(
        titanic_data(), key="PassengerId").train()


def port_titanic(selector, models):
    return PTitanic.train_titanic(device="cpu", selector=selector,
                                  models_and_parameters=models)[0]


def write_fixture(path=FIXTURE):
    out = {}
    for sel in ("multiclass", "split"):
        model, metrics, (tw, vm) = recorded(JSF, jax_titanic, sel, stock_space("jax"))
        summ = model.stages[-1].summary
        best = [(r["modelName"], r["grid"]) for r in summ.validation_results].index(
            (summ.best_model_name, summ.best_grid))
        out.update({f"{sel}_metrics": metrics, f"{sel}_best": np.int64(best),
                    f"{sel}_train_w": tw, f"{sel}_val_mask": vm,
                    f"{sel}_folds": np.array([r["foldMetrics"] for r in
                                              summ.validation_results], np.float64)})
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "sweep.npz"), **out)


# ---------------------------------------------------------------------------
# the train/validation split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stratify", [False, True])
@pytest.mark.parametrize("ratio", [0.75, 0.5, 0.9])
def test_train_validation_split_masks_are_the_jax_packages(stratify, ratio):
    rng = np.random.default_rng(3)
    y = (rng.random(1001) < 0.3).astype(np.float32)
    ev = PE.OpBinaryClassificationEvaluator()
    pv = PV.OpTrainValidationSplit(ev, train_ratio=ratio, seed=7, stratify=stratify)
    jv = JV.OpTrainValidationSplit(JE.OpBinaryClassificationEvaluator(), train_ratio=ratio,
                                   seed=7, stratify=stratify)
    for a, b in zip(pv.make_folds(len(y), y if stratify else None),
                    jv.make_folds(len(y), y if stratify else None)):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    with pytest.raises(ValueError, match="train_ratio"):
        PV.OpTrainValidationSplit(ev, train_ratio=1.0)


def test_with_train_validation_split_builds_the_split_selector():
    sel = PTitanic.SELECTORS["split"]
    model = getattr(sel[0], sel[1])(seed=42)
    assert isinstance(model.validator, PV.OpTrainValidationSplit)
    assert model.validator.train_ratio == 0.75 and model.validator.seed == 42
    for cls in ("MultiClassificationModelSelector", "RegressionModelSelector"):
        from transmogrifai_tpu_torch.impl.selector import factories as PF

        assert getattr(PF, cls).with_train_validation_split(train_ratio=0.6) \
            .validator.train_ratio == 0.6


# ---------------------------------------------------------------------------
# the cut space through both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["multiclass", "split"])
def cut(request):
    """(selector, the JAX package's model, the port's, the port's sweep
    metrics and first call's masks).  The JAX package's sweep calls are not
    recorded here: on the test suite's 8-device CPU mesh its validator takes
    the mesh's launcher, not ``SweepPlan.run``."""
    sel = request.param
    jm = jax_titanic(sel, cut_space("jax"))
    pm, pmetrics, pmasks = recorded(PSF, port_titanic, sel, cut_space("port"))
    return sel, jm, pm, pmetrics, pmasks


def test_cut_space_sweep_equals_the_jax_packages(cut):
    """The fold masks of the validator, the same winner, every fold metric
    within its family's tolerance (``FX.BRANCHES_TOL``)."""
    sel, jm, pm, pmetrics, pmasks = cut
    # one sweep call a workflow-level fold (the features refit in each)
    calls = 3 if sel == "multiclass" else 1
    assert pmasks[0].shape[0] == pmasks[1].shape[0] == 1
    assert pmetrics.shape == (calls, 1, 6, 4 if sel == "multiclass" else 6)
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert ps.validation_type == js.validation_type
    assert [(r["modelName"], r["grid"]) for r in ps.validation_results] == \
        [(r["modelName"], r["grid"]) for r in js.validation_results]
    for mine, theirs in zip(ps.validation_results, js.validation_results):
        tol = FX.BRANCHES_TOL[sel][mine["modelName"]]
        np.testing.assert_allclose(mine["foldMetrics"], theirs["foldMetrics"], rtol=0,
                                   atol=tol, err_msg=f"{mine['modelName']} {mine['grid']}")
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name, js.best_grid)
    if sel == "multiclass":
        assert ps.evaluation_metric == "Error" and ps.problem_type == "MultiClassification"
    else:
        assert len(ps.validation_results[0]["foldMetrics"]) == 1


def test_two_class_multiclass_plan_trains_the_binary_kernels():
    """The plan of a two-class label under the multiclass evaluator: the
    binary families' fragments (an LR "newton" fragment, one-channel
    forests, the logistic loss) and the reference's strict flags."""
    rng = np.random.default_rng(0)
    n, d = 120, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    tw, _ = PV.make_fold_weights(n, 3, 7)
    ev = PE.OpMultiClassificationEvaluator()
    jplan = JSF.build_sweep_plan(cut_space("jax"), X, y, tw, JE.OpMultiClassificationEvaluator())
    pplan = PSF.build_sweep_plan(cut_space("port"), torch.from_numpy(X), y, tw, ev)
    assert pplan.spec[0] == jplan.spec[0] == ("multiclass", 2)
    assert pplan.spec[2] == jplan.spec[2]
    assert [f[0] for f in pplan.spec[1]] == [f[0] for f in jplan.spec[1]]
    forest = [f for f in pplan.spec[1] if f[0] == "forest"][0]
    gbt = [f for f in pplan.spec[1] if f[0] == "gbt"][0]
    assert forest[1] == 1 and gbt[1:3] == ("logistic", 1)


# ---------------------------------------------------------------------------
# the evaluators
# ---------------------------------------------------------------------------
def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=EVAL_RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_score_evaluator_equals_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    n = 997
    y = (rng.random(n) < 0.4).astype(np.float64)
    p = rng.random(n).astype(np.float32)
    p[:5] = [0.0, 1.0, 0.5, 0.01, 0.99]
    prob = np.stack([1 - p, p], axis=1)
    for bins in (100, 7):
        _close(PE.OpBinScoreEvaluator(num_bins=bins).evaluate_arrays(y, (p > 0.5) * 1.0, prob),
               JE.OpBinScoreEvaluator(num_bins=bins).evaluate_arrays(y, (p > 0.5) * 1.0, prob))
    _close(PE.OpBinScoreEvaluator().evaluate_arrays(y, p), JE.OpBinScoreEvaluator()
           .evaluate_arrays(y, p))
    assert PE.Evaluators.BinaryClassification.brierScore().default_metric == "BrierScore"


@pytest.mark.parametrize("k", [2, 3, 5])
def test_log_loss_equals_the_jax_packages(k):
    rng = np.random.default_rng(k)
    n = 500
    y = rng.integers(0, k, n)
    prob = rng.dirichlet(np.ones(k), n).astype(np.float32)
    prob[0, y[0]] = 0.0  # clipped at 1e-15
    _close(PE.OpLogLoss().evaluate_arrays(y, prob.argmax(1), prob),
           JE.OpLogLoss().evaluate_arrays(y, prob.argmax(1), prob))
    with pytest.raises(ValueError, match="probabilities"):
        PE.OpLogLoss().evaluate_arrays(y, prob.argmax(1))
    assert PE.Evaluators.MultiClassification.logLoss().default_metric == "LogLoss"


@pytest.mark.parametrize("window", [1, 3, 12, 600])
def test_forecast_evaluator_equals_the_jax_packages(window):
    rng = np.random.default_rng(window)
    n = 400
    y = np.sin(np.arange(n) / 5.0) * 10 + rng.normal(size=n)
    y[:3] = 0.0
    pred = y + rng.normal(size=n).astype(np.float32)
    pred[0] = 0.0  # a zero denominator counts 0
    _close(PE.OpForecastEvaluator(seasonal_window=window).evaluate_arrays(y, pred),
           JE.OpForecastEvaluator(seasonal_window=window).evaluate_arrays(y, pred))
    assert PE.Evaluators.Regression.smape().default_metric == "SMAPE"


def test_evaluators_on_a_trains_scores(cut):
    """The three evaluators on the cut train's holdout scores (the port's
    model on the port, the JAX package's on the JAX package)."""
    sel, jm, pm, _, _ = cut
    cols = PTitanic.titanic_data(300, 5)
    import pandas as pd

    jp = jm.score(pd.DataFrame(cols))[jm.result_features[0].name]
    pp = pm.score(cols)[pm.result_features[0].name]
    y = cols["Survived"].astype(np.float64)
    for P_, J_ in ((PE.OpBinScoreEvaluator(), JE.OpBinScoreEvaluator()),
                   (PE.OpLogLoss(), JE.OpLogLoss())):
        mine = P_.evaluate_arrays(y, pp.prediction, pp.probability)
        theirs = J_.evaluate_arrays(y, jp.prediction, jp.probability)
        k = P_.default_metric
        np.testing.assert_allclose(mine[k], theirs[k], rtol=FX.BRANCHES_SCORE_RTOL, atol=0)
    mine = PE.OpForecastEvaluator().evaluate_arrays(y, pp.probability[:, 1])
    theirs = JE.OpForecastEvaluator().evaluate_arrays(y, jp.probability[:, 1])
    np.testing.assert_allclose(mine["SMAPE"], theirs["SMAPE"], rtol=FX.BRANCHES_SCORE_RTOL)


# ---------------------------------------------------------------------------
# the full-width trains, against the fixture
# ---------------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.parametrize("sel", ["multiclass", "split"])
def test_full_width_train_matches_the_fixture(sel):
    model, metrics, masks = recorded(PSF, port_titanic, sel, stock_space("port"))
    FX.check_titanic_branches_train(model, sel, metrics, masks)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture()
    print(f"wrote {FIXTURE}")
