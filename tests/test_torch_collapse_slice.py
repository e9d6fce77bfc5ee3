"""Round-collapsed boosting in the three selectors, on the port against the
JAX package's, on the CPU.

Collapse reaches a workflow two ways: the stage parameter
(``OpXGBoostClassifier(trees_per_round=4)``, or a grid key) and the default
``TMOG_GBT_ROUND_COLLAPSE`` (the JAX package's model setting).  Either way
the selectors' fused sweeps run their "gbt" groups at K trees a step
(``ops/sweep._gbt_group_scores`` -> ``ops/trees.fit_gbt_batch``: the
collapse modes of K-H and K-R), and the refit stores each tree's eta / K.

- The two routes give the same plan, and the port's plans equal the JAX
  package's; the stock XGB grid's sequential chain is 200 steps of 10
  levels at K = 1 and 50 at K = 4.
- A cut space (few rounds, draws at 0.8) trains through both packages in
  tier 1: Titanic (binary, logistic), Iris (softmax, every fold Error bit
  for bit) and Boston (squared from each fold's label mean, fold RMSE
  within 2e-4 relative).
- The JAX-saved collapsed XGBoost model (``fixtures/titanic_collapse``:
  K = 4, ``subsample=0.8, colsample_bytree=0.8``) scores in the port within
  the serve tolerances of ``fixtures/titanic_xgb``.
- The full-width trains (``slow`` here, on the card in ``chip_smoke.py``)
  against the fixtures: the Titanic stock space under K = 4 (the JAX
  package's winner, XGB fold AuPR within 2e-4), Iris XGB at K = 4 (every
  fold Error bit for bit), Boston's stock space under K = 4 (fold RMSE
  within 2e-4 relative).

Regenerate the fixtures with ``python tests/test_torch_collapse_slice.py
--write`` (the JAX package on the CPU, about three minutes).
"""
import argparse
import contextlib
import json
import os
import shutil
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
from transmogrifai_tpu.evaluators.classification import OpBinaryClassificationEvaluator as JBE
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification import logistic as JLo
from transmogrifai_tpu.impl.classification import trees as JTr
from transmogrifai_tpu.impl.regression import trees as JRTr
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.ops import sweep as JS

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import boston as PBoston
from transmogrifai_tpu_torch.apps import iris as PIris
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.evaluators.classification import \
    OpBinaryClassificationEvaluator as PBE
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.classification import logistic as PLo
from transmogrifai_tpu_torch.impl.classification import trees as PTr
from transmogrifai_tpu_torch.impl.regression import trees as PRTr
from transmogrifai_tpu_torch.impl.selector import defaults as PD
from transmogrifai_tpu_torch.impl.tuning.validators import make_fold_weights
from transmogrifai_tpu_torch.ops import sweep as PS

torch.set_num_threads(1)

ENV = "TMOG_GBT_ROUND_COLLAPSE"


@contextlib.contextmanager
def collapse_env(k):
    """``TMOG_GBT_ROUND_COLLAPSE`` set to ``k`` inside the block (unset for
    None)."""
    with pytest.MonkeyPatch.context() as mp:
        if k is None:
            mp.delenv(ENV, raising=False)
        else:
            mp.setenv(ENV, str(k))
        yield


def xgb_collapse_space(pkg):
    """The one-family space of the collapsed XGB fixture."""
    Tr, D = (JTr, JD) if pkg == "jax" else (PTr, PD)
    return [(Tr.OpXGBoostClassifier(trees_per_round=4, subsample=0.8, colsample_bytree=0.8),
             D.xgboost_grid())]


def iris_xgb_space(pkg):
    Tr, D = (JTr, JD) if pkg == "jax" else (PTr, PD)
    return [(Tr.OpXGBoostClassifier(trees_per_round=4), D.xgboost_grid())]


def _folds(model):
    summ = model.stages[-1].summary
    return (np.array([r["foldMetrics"] for r in summ.validation_results], np.float64),
            np.int64(FX._best_index(summ)))


def jax_titanic(models=None):
    from test_torch_fixture import build_titanic
    from titanic import titanic_data

    return build_titanic(None, models).set_input_dataset(titanic_data(),
                                                         key="PassengerId").train()


def jax_boston():
    from boston import boston_data, build_workflow

    wf, _ = build_workflow()
    return wf.set_input_dataset(boston_data(), key="id").train()


def write_fixture():
    import tempfile

    from test_torch_fixture import jax_answers, make_requests
    from test_torch_iris_boost_slice import jax_train as jax_iris

    path = FX.TITANIC_COLLAPSE
    with collapse_env(None):
        model = jax_titanic(xgb_collapse_space("jax"))
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    xgb_folds, xgb_best = _folds(model)
    with collapse_env(4):
        stock_folds, stock_best = _folds(jax_titanic())
    np.savez_compressed(os.path.join(path, "sweep.npz"), xgb_folds=xgb_folds, xgb_best=xgb_best,
                        stock_folds=stock_folds, stock_best=stock_best)
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(model, seed=0)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(model, cols))
    with collapse_env(None):
        folds, best = _folds(jax_iris(iris_xgb_space("jax")))
    os.makedirs(FX.IRIS_COLLAPSE, exist_ok=True)
    np.savez_compressed(os.path.join(FX.IRIS_COLLAPSE, "sweep.npz"), folds=folds, best=best)
    with collapse_env(4):
        folds, best = _folds(jax_boston())
    os.makedirs(FX.BOSTON_COLLAPSE, exist_ok=True)
    np.savez_compressed(os.path.join(FX.BOSTON_COLLAPSE, "sweep.npz"), folds=folds, best=best)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------
def _plans(models_jax, models_port, k_env):
    rng = np.random.default_rng(0)
    n, d = 240, 12
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    tw, _ = make_fold_weights(n, 3, seed=7)
    with collapse_env(k_env):
        jplan = JSF.build_sweep_plan(models_jax, X, y, tw, JBE())
        pplan = PSF.build_sweep_plan(models_port, torch.from_numpy(X), y, tw, PBE())
    return jplan, pplan


def _stock(pkg):
    Lo, Tr, D = (JLo, JTr, JD) if pkg == "jax" else (PLo, PTr, PD)
    return [(Lo.OpLogisticRegression(max_iter=50), D.logistic_regression_grid()),
            (Tr.OpRandomForestClassifier(), D.random_forest_grid()),
            (Tr.OpXGBoostClassifier(), D.xgboost_grid())]


def _gbt_groups(plan):
    return [g for f in plan.spec[1] if f[0] == "gbt" for g in f[3]]


@pytest.mark.parametrize("k_env,chain", [(None, {"steps": 200, "levels": 2000}),
                                         (4, {"steps": 50, "levels": 500}),
                                         ("junk", {"steps": 200, "levels": 2000})])
def test_stock_grid_chain_equals_the_jax_packages(k_env, chain):
    jplan, pplan = _plans(_stock("jax"), _stock("port"), k_env)
    assert PS.gbt_chain(pplan.spec) == JS._spec_gbt_chain(jplan.spec) == chain
    assert _gbt_groups(pplan) == _gbt_groups(jplan)


def test_parameter_and_environment_routes_give_the_same_plan():
    space = lambda Tr, D, **kw: [(Tr.OpXGBoostClassifier(**kw), D.xgboost_grid())]  # noqa: E731
    _, by_env = _plans(space(JTr, JD), space(PTr, PD), 4)
    jplan, by_param = _plans(space(JTr, JD, trees_per_round=4),
                             space(PTr, PD, trees_per_round=4), None)
    assert by_env.spec == by_param.spec
    assert _gbt_groups(by_param) == _gbt_groups(jplan)
    assert all(g[11] == 4 for g in _gbt_groups(by_param))
    # a grid key is the third route; rounds K does not divide train uncollapsed
    grid = [{"num_round": 10, "max_depth": 3, "trees_per_round": 4},
            {"num_round": 12, "max_depth": 3, "trees_per_round": 4}]
    _, by_grid = _plans([(JTr.OpXGBoostClassifier(), grid)],
                        [(PTr.OpXGBoostClassifier(), grid)], None)
    assert sorted(g[11] for g in _gbt_groups(by_grid)) == [1, 4]


# ---------------------------------------------------------------------------
# cut spaces through both packages (tier 1)
# ---------------------------------------------------------------------------
def titanic_cut(pkg):
    Lo, Tr, D = (JLo, JTr, JD) if pkg == "jax" else (PLo, PTr, PD)
    return [(Lo.OpLogisticRegression(max_iter=50),
             [{"reg_param": 0.01, "elastic_net_param": 0.1}]),
            (Tr.OpRandomForestClassifier(num_trees=5),
             D.grid(max_depth=[3], min_info_gain=[0.001], min_instances_per_node=[10])),
            (Tr.OpXGBoostClassifier(trees_per_round=4, subsample=0.8, colsample_bytree=0.8),
             D.grid(num_round=[8], eta=[0.3], min_child_weight=[1.0, 10.0], max_depth=[4]))]


def test_titanic_cut_collapsed_train_equals_the_jax_packages(tmp_path):
    with collapse_env(None):
        jm = jax_titanic(titanic_cut("jax"))
        pm, _ = PTitanic.train_titanic(device="cpu", models_and_parameters=titanic_cut("port"))
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    tols = {"OpLogisticRegression": FX.LR_AUPR_TOL, "OpRandomForestClassifier": FX.RF_AUPR_TOL,
            "OpXGBoostClassifier": FX.COLLAPSE_XGB_AUPR_TOL}
    for mine, theirs in zip(ps.validation_results, js.validation_results):
        assert (mine["modelName"], mine["grid"]) == (theirs["modelName"], theirs["grid"])
        np.testing.assert_allclose(mine["foldMetrics"], theirs["foldMetrics"], rtol=0,
                                   atol=tols[mine["modelName"]])
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name, js.best_grid)
    # the collapsed XGB refit stores eta / K and scores alike in both packages
    with collapse_env(None):
        pm, _ = PTitanic.train_titanic(device="cpu", models_and_parameters=titanic_cut("port")[2:])
    params = pm.stages[-1].model_params
    assert float(params["eta"]) == pytest.approx(0.3 / 4)
    assert np.asarray(params["leaf_val"]).shape[0] == 8
    pm.save(str(tmp_path))
    cols = PTitanic.titanic_data(64, 3)
    import pandas as pd

    jl = J.OpWorkflowModel.load(str(tmp_path))
    np.testing.assert_allclose(
        jl.score(pd.DataFrame(cols))[jl.result_features[0].name].probability,
        pm.score(cols)[pm.result_features[0].name].probability, rtol=0, atol=FX.PROB_ATOL)


def test_iris_cut_collapsed_train_equals_the_jax_packages():
    from test_torch_iris_boost_slice import jax_train as jax_iris

    def space(Tr, D):
        return [(Tr.OpXGBoostClassifier(trees_per_round=4, subsample=0.8,
                                        colsample_bytree=0.8),
                 D.grid(num_round=[8], eta=[0.3], min_child_weight=[1.0], max_depth=[3, 4]))]

    with collapse_env(None):
        jm = jax_iris(space(JTr, JD))
        pm, _ = PIris.train_iris(device="cpu", models_and_parameters=space(PTr, PD))
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert [r["foldMetrics"] for r in ps.validation_results] == \
        [r["foldMetrics"] for r in js.validation_results]
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name, js.best_grid)
    assert min(np.mean(r["foldMetrics"]) for r in ps.validation_results) < 0.2


def test_boston_cut_collapsed_train_equals_the_jax_packages():
    def space(Tr, D):
        return [(Tr.OpGBTRegressor(),
                 D.grid(max_depth=[3, 6], min_info_gain=[0.001], min_instances_per_node=[10],
                        max_iter=[8], step_size=[0.1]))]

    from test_torch_boston_ridge_slice import jax_train as jax_boston_space

    with collapse_env(4):
        jm = jax_boston_space(space(JRTr, JD))
        pm, _ = PBoston.train_boston(device="cpu", models_and_parameters=space(PRTr, PD))
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    for mine, theirs in zip(ps.validation_results, js.validation_results):
        assert mine["grid"] == theirs["grid"]
        np.testing.assert_allclose(mine["foldMetrics"], theirs["foldMetrics"],
                                   rtol=FX.BOSTON_RMSE_RTOL["OpGBTRegressor"], atol=0)
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name, js.best_grid)


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------
def test_fixtures_hold_the_collapsed_trains():
    with open(os.path.join(FX.TITANIC_COLLAPSE, "op_model.json")) as fh:
        summ = FX.stage_summary(json.load(fh))
    assert summ["bestModelName"] == "OpXGBoostClassifier"
    ref = FX.load_sweep(os.path.join(FX.TITANIC_COLLAPSE, "sweep.npz"))
    assert ref["xgb_folds"].shape == (2, 3) and ref["stock_folds"].shape == (28, 3)
    np.testing.assert_array_equal(
        ref["xgb_folds"], [r["foldMetrics"] for r in summ["validationResults"]])
    iris = FX.load_sweep(os.path.join(FX.IRIS_COLLAPSE, "sweep.npz"))
    boston = FX.load_sweep(os.path.join(FX.BOSTON_COLLAPSE, "sweep.npz"))
    assert iris["folds"].shape == (2, 3) and boston["folds"].shape == (44, 3)


def test_port_scores_the_jax_saved_collapsed_model():
    """The JAX package's collapsed model (its trees at eta / 4) through the
    port's scoring paths: the fixture answers within ``titanic_xgb``'s serve
    tolerances (``FX.compare``)."""
    model = P.load_model(FX.TITANIC_COLLAPSE, device="cpu")
    params = model.stages[-1].model_params
    eta = model.stages[-1].summary.best_grid["eta"]
    assert float(params["eta"]) == pytest.approx(eta / 4)
    cols = FX.load_columns(os.path.join(FX.TITANIC_COLLAPSE, "requests.npz"))
    pred, prob, raw, Xb, F = FX.port_answers(model, cols)
    gaps = FX.compare(FX.load_expected(os.path.join(FX.TITANIC_COLLAPSE, "expected.npz")),
                      pred, prob, raw, Xb=Xb, F=F)
    assert gaps["Xb_mismatches"] == 0


# ---------------------------------------------------------------------------
# the full-width trains, against the fixtures
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_full_width_titanic_trains_match_the_fixture():
    with collapse_env(4):
        stock, _ = PTitanic.train_titanic(device="cpu")
    FX.check_titanic_collapse_train(stock, "stock")
    with collapse_env(None):
        xgb, _ = PTitanic.train_titanic(device="cpu",
                                        models_and_parameters=xgb_collapse_space("port"))
    FX.check_titanic_collapse_train(xgb, "xgb")


@pytest.mark.slow
def test_full_width_iris_and_boston_trains_match_the_fixtures():
    with collapse_env(None):
        iris, _ = PIris.train_iris(device="cpu", models_and_parameters=iris_xgb_space("port"))
    FX.check_iris_collapse_train(iris)
    with collapse_env(4):
        boston, _ = PBoston.train_boston(device="cpu")
    FX.check_boston_collapse_train(boston)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixtures")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture()
    print(f"wrote {FX.TITANIC_COLLAPSE}, {FX.IRIS_COLLAPSE}, {FX.BOSTON_COLLAPSE}")
