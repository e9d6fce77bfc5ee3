"""Softmax boosting in the Iris workflow's multiclass selector, on the port
against the JAX package's, on the CPU.

Two trains of the Iris flow (``transmogrifai_tpu_torch/apps/iris.py``)
through ``models_and_parameters``:

- the mixed space: the multiclass selector's stock 26 candidates
  (multinomial LR, RF) with ``OpGBTClassifier`` x ``gbt_grid()`` (18: 20
  rounds, depths 3 / 6 / 12) and ``OpXGBoostClassifier`` x
  ``xgboost_grid()`` (2: 200 rounds, depth 10, eta 0.02) added: 46
  candidates in one fused sweep whose "gbt" fragment boosts the softmax
  loss over the k = 3 class margins (K-R, and K-E / K-F / K-G over three
  gradient channels).  The winner stays the stock RF (nine candidates tie
  at its mean Error); most boosted candidates are constant (their
  min_child_weight blocks the splits on 90 training rows a fold), so
  their probabilities are exactly 1/3 each and the metrics' first-index
  argmax decides their Error;
- the XGB-only space ``[(OpXGBoostClassifier(), xgboost_grid())]``: its
  winner (min_child_weight 1) refits by softmax boosting (200 rounds), is
  saved, and serves through K-B over c = 3 channels.

Both are held to the committed fixture
``transmogrifai_tpu_torch/fixtures/iris_boost/``: every fold Error bit
for bit, the same winners, the holdout's Error / F1 / Precision / Recall
equal, and the saved model's probabilities for the fixture's 256 requests
within ``FX.IRIS_BOOST_PROB_ATOL`` (the boosted margins are float32 sums in
another order, and K-E's fixed-point histogram sums can move a leaf value
in its last bits).  The full-width trains take longer than tier 1 allows
on one CPU thread, so they are marked ``slow``; a cut grid (3 rounds, depth
3) trains through both packages in tier 1.

Regenerate the fixture with ``python tests/test_torch_iris_boost_slice.py
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
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JTy
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification import logistic as JLo
from transmogrifai_tpu.impl.classification import trees as JTr
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.impl.selector.factories import MultiClassificationModelSelector as JMS

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import iris as PI
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.classification import logistic as PLo
from transmogrifai_tpu_torch.impl.classification import trees as PTr
from transmogrifai_tpu_torch.impl.selector import defaults as PD

torch.set_num_threads(1)

FIXTURE = FX.IRIS_BOOST
K = 3
MIXED = 46
#: the mixed space's families: 8 LR, 18 RF, 18 GBT, 2 XGB
GBT = slice(26, 44)


def _frame(cols):
    return pd.DataFrame(cols)


def mixed_space(pkg):
    """The 46-candidate space in package ``pkg`` ("jax" or "port")."""
    Lo, Tr, D = (JLo, JTr, JD) if pkg == "jax" else (PLo, PTr, PD)
    return [(Lo.OpLogisticRegression(max_iter=50), D.logistic_regression_grid()),
            (Tr.OpRandomForestClassifier(), D.random_forest_grid()),
            (Tr.OpGBTClassifier(), D.gbt_grid()),
            (Tr.OpXGBoostClassifier(), D.xgboost_grid())]


def xgb_space(pkg):
    Tr, D = (JTr, JD) if pkg == "jax" else (PTr, PD)
    return [(Tr.OpXGBoostClassifier(), D.xgboost_grid())]


def cut_space(pkg):
    """A tier-1 cut of the mixed space: two points a family, 5 trees a
    forest, 3 boosting rounds of depth 3."""
    Lo, Tr, D = (JLo, JTr, JD) if pkg == "jax" else (PLo, PTr, PD)
    return [(Lo.OpLogisticRegression(max_iter=50),
             D.grid(reg_param=[0.01, 0.1], elastic_net_param=[0.1])),
            (Tr.OpRandomForestClassifier(num_trees=5),
             D.grid(max_depth=[3], min_info_gain=[0.001], min_instances_per_node=[10, 100])),
            (Tr.OpGBTClassifier(),
             D.grid(max_depth=[3], min_info_gain=[0.001], min_instances_per_node=[1, 10],
                    max_iter=[3], step_size=[0.1])),
            (Tr.OpXGBoostClassifier(),
             D.grid(num_round=[3], eta=[0.3], min_child_weight=[1.0, 10.0], max_depth=[3],
                    gamma=[0.8]))]


def jax_train(models):
    """The JAX package's Iris flow (``helloworld/iris.py``'s features and
    selector) over ``models``."""
    from iris import iris_data

    label = J.FeatureBuilder("label", JTy.RealNN).extract(field="label").as_response()
    feats = [J.FeatureBuilder(f, JTy.Real).extract(field=f).as_predictor()
             for f in PI.REAL_FEATURES]
    features = feats[0].vectorize(*feats[1:])
    pred = JMS.with_cross_validation(num_folds=3, seed=42, models_and_parameters=models) \
        .set_input(label, features).get_output()
    return J.OpWorkflow().set_result_features(pred).set_input_dataset(
        iris_data(), key="id").train()


def recorded(module, train, *args):
    """(train(*args), the metrics of each fused-sweep call it made)."""
    calls = []
    run = module.SweepPlan.run

    def recording_run(self, *a, **k):
        out = run(self, *a, **k)
        calls.append(np.asarray(out))
        return out

    module.SweepPlan.run = recording_run
    try:
        out = train(*args)
    finally:
        module.SweepPlan.run = run
    return out, np.stack(calls)


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    from test_torch_iris_slice import jax_answers, make_requests

    mixed, mixed_metrics = recorded(JSF, jax_train, mixed_space("jax"))
    model, metrics = recorded(JSF, jax_train, xgb_space("jax"))
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    summ = mixed.stages[-1].summary
    best = [(r["modelName"], r["grid"]) for r in summ.validation_results].index(
        (summ.best_model_name, summ.best_grid))
    np.savez_compressed(os.path.join(path, "sweep.npz"), metrics=metrics,
                        mixed_metrics=mixed_metrics, mixed_best=np.int64(best))
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
def test_boosting_grids_equal_the_jax_packages():
    assert PD.gbt_grid() == JD.gbt_grid() and len(PD.gbt_grid()) == 18
    assert PD.xgboost_grid() == JD.xgboost_grid() and len(PD.xgboost_grid()) == 2


def test_fixture_holds_both_boosting_trains():
    summ = _summary()
    assert summ["problemType"] == "MultiClassification" and summ["evaluationMetric"] == "Error"
    assert summ["bestModelName"] == "OpXGBoostClassifier"
    assert summ["bestGrid"]["min_child_weight"] == 1.0
    assert [r["grid"] for r in summ["validationResults"]] == JD.xgboost_grid()
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    assert sweep["metrics"].shape == (1, 3, 2, 4)
    assert sweep["mixed_metrics"].shape == (1, 3, MIXED, 4)
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(sweep["metrics"][0, :, :, 3].T, folds)
    # the mixed call: the stock RF winner, nine candidates tied at its mean
    errors = sweep["mixed_metrics"][0, :, :, 3].astype(np.float64).mean(0)
    assert int(sweep["mixed_best"]) == 8 and int(np.argmin(errors)) == 8
    # the boosted candidates: 0.6815 at min_instances_per_node 10, 0.7407 at 100
    gbt = sweep["mixed_metrics"][0, :, GBT, 3].astype(np.float64).mean(0)
    assert set(np.round(gbt, 4).tolist()) == {0.6815, 0.7407}


def test_jax_reproduces_the_fixture_answers():
    from test_torch_iris_slice import jax_answers

    model = J.OpWorkflowModel.load(FIXTURE)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    got = jax_answers(model, cols)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    for k in expected:
        np.testing.assert_array_equal(got[k], expected[k], err_msg=k)


def test_port_scores_the_fixture_model():
    """The JAX package's softmax-boosted model, scored by the port (K-B
    over three channels): the same predictions, probabilities within
    ``FX.IRIS_BOOST_PROB_ATOL``, through ``BatchScoreFunction``,
    ``ScoreFunction`` and ``score``."""
    model = P.load_model(FIXTURE, device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    name = model.result_features[0].name
    pred, prob, raw = FX.multiclass_predictions(
        P.BatchScoreFunction(model)(FX.records(cols)), name, K)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    np.testing.assert_array_equal(pred, expected["prediction"])
    np.testing.assert_allclose(prob, expected["probability"], rtol=0, atol=FX.IRIS_PROB_ATOL)
    np.testing.assert_allclose(raw, expected["rawPrediction"], rtol=0, atol=FX.IRIS_PROB_ATOL)
    one = P.ScoreFunction(model)(FX.records(cols)[0])[name]
    assert one["prediction"] == pred[0]
    np.testing.assert_array_equal(model.score(cols)[name].prediction, pred)


# ---------------------------------------------------------------------------
# the cut grid, through both packages (tier 1)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    jm = jax_train(cut_space("jax"))
    pm, _ = PI.train_iris(device="cpu", models_and_parameters=cut_space("port"))
    tmp = tmp_path_factory.mktemp("iris_boost_cut")
    jm.save(str(tmp / "jax"))
    pm.save(str(tmp / "port"))
    return jm, pm, str(tmp / "jax"), str(tmp / "port")


def test_cut_grid_boosting_sweep_equals_the_jax_packages(cut):
    """Every fold Error of the cut space bit for bit (the boosted ones by
    softmax over three class margins), the same winner and holdout
    metrics."""
    jm, pm, _, _ = cut
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert [(r["modelName"], r["grid"]) for r in ps.validation_results] == \
        [(r["modelName"], r["grid"]) for r in js.validation_results]
    assert [r["foldMetrics"] for r in ps.validation_results] == \
        [r["foldMetrics"] for r in js.validation_results]
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name, js.best_grid)
    for k in ("Error", "F1", "Precision", "Recall"):
        assert ps.holdout_evaluation[k] == js.holdout_evaluation[k], k
    # the boosted candidates learned something: not all at the constant model's Error
    boosted = [np.mean(r["foldMetrics"]) for r in ps.validation_results[4:]]
    assert min(boosted) < 0.2


def test_cut_grid_winner_saves_and_loads_in_both_packages(cut, tmp_path):
    """The cut space's winner and a softmax-boosted refit: the port's save
    scores alike in the JAX package and the reverse."""
    jm, pm, jax_dir, port_dir = cut
    cols = PI.iris_data(64, 5)
    jl, pl = J.OpWorkflowModel.load(port_dir), P.load_model(jax_dir, device="cpu")
    jp = jl.score(_frame(cols))[jl.result_features[0].name]
    pp = pl.score(cols)[pl.result_features[0].name]
    np.testing.assert_allclose(jp.probability, pm.score(cols)[pm.result_features[0].name]
                               .probability, rtol=0, atol=FX.IRIS_BOOST_PROB_ATOL)
    np.testing.assert_allclose(pp.probability, jm.score(_frame(cols))[
        jm.result_features[0].name].probability, rtol=0, atol=FX.IRIS_BOOST_PROB_ATOL)
    # a softmax-boosted XGB refit through the same entry point
    xgb = [(PTr.OpXGBoostClassifier(), PD.grid(num_round=[3], eta=[0.3], max_depth=[3]))]
    m, _ = PI.train_iris(device="cpu", models_and_parameters=xgb)
    params = m.stages[-1].model_params
    assert params["loss"] == "softmax" and np.asarray(params["leaf_val"]).shape[-1] == K
    m.save(str(tmp_path / "xgb"))
    jx = J.OpWorkflowModel.load(str(tmp_path / "xgb"))
    np.testing.assert_allclose(jx.score(_frame(cols))[jx.result_features[0].name].probability,
                               m.score(cols)[m.result_features[0].name].probability, rtol=0,
                               atol=FX.IRIS_PROB_ATOL)


# ---------------------------------------------------------------------------
# the full-width trains, against the fixture
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_full_width_mixed_train_matches_the_fixture():
    (pm, wf), metrics = recorded(PSF, lambda m: PI.train_iris(device="cpu",
                                                               models_and_parameters=m),
                                 mixed_space("port"))
    found = FX.check_iris_boost_train(pm, mixed=True)
    ref = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))["mixed_metrics"]
    np.testing.assert_array_equal(metrics[..., 3], ref[..., 3])
    assert found["candidates"] == MIXED and found["tied_at_best"] == 9
    assert "cv_sweep_gbt" in wf.train_timings


@pytest.mark.slow
def test_full_width_xgb_train_matches_the_fixture(tmp_path):
    pm, _ = PI.train_iris(device="cpu", models_and_parameters=xgb_space("port"))
    FX.check_iris_boost_train(pm, mixed=False)
    pm.save(str(tmp_path))
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    for model in (P.load_model(str(tmp_path), device="cpu"), J.OpWorkflowModel.load(str(tmp_path))):
        name = model.result_features[0].name
        scored = model.score(cols if isinstance(model, P.OpWorkflowModel) else _frame(cols))
        np.testing.assert_array_equal(scored[name].prediction, expected["prediction"])
        np.testing.assert_allclose(scored[name].probability, expected["probability"], rtol=0,
                                   atol=FX.IRIS_BOOST_PROB_ATOL)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
