"""The binary selector's other families on the Titanic workflow, on the port
against the JAX package's, on the CPU.

``apps/titanic.families_space()`` reaches the families the stock space
leaves out through ``models_and_parameters``: LinearSVC x
``linear_svc_grid()`` (4), NaiveBayes x ``naive_bayes_grid()`` (1),
DecisionTree x ``decision_tree_grid()`` (18) and the default MLP (1).

- Space A (all 24): naive Bayes is not a fused family in either package,
  so the validator takes the per-family sweep (each family's
  ``fit_grid_folds``, host float64 metrics); the winner is naive Bayes.
- Space B (without naive Bayes, 23): one fused sweep per workflow-level
  fold over the "svc", "forest" (the decision trees: one-tree forests,
  unbagged, on every feature) and "mlp" fragments; the winner is the MLP.
- The Iris flow over the one-MLP space: the multiclass "mlp" fragment.

Both Titanic trains are held to the committed fixture
``transmogrifai_tpu_torch/fixtures/titanic_families/`` by
``FX.check_titanic_families_train`` (the winner; fold AuPR per family:
SVC within ``FX.SVC_AUPR_TOL``, naive Bayes within ``FX.NB_AUPR_TOL``, the
MLP within ``FX.MLP_AUPR_TOL``, the decision trees bit for bit on the
per-family path and within ``FX.RF_AUPR_TOL`` on the fused one).  The
JAX-saved winners score the fixture's requests through the port within
``FX.JAX_SAVED_PROB_ATOL``; the port's own refits, saved and loaded by
either package, within ``FX.FAMILIES_PROB_ATOL`` (the MLP refit's stated
gap: Adam's drift).

Regenerate the fixture with ``python tests/test_torch_families_slice.py
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
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.evaluators import Evaluators as JE
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification.mlp import OpMultilayerPerceptronClassifier as JMLP
from transmogrifai_tpu.impl.classification.naive_bayes import OpNaiveBayes as JNB
from transmogrifai_tpu.impl.classification.svc import OpLinearSVC as JSVC
from transmogrifai_tpu.impl.classification.trees import OpDecisionTreeClassifier as JDT
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import iris as PIris
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF

torch.set_num_threads(1)

FIXTURE = FX.TITANIC_FAMILIES


def jax_space(naive_bayes):
    return ([(JSVC(), JD.linear_svc_grid())]
            + ([(JNB(), JD.naive_bayes_grid())] if naive_bayes else [])
            + [(JDT(), JD.decision_tree_grid()), (JMLP(), [{}])])


def recorded(module, train, *args):
    """(train(*args), the metrics [calls, F, C, M] of its fused-sweep calls or
    None, their specs)."""
    calls, specs = [], []
    run = module.SweepPlan.run

    def recording_run(self, *a, **k):
        out = run(self, *a, **k)
        calls.append(np.asarray(out))
        specs.append(self.spec)
        return out

    module.SweepPlan.run = recording_run
    try:
        out = train(*args)
    finally:
        module.SweepPlan.run = run
    return out, (np.stack(calls) if calls else None), specs


def jax_titanic(models):
    from test_torch_fixture import build_titanic
    from titanic import titanic_data

    return build_titanic(None, models).set_input_dataset(titanic_data(),
                                                         key="PassengerId").train()


def port_titanic(models):
    return PTitanic.train_titanic(device="cpu", models_and_parameters=models)[0]


def jax_answers(model, cols, space):
    """The JAX package's answers for request columns, keyed for ``space``."""
    name = model.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(JBatchScoreFunction(model)(FX.records(cols)), name)
    return {f"{space}_prediction": pred, f"{space}_probability": prob,
            f"{space}_rawPrediction": raw}


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    from test_torch_fixture import make_requests
    from test_torch_iris_boost_slice import jax_train as jax_iris

    a, a_calls, _ = recorded(JSF, jax_titanic, jax_space(True))
    assert a_calls is None, "space A took the fused sweep"
    b, b_metrics, _ = recorded(JSF, jax_titanic, jax_space(False))
    _, iris_metrics, _ = recorded(JSF, jax_iris, [(JMLP(), [{}])])
    os.makedirs(path, exist_ok=True)
    for name, model in (("space_a", a), ("space_b", b)):
        with tempfile.TemporaryDirectory() as tmp:
            model.save(tmp)
            os.makedirs(os.path.join(path, name), exist_ok=True)
            for f in ("op_model.json", "op_model_arrays.npz"):
                shutil.copy(os.path.join(tmp, f), os.path.join(path, name, f))
    np.savez_compressed(os.path.join(path, "sweep.npz"), b_metrics=b_metrics,
                        iris_mlp_metrics=iris_metrics)
    cols = make_requests(a, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    expected = {}
    for space in ("a", "b"):
        expected.update(jax_answers(J.OpWorkflowModel.load(os.path.join(path, "space_" + space)),
                                    cols, space))
    np.savez_compressed(os.path.join(path, "expected.npz"), **expected)


def _summary(space):
    with open(os.path.join(FIXTURE, "space_" + space, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------
def test_fixture_holds_the_references_winners():
    a, b = _summary("a"), _summary("b")
    assert (a["bestModelName"], a["bestGrid"]) == ("OpNaiveBayes", {"smoothing": 1.0})
    assert (b["bestModelName"], b["bestGrid"]) == ("OpMultilayerPerceptronClassifier", {})
    assert [r["modelName"] for r in a["validationResults"]] == \
        ["OpLinearSVC"] * 4 + ["OpNaiveBayes"] + ["OpDecisionTreeClassifier"] * 18 + \
        ["OpMultilayerPerceptronClassifier"]
    assert len(b["validationResults"]) == 23
    means = {r["modelName"]: max(np.mean(q["foldMetrics"]) for q in a["validationResults"]
                                 if q["modelName"] == r["modelName"])
             for r in a["validationResults"]}
    # the winner leads the MLP and the best decision tree by about 1e-3
    assert means["OpNaiveBayes"] - means["OpMultilayerPerceptronClassifier"] > 5e-4
    assert means["OpMultilayerPerceptronClassifier"] - means["OpDecisionTreeClassifier"] > 5e-4
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    assert sweep["b_metrics"].shape == (3, 1, 23, 6)
    assert sweep["iris_mlp_metrics"].shape == (1, 3, 1, 4)
    folds = np.array([r["foldMetrics"] for r in b["validationResults"]], np.float32)
    np.testing.assert_array_equal(FX._titanic_folds(sweep["b_metrics"]), folds)


def test_jax_reproduces_the_fixture_answers():
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    for space in ("a", "b"):
        got = jax_answers(J.OpWorkflowModel.load(os.path.join(FIXTURE, "space_" + space)), cols,
                          space)
        for k, v in got.items():
            np.testing.assert_array_equal(v, expected[k], err_msg=k)


@pytest.mark.parametrize("space", ["a", "b"])
def test_port_scores_the_jax_saved_winners(space):
    model = P.load_model(os.path.join(FIXTURE, "space_" + space), device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    pred, prob, _ = FX.prediction_arrays(P.BatchScoreFunction(model)(FX.records(cols)),
                                         model.result_features[0].name)
    FX.compare_family_answers(FX.load_expected(os.path.join(FIXTURE, "expected.npz")), space,
                              pred, prob, tol=FX.JAX_SAVED_PROB_ATOL)


def test_space_b_plan_equals_the_jax_packages():
    """The fused plan of space B on seeded inputs: the same spec (the "svc"
    fragment, the decision trees' unbagged one-tree forest groups, the
    "mlp" fragment) and the same blob in both packages."""
    rng = np.random.default_rng(3)
    n, d = 300, 10
    X = np.concatenate([rng.integers(0, 2, (n, 6)), rng.uniform(1, 80, (n, 4))],
                       1).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float64)
    tw = np.ones((1, n), np.float32)
    tw[0, ::3] = 0.0
    jplan = JSF.build_sweep_plan(jax_space(False), X, y, tw, JE.BinaryClassification.auPR())
    pplan = PSF.build_sweep_plan(PTitanic.families_space(False), torch.from_numpy(X), y, tw,
                                 PE.BinaryClassification.auPR())
    assert [f[0] for f in pplan.spec[1]] == ["svc", "forest", "mlp"]
    assert pplan.spec == jplan.spec
    np.testing.assert_array_equal(pplan.blob, np.asarray(jplan.blob))
    # with naive Bayes neither package fuses
    assert PSF.build_sweep_plan(PTitanic.families_space(True), torch.from_numpy(X), y, tw,
                                PE.BinaryClassification.auPR()) is None


# ---------------------------------------------------------------------------
# the trains, against the fixture
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trains(tmp_path_factory):
    out = {}
    for space, nb in (("a", True), ("b", False)):
        model, metrics, specs = recorded(PSF, port_titanic, PTitanic.families_space(nb))
        path = str(tmp_path_factory.mktemp("families_" + space))
        model.save(path)
        out[space] = (model, metrics, specs, path)
    return out


def test_space_a_trains_per_family_and_matches_the_fixture(trains):
    model, metrics, _, _ = trains["a"]
    assert metrics is None  # no fused sweep: naive Bayes is not a fused family
    found = FX.check_titanic_families_train(model, "a")
    assert found["best"] == "OpNaiveBayes"
    assert found["max_gap"]["OpDecisionTreeClassifier"] == 0.0
    assert model.stages[-1].summary.holdout_evaluation["AuPR"] > 0.9


def test_space_b_trains_fused_and_matches_the_fixture(trains):
    model, metrics, specs, _ = trains["b"]
    found = FX.check_titanic_families_train(model, "b")
    assert found["best"] == "OpMultilayerPerceptronClassifier"
    ref = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))["b_metrics"]
    assert metrics.shape == ref.shape
    assert all([f[0] for f in sp[1]] == ["svc", "forest", "mlp"] for sp in specs)
    # the SVC's scores are its 0/1 predictions, so the thresholded counts'
    # metrics (precision, recall, F1, error) are equal where its AuPR is
    svc = slice(0, 4)
    np.testing.assert_allclose(metrics[:, :, svc, :2], ref[:, :, svc, :2], rtol=0,
                               atol=FX.SVC_AUPR_TOL)
    np.testing.assert_array_equal(metrics[:, :, svc, 2:], ref[:, :, svc, 2:])


@pytest.mark.parametrize("space", ["a", "b"])
def test_saved_winners_score_alike_in_both_packages(trains, space):
    _, _, _, path = trains[space]
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    loaded = P.load_model(path, device="cpu")
    pred, prob, _ = FX.prediction_arrays(P.BatchScoreFunction(loaded)(FX.records(cols)),
                                         loaded.result_features[0].name)
    FX.compare_family_answers(expected, space, pred, prob)
    jl = J.OpWorkflowModel.load(path)
    jpred, jprob, _ = FX.prediction_arrays(JBatchScoreFunction(jl)(FX.records(cols)),
                                           jl.result_features[0].name)
    FX.compare_family_answers(expected, space, jpred, jprob)


def test_iris_mlp_train_matches_the_fixture():
    (model, _), metrics, specs = recorded(
        PSF, lambda: PIris.train_iris(device="cpu", models_and_parameters=PIris.mlp_space()))
    ref = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))["iris_mlp_metrics"]
    assert specs[0][1][0][:3] == ("mlp", (0,), (8, 10, 3)) and specs[0][0] == ("multiclass", 3)
    # every fold Error equal: the probabilities differ in their last bits only
    np.testing.assert_array_equal(metrics[..., 3], ref[..., 3])
    assert model.stages[-1].summary.best_model_name == "OpMultilayerPerceptronClassifier"


@pytest.mark.parametrize("family", ["svc", "tree"])
def test_jax_saved_svc_and_tree_winners_score_alike_on_the_port(tmp_path, family):
    """A JAX-saved linear SVC (coef, intercept; no probability) and a
    JAX-saved decision tree (the tree arrays) load and score through the
    port: the SVC's margins within rounding, the tree's answers equal."""
    est, grid = ((JSVC(), [{"reg_param": 0.01}]) if family == "svc"
                 else (JDT(), [{"max_depth": 6, "min_instances_per_node": 10}]))
    model = jax_titanic([(est, grid)])
    model.save(str(tmp_path))
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    jname = model.result_features[0].name
    jout = [o[jname] for o in JBatchScoreFunction(model)(FX.records(cols))]
    loaded = P.load_model(str(tmp_path), device="cpu")
    pout = [o[loaded.result_features[0].name]
            for o in P.BatchScoreFunction(loaded)(FX.records(cols))]
    assert sorted(jout[0]) == sorted(pout[0])
    for key in jout[0]:
        a = np.array([o[key] for o in pout], np.float64)
        b = np.array([o[key] for o in jout], np.float64)
        if family == "tree":
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5, err_msg=key)
    if family == "svc":
        assert "probability_1" not in jout[0]


def test_titanic_entry_point_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is available")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PTitanic.train_titanic(models_and_parameters=PTitanic.families_space(False))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
