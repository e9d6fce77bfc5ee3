"""TransmogrifAI's OpTitanicSimple feature set on the port against the JAX
package's, on the CPU.

``apps/titanic.build_workflow(reference_features=True)`` builds the
reference's helloworld predictors (OpTitanicSimple.scala:77-120):
``family_size``, ``estimated_cost``, ``Sex.pivot()``,
``Age.fill_missing_with_mean().z_normalize()`` and ``Age.map(age_group)``
beside the raw columns, all through ``transmogrify`` (its ``RealNN`` branch
included), the sanity check and the stock binary selector (3-fold CV).  The
JAX side builds the same workflow from the JAX package's DSL through the
same ``reference_features`` function.

The committed fixture ``transmogrifai_tpu_torch/fixtures/titanic_simple/``
holds the JAX package's 891-row stock-space train (the saved model and its
sweep metrics), 256 requests and the JAX package's answers.  Here:

- the port's 891-row train over the logistic-regression part of the stock
  space picks the fixture's best LR candidate, every fold AuPR within
  ``FX.SIMPLE_AUPR_TOL``;
- the port loads the JAX-saved model (its FillMissingWithMean, scaler,
  LambdaTransformer and RealNN vectorizer stages included) and answers the
  256 requests within ``FX.SIMPLE_PROB_ATOL``;
- a 2,000-row train and a 2,000-row score with both packages forced to
  stream (thresholds of 500 rows, chunks of 512: three full chunks and a
  tail) agree with each other: the same winner, fold AuPR within
  ``FX.SIMPLE_AUPR_TOL``, probabilities within ``STREAM_PROB_ATOL``.

Regenerate the fixture with ``python tests/test_torch_titanic_simple_slice.py
--write`` (trains with the JAX package on the CPU, about a minute).
"""
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np
import pandas as pd
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JT
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.impl.selector.factories import BinaryClassificationModelSelector as JB
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.impl.selector import defaults as PD
from transmogrifai_tpu_torch.workflow import dag as PDag
from transmogrifai_tpu_torch.workflow import stream as PStream

torch.set_num_threads(1)

FIXTURE = FX.TITANIC_SIMPLE
#: probabilities of the forced-stream 2,000-row models scored by the other
#: package's rules: both refit the same LR winner from streamed features
#: (float32 device scalers on both sides), FISTA sums in another order
STREAM_PROB_ATOL = 1e-5


def jax_workflow(models_and_parameters=None):
    """The OpTitanicSimple flow from the JAX package's stages."""
    survived = J.FeatureBuilder("Survived", JT.RealNN).extract(field="Survived").as_response()
    features = PTitanic.reference_features(survived, F=J.FeatureBuilder, types=JT)
    checked = features.sanity_check(survived)
    pred = JB.with_cross_validation(num_folds=3, seed=42,
                                    models_and_parameters=models_and_parameters
                                    ).set_input(survived, checked).get_output()
    return J.OpWorkflow().set_result_features(pred)


def frame(cols):
    return pd.DataFrame({k: (list(v) if v.dtype == object else v) for k, v in cols.items()})


def jax_answers(model, cols):
    name = model.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(JBatchScoreFunction(model)(FX.records(cols)), name)
    return {"prediction": pred, "probability": prob, "rawPrediction": raw}


def port_answers(model, cols):
    return FX.prediction_arrays(P.BatchScoreFunction(model)(FX.records(cols)),
                                model.result_features[0].name)


def simple_requests(model, n=256, seed=0):
    """Titanic-schema request columns (``test_torch_fixture.make_requests``'s
    draws: nulls in Age, Fare and Embarked, an unseen category in each
    picklist, one +inf and one -inf Fare), with Age values on the tree
    winner's bin edges where the vector holds a raw Age column (this flow
    vectorizes Fare only inside ``estimated_cost``)."""
    rng = np.random.default_rng(seed)
    cols = {
        "PassengerId": np.arange(1000, 1000 + n),
        "Survived": rng.integers(0, 2, n),
        "Pclass": rng.choice([1, 2, 3, 4], n, p=[0.3, 0.3, 0.3, 0.1]),
        "Name": rng.choice(["p", "q"], n, p=[0.9, 0.1]).astype(object),
        "Sex": rng.choice(["male", "female", "unknown"], n, p=[0.45, 0.45, 0.1]).astype(object),
        "Age": rng.uniform(1, 80, n),
        "SibSp": rng.integers(0, 4, n),
        "Parch": rng.integers(0, 3, n),
        "Ticket": np.array(["t"] * n, dtype=object),
        "Fare": rng.uniform(5, 100, n),
        "Cabin": np.array([None] * n, dtype=object),
        "Embarked": rng.choice(["S", "C", "Q", "X"], n, p=[0.4, 0.25, 0.25, 0.1]).astype(object),
    }
    cols["Age"][rng.random(n) < 0.1] = np.nan
    cols["Fare"][rng.random(n) < 0.1] = np.nan
    cols["Embarked"][rng.random(n) < 0.1] = None
    edges = np.asarray(model.stages[-1].model_params.get("edges", np.zeros((0, 0))))
    meta = next(s for s in model.stages if type(s).__name__ == "SanityCheckerModel").out_metadata
    j = next((c.index for c in meta.columns if c.parent_feature_name == ("Age",)
              and c.indicator_value is None and c.descriptor_value is None), None)
    if edges.size and j is not None:
        rows = rng.choice(n, 16, replace=False)
        cols["Age"][rows] = edges[j, rng.integers(0, edges.shape[1], 16)].astype(np.float64)
    cols["Fare"][[3, 4]] = [np.inf, -np.inf]
    return cols


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    from test_torch_text_slice import recorded_sweep

    model, metrics = recorded_sweep(
        JSF, lambda: jax_workflow().set_input_dataset(frame(PTitanic.titanic_data()),
                                                      key="PassengerId").train())
    os.makedirs(path, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    np.savez_compressed(os.path.join(path, "sweep.npz"), metrics=metrics)
    req = simple_requests(model, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), req)
    saved = J.OpWorkflowModel.load(path)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(saved, req))


def _summary():
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


# ---------------------------------------------------------------------------
# the fixture and the JAX-saved model
# ---------------------------------------------------------------------------
def test_fixture_holds_the_stock_space_and_its_stages():
    summ = _summary()
    assert [r["modelName"] for r in summ["validationResults"]] == \
        ["OpLogisticRegression"] * 8 + ["OpRandomForestClassifier"] * 18 + \
        ["OpXGBoostClassifier"] * 2
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        classes = {st["class"].split(":")[1] for st in json.load(fh)["stages"]}
    assert {"FillMissingWithMeanModel", "OpScalarStandardScalerModel", "LambdaTransformer",
            "RealNNVectorizer", "MultiplyTransformer"} <= classes
    metrics = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))["metrics"]
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(FX._titanic_folds(metrics), folds)


def test_jax_reproduces_the_fixture_answers():
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    got = jax_answers(J.OpWorkflowModel.load(FIXTURE), cols)
    for k, v in got.items():
        np.testing.assert_array_equal(v, expected[k], err_msg=k)


def test_port_scores_the_jax_saved_model():
    model = P.load_model(FIXTURE, device="cpu")
    assert any(type(s).__name__ == "LambdaTransformer" for s in model.stages)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    pred, prob, _ = port_answers(model, cols)
    FX.compare_text_answers(FX.load_expected(os.path.join(FIXTURE, "expected.npz")), pred,
                            prob, FX.SIMPLE_PROB_ATOL)


def test_port_saves_what_both_packages_load(tmp_path):
    model = P.load_model(FIXTURE, device="cpu")
    model.save(str(tmp_path))
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    again = port_answers(P.load_model(str(tmp_path), device="cpu"), cols)
    first = port_answers(model, cols)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    jax = jax_answers(J.OpWorkflowModel.load(str(tmp_path)), cols)
    np.testing.assert_allclose(jax["probability"], first[1], rtol=0, atol=FX.SIMPLE_PROB_ATOL)


# ---------------------------------------------------------------------------
# the port's trains
# ---------------------------------------------------------------------------
def test_port_train_matches_the_fixture():
    model, wf = PTitanic.train_titanic(device="cpu", reference_features=True,
                                       models_and_parameters=[(PLR(),
                                                               PD.logistic_regression_grid())])
    found = FX.check_titanic_simple_train(model)
    assert found["best"] == "OpLogisticRegression" and found["candidates"] == 8
    assert found["max_gap"]["OpLogisticRegression"] <= FX.SIMPLE_AUPR_TOL["OpLogisticRegression"]
    names = {type(s).__name__ for s in model.stages}
    assert {"RealNNVectorizer", "FillMissingWithMeanModel", "OpScalarStandardScalerModel",
            "LambdaTransformer"} <= names


def test_both_packages_forced_to_stream_agree(monkeypatch):
    """2,000 rows, thresholds of 500 rows and chunks of 512 on both sides:
    every flush and the scoring DAG stream in four chunks, the last a tail."""
    monkeypatch.setenv("TMOG_FUSE_MAX_ROWS", "500")
    monkeypatch.setenv("TMOG_TRANSFORM_CHUNK_ROWS", "512")
    monkeypatch.setattr(PDag, "STREAM_ROWS", 500)
    monkeypatch.setattr(PStream, "CHUNK_ROWS", 512)
    train, score = PTitanic.titanic_data(2000, 1), PTitanic.titanic_data(2000, 2)
    space_j, space_p = [(JLR(), JD.logistic_regression_grid())], \
        [(PLR(), PD.logistic_regression_grid())]
    jm = jax_workflow(space_j).set_input_dataset(frame(train), key="PassengerId").train()
    PStream.reset_stream_stats()
    pm, _ = PTitanic.train_titanic(train, device="cpu", reference_features=True,
                                   models_and_parameters=space_p)
    stats = PStream.stream_stats()
    assert stats["streams"] > 0 and stats["chunks"] >= 4 * stats["streams"] - 3
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name, js.best_grid)
    for a, b in zip(ps.validation_results, js.validation_results):
        assert a["grid"] == b["grid"]
        assert max(abs(x - y) for x, y in zip(a["foldMetrics"], b["foldMetrics"])) \
            <= FX.SIMPLE_AUPR_TOL["OpLogisticRegression"]
    PStream.reset_stream_stats()
    pscored = pm.score(score)
    assert PStream.stream_stats()["chunks"] == 4
    jscored = jm.score(frame(score))
    pcol, jcol = pscored[pm.result_features[0].name], jscored[jm.result_features[0].name]
    pp = np.array([pcol.to_scalar(i).probability[1] for i in range(2000)])
    jp = np.array([jcol.to_scalar(i).probability[1] for i in range(2000)])
    np.testing.assert_allclose(pp, jp, rtol=0, atol=STREAM_PROB_ATOL)


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_fixture()
