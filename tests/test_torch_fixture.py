"""The committed full-width Titanic XGB fixture of the PyTorch port.

``transmogrifai_tpu_torch/fixtures/titanic_xgb/`` carries a model the JAX
package trained and saved, 256 request records and the JAX package's
answers for them; the machine with the card has no JAX, so the reference
travels as data.  These tests hold both packages to it on the CPU:

- the JAX package, loading the fixture, still reproduces ``expected.npz``
  bit for bit (the fixture has not drifted from the reference);
- the port matches it: bit-equal bins, margins within atol=rtol=1e-5 (float32
  sums over 200 trees in another order), probabilities within 1e-6 and equal
  predictions away from the 0.5 boundary.

Regenerate everything with ``python tests/test_torch_fixture.py --write``
(trains with ``transmogrifai_tpu`` on the CPU at a fixed seed).
"""
import argparse
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
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JT
from transmogrifai_tpu.impl.selector.factories import BinaryClassificationModelSelector
from transmogrifai_tpu.impl.trees_common import tree_from_params as j_tree_from_params
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction
from transmogrifai_tpu.ops import trees as JTr

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX

torch.set_num_threads(1)

FIXTURE = FX.TITANIC_XGB


# ---------------------------------------------------------------------------
# the Titanic flow (helloworld/titanic.py::build_workflow) with a chosen grid
# ---------------------------------------------------------------------------
def build_titanic(model_types=None, models_and_parameters=None):
    F = J.FeatureBuilder
    survived = F("Survived", JT.RealNN).extract(field="Survived").as_response()
    pclass = F("Pclass", JT.PickList).extract(field="Pclass").as_predictor()
    name = F("Name", JT.Text).extract(field="Name").as_predictor()
    sex = F("Sex", JT.PickList).extract(field="Sex").as_predictor()
    age = F("Age", JT.Real).extract(field="Age").as_predictor()
    sib_sp = F("SibSp", JT.Integral).extract(field="SibSp").as_predictor()
    par_ch = F("Parch", JT.Integral).extract(field="Parch").as_predictor()
    fare = F("Fare", JT.Real).extract(field="Fare").as_predictor()
    embarked = F("Embarked", JT.PickList).extract(field="Embarked").as_predictor()
    family_size = (sib_sp + par_ch + 1).alias("family_size")
    features = family_size.vectorize(age, fare, label=survived).combine(
        sex.pivot(pclass, embarked, top_k=10, min_support=1),
        name.smart_vectorize(max_cardinality=10, num_hashes=64, min_support=1))
    checked = features.sanity_check(survived)
    pred = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, model_types=model_types,
        models_and_parameters=models_and_parameters,
    ).set_input(survived, checked).get_output()
    return J.OpWorkflow().set_result_features(pred)


def train_titanic(path, model_types=None, models_and_parameters=None):
    """Train the Titanic flow with the JAX package on its synthetic data
    (``helloworld/titanic.py::titanic_data``) and save it to ``path``."""
    from titanic import titanic_data

    model = build_titanic(model_types, models_and_parameters) \
        .set_input_dataset(titanic_data(), key="PassengerId").train()
    model.save(path)
    return model


def make_requests(model, n=256, seed=0):
    """Titanic-schema request columns from ``seed``: nulls in Age, Fare and
    Embarked, an unseen category in each picklist, Age and Fare values
    exactly on the model's bin edges (tree models), and one +inf and one
    -inf Fare."""
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
    params = model.stages[-1].model_params
    edges = np.asarray(params.get("edges", np.zeros((0, 0))))
    meta = next(s for s in model.stages if type(s).__name__ == "SanityCheckerModel").out_metadata
    for fname in ("Age", "Fare") if edges.size else ():
        j = next(c.index for c in meta.columns if c.parent_feature_name == (fname,)
                 and c.indicator_value is None and c.descriptor_value is None)
        rows = rng.choice(n, 16, replace=False)
        cols[fname][rows] = edges[j, rng.integers(0, edges.shape[1], 16)].astype(np.float64)
    cols["Fare"][[3, 4]] = [np.inf, -np.inf]
    return cols


def jax_answers(model, cols):
    """What the JAX package computes for the request columns."""
    name = model.result_features[0].name
    recs = FX.records(cols)
    out = JBatchScoreFunction(model)(recs)
    pred, prob, raw = FX.prediction_arrays(out, name)
    stage = model.stages[-1]
    full = model.score(pd.DataFrame(cols), keep_intermediate_features=True)
    V = np.asarray(full[stage.inputs[-1].name].values, np.float32)
    params = stage.model_params
    Xb = JTr.bin_with_edges(V, params["edges"])
    F = np.asarray(JTr.predict_gbt(Xb, j_tree_from_params(params),
                                   int(params["max_depth"]), float(params["eta"])))
    np.testing.assert_array_equal(full[name].probability, prob)
    return {"prediction": pred, "probability": prob, "rawPrediction": raw,
            "Xb": Xb, "F": F}


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        model = train_titanic(tmp, model_types=["OpXGBoostClassifier"])
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(model, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(model, cols))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_fixture_is_full_width():
    with np.load(os.path.join(FIXTURE, "op_model_arrays.npz")) as z:
        shapes = sorted(tuple(z[k].shape) for k in z.files)
    assert (200, 1023) in shapes and (200, 1023, 1) in shapes and (10, 31) in shapes


def test_jax_reproduces_expected():
    model = J.OpWorkflowModel.load(FIXTURE)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    got = jax_answers(model, cols)
    expected = FX.load_expected()
    for k, v in expected.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == v.dtype, k


def test_port_matches_expected_on_cpu():
    model = P.load_model(FIXTURE, device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    pred, prob, raw, Xb, F = FX.port_answers(model, cols)
    gaps = FX.compare(FX.load_expected(), pred, prob, raw, Xb=Xb, F=F)
    assert gaps["Xb_mismatches"] == 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
