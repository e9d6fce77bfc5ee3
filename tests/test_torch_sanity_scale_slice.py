"""The sanity checker at scale on the port against the JAX package's, on the CPU.

The port's ``SanityChecker`` (``impl/preparators/sanity_checker.py``) takes
the reference's branch: a sample of at most 2^18 rows in memory (float64
moments, K-I's correlation matrix; Spearman ranks the columns with K-Y), a
larger one or ``sharded_stats=True`` streamed in chunks of 2^18 rows
(``parallel/stats.py``: one pass of K-X's Chan moments and K-I's centered
Gram when every column is correlated under Pearson; else K-X's raw moments,
then the centered Gram over the correlated columns or their K-Y ranks).

The stage is fitted in both packages on the same Titanic vector (the JAX
package's vectorizers on its synthetic 891-row frame) in the five settings
of ``FX.SANITY_SETTINGS``: {pearson, spearman} x {in memory,
``sharded_stats=True``}, and Pearson with ``correlation_exclusion=
"hashed_text"``, whose two-pass branch needs hashed columns: that one runs
on the frame with distinct names (the real data's), which SmartText hashes
into 64 columns.  The dropped features and reasons (without their numbers)
are equal, and the summaries agree within ``FX.SANITY_CORR_ATOL`` /
``FX.SANITY_MOMENT_RTOL``; the largest gaps measured on these settings and
on the 2^20-row frame are in the fixture (``port_cpu_gaps``).  One
end-to-end ``train_titanic`` (Spearman, streamed) holds its final fit to
the fixture, its model saves, loads in the JAX package with
``correlationType`` kept, and scores there as in the port; a sample just
above 2^18 rows streams by default.

Regenerate the fixture ``transmogrifai_tpu_torch/fixtures/titanic_sanity/``
with ``python tests/test_torch_sanity_scale_slice.py --write`` (the JAX
package on the CPU's 8-device mesh, as the suite runs it; about a minute,
the 2^20-row frame's vectorizers and checks included).
"""
import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, ROOT)  # chip_smoke: the scale frame and the Newton space
sys.path.insert(0, os.path.join(ROOT, "helloworld"))

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JT
from transmogrifai_tpu.columns import NumericColumn as JNumeric, VectorColumn as JVector
from transmogrifai_tpu.features.metadata import VectorMetadata as JMeta
from transmogrifai_tpu.impl.preparators import sanity_checker as JSC

import transmogrifai_tpu_torch as P
import transmogrifai_tpu_torch.types as PT
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.features.metadata import VectorMetadata as PMeta
from transmogrifai_tpu_torch.impl.preparators import sanity_checker as PSC
from transmogrifai_tpu_torch.ops import stats as K

torch.set_num_threads(1)

SMALL = [s for s, (frame, _) in FX.SANITY_SETTINGS.items() if frame != "scale"]


def frame(name):
    """The JAX package's input frame of a setting, as a DataFrame."""
    from titanic import titanic_data

    if name == "scale":
        import chip_smoke

        return pd.DataFrame(chip_smoke.titanic_columns(FX.SANITY_SCALE_ROWS,
                                                       FX.SANITY_SCALE_SEED))
    df = titanic_data()
    if name == "titanic_distinct_names":
        df["Name"] = [f"Person {i}" for i in range(len(df))]
    return df


def jax_vector(df):
    """(label f64[n], the Titanic vector f32[n, d], its metadata as JSON):
    the JAX package's vectorizers fitted on ``df``, as the workflow fits them
    before the sanity checker."""
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
    model = J.OpWorkflow().set_result_features(features).set_input_dataset(
        df, key="PassengerId").train()
    vec = model.train_data[features.name]
    return (np.asarray(model.train_data[survived.name].values, np.float64),
            np.asarray(vec.values, np.float32), vec.metadata.to_json())


def fit_checker(pkg, y, X, meta_json, params):
    """(summary, correlation matrix) of the package's SanityChecker fitted
    on (y, X)."""
    if pkg == "jax":
        T, Num, Vec, SC, FB, DS, Meta = JT, JNumeric, JVector, JSC, J.FeatureBuilder, \
            J.Dataset, JMeta
    else:
        T, Num, Vec, SC, FB, DS, Meta = PT, P.NumericColumn, P.VectorColumn, PSC, \
            P.FeatureBuilder, P.Dataset, PMeta
    label = FB("label", T.RealNN).extract(field="label").as_response()
    vector = FB("features", T.OPVector).extract(field="features").as_predictor()
    ds = DS({"label": Num(T.RealNN, y, np.ones(len(y), bool)),
             "features": Vec(T.OPVector, X, Meta.from_json(meta_json))})
    stage = SC.SanityChecker(**params).set_input(label, vector)
    if pkg == "port":
        stage.to("cpu")
    with FX.CorrMatrices(SC) as rec:
        model = stage.fit(ds)
    return model.metadata["sanity_checker_summary"], rec.matrices[-1]


def _jsonable(summary, matrix):
    return {"summary": json.loads(json.dumps(summary, default=float)),
            "corr_matrix": [[None if np.isnan(v) else float(v) for v in row] for row in matrix]}


def write_fixture(path=FX.TITANIC_SANITY):
    out, vectors = {}, {}
    for setting, (name, params) in FX.SANITY_SETTINGS.items():
        if name not in vectors:
            vectors[name] = jax_vector(frame(name))
        y, X, meta = vectors[name]
        out[setting] = {"frame": name, "params": params, "rows": len(y), "width": X.shape[1],
                        **_jsonable(*fit_checker("jax", y, X, meta, params))}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "summaries.json"), "w") as fh:
        json.dump(out, fh)
    # the port's gaps to it on the CPU (the tolerances' origin)
    gaps = {}
    for setting, (name, params) in FX.SANITY_SETTINGS.items():
        y, X, meta = vectors[name]
        summary, matrix = fit_checker("port", y, X, meta, params)
        gaps[setting] = FX.check_titanic_sanity(summary, setting, matrix)
    out["port_cpu_gaps"] = gaps
    with open(os.path.join(path, "summaries.json"), "w") as fh:
        json.dump(out, fh)
    return gaps


# ---------------------------------------------------------------------------
# the stage in both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def vectors():
    return {name: jax_vector(frame(name)) for name in ("titanic", "titanic_distinct_names")}


@pytest.mark.parametrize("setting", SMALL)
def test_sanity_checker_matches_the_jax_package(vectors, setting):
    name, params = FX.SANITY_SETTINGS[setting]
    y, X, meta = vectors[name]
    mine, matrix = fit_checker("port", y, X, meta, params)
    theirs, their_matrix = fit_checker("jax", y, X, meta, params)
    # the JAX package reproduces the fixture, and the port holds to it
    ref = FX.load_sanity()[setting]
    assert FX.strip_numbers(theirs["reasons"]) == FX.strip_numbers(ref["summary"]["reasons"])
    assert theirs["dropped"] == ref["summary"]["dropped"]
    np.testing.assert_array_equal(
        their_matrix, np.array(ref["corr_matrix"], dtype=np.float64))
    gaps = FX.check_titanic_sanity(mine, setting, matrix)
    assert mine["dropped"] == theirs["dropped"] and mine["dropped"]
    if name == "titanic_distinct_names":
        hashed = [i for i, n in enumerate(mine["names"]) if "Name" in n and "_hash" in n.lower()]
        assert len(hashed) >= 64 and all(np.isnan(matrix[hashed]).ravel())
    assert gaps["corr_label_max_gap"] <= FX.SANITY_CORR_ATOL


def test_fixture_holds_every_setting():
    ref = FX.load_sanity()
    assert set(FX.SANITY_SETTINGS) <= set(ref)
    for setting, (name, params) in FX.SANITY_SETTINGS.items():
        entry = ref[setting]
        assert entry["params"] == json.loads(json.dumps(params))
        assert entry["summary"]["sampleSize"] == entry["rows"]
        assert entry["summary"]["correlationType"] == params.get("correlation_type", "pearson")
    # the 2^20-row frame's final fit: every row checked, 24 columns
    assert ref["scale_pearson"]["rows"] == FX.SANITY_SCALE_ROWS
    assert ref["scale_pearson"]["width"] == ref["scale_spearman"]["width"] == 24
    # the port's gaps to the JAX package on the CPU when it was written
    for setting, gaps in ref["port_cpu_gaps"].items():
        assert gaps["corr_label_max_gap"] <= FX.SANITY_CORR_ATOL
        assert gaps["variance_max_rel_gap"] <= FX.SANITY_MOMENT_RTOL


def test_streams_above_2_18_rows_by_default():
    """A sample of 2^18 + 5 rows takes the streamed branch (K-X, K-I centered
    on their plain versions here) in both packages, with the same drops."""
    rng = np.random.default_rng(3)
    n, d = (1 << 18) + 5, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 1] = X[:, 0] * 2 + 1e-4 * rng.normal(size=n).astype(np.float32)
    X[:, 2] = 0.5
    y = (X[:, 0] > 0).astype(np.float64)
    meta = {"name": "features", "columns": [
        {"parentFeatureName": [f"f{i}"], "parentFeatureType": ["Real"], "index": i}
        for i in range(d)]}
    params = {"sample_upper_limit": n}
    launches = K.chunk_moments.launches, K.centered_gram.launches
    with mock.patch.object(K, "chunk_moments", wraps=K.chunk_moments) as moments, \
            mock.patch.object(K, "centered_gram", wraps=K.centered_gram) as gram:
        mine, _ = fit_checker("port", y, X, meta, params)
    # one pass over two chunks, on the plain versions (CPU tensors: no launch)
    assert [c.kwargs["mode"] for c in moments.call_args_list] == ["chan", "chan"]
    assert gram.call_count == 2
    assert (K.chunk_moments.launches, K.centered_gram.launches) == launches
    theirs, _ = fit_checker("jax", y, X, meta, params)
    assert mine["sampleSize"] == n
    assert mine["dropped"] == theirs["dropped"] == ["f1_1", "f2_2"]
    assert FX.strip_numbers(mine["reasons"]) == FX.strip_numbers(theirs["reasons"])


# ---------------------------------------------------------------------------
# the train, end to end
# ---------------------------------------------------------------------------
def test_spearman_streamed_train_matches_the_fixture(tmp_path):
    import chip_smoke

    params = FX.SANITY_SETTINGS["spearman_streamed"][1]
    model, _ = PTitanic.train_titanic(device="cpu",
                                      models_and_parameters=chip_smoke.spaces()["titanic_newton"],
                                      sanity_check_params=params)
    sc = next(s for s in model.stages if type(s).__name__ == "SanityCheckerModel")
    summary = sc.metadata["sanity_checker_summary"]
    FX.check_titanic_sanity(summary, "spearman_streamed")
    assert summary["correlationType"] == "spearman"
    model.save(str(tmp_path))
    loaded = J.OpWorkflowModel.load(str(tmp_path))
    jsc = next(s for s in loaded.stages if type(s).__name__ == "SanityCheckerModel")
    assert jsc.metadata["sanity_checker_summary"]["correlationType"] == "spearman"
    assert jsc.metadata["sanity_checker_summary"]["dropped"] == summary["dropped"]
    cols = PTitanic.titanic_data(64, 5)
    pred, _, _ = FX.prediction_arrays(P.BatchScoreFunction(model)(FX.records(cols)),
                                      model.result_features[0].name)
    theirs = loaded.score(pd.DataFrame(cols))[loaded.result_features[0].name]
    np.testing.assert_array_equal(np.asarray(theirs.prediction), pred)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    print(json.dumps(write_fixture(), indent=1))
    print(f"wrote {FX.TITANIC_SANITY}")
