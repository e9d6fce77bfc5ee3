"""The Titanic XGBoost train of the port against the JAX package's, on the CPU.

The Titanic flow (``transmogrifai_tpu_torch/apps/titanic.py``, the port's
copy of ``helloworld/titanic.py``) on the 891-row synthetic frame, with the
stock XGBoost grid cut to 8 rounds at depth 4 (both min_child_weight
values), is trained by the JAX package and by the port with
``device="cpu"``, each on its default route, the fused sweep (metrics on
the device: float32 in the JAX package, exact counts in the port).  They
must agree on the fold masks and the holdout, the kept sanity-check columns
and the statistics behind them (float64 moments and correlations within
1e-9, contingency counts equal), every fold's AuPR (within 1e-6), the
winner, the refit trees, and the holdout metrics (AuPR and AuROC within
5e-3, equal confusion counts: the refit's leaf values differ in the last
bits, because the port sums the histograms in fixed point and XLA in
float32, and the 8-round model's scores have many ties, which such bits can
split or join; measured: AuPR equal, AuROC 1.6e-3 apart); the model the
port saves loads in both packages, which score it with the fixture's
tolerances, and re-saves to byte-equal JSON.  The per-family sweep (the
route for candidates the fused sweep does not take) is held to the JAX
package's per-family sweep directly.  The binary selector's default
candidates are the JAX package's 28.
"""
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "helloworld"))

import transmogrifai_tpu as J  # noqa: E402
from transmogrifai_tpu.impl.classification.trees import OpXGBoostClassifier as JXGB  # noqa: E402
from transmogrifai_tpu.impl.tuning.splitters import DataBalancer as JDataBalancer  # noqa: E402
from transmogrifai_tpu.parallel.sweep import make_fold_weights as j_fold_weights  # noqa: E402

import transmogrifai_tpu_torch as P  # noqa: E402
from transmogrifai_tpu_torch import fixtures as FX  # noqa: E402
from transmogrifai_tpu_torch.apps import titanic as PTitanic  # noqa: E402
from transmogrifai_tpu_torch.impl.classification.trees import OpXGBoostClassifier  # noqa: E402
from transmogrifai_tpu_torch.impl.selector.factories import \
    BinaryClassificationModelSelector  # noqa: E402
from transmogrifai_tpu_torch.impl.tuning.splitters import DataBalancer  # noqa: E402
from transmogrifai_tpu_torch.impl.tuning.validators import make_fold_weights  # noqa: E402

torch.set_num_threads(1)

#: the stock XGBoost grid (defaults.py:69) cut to 8 rounds at depth 4
GRID = [{"num_round": 8, "eta": 0.02, "min_child_weight": mcw, "max_depth": 4, "gamma": 0.8}
        for mcw in (1.0, 10.0)]
AUPR_TOL = 1e-6
HOLDOUT_TOL = 5e-3


def _rule_words(reasons):
    """Each feature's drop reasons without the numbers they quote."""
    def words(text):
        out = []
        for w in text.split():
            try:
                float(w)
            except ValueError:
                out.append(w)
        return out
    return {k: [words(r) for r in v] for k, v in reasons.items()}


def _frame(cols):
    return pd.DataFrame({k: (list(v) if v.dtype == object else v) for k, v in cols.items()})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX model, port model, port save dir, JAX save dir)."""
    from test_torch_fixture import build_titanic
    from titanic import titanic_data

    jm = build_titanic(models_and_parameters=[(JXGB(), GRID)]) \
        .set_input_dataset(titanic_data(), key="PassengerId").train()
    pm, _ = PTitanic.train_titanic(device="cpu", model_types=None,
                                   models_and_parameters=[(OpXGBoostClassifier(), GRID)])
    tmp = tmp_path_factory.mktemp("titanic")
    pm.save(str(tmp / "port"))
    jm.save(str(tmp / "jax"))
    return jm, pm, str(tmp / "port"), str(tmp / "jax")


def test_titanic_data_is_the_jax_frame():
    from titanic import titanic_data

    want = titanic_data()
    got = PTitanic.titanic_data()
    assert list(got) == list(want.columns)
    for k in got:
        assert list(got[k]) == list(want[k]), k
    big = PTitanic.titanic_data(5000, 7)
    assert np.all(big["Survived"][big["Sex"] == "female"] == 1)


@pytest.mark.parametrize("stratify", [False, True])
def test_fold_masks_and_holdout_match_jax(stratify):
    rng = np.random.default_rng(0)
    y = (rng.random(801) < 0.6).astype(np.float32)
    lab = y if stratify else None
    for a, b in zip(make_fold_weights(801, 3, 42, lab), j_fold_weights(801, 3, 42, lab)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(DataBalancer(0.1, 0.1).split(801, y), JDataBalancer(0.1, 0.1).split(801, y)):
        np.testing.assert_array_equal(a, b)
    y_rare = (rng.random(801) < 0.04).astype(np.float32)
    pb, jb = DataBalancer(0.1, 0.1), JDataBalancer(0.1, 0.1)
    assert pb.pre_validation_prepare(y_rare).prepared == jb.pre_validation_prepare(y_rare).prepared
    np.testing.assert_array_equal(pb.prepare_weights(y_rare), jb.prepare_weights(y_rare))
    np.testing.assert_array_equal(pb.prepare_indices(y_rare), jb.prepare_indices(y_rare))


def test_sweep_and_winner_match_jax(trained):
    jm, pm, _, _ = trained
    js, ps = jm.stages[-1].summary, pm.stages[-1].summary
    assert ps.validation_type == js.validation_type == "workflow-OpCrossValidation"
    assert ps.best_grid == js.best_grid
    for jr, pr in zip(js.validation_results, ps.validation_results):
        assert pr["grid"] == jr["grid"]
        np.testing.assert_allclose(pr["foldMetrics"], jr["foldMetrics"], rtol=0, atol=AUPR_TOL)
    assert ps.data_prep_results == js.data_prep_results
    for key in ("AuPR", "AuROC"):
        assert abs(ps.holdout_evaluation[key] - js.holdout_evaluation[key]) <= HOLDOUT_TOL, key
    for key in ("TP", "TN", "FP", "FN"):  # predictions at 0.5 agree
        assert ps.holdout_evaluation[key] == js.holdout_evaluation[key], key


def test_kept_columns_and_feature_fits_match_jax(trained):
    jm, pm, _, _ = trained
    by_type = {}
    for j, p in zip(jm.stages, pm.stages):
        assert type(j).__name__ == type(p).__name__ and j.uid.split("_")[0] == p.uid.split("_")[0]
        by_type.setdefault(type(j).__name__, []).append((j, p))
    (jsc, psc), = by_type["SanityCheckerModel"]
    np.testing.assert_array_equal(psc.indices_to_keep, jsc.indices_to_keep)
    assert psc.out_metadata.column_names() == jsc.out_metadata.column_names()
    ps, js = (m.metadata["sanity_checker_summary"] for m in (psc, jsc))
    assert ps["dropped"] == js["dropped"]
    # the same rules fire (their texts quote the statistics, which differ
    # in the last bits)
    assert _rule_words(ps["reasons"]) == _rule_words(js["reasons"])
    # float64 moments and label correlations, taken in another summation
    # order; the contingency counts are exact
    nan0 = [np.nan if v is None else v for v in js["correlationsWLabel"]["values"]]
    nan1 = [np.nan if v is None else v for v in ps["correlationsWLabel"]["values"]]
    np.testing.assert_allclose(nan1, nan0, rtol=1e-9, atol=1e-12)
    for a, b in zip(ps["featuresStatistics"], js["featuresStatistics"]):
        for key in ("mean", "min", "max", "variance"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-9, atol=1e-12)
    assert len(ps["categoricalStats"]) == len(js["categoricalStats"]) > 0
    for a, b in zip(ps["categoricalStats"], js["categoricalStats"]):
        assert a["contingencyMatrix"] == b["contingencyMatrix"]
        np.testing.assert_allclose(a["cramersV"], b["cramersV"], rtol=1e-12)
    for j, p in by_type["DecisionTreeNumericBucketizerModel"]:
        assert p.splits == j.splits
    (jr, pr), = by_type["RealVectorizerModel"]
    np.testing.assert_array_equal(pr.fills, jr.fills)
    (jo, po), = by_type["OneHotVectorizerModel"]
    assert po.categories == jo.categories
    (jt, pt), = by_type["SmartTextVectorizerModel"]
    assert (pt.is_categorical, pt.categories) == (jt.is_categorical, jt.categories)


def test_refit_trees_match_jax(trained):
    jm, pm, _, _ = trained
    jp, pp = jm.stages[-1].model_params, pm.stages[-1].model_params
    np.testing.assert_array_equal(pp["edges"], jp["edges"])
    for k in ("split_feat", "split_bin", "left", "right"):
        np.testing.assert_array_equal(pp[k], jp[k], k)
        assert pp[k].dtype == jp[k].dtype
    np.testing.assert_allclose(pp["leaf_val"], jp["leaf_val"], rtol=0, atol=1e-5)
    assert {k: pp[k] for k in ("max_depth", "eta", "num_classes", "loss")} == \
        {k: jp[k] for k in ("max_depth", "eta", "num_classes", "loss")}


def test_port_saved_model_scores_alike_in_both_packages(trained):
    _, pm, port_dir, _ = trained
    cols = PTitanic.titanic_data(300, 11)
    cols["Age"][::9] = np.nan
    cols["Embarked"][::13] = None
    jl = J.OpWorkflowModel.load(port_dir)
    pl = P.load_model(port_dir, device="cpu")
    name = pl.result_features[0].name
    jp = jl.score(_frame(cols))[jl.result_features[0].name]
    pp = pl.score(cols)[name]
    np.testing.assert_allclose(pp.probability, jp.probability, rtol=0, atol=FX.PROB_ATOL)
    margin = np.abs(jp.raw_prediction[:, 1])
    off = margin >= FX.BOUNDARY
    np.testing.assert_array_equal(pp.prediction[off], jp.prediction[off])
    np.testing.assert_array_equal(pm.score(cols)[name].probability, pp.probability)


def test_port_saved_model_resaves_byte_equal(trained, tmp_path):
    _, _, port_dir, jax_dir = trained
    P.load_model(port_dir, device="cpu").save(str(tmp_path))
    with open(os.path.join(port_dir, "op_model.json"), "rb") as a, \
            open(tmp_path / "op_model.json", "rb") as b:
        assert a.read() == b.read()
    with np.load(os.path.join(port_dir, "op_model_arrays.npz")) as za, \
            np.load(tmp_path / "op_model_arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k
    # the manifest has the JAX package's class paths and layout
    mp, mj = (json.load(open(os.path.join(d, "op_model.json"))) for d in (port_dir, jax_dir))
    assert [s["class"] for s in mp["stages"]] == [s["class"] for s in mj["stages"]]
    assert [sorted(s["state"]) for s in mp["stages"]] == [sorted(s["state"]) for s in mj["stages"]]


def test_stock_space_needs_the_unported_families():
    """The binary selector's default candidates: the JAX package's 28 (LR,
    RF and XGBoost with their grids and constructor params), and
    ``model_types`` keeps the named families."""
    from transmogrifai_tpu.impl.selector.factories import BinaryClassificationModelSelector as JB

    jc, pc = JB._default_models(), BinaryClassificationModelSelector._default_models()
    assert [type(e).__name__ for e, _ in pc] == [type(e).__name__ for e, _ in jc] == \
        ["OpLogisticRegression", "OpRandomForestClassifier", "OpXGBoostClassifier"]
    for (pe, pg), (je, jg) in zip(pc, jc):
        assert pg == jg
        assert pe._params == je._params
    assert sum(len(g) for _, g in pc) == 28
    sel = BinaryClassificationModelSelector.with_cross_validation(
        model_types=["OpXGBoostClassifier", "OpRandomForestClassifier"])
    assert [type(e).__name__ for e, _ in sel.models] == \
        ["OpRandomForestClassifier", "OpXGBoostClassifier"]
    with pytest.raises(ValueError, match="No candidate models"):
        BinaryClassificationModelSelector.with_cross_validation(model_types=["OpNaiveBayes"])


@pytest.mark.parametrize("family", ["xgb", "rf", "lr"])
def test_per_family_sweep_matches_jax(family, monkeypatch):
    """The port's per-family sweep (``_family_sweep``) against the JAX
    package's (``_sweep`` with ``TMOG_FUSED_SWEEP=0``) on the same matrix
    and folds: equal fold AuPR within 1e-6 (XGBoost: within 1e-4, its
    histograms summed in fixed point against XLA's float32)."""
    from transmogrifai_tpu.evaluators import Evaluators as JE
    from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression as JLR
    from transmogrifai_tpu.impl.classification.trees import OpRandomForestClassifier as JRF
    from transmogrifai_tpu.impl.tuning.validators import OpCrossValidation as JCV
    from transmogrifai_tpu_torch.evaluators import Evaluators as PE
    from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
    from transmogrifai_tpu_torch.impl.classification.trees import OpRandomForestClassifier
    from transmogrifai_tpu_torch.impl.tuning.validators import OpCrossValidation

    rng = np.random.default_rng(3)
    n, d = 500, 7
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 2] = rng.integers(0, 3, n)
    y = ((X[:, 0] - X[:, 2] + rng.normal(size=n)) > 0).astype(np.float32)
    grids = {"xgb": (JXGB, OpXGBoostClassifier, [dict(g, num_round=3, max_depth=3) for g in GRID]),
             "rf": (JRF, OpRandomForestClassifier,
                    [{"num_trees": 4, "max_depth": dd, "min_instances_per_node": 10}
                     for dd in (3, 5)]),
             "lr": (JLR, OpLogisticRegression,
                    [{"reg_param": 0.01, "elastic_net_param": a} for a in (0.1, 0.5)])}
    jcls, pcls, grid = grids[family]
    jv, pv = JCV(JE.BinaryClassification.auPR(), seed=42), \
        OpCrossValidation(PE.BinaryClassification.auPR(), seed=42)
    train_w, val_mask = pv.make_folds(n, None)
    from transmogrifai_tpu.impl.tuning.validators import ValidationSummary as JVS
    from transmogrifai_tpu_torch.impl.tuning.validators import ValidationSummary as PVS

    js = JVS("cv", "auPR", "AuPR", True)
    ps = PVS("cv", "auPR", "AuPR", True)
    monkeypatch.setenv("TMOG_FUSED_SWEEP", "0")
    jv._sweep([(jcls(), grid)], X, y, train_w, val_mask, js)
    pv._family_sweep([(pcls().to("cpu"), grid)], torch.from_numpy(X), y, train_w, val_mask, ps)
    tol = 1e-4 if family == "xgb" else 1e-6
    assert len(ps.results) == len(js.results) == len(grid)
    for a, b in zip(ps.results, js.results):
        assert a.grid == b.grid and a.error is None
        np.testing.assert_allclose(a.fold_metrics, b.fold_metrics, rtol=0, atol=tol)
