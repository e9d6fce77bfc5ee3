"""The Titanic flow with a free-text column, on the port against the JAX
package's, on the CPU.

``apps/titanic.text_columns(n, seed)`` adds ``Notes`` (a case-description
field: topic mixtures over a 2,000-word vocabulary, 8-32 tokens a row, 1%
null) to the Titanic frame, and ``build_workflow(text_embeddings=True)``
embeds it on two branches beside the flow's other features:
``notes.tokenize()`` -> ``OpWord2Vec()`` (64 dimensions) and
``notes.tokenize().count_vectorize()`` -> ``OpLDA()`` (10 topics over 512
terms).  The JAX side builds the same workflow from the JAX package's stages
here.  The count vectorizer, Word2Vec and LDA refit in every workflow-level
fold (they sit in the layers from the first label-using one on), so one
train fits each four times.

The committed fixture ``transmogrifai_tpu_torch/fixtures/titanic_text/``
holds the JAX package's 891-row train over the binary selector's stock space
(winner: logistic regression {0.001, 0.1}), its three fused-sweep calls'
metrics, 256 requests and the JAX package's answers, and (``k18.npz``) the
final fit's tokens, count matrix and skip-gram digests plus small SGNS / LDA
cases with the JAX package's outputs, for the card, which has no JAX.  The
port's 891-row train over the logistic-regression part of that space (the
winner's family; the full space is marked ``slow``) is held to it by
``FX.check_titanic_text_train``.  Regenerate the fixture with ``python
tests/test_torch_text_slice.py --write`` (trains with the JAX package on the
CPU, about two minutes).
"""
import argparse
import json
import os
import shutil
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JT
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.feature import embeddings as JEmb
from transmogrifai_tpu.impl.feature import text as JText
from transmogrifai_tpu.impl.selector.factories import BinaryClassificationModelSelector as JB
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.impl.feature import embeddings as PEmb
from transmogrifai_tpu_torch.impl.selector import defaults as PD

torch.set_num_threads(1)

FIXTURE = FX.TITANIC_TEXT


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def jax_workflow(models_and_parameters=None):
    """The text flow built from the JAX package's stages (the port's
    ``build_workflow(text_embeddings=True)`` stage for stage)."""
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
    vectors = [sex.pivot(pclass, embarked, top_k=10, min_support=1),
               name.smart_vectorize(max_cardinality=10, num_hashes=64, min_support=1)]
    notes = F("Notes", JT.Text).extract(field="Notes").as_predictor()
    tokens = notes.tokenize()
    vectors += [JEmb.OpWord2Vec().set_input(tokens).get_output(),
                JEmb.OpLDA().set_input(tokens.count_vectorize()).get_output()]
    features = family_size.vectorize(age, fare, label=survived).combine(*vectors)
    checked = features.sanity_check(survived)
    pred = JB.with_cross_validation(num_folds=3, seed=42,
                                    models_and_parameters=models_and_parameters
                                    ).set_input(survived, checked).get_output()
    return J.OpWorkflow().set_result_features(pred)


def frame(cols):
    return pd.DataFrame({k: (list(v) if v.dtype == object else v) for k, v in cols.items()})


class JaxW2VArgs:
    """Records the arguments (W0, C0, pairs, negs) of every jitted Word2Vec
    train of the JAX package while on."""

    def __init__(self):
        self.calls = []
        self._patch = None

    def __enter__(self):
        real_jit = jax.jit

        def recording_jit(fn, *a, **k):
            jitted = real_jit(fn, *a, **k)
            if getattr(fn, "__name__", "") != "train":
                return jitted

            def call(*args):
                self.calls.append([np.asarray(x) for x in args])
                return jitted(*args)
            return call

        self._patch = mock.patch.object(jax, "jit", recording_jit)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)


def recorded_sweep(module, train):
    """(train(), the metrics [calls, F, C, M] of its fused-sweep calls)."""
    calls = []
    run = module.SweepPlan.run

    def recording_run(self, *a, **k):
        out = run(self, *a, **k)
        calls.append(np.asarray(out))
        return out

    module.SweepPlan.run = recording_run
    try:
        out = train()
    finally:
        module.SweepPlan.run = run
    return out, np.stack(calls)


def jax_answers(model, cols):
    name = model.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(JBatchScoreFunction(model)(FX.records(cols)), name)
    return {"prediction": pred, "probability": prob, "rawPrediction": raw}


def text_requests(model, n=256, seed=0):
    """Titanic-schema request columns (``make_requests``) with a Notes field
    from ``text_columns(n, seed + 1)``: a null, an empty note, unseen words
    only, an upper-cased note."""
    from test_torch_fixture import make_requests

    cols = make_requests(model, n=n, seed=seed)
    notes = PTitanic.text_columns(n, seed + 1)["Notes"].copy()
    notes[0], notes[1], notes[2] = None, "", "zzz qqq unseen words"
    notes[3] = (notes[4] or "w0001").upper()
    cols["Notes"] = notes
    return cols


def k18_cases(seed=0):
    """Small SGNS-epoch and LDA E- / M-step cases and the JAX package's
    outputs for them (the card holds the port's kernels to these)."""
    rng = np.random.default_rng(seed)
    V, d, Pn, K = 300, 64, 5000, 5
    zipf = 1.0 / np.arange(1, V + 1) ** 1.1
    zipf /= zipf.sum()
    W = (rng.standard_normal((V, d)) / np.sqrt(d)).astype(np.float32)
    C = (0.1 * rng.standard_normal((V, d))).astype(np.float32)
    pairs = rng.choice(V, (Pn, 2), p=zipf).astype(np.int32)
    negs = rng.choice(V, (Pn, K), p=zipf).astype(np.int32)
    (jW, jC), jloss = jax.jit(JEmb._sgns_epoch, static_argnums=3)(
        (jnp.asarray(W), jnp.asarray(C)), jnp.asarray(pairs), jnp.asarray(negs), 0.2)
    n, v, k = 500, 512, 10
    X = rng.poisson(0.04, (n, v)).astype(np.float32)
    lam = rng.gamma(2.0, 1.0, (k, v)).astype(np.float32)
    gamma, exp_beta = JEmb._lda_e_step_jit(jnp.asarray(lam), jnp.asarray(X), 0.1, 30)
    lam2 = jax.jit(m_step)(jnp.asarray(lam), jnp.asarray(X), gamma, 0.01)
    return {"sgns_W": W, "sgns_C": C, "sgns_pairs": pairs, "sgns_negs": negs,
            "sgns_W_out": np.asarray(jW), "sgns_C_out": np.asarray(jC),
            "sgns_loss": np.float32(jloss), "lda_X": X, "lda_lam": lam,
            "lda_exp_beta": np.asarray(exp_beta), "lda_gamma": np.asarray(gamma),
            "lda_lam_out": np.asarray(lam2)}


def m_step(lam, X, gamma, eta):
    """The M-step lines of the JAX package's ``OpLDA.fit_columns`` ``em``
    program (``embeddings.py:208-211``) at a given gamma."""
    from jax.scipy.special import digamma

    exp_beta = jnp.exp(digamma(lam) - digamma(lam.sum(axis=1, keepdims=True)))
    exp_theta = jnp.exp(digamma(gamma) - digamma(gamma.sum(axis=1, keepdims=True)))
    phi_norm = exp_theta @ exp_beta + 1e-100
    return eta + exp_beta * (exp_theta.T @ (X / phi_norm))


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    cols = PTitanic.text_columns()
    with JaxW2VArgs() as rec:
        model, metrics = recorded_sweep(
            JSF, lambda: jax_workflow().set_input_dataset(frame(cols), key="PassengerId")
            .train())
    assert len(rec.calls) == 4, "Word2Vec fits: three folds and the final"
    os.makedirs(path, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    np.savez_compressed(os.path.join(path, "sweep.npz"), metrics=metrics)
    req = text_requests(model, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), req)
    saved = J.OpWorkflowModel.load(path)
    np.savez_compressed(os.path.join(path, "expected.npz"), **jax_answers(saved, req))
    W0, _, pairs, negs = rec.calls[-1]
    tokenizer = next(s for s in saved.stages if isinstance(s, JText.TextTokenizer))
    counter = next(s for s in saved.stages if isinstance(s, JText.OpCountVectorizerModel))
    tokens = [tokenizer.tokenize(t) for t in cols["Notes"]]
    col = J.columns.ObjectColumn(JT.TextList, np.empty(len(tokens), dtype=object))
    col.values[:] = tokens
    counts = np.asarray(counter.transform_columns([col]).values)
    assert counts.max() < 256
    np.savez_compressed(
        os.path.join(path, "k18.npz"), tokens=np.array([" ".join(t) for t in tokens]),
        counts=counts.astype(np.uint8), final_pairs=np.int64(pairs.shape[0]),
        final_pairs_sha=FX.digest(pairs), final_negs_sha=FX.digest(negs),
        final_W0_sha=FX.digest(W0), **k18_cases(seed))


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------
def _summary():
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


def test_fixture_holds_the_references_winner():
    summ = _summary()
    assert (summ["bestModelName"], summ["bestGrid"]) == \
        ("OpLogisticRegression", {"reg_param": 0.001, "elastic_net_param": 0.1})
    assert [r["modelName"] for r in summ["validationResults"]] == \
        ["OpLogisticRegression"] * 8 + ["OpRandomForestClassifier"] * 18 + \
        ["OpXGBoostClassifier"] * 2
    metrics = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))["metrics"]
    assert metrics.shape == (3, 1, 28, 6)
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(FX._titanic_folds(metrics), folds)
    k18 = FX.load_k18()
    # the final fit's skip-gram pairs stay under max_pairs: no subsample at 891 rows
    assert k18["counts"].shape == (891, 512) and 100_000 < int(k18["final_pairs"]) < 200_000


def test_text_columns_are_the_titanic_frame_plus_notes():
    cols, base = PTitanic.text_columns(500, 3), PTitanic.titanic_data(500, 3)
    assert set(cols) == set(base) | {"Notes"}
    for k in base:
        np.testing.assert_array_equal(cols[k], base[k])
    notes = cols["Notes"]
    lens = [len(t.split()) for t in notes if t is not None]
    assert min(lens) >= 8 and max(lens) <= 32 and 0 < sum(t is None for t in notes) < 20
    assert all(w.startswith("w") and len(w) == 5 for t in notes if t for w in t.split())
    again = PTitanic.text_columns(500, 3)["Notes"]
    assert list(again) == list(notes)


def test_jax_reproduces_the_fixture_answers():
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    got = jax_answers(J.OpWorkflowModel.load(FIXTURE), cols)
    for k, v in got.items():
        np.testing.assert_array_equal(v, expected[k], err_msg=k)


def test_port_scores_the_jax_saved_model():
    model = P.load_model(FIXTURE, device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    pred, prob, _ = FX.prediction_arrays(P.BatchScoreFunction(model)(FX.records(cols)),
                                         model.result_features[0].name)
    FX.compare_text_answers(FX.load_expected(os.path.join(FIXTURE, "expected.npz")), pred,
                            prob, FX.TEXT_JAX_SAVED_PROB_ATOL)


def test_port_tokens_and_counts_equal_the_fixtures():
    """The port's tokenizer on the 891-row Notes and the fixture's count
    model (loaded by the port) give the JAX package's tokens and counts."""
    model = P.load_model(FIXTURE, device="cpu")
    found = FX.check_text_tokens(model, PTitanic.text_columns()["Notes"])
    assert found["rows"] == 891


# ---------------------------------------------------------------------------
# the port's train, against the fixture
# ---------------------------------------------------------------------------
def lr_space(lr):
    return [(lr(), PD.logistic_regression_grid())]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's 891-row text-flow train over the LR part of the stock
    space, with its final Word2Vec fit's inputs recorded."""
    with FX.PortW2VArgs(PEmb) as rec:
        model, wf = PTitanic.train_titanic(PTitanic.text_columns(), device="cpu",
                                           text_embeddings=True,
                                           models_and_parameters=lr_space(PLR))
    path = str(tmp_path_factory.mktemp("text"))
    model.save(path)
    return model, wf, rec.calls, path


def test_port_train_matches_the_fixture(trained):
    model, wf, w2v_calls, _ = trained
    assert len(w2v_calls) == 4
    found = FX.check_titanic_text_train(model, w2v_calls[-1])
    assert found["best"] == "OpLogisticRegression"
    assert found["max_gap"]["OpLogisticRegression"] <= FX.LR_AUPR_TOL
    assert {"cv_feature_refits", "cv_sweep_fista"} <= set(wf.train_timings)


def test_port_saved_text_model_scores_alike_in_both_packages(trained):
    model, _, _, path = trained
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    loaded = P.load_model(path, device="cpu")
    name = loaded.result_features[0].name
    pred, prob, _ = FX.prediction_arrays(P.BatchScoreFunction(loaded)(FX.records(cols)), name)
    FX.compare_text_answers(expected, pred, prob, FX.TEXT_PROB_ATOL)
    mine, _, _ = FX.prediction_arrays(P.BatchScoreFunction(model)(FX.records(cols)), name)
    np.testing.assert_array_equal(mine, pred)
    jl = J.OpWorkflowModel.load(path)
    jpred, jprob, _ = FX.prediction_arrays(JBatchScoreFunction(jl)(FX.records(cols)), name)
    np.testing.assert_allclose(jprob, prob, rtol=0, atol=FX.TEXT_JAX_SAVED_PROB_ATOL)


def test_default_flow_is_unchanged_without_text():
    """``build_workflow()`` keeps the Titanic flow's stages; with
    ``text_embeddings`` the Notes branches join the combiner."""
    wf, _ = PTitanic.build_workflow()
    wf_text, _ = PTitanic.build_workflow(text_embeddings=True)
    plain = [type(s).__name__ for s in wf.stages]
    text = [type(s).__name__ for s in wf_text.stages]
    assert "Notes" not in {f.name for f in wf.raw_features}
    assert "Notes" in {f.name for f in wf_text.raw_features}
    assert not {"TextTokenizer", "OpCountVectorizer", "OpWord2Vec", "OpLDA"} & set(plain)
    assert sorted(text) == sorted(plain + ["TextTokenizer", "OpCountVectorizer", "OpWord2Vec",
                                           "OpLDA"])
    combiner = [s for s in wf_text.stages if type(s).__name__ == "VectorsCombiner"][-1]
    assert [type(f.origin_stage).__name__ for f in combiner.inputs][-2:] == ["OpWord2Vec",
                                                                            "OpLDA"]


@pytest.mark.slow
def test_port_full_width_train_matches_the_fixture():
    """The stock space (28 candidates) as the fixture's train (marked slow:
    its forests and boosting take minutes on one CPU thread)."""
    with FX.PortW2VArgs(PEmb) as rec:
        model, _ = PTitanic.train_titanic(PTitanic.text_columns(), device="cpu",
                                          text_embeddings=True)
    found = FX.check_titanic_text_train(model, rec.calls[-1])
    assert found["best"] == "OpLogisticRegression"


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
