"""The MLP, naive Bayes, Word2Vec and LDA past their old widths, on the port
against the JAX package, on the CPU.

K-U (the MLP) takes 8 hidden layers, features and hidden widths up to 4,096
and 128 classes; K-V (naive Bayes) 65,536 features and 128 classes; K-AA
(Word2Vec) 1,024 dimensions; K-AB (LDA) 256 topics with ``exp_beta``
bounded by the card's memory.  The same seeded numpy inputs go through the
JAX package's programs and the port's plain versions (the wrappers' CPU
branch) at the new widths:

- ``mlp_grad_plain`` / ``mlp_forward_plain`` at layers (32, 128, 64, 26) and
  (450, 128, 64, 32, 2) against ``jax.grad`` of the reference's loss and its
  ``forward``;
- ``nb_tables_*_plain`` at 2,100 features and at 26 classes against
  ``_nb_grid_z``;
- ``sgns_epoch_plain`` at 300 dimensions against ``_sgns_epoch``;
- ``lda_*_plain`` at 100 topics over 1,200 terms (k v = 120,000, past the
  old 51,200) against ``_lda_e_step`` and the M-step.

Then three flows, each built in both packages' DSL (``FX.letters_workflow``
with ``FX.port_letters_families_space()``; ``FX.port_wide_text_workflow``),
against the fixtures the JAX package wrote:

- ``letters_families``: the Letter flow (26 classes, 600 rows) over naive
  Bayes and the MLP at hidden (10,) and (128, 64), the per-family sweep;
- ``wide_text`` "embed": the Titanic text flow (891 rows) with Word2Vec at
  300 dimensions and LDA at 100 topics over a count vector of up to 8,192
  terms, the binary stock space and the MLP at (128, 64, 32) (the fused
  sweep's "mlp" fragment over about 450 features);
- ``wide_text`` "bow": the count vector itself and LDA over it, naive Bayes
  and the default MLP over about 1,700 features.

Each train must pick the fixture's winner with every fold metric within its
family's tolerance (``FX.LETTERS_FAMILIES_TOL``, ``FX.WIDE_TEXT_TOL``: the
existing text-tree and Adam-drift tolerances, unwidened); the JAX-saved
Letter winner loads and scores in the port.  The text trains are ``slow``;
"embed" fails at one CPU thread, a standing gap (its forests and its MLP
past their AuPR tolerances: ROADMAP Queue 3 item 4) that the JAX package
shows against itself: two ``slow`` tests hold that its LDA topic mixtures
move as far as the port's when only its float32 sums' order changes, and
that its MLP's fold AuPR moves past ``MLP_AUPR_TOL`` when one input moves
one ulp.  ``python tests/test_torch_wide_families.py --witness`` prints the
whole account (one JSON line, about an hour).  Regenerate the fixtures with
``python tests/test_torch_wide_families.py --write`` (the JAX package on the
CPU, about ten minutes).
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

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JTy
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import OpWorkflow as JWorkflow
from transmogrifai_tpu.impl.classification import naive_bayes as JNB
from transmogrifai_tpu.impl.classification.mlp import OpMultilayerPerceptronClassifier as JMLP
from transmogrifai_tpu.impl.feature import embeddings as JEmb
from transmogrifai_tpu.impl.selector import defaults as JD
from transmogrifai_tpu.impl.selector.factories import BinaryClassificationModelSelector as JBin
from transmogrifai_tpu.impl.selector.factories import MultiClassificationModelSelector as JMS
from transmogrifai_tpu.local.scoring import BatchScoreFunction as JBatchScoreFunction
from transmogrifai_tpu.ops import mlp as JM

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.impl.classification import naive_bayes as PNB
from transmogrifai_tpu_torch.ops import embeddings as E
from transmogrifai_tpu_torch.ops import mlp as PM

torch.set_num_threads(1)

#: K-U's plain gradients against ``jax.grad``, relative to the largest
#: entry: float32 forward passes in two orders (XLA's dot against torch's
#: matmul), the port's float64 sums of the gradients rounded once
MLP_GRAD_RTOL = 1e-5
#: the logits and the probabilities of ``mlp_forward_plain``
MLP_LOGIT_ATOL = 2e-5
MLP_PROB_ATOL = 2e-6
#: the joint log-likelihoods (values of thousands at 2,100 features): the
#: masses' last bits and the dot products' order, relative
NB_Z_RTOL = 2e-6
#: one SGNS epoch at 300 dimensions (tests/test_torch_embeddings.py's
#: SGNS_ATOL at 8)
SGNS_ATOL = 2e-7
#: the E-step's gammas and the M-step's lambda, relative (as
#: tests/test_torch_embeddings.py's GAMMA_RTOL and its M-step test)
GAMMA_RTOL = 2e-3
LAMBDA_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


# ---------------------------------------------------------------------------
# K-U at the new widths
# ---------------------------------------------------------------------------
def _mlp_case(layers, n=300, F=2, G=2, seed=0):
    rng = np.random.default_rng(seed)
    k = layers[-1]
    X = (rng.normal(size=(n, layers[0])) * 2).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.float32)
    w = rng.integers(0, 3, size=(F, n)).astype(np.float32)
    E_ = PM.param_count(layers)
    flat = (rng.normal(size=(F * G, E_)) * 0.1).astype(np.float32)
    return X, y, w, flat


def _jax_grads(layers, X, y, w, flat, G):
    k = layers[-1]
    Y = jax.nn.one_hot(jnp.asarray(y).astype(jnp.int32), k, dtype=jnp.float32)
    out = []
    for c in range(flat.shape[0]):
        params = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy()))
                  for W, b in PM.unflatten(torch.from_numpy(flat[c]), layers)]
        wc = jnp.asarray(w[c // G])
        ws = jnp.maximum(wc.sum(), 1e-12)

        def loss_fn(p):
            ll = jax.nn.log_softmax(JM.forward(p, jnp.asarray(X)), axis=-1)
            return -(wc[:, None] * Y * ll).sum() / ws

        g = jax.grad(loss_fn)(params)
        out.append(np.concatenate([np.concatenate([np.asarray(a).reshape(-1), np.asarray(b)])
                                   for a, b in g]))
    return np.stack(out)


@pytest.mark.parametrize("layers", [(32, 128, 64, 26), (450, 128, 64, 32, 2)])
def test_mlp_plain_matches_jax_at_the_new_widths(layers):
    X, y, w, flat = _mlp_case(layers)
    G = 2
    fold = torch.arange(flat.shape[0], dtype=torch.int32) // G
    wsum = torch.clamp_min(torch.from_numpy(w).sum(1), 1e-12)[fold.long()].contiguous()
    got = PM.mlp_grad(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w), fold, wsum,
                      torch.from_numpy(flat), layers).numpy()
    want = _jax_grads(layers, X, y, w, flat, G)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_GRAD_RTOL * np.abs(want).max())
    z, prob = PM.mlp_forward(torch.from_numpy(X), torch.from_numpy(flat), layers)
    for c in range(flat.shape[0]):
        params = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy()))
                  for W, b in PM.unflatten(torch.from_numpy(flat[c]), layers)]
        jz, jp, _ = JM.predict_mlp(params, jnp.asarray(X))
        np.testing.assert_allclose(z[c].numpy(), np.asarray(jz), rtol=0, atol=MLP_LOGIT_ATOL)
        np.testing.assert_allclose(prob[c].numpy(), np.asarray(jp), rtol=0, atol=MLP_PROB_ATOL)
    assert PM.mlp_grad.launches == 0 and PM.mlp_forward.launches == 0


# ---------------------------------------------------------------------------
# K-V at the new widths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d,k,bernoulli", [(400, 2100, 2, False), (400, 2100, 2, True),
                                             (900, 32, 26, False)])
def test_nb_plain_matches_jax_at_the_new_widths(n, d, k, bernoulli):
    rng = np.random.default_rng(d + k)
    X = np.concatenate([rng.poisson(0.05, (n, d - 2)), rng.uniform(1, 80, (n, 2))],
                       axis=1).astype(np.float32)
    Xd = (X > 0).astype(np.float32) if bernoulli else X
    y = rng.integers(0, k, n).astype(np.float32)
    y[:k] = np.arange(k)
    tw = np.ones((3, n), np.float32)
    for f in range(3):
        tw[f, f::3] = 0.0
    sm = np.array([1.0, 0.5], np.float32)
    zj = np.asarray(JNB._nb_grid_z(jnp.asarray(Xd), jnp.asarray(np.eye(k, dtype=np.float32)[
        y.astype(int)]), jnp.asarray(tw), jnp.asarray(sm), bernoulli))
    zp = PNB._nb_grid_z(torch.from_numpy(Xd), torch.from_numpy(y), torch.from_numpy(tw), sm,
                        bernoulli, k).numpy()
    assert zp.shape == zj.shape == (3, 2, n, k)
    np.testing.assert_allclose(zp, zj, rtol=NB_Z_RTOL, atol=2e-4)
    assert PNB.nb_tables_mass.launches == 0 and PNB.nb_tables_score.launches == 0


# ---------------------------------------------------------------------------
# K-AA at 300 dimensions
# ---------------------------------------------------------------------------
def test_sgns_plain_matches_jax_at_300_dimensions():
    rng = np.random.default_rng(300)
    V, d, P_, K = 200, FX.WIDE_W2V_DIM, 3000, 5
    p = 1.0 / np.arange(1, V + 1) ** 1.1
    p /= p.sum()
    W = (rng.standard_normal((V, d)) / np.sqrt(d)).astype(np.float32)
    C = (0.1 * rng.standard_normal((V, d))).astype(np.float32)
    pairs = rng.choice(V, (P_, 2), p=p).astype(np.int32)
    negs = rng.choice(V, (P_, K), p=p).astype(np.int32)
    (jW, jC), jloss = jax.jit(JEmb._sgns_epoch, static_argnums=3)(
        (jnp.asarray(W), jnp.asarray(C)), jnp.asarray(pairs), jnp.asarray(negs), 0.2)
    pW, pC, ploss = E.sgns_epoch(torch.from_numpy(W), torch.from_numpy(C),
                                 torch.from_numpy(pairs), torch.from_numpy(negs), 0.2)
    np.testing.assert_allclose(pW.numpy(), np.asarray(jW), rtol=0, atol=SGNS_ATOL)
    np.testing.assert_allclose(pC.numpy(), np.asarray(jC), rtol=0, atol=SGNS_ATOL)
    assert abs(float(ploss) - float(jloss)) <= 1e-6
    with pytest.raises(ValueError, match="1024"):
        E.sgns_epoch(torch.zeros((3, 1025)), torch.zeros((3, 1025)),
                     torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32),
                     0.2)


# ---------------------------------------------------------------------------
# K-AB at 100 topics, k v past the old 51,200
# ---------------------------------------------------------------------------
def _jax_m_step(lam, X, gamma, eta):
    """The M-step lines of the JAX package's ``OpLDA.fit_columns`` ``em``
    program (``embeddings.py:208-211``) at a given gamma."""
    from jax.scipy.special import digamma

    exp_beta = jnp.exp(digamma(lam) - digamma(lam.sum(axis=1, keepdims=True)))
    exp_theta = jnp.exp(digamma(gamma) - digamma(gamma.sum(axis=1, keepdims=True)))
    phi_norm = exp_theta @ exp_beta + 1e-100
    return eta + exp_beta * (exp_theta.T @ (X / phi_norm))


def test_lda_plain_matches_jax_at_100_topics():
    n, v, k = 120, 1200, FX.WIDE_LDA_TOPICS
    assert k * v > 51_200
    rng = np.random.default_rng(100)
    X = rng.poisson(0.02, (n, v)).astype(np.float32)
    X[5] = 0.0                                   # an empty document
    lam = rng.gamma(2.0, 1.0, (k, v)).astype(np.float32)
    jg, jeb = JEmb._lda_e_step_jit(jnp.asarray(lam), jnp.asarray(X), 0.1, 30)
    eb = E.lda_beta(torch.from_numpy(lam))
    # the digamma replica's gap (DIGAMMA_ATOL) moves exp_beta by 2e-5
    # relative; a few entries underflow to subnormals (below 1e-37) in one
    # package and to 0 in the other
    np.testing.assert_allclose(eb.numpy(), np.asarray(jeb), rtol=2e-5, atol=1e-37)
    g = E.lda_estep(eb, torch.from_numpy(X), 0.1, 30)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=GAMMA_RTOL, atol=0)
    np.testing.assert_array_equal(g.numpy()[5], np.full(k, 0.1, np.float32))
    gamma = rng.gamma(2.0, 1.0, (n, k)).astype(np.float32) + 0.1
    want = np.asarray(jax.jit(_jax_m_step)(jnp.asarray(lam), jnp.asarray(X), jnp.asarray(gamma),
                                           0.01))
    got = E.lda_sstats(eb, torch.from_numpy(X), torch.from_numpy(gamma), 0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=LAMBDA_RTOL, atol=0)
    docs = E.lda_docs(torch.from_numpy(X))
    assert int(docs.term_seg[-1]) == docs.seg_lo.numel()
    assert (E.lda_estep.launches, E.lda_sstats.launches) == (0, 0)
    with pytest.raises(ValueError, match="256 topics"):
        E.lda_estep(torch.ones((257, 4)), torch.ones((2, 4)), 0.1)


def test_lda_docs_group_the_nonzeros_by_term_in_document_order():
    rng = np.random.default_rng(3)
    X = torch.from_numpy((rng.poisson(0.6, (300, 7)) * (rng.random((300, 7)) < 0.9))
                         .astype(np.float32))
    X[:, 2] = 1.0          # a term in every document: three segments of 128 or fewer
    docs = E.lda_docs(X)
    rows, terms = torch.nonzero(X > 0, as_tuple=True)
    order = docs.col_entry.long()
    assert torch.equal(terms[order], torch.sort(terms, stable=True).values)
    assert torch.equal(docs.col_doc.long(), rows[order])
    for w in range(7):
        lo, hi = int(docs.term_seg[w]), int(docs.term_seg[w + 1])
        segs = list(zip(docs.seg_lo[lo:hi].tolist(), docs.seg_hi[lo:hi].tolist()))
        assert all(b - a <= E.LDA_SEGMENT for a, b in segs)
        idx = [e for a, b in segs for e in range(a, b)]
        assert sorted(rows[order[idx]].tolist()) == rows[order[idx]].tolist()
        assert len(idx) == int((X[:, w] > 0).sum())
    assert int(docs.term_seg[3]) - int(docs.term_seg[2]) == 3


# ---------------------------------------------------------------------------
# the JAX package's flows, built with its own DSL
# ---------------------------------------------------------------------------
def jax_letters_workflow():
    label = JFB("label", JTy.RealNN).extract(field="label").as_response()
    feats = [JFB(f, JTy.Integral).extract(field=f).as_predictor() for f in FX.LETTER_FEATURES]
    space = FX.letters_families_space(JNB.OpNaiveBayes, JMLP, JD.naive_bayes_grid)
    pred = JMS.with_cross_validation(num_folds=3, seed=42, models_and_parameters=space) \
        .set_input(label, feats[0].vectorize(*feats[1:])).get_output()
    return JWorkflow().set_result_features(pred)


def jax_wide_text_workflow(kind):
    space = FX.wide_text_space(kind, JBin, JMLP, JNB.OpNaiveBayes, JD.naive_bayes_grid)
    return FX.wide_text_flow(kind, JFB, JTy, JEmb.OpWord2Vec, JEmb.OpLDA, JBin, JWorkflow,
                             space)[0]


def frame(cols):
    return pd.DataFrame({k: (list(v) if v.dtype == object else v) for k, v in cols.items()})


def letters_requests(n=256, seed=0):
    """Letter-schema request columns: a null in every attribute now and then,
    and values outside the training range."""
    rng = np.random.default_rng(seed)
    cols = FX.letters_data(n, 26, seed + 100)
    cols["id"] = np.arange(10_000, 10_000 + n)
    for f in FX.LETTER_FEATURES:
        cols[f][rng.random(n) < 0.05] = np.nan
        cols[f][rng.random(n) < 0.02] = 20.0
    return cols


def text_requests(n=FX.WIDE_TEXT_REQUESTS, seed=FX.WIDE_TEXT_REQUEST_SEED):
    return PTitanic.text_columns(n, seed)


def summary_of(model):
    summ = model.stages[-1].summary
    return {"best": [summ.best_model_name, summ.best_grid],
            "results": [[r["modelName"], r["grid"], list(map(float, r["foldMetrics"]))]
                        for r in summ.validation_results]}


def vector_width(model):
    """The width of the vector the selector trained on (the sanity
    checker's kept columns)."""
    checker = next(s for s in model.stages if type(s).__name__ == "SanityCheckerModel")
    return int(len(checker.indices_to_keep))


def write_fixtures(seed=0):
    import tempfile

    model = jax_letters_workflow().set_input_dataset(frame(FX.letters_data()), key="id").train()
    path = FX.LETTERS_FAMILIES
    os.makedirs(path, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    saved = J.OpWorkflowModel.load(path)
    cols = letters_requests(seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    name = saved.result_features[0].name
    pred, prob, raw = FX.multiclass_predictions(JBatchScoreFunction(saved)(FX.records(cols)),
                                                name, 26)
    np.savez_compressed(os.path.join(path, "expected.npz"), prediction=pred, probability=prob,
                        rawPrediction=raw)
    out, scores = {}, {}
    req = FX.records(text_requests())
    for kind in FX.WIDE_FLOWS:
        m = jax_wide_text_workflow(kind).set_input_dataset(
            frame(PTitanic.text_columns()), key="PassengerId").train()
        out[kind] = {**summary_of(m), "width": vector_width(m)}
        pred, prob, _ = FX.prediction_arrays(JBatchScoreFunction(m)(req),
                                             m.result_features[0].name)
        scores[f"{kind}_prediction"], scores[f"{kind}_probability"] = pred, prob
    os.makedirs(FX.WIDE_TEXT, exist_ok=True)
    with open(os.path.join(FX.WIDE_TEXT, "trains.json"), "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(FX.WIDE_TEXT, "answers.npz"), **scores)


# ---------------------------------------------------------------------------
# the fixtures, and the port's trains against them
# ---------------------------------------------------------------------------
def test_fixtures_hold_the_references_winners_and_stay_small():
    with open(os.path.join(FX.LETTERS_FAMILIES, "op_model.json")) as fh:
        summ = FX.stage_summary(json.load(fh))
    assert (summ["bestModelName"], summ["bestGrid"]) == \
        ("OpMultilayerPerceptronClassifier", {"hidden_layers": [128, 64]})
    assert [r["modelName"] for r in summ["validationResults"]] == \
        ["OpNaiveBayes"] + ["OpMultilayerPerceptronClassifier"] * 2
    assert summ["dataPrepResults"]["labelsKept"] == [float(j) for j in range(26)]
    with open(os.path.join(FX.WIDE_TEXT, "trains.json")) as fh:
        trains = json.load(fh)
    assert trains["embed"]["best"] == ["OpLogisticRegression",
                                       {"elastic_net_param": 0.1, "reg_param": 0.001}]
    assert trains["bow"]["best"] == ["OpNaiveBayes", {"smoothing": 1.0}]
    assert [r[0] for r in trains["embed"]["results"]][-1] == "OpMultilayerPerceptronClassifier"
    assert len(trains["embed"]["results"]) == 29 and len(trains["bow"]["results"]) == 2
    # the vectors past K-U's and K-V's old widths (128 and 256 features)
    assert 256 < trains["embed"]["width"] < 512 and 1024 < trains["bow"]["width"] < 4096
    size = sum(os.path.getsize(os.path.join(d, f)) for d in (FX.LETTERS_FAMILIES, FX.WIDE_TEXT)
               for f in os.listdir(d))
    assert size < 1 << 20


@pytest.mark.parametrize("kind", FX.WIDE_FLOWS)
def test_wide_text_flows_are_built_alike_in_both_packages(kind):
    port, _ = FX.port_wide_text_workflow(kind)
    jax_wf = jax_wide_text_workflow(kind)
    names = lambda wf: sorted(type(s).__name__ for s in wf.stages)  # noqa: E731
    assert names(port) == names(jax_wf)
    assert ("OpWord2Vec" in names(port)) == (kind == "embed")
    for wf in (port, jax_wf):
        lda = next(s for s in wf.stages if type(s).__name__ == "OpLDA")
        counts = next(s for s in wf.stages if type(s).__name__ == "OpCountVectorizer")
        assert lda.get_param("k") == FX.WIDE_LDA_TOPICS
        assert counts.get_param("vocab_size") == FX.WIDE_VOCAB


def test_port_scores_the_jax_saved_letters_families_winner():
    model = P.load_model(FX.LETTERS_FAMILIES, device="cpu")
    found = FX.check_letters_families_answers(model)
    assert found["rows"] == 256 and found["prediction_mismatches"] == 0
    selected = model.stages[-1]
    assert selected.predictor_class.__name__ == "OpMultilayerPerceptronClassifier"
    assert tuple(selected.model_params["layers"]) == (32, 128, 64, 26)


def test_letters_families_train_matches_the_fixture(tmp_path):
    """The Letter flow over naive Bayes and the MLP (26 classes, 600 rows):
    the fixture's winner, naive Bayes's fold Errors bit-equal, the MLP's
    within ``FX.LETTERS_FAMILIES_TOL``; the port-saved winner scores alike
    in both packages."""
    wf, _ = FX.letters_workflow(FX.port_letters_families_space())
    model = wf.set_input_dataset(FX.letters_data(), key="id").train(device="cpu")
    found = FX.check_letters_families_train(model)
    assert found["max_gap"]["OpNaiveBayes"] == 0.0
    assert {"cv_sweep_OpNaiveBayes", "cv_sweep_OpMultilayerPerceptronClassifier"} <= \
        set(wf.train_timings)
    model.save(str(tmp_path))
    cols = FX.load_columns(os.path.join(FX.LETTERS_FAMILIES, "requests.npz"))
    name = model.result_features[0].name
    pp, _, _ = FX.multiclass_predictions(P.BatchScoreFunction(
        P.load_model(str(tmp_path), device="cpu"))(FX.records(cols)), name, 26)
    jp, _, _ = FX.multiclass_predictions(JBatchScoreFunction(J.OpWorkflowModel.load(
        str(tmp_path)))(FX.records(cols)), name, 26)
    np.testing.assert_array_equal(pp, jp)


@pytest.mark.slow
@pytest.mark.parametrize("kind", FX.WIDE_FLOWS)
def test_wide_text_train_matches_the_fixture(kind):
    """A wide text flow on the 891-row frame ("bow" two minutes, "embed" an
    hour on one CPU thread: Word2Vec at 300 dimensions and LDA at 100 topics
    refit in every workflow-level fold, and the stock space's forests and
    boosting): the fixture's winner and candidates, every fold metric within
    ``FX.WIDE_TEXT_TOL``, the vector's width, the answers on the fixture's
    rows within ``FX.WIDE_TEXT_PROB_ATOL``.  "embed" exceeds the forests'
    and the MLP's tolerances (ROADMAP Queue 3 item 4): a standing failure,
    whose gaps the JAX package shows against itself (the two
    ``test_embed_*`` tests below, ``--witness``)."""
    wf, _ = FX.port_wide_text_workflow(kind)
    model = wf.set_input_dataset(PTitanic.text_columns(), key="PassengerId").train(device="cpu")
    found = FX.check_wide_text_train(model, kind)
    assert found["prediction_mismatches"] == 0


# ---------------------------------------------------------------------------
# "embed" against its fixture: what moves with the reference's own rounding
# ---------------------------------------------------------------------------
#: rows whose largest feature ``ulp_moves`` moves one ulp up, one row at a
#: time in every fold's inputs
ULP_ROWS = (0, 1, 2, 3, 4)
#: the seeds of the vocabulary orders of ``_lda_in_order``
LDA_ORDER_SEEDS = (1, 2)
#: the port's CPU threads in ``--witness`` (its sweeps' plain forests take
#: about half an hour at one)
WITNESS_THREADS = 4


class _Recorded(Exception):
    """Raised by ``fold_inputs``'s recorder once every fold is recorded."""


def jax_lda_topic_word(X, order, k, alpha, eta, max_iter, seed):
    """The JAX package's ``OpLDA.fit_columns`` (its ``em`` program, the
    initial lambda drawn from ``seed``) on the counts X f32[n, v] with the
    vocabulary taken in ``order``, its topic-word lambda returned in X's
    order: one function for every order, whose float32 sums over the terms
    (``lam.sum``, ``(X / phi_norm) @ exp_beta.T``) run in another order."""
    from jax.scipy.special import digamma as jdigamma

    lam0 = np.random.default_rng(seed).gamma(100.0, 0.01, size=(k, X.shape[1]))
    Xj = jnp.asarray(np.asarray(X, np.float32)[:, order])

    def step(lam, _):
        gamma, exp_beta = JEmb._lda_e_step(lam, Xj, alpha)
        exp_theta = jnp.exp(jdigamma(gamma) - jdigamma(gamma.sum(axis=1, keepdims=True)))
        phi_norm = exp_theta @ exp_beta + 1e-100
        return eta + exp_beta * (exp_theta.T @ (Xj / phi_norm)), None

    em = jax.jit(lambda lam: jax.lax.scan(step, lam, None, length=max_iter)[0])
    lam = np.asarray(em(jnp.asarray(lam0[:, order], jnp.float32)), np.float32)
    return lam[:, np.argsort(order)]


def _lda_in_order(order_seed):
    """A stand-in for the JAX package's ``OpLDA.fit_columns`` that fits
    through ``jax_lda_topic_word`` with the vocabulary in the order drawn
    from ``order_seed`` (None: the stage's own order)."""
    def fit_columns(stage, cols, dataset):
        X = np.maximum(np.asarray(cols[0].values), 0.0).astype(np.float32)
        v = X.shape[1]
        order = (np.arange(v) if order_seed is None
                 else np.random.default_rng(order_seed).permutation(v))
        alpha = float(stage.get_param("alpha"))
        lam = jax_lda_topic_word(X, order, int(stage.get_param("k")), alpha,
                                 float(stage.get_param("eta")), int(stage.get_param("max_iter")),
                                 int(stage.get_param("seed")))
        return JEmb.OpLDAModel(topic_word=lam, alpha=alpha, operation_name=stage.operation_name,
                               output_type=stage.output_type)
    return fit_columns


def fold_inputs(package, kind="embed", lda_order=False, order_seed=None):
    """Each workflow-level fold's sweep inputs [(X, y, train_w, val_mask)]
    of a wide text train of the 891 rows in ``package`` ("jax", or "port" on
    the CPU), recorded from its validator's ``_sweep`` (no sweep runs).
    With ``lda_order`` (the JAX package) OpLDA fits through
    ``_lda_in_order(order_seed)``."""
    from transmogrifai_tpu.impl.tuning import validators as JV
    from transmogrifai_tpu_torch.impl.tuning import validators as PV

    V = JV if package == "jax" else PV
    calls = []

    def record(self, candidates, X, y, train_w, val_mask, summary):
        X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
        calls.append((np.array(X, np.float32), np.asarray(y), np.asarray(train_w),
                      np.asarray(val_mask)))
        if len(calls) == self.num_folds:
            raise _Recorded

    sweep, fit = V.OpValidator._sweep, JEmb.OpLDA.fit_columns
    V.OpValidator._sweep = record
    if lda_order:
        JEmb.OpLDA.fit_columns = _lda_in_order(order_seed)
    try:
        if package == "jax":
            jax_wide_text_workflow(kind).set_input_dataset(
                frame(PTitanic.text_columns()), key="PassengerId").train()
        else:
            wf, _ = FX.port_wide_text_workflow(kind)
            wf.set_input_dataset(PTitanic.text_columns(), key="PassengerId").train(device="cpu")
    except _Recorded:
        pass
    finally:
        V.OpValidator._sweep, JEmb.OpLDA.fit_columns = sweep, fit
    return calls


def sweep_gaps(package, folds, families, kind="embed"):
    """{family: the largest gap of its fold metrics to the ``wide_text``
    fixture's} of ``package``'s selector sweep (on the CPU) over ``folds``'s
    inputs, for the candidates of ``families``."""
    from transmogrifai_tpu.impl.tuning.validators import ValidationSummary as JSummary
    from transmogrifai_tpu.parallel.mesh import use_mesh
    from transmogrifai_tpu_torch.impl.tuning.validators import ValidationSummary as PSummary

    if package == "jax":
        wf = jax_wide_text_workflow(kind)
    else:
        wf, _ = FX.port_wide_text_workflow(kind)
    sel = next(s for s in wf.stages if getattr(s, "is_model_selector", False))
    if package == "port":
        sel.to(torch.device("cpu"))
    models = [(e, g) for e, g in sel.models if type(e).__name__ in families]
    v = sel.validator
    got = {}
    for X, y, w, vm in folds:
        s = (JSummary if package == "jax" else PSummary)(
            validation_type="workflow", evaluator_name=v.evaluator.name,
            metric_name=v.evaluator.default_metric, is_larger_better=v.evaluator.is_larger_better)
        if package == "jax":
            with use_mesh(v._resolve_mesh()):
                v._sweep(models, X, y, w, vm, s)
        else:
            v._sweep(models, torch.from_numpy(X), y, w, vm, s)
        for i, r in enumerate(s.results):
            got.setdefault(i, (r.model_name, []))[1].extend(r.fold_metrics)
    with open(os.path.join(FX.WIDE_TEXT, "trains.json")) as fh:
        ref = [r for r in json.load(fh)[kind]["results"] if r[0] in families]
    assert [got[i][0] for i in range(len(ref))] == [r[0] for r in ref]
    gaps = {}
    for i, (name, _, folds_ref) in enumerate(ref):
        g = float(np.abs(np.asarray(got[i][1], np.float64) - np.asarray(folds_ref)).max())
        gaps[name] = max(gaps.get(name, 0.0), g)
    return gaps


def ulp_moves(folds, row):
    """``folds`` with the largest entry of ``row`` in each fold's X moved one
    ulp up."""
    out = []
    for X, y, w, vm in folds:
        X = X.copy()
        j = int(np.argmax(np.abs(X[row])))
        X[row, j] = np.nextafter(X[row, j], np.float32(np.inf))
        out.append((X, y, w, vm))
    return out


def feature_gaps(a, b):
    """[(largest gap over the LDA topics' columns, over the rest)] by fold
    between two packages' fold inputs (the topics are the vector's last
    ``FX.WIDE_LDA_TOPICS`` columns)."""
    t = FX.WIDE_LDA_TOPICS
    return [(float(np.abs(Xa[:, -t:] - Xb[:, -t:]).max()),
             float(np.abs(Xa[:, :-t] - Xb[:, :-t]).max())) for (Xa, *_), (Xb, *_) in zip(a, b)]


def flow_counts():
    """The wide text flows' count matrix of the 891 rows (``Notes``
    tokenized and counted over at most ``FX.WIDE_VOCAB`` terms, the final
    fit's OpLDA input) by the port's stages."""
    import transmogrifai_tpu_torch.types as PTy
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow as PWorkflow

    notes = PFB("Notes", PTy.Text).extract(field="Notes").as_predictor()
    counts = notes.tokenize().count_vectorize(vocab_size=FX.WIDE_VOCAB)
    model = PWorkflow().set_result_features(counts).set_input_dataset(
        PTitanic.text_columns(), key="PassengerId").train(device="cpu")
    return model.train_data[counts.name].tensor("cpu").numpy()


def lda_theta_gaps(X):
    """The topic mixtures of OpLDA at ``FX.WIDE_LDA_TOPICS`` topics fit and
    applied on X (the stage's defaults), largest gaps: the port's plain
    versions against the JAX package's program, and the JAX package's
    program with the vocabulary in each order of ``LDA_ORDER_SEEDS`` against
    itself in its own order."""
    k, alpha, eta, iters, seed = FX.WIDE_LDA_TOPICS, 0.1, 0.01, 20, 42
    stage = JEmb.OpLDA(k=k)
    assert (stage.get_param("alpha"), stage.get_param("eta"), stage.get_param("max_iter"),
            stage.get_param("seed")) == (alpha, eta, iters, seed)

    def theta_jax(lam):
        gamma = np.asarray(JEmb._lda_e_step_jit(jnp.asarray(lam), jnp.asarray(X), alpha, 30)[0],
                           np.float64)
        return gamma / gamma.sum(1, keepdims=True)

    base = theta_jax(jax_lda_topic_word(X, np.arange(X.shape[1]), k, alpha, eta, iters, seed))
    orders = [theta_jax(jax_lda_topic_word(
        X, np.random.default_rng(s).permutation(X.shape[1]), k, alpha, eta, iters, seed))
        for s in LDA_ORDER_SEEDS]
    Xt = torch.from_numpy(X)
    lam = torch.from_numpy(np.random.default_rng(seed).gamma(100.0, 0.01, (k, X.shape[1]))
                           .astype(np.float32))
    for _ in range(iters):                       # the port's OpLDA.fit_columns on the CPU
        eb = E.lda_beta(lam)
        lam = E.lda_sstats(eb, Xt, E.lda_estep(eb, Xt, alpha, 30), eta)
    gamma = E.lda_estep(E.lda_beta(lam), Xt, alpha, 30).numpy().astype(np.float64)
    port = gamma / gamma.sum(1, keepdims=True)
    return {"port": float(np.abs(port - base).max()),
            "jax_orders": [float(np.abs(o - base).max()) for o in orders]}


def embed_witness():
    """Where "embed"'s fold gaps come from (about 40 minutes on the CPU):
    the fold inputs of both packages, and of the JAX package with OpLDA's
    vocabulary in another order; the fold-metric gaps to the fixture of the
    JAX package's sweep on its own, the port's and its reordered inputs, of
    the port's sweep on the JAX package's inputs, and of the JAX package's
    MLP on its inputs with one row's largest entry one ulp up; the topic
    mixtures' gaps of ``lda_theta_gaps`` on the final fit's counts (the
    reordered fold inputs take the first of ``LDA_ORDER_SEEDS``)."""
    fams = ("OpLogisticRegression", "OpRandomForestClassifier", "OpXGBoostClassifier",
            "OpMultilayerPerceptronClassifier")
    jx, pt = fold_inputs("jax"), fold_inputs("port")
    same = fold_inputs("jax", lda_order=True)
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(jx, same))
    reordered = fold_inputs("jax", lda_order=True, order_seed=LDA_ORDER_SEEDS[0])
    out = {"threads": torch.get_num_threads(),
           "feature_gaps": {"port": feature_gaps(pt, jx), "jax_reordered": feature_gaps(
               reordered, jx)},
           "sweep_gaps": {"jax_on_jax": sweep_gaps("jax", jx, fams),
                          "jax_on_port": sweep_gaps("jax", pt, fams),
                          "port_on_jax": sweep_gaps("port", jx, fams),
                          "jax_on_jax_reordered": sweep_gaps("jax", reordered, fams)},
           "mlp_ulp_gaps": {row: sweep_gaps("jax", ulp_moves(jx, row),
                                            ("OpMultilayerPerceptronClassifier",))[
                                                "OpMultilayerPerceptronClassifier"]
                            for row in ULP_ROWS},
           "lda_theta_gaps": lda_theta_gaps(flow_counts())}
    return out


@pytest.mark.slow
def test_embed_lda_topics_move_with_the_sum_order_in_the_reference_too():
    """OpLDA at 100 topics over the flows' 891-row counts (the final fit's):
    ``jax_lda_topic_word`` in the vocabulary's own order is the JAX
    package's stage bit for bit, and the port's topic mixtures lie no farther
    from the JAX package's than the JAX package's own do when only the order
    of its float32 sums over the terms changes (about 100 s at one thread)."""
    from transmogrifai_tpu.columns import VectorColumn as JVectorColumn

    X = flow_counts()
    stage = JEmb.OpLDA(k=FX.WIDE_LDA_TOPICS).fit_columns([JVectorColumn(JTy.OPVector, X)], None)
    np.testing.assert_array_equal(
        jax_lda_topic_word(X, np.arange(X.shape[1]), FX.WIDE_LDA_TOPICS, 0.1, 0.01, 20, 42),
        stage.topic_word)
    gaps = lda_theta_gaps(X)
    assert gaps["port"] <= min(gaps["jax_orders"]), gaps


@pytest.mark.slow
def test_embed_mlp_fold_metrics_move_past_their_tolerance_in_the_reference_itself():
    """The "embed" MLP (128, 64, 32) against ``MLP_AUPR_TOL``: on the JAX
    package's own fold inputs its sweep gives the fixture's fold AuPR
    exactly, one ulp on one entry of one row moves them past
    ``MLP_AUPR_TOL`` (200 Adam steps over 395-404 features diverge from
    about step 100), and the port's MLP on those same inputs stays within
    the largest such move (about 70 s at one thread)."""
    fam = "OpMultilayerPerceptronClassifier"
    jx = fold_inputs("jax")
    assert sweep_gaps("jax", jx, (fam,))[fam] == 0.0
    moves = [sweep_gaps("jax", ulp_moves(jx, row), (fam,))[fam] for row in ULP_ROWS]
    assert max(moves) > FX.MLP_AUPR_TOL, moves
    assert sweep_gaps("port", jx, (fam,))[fam] <= max(moves), moves


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixtures")
    ap.add_argument("--witness", action="store_true",
                    help="print (JSON) where the \"embed\" train's fold gaps come from")
    ap.add_argument("--seed", type=int, default=0, help="seed of the Letter request records")
    args = ap.parse_args()
    if not (args.write or args.witness):
        ap.error("nothing to do: pass --write or --witness")
    if args.write:
        write_fixtures(seed=args.seed)
        print(f"wrote {FX.LETTERS_FAMILIES} and {FX.WIDE_TEXT}")
    if args.witness:
        torch.set_num_threads(WITNESS_THREADS)
        print(json.dumps(embed_witness()), flush=True)
