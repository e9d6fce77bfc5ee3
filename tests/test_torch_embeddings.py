"""K18 of the port against the JAX package, on the CPU: the text stages
(``TextTokenizer``, ``OpCountVectorizer``), Word2Vec's SGNS epoch and fit,
LDA's E-step, fit and scoring, and the port's float32 ``digamma``.

Both packages get the same seeded numpy inputs.  The port's kernel wrappers
take their plain versions here (CPU tensors), which follow the JAX math
densely; the hand-written kernels (K-AA ``sgns_epoch``, K-AB ``lda_beta`` /
``lda_estep`` / ``lda_sstats``) are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Bit-equal: tokens, count vectors and vocabularies, the skip-gram pairs, the
negatives and ``W0`` (the numpy generator's calls in the JAX package's
order), the mean-vector transform for given vectors.  Within tolerances
stated below: the SGNS epoch (float32 sums in another order), the fitted
vectors, the LDA gammas and topic-word matrices (the digamma replica's
1-ulp gaps, iterated).
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma as jax_digamma

import transmogrifai_tpu as J
import transmogrifai_tpu.types as JT
from transmogrifai_tpu.columns import Dataset as JDataset
from transmogrifai_tpu.columns import ObjectColumn as JObjectColumn
from transmogrifai_tpu.columns import VectorColumn as JVectorColumn
from transmogrifai_tpu.impl.feature import embeddings as JEmb
from transmogrifai_tpu.impl.feature import text as JText

import transmogrifai_tpu_torch as P
import transmogrifai_tpu_torch.types as PT
from transmogrifai_tpu_torch.columns import Dataset as PDataset
from transmogrifai_tpu_torch.columns import ObjectColumn as PObjectColumn
from transmogrifai_tpu_torch.columns import VectorColumn as PVectorColumn
from transmogrifai_tpu_torch.impl.feature import embeddings as PEmb
from transmogrifai_tpu_torch.impl.feature import text as PText
from transmogrifai_tpu_torch.ops import embeddings as E

torch.set_num_threads(1)

#: one SGNS epoch: float32 sums of a pair's K + 1 rows and of each row's
#: scattered gradients in another order than XLA's
SGNS_ATOL = 2e-7
#: the fitted word vectors after 30 full-batch epochs (the epoch's gap,
#: carried through the iterations)
W2V_ATOL = 2e-6
#: the E-step's gammas, relative: digamma's 1-ulp gaps and the products'
#: summation order, carried through 30 iterations of a map whose fixed point
#: is unstable for a small topic weight (its slope (gamma - alpha) x
#: trigamma(gamma) is about 2.5 near gamma = 0.25), so a few documents'
#: small gammas move by up to 8.5e-4 (the 891-row text flow's counts, my CPU
#: run); the rest within 1e-6
GAMMA_RTOL = 2e-3
#: the topic-word lambda after the EM steps, relative (the gammas' gaps fed
#: back through the M-steps)
LAMBDA_RTOL = 2e-3
#: the scored topic mixtures
THETA_ATOL = 2e-4


def _docs(n, vocab, seed, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    words = np.array([f"t{i:02d}" for i in range(vocab)])
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(rng.choice(words, rng.integers(lo, hi + 1), p=p)) for _ in range(n)]


def _jcol(values):
    col = JObjectColumn(JT.TextList, np.empty(len(values), dtype=object))
    col.values[:] = values
    return col


def _pcol(values):
    col = PObjectColumn(PT.TextList, np.empty(len(values), dtype=object))
    col.values[:] = values
    return col


def _features(name, jtype, ptype):
    jf = J.FeatureBuilder(name, jtype).extract(field=name).as_predictor()
    pf = P.FeatureBuilder(name, ptype).extract(field=name).as_predictor()
    return jf, pf


# ---------------------------------------------------------------------------
# the text stages
# ---------------------------------------------------------------------------
TEXTS = ["The quick brown fox", None, "", "Ünïcode Straße, and THE end!", "a b c 12 3.5",
         "Le chat et la souris", "x" * 3 + " yy zz yy"]


@pytest.mark.parametrize("opts", [{}, {"min_token_length": 2}, {"filter_stopwords": False},
                                  {"to_lowercase": False}, {"language": "fr"}])
def test_tokenizer_equals_jax(opts):
    jt, pt = JText.TextTokenizer(**opts), PText.TextTokenizer(**opts)
    for text in TEXTS:
        assert pt.tokenize(text) == jt.tokenize(text)
    jf, pf = _features("T", JT.Text, PT.Text)
    jcol = JObjectColumn(JT.Text, np.array(TEXTS, dtype=object))
    pcol = PObjectColumn(PT.Text, np.array(TEXTS, dtype=object))
    jout = jt.set_input(jf).transform_columns([jcol])
    pout = pt.set_input(pf).transform_columns([pcol])
    assert list(pout.values) == list(jout.values)


def test_tokenizer_language_detection_is_not_ported():
    with pytest.raises(NotImplementedError):
        PText.TextTokenizer(auto_detect_language=True).tokenize("bonjour le monde")


@pytest.mark.parametrize("opts", [{}, {"vocab_size": 7}, {"min_df": 3}, {"binary": True}])
def test_count_vectorizer_equals_jax(opts):
    docs = _docs(60, 25, 1) + [[], None]
    jf, pf = _features("T", JT.TextList, PT.TextList)
    jm = JText.OpCountVectorizer(**opts).set_input(jf).fit(JDataset({"T": _jcol(docs)}))
    pm = PText.OpCountVectorizer(**opts).to("cpu").set_input(pf).fit(
        PDataset({"T": _pcol(docs)}))
    assert pm.vocabulary == jm.vocabulary
    jout = jm.transform_columns([_jcol(docs)])
    pout = pm.transform_columns([_pcol(docs)])
    np.testing.assert_array_equal(pout.numpy(), np.asarray(jout.values))
    assert [c.indicator_value for c in pout.metadata.columns] == \
        [c.indicator_value for c in jout.metadata.columns]


def test_dsl_tokenize_and_count_vectorize():
    notes = P.FeatureBuilder("Notes", PT.Text).extract(field="Notes").as_predictor()
    tokens = notes.tokenize(min_token_length=2)
    counts = tokens.count_vectorize(vocab_size=16)
    assert isinstance(tokens.origin_stage, PText.TextTokenizer)
    assert tokens.origin_stage.get_param("min_token_length") == 2
    assert isinstance(counts.origin_stage, PText.OpCountVectorizer)
    assert counts.origin_stage.get_param("vocab_size") == 16


# ---------------------------------------------------------------------------
# digamma
# ---------------------------------------------------------------------------
def test_digamma_replica_gap_to_jax():
    """The port's float32 Lanczos digamma against ``jax.scipy.special.digamma``
    on [0.005, 5000] (both branches of the reflection), and
    ``torch.special.digamma``'s gap for contrast."""
    x = np.geomspace(0.005, 5000, 20001).astype(np.float32)
    x = np.concatenate([x, np.float32([0.01, 0.1, 0.49999997, 0.5, 1.0, 2.0])])
    ref = np.asarray(jax.jit(jax_digamma)(jnp.asarray(x)))
    got = E.digamma(torch.from_numpy(x)).numpy()
    gap = np.abs(got.astype(np.float64) - ref)
    assert gap.max() <= E.DIGAMMA_ATOL, gap.max()
    assert (gap / np.maximum(np.abs(ref), 1.0)).max() <= 5e-7
    assert np.mean(got == ref) > 0.8
    lib = torch.special.digamma(torch.from_numpy(x)).numpy()
    assert np.abs(lib.astype(np.float64) - ref).max() > gap.max()
    # the poles are NaN, as chlo.digamma's
    assert torch.isnan(E.digamma(torch.tensor([0.0, -1.0, -3.0]))).all()


# ---------------------------------------------------------------------------
# Word2Vec
# ---------------------------------------------------------------------------
def _sgns_inputs(seed, V=40, d=8, P_=500, K=5):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((V, d)) / np.sqrt(d)).astype(np.float32)
    C = (rng.standard_normal((V, d)) * 0.1).astype(np.float32)
    pairs = rng.integers(0, V, (P_, 2)).astype(np.int32)
    negs = rng.integers(0, V, (P_, K)).astype(np.int32)
    return W, C, pairs, negs


@pytest.mark.parametrize("seed", [0, 1])
def test_sgns_epoch_plain_matches_jax(seed):
    W, C, pairs, negs = _sgns_inputs(seed)
    (jW, jC), jloss = jax.jit(JEmb._sgns_epoch, static_argnums=3)(
        (jnp.asarray(W), jnp.asarray(C)), jnp.asarray(pairs), jnp.asarray(negs), 0.2)
    pW, pC, ploss = E.sgns_epoch(torch.from_numpy(W), torch.from_numpy(C),
                                 torch.from_numpy(pairs), torch.from_numpy(negs), 0.2)
    np.testing.assert_allclose(pW.numpy(), np.asarray(jW), rtol=0, atol=SGNS_ATOL)
    np.testing.assert_allclose(pC.numpy(), np.asarray(jC), rtol=0, atol=SGNS_ATOL)
    assert abs(float(ploss) - float(jloss)) <= 1e-6


def test_sgns_lists_cover_every_pair_and_slot():
    """K-AA's index lists: every pair once under its centre, every (pair,
    slot) entry once under its output word, segments of at most
    ``SGNS_SEGMENT`` in pair order."""
    _, _, pairs, negs = _sgns_inputs(2, V=12, P_=900, K=3)
    L = E.sgns_lists(torch.from_numpy(pairs), torch.from_numpy(negs), 12)
    wp = L.w_pairs.numpy()
    assert sorted(wp.tolist()) == list(range(900))
    out = np.concatenate([pairs[:, 1:2], negs], 1).reshape(-1)
    ce = L.c_entries.numpy()
    assert sorted(ce.tolist()) == list(range(900 * 4))
    rows, lo, hi, first = (L.seg_row.numpy(), L.seg_lo.numpy(), L.seg_hi.numpy(),
                           L.row_seg.numpy())
    assert np.all(hi - lo <= E.SGNS_SEGMENT) and np.all(hi > lo)
    for r in range(24):
        segs = range(first[r], first[r + 1])
        assert all(rows[s] == r for s in segs)
        ent = np.concatenate([np.arange(lo[s], hi[s]) for s in segs]) if len(segs) else []
        if r < 12:
            assert np.all(pairs[wp[ent], 0] == r) and np.all(np.diff(wp[ent]) > 0)
            assert len(ent) == np.sum(pairs[:, 0] == r)
        else:
            assert np.all(out[ce[ent]] == r - 12) and np.all(np.diff(ce[ent]) > 0)
            assert len(ent) == np.sum(out == r - 12)


def _jax_w2v_fit(docs, **kw):
    """The JAX package's fit, with the arguments of its jitted train
    (W0, C0, pairs, negs) recorded."""
    seen = {}
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)

        def call(*args):
            if fn.__name__ == "train":
                seen["args"] = [np.asarray(x) for x in args]
            return jitted(*args)
        return call

    jf = J.FeatureBuilder("T", JT.TextList).extract(field="T").as_predictor()
    est = JEmb.OpWord2Vec(**kw).set_input(jf)
    with mock.patch.object(jax, "jit", recording_jit):
        model = est.fit(JDataset({"T": _jcol(docs)}))
    return model, seen.get("args")


def _port_w2v_fit(docs, **kw):
    seen = {}
    train = PEmb.OpWord2Vec.train

    def recording(self, W0, pairs, negs, device):
        seen["args"] = [W0, pairs, negs]
        return train(self, W0, pairs, negs, device)

    pf = P.FeatureBuilder("T", PT.TextList).extract(field="T").as_predictor()
    est = PEmb.OpWord2Vec(**kw).to("cpu").set_input(pf)
    with mock.patch.object(PEmb.OpWord2Vec, "train", recording):
        model = est.fit(PDataset({"T": _pcol(docs)}))
    return model, seen.get("args")


@pytest.mark.parametrize("max_pairs", [200_000, 600])
def test_word2vec_fit_matches_jax(max_pairs):
    """A whole fit at 64 documents and vector_size 8, below and above
    ``max_pairs`` (the subsample branch): vocabulary, pairs, negatives and
    W0 bit-equal; the vectors within ``W2V_ATOL``; the transform of the
    fitted vectors bit-equal for the same vectors."""
    docs = _docs(64, 30, 3) + [[], None, ["t00"], ["unseen", "t01"]]
    kw = dict(vector_size=8, max_pairs=max_pairs)
    jm, jargs = _jax_w2v_fit(docs, **kw)
    pm, pargs = _port_w2v_fit(docs, **kw)
    assert pm.vocabulary == jm.vocabulary
    W0, _, jpairs, jnegs = jargs
    np.testing.assert_array_equal(pargs[0], W0)
    np.testing.assert_array_equal(pargs[1], jpairs)
    np.testing.assert_array_equal(pargs[2], jnegs)
    assert pargs[1].dtype == np.int32 and pargs[2].dtype == np.int32
    index = {t: i for i, t in enumerate(jm.vocabulary)}
    all_pairs = PEmb.skipgram_pairs(*PEmb._token_ids([d or [] for d in docs], index), 5)
    assert jpairs.shape[0] == min(max_pairs, len(all_pairs)) and len(all_pairs) > 600
    np.testing.assert_allclose(pm.vectors, jm.vectors, rtol=0, atol=W2V_ATOL)
    assert abs(pm.metadata["final_loss"] - jm.metadata["final_loss"]) <= 1e-5
    # the transform: the port's model on the JAX package's vectors
    pm.vectors = jm.vectors
    got = pm.transform_columns([_pcol(docs)]).numpy()
    want = np.asarray(jm.transform_columns([_jcol(docs)]).values)
    np.testing.assert_array_equal(got, want)


def test_skipgram_pairs_equal_the_loop():
    rng = np.random.default_rng(5)
    docs = [list(rng.integers(0, 9, rng.integers(0, 14))) for _ in range(40)]
    for window in (1, 2, 5):
        ref = [(c, ids[j]) for ids in docs for i, c in enumerate(ids)
               for j in range(max(0, i - window), min(len(ids), i + window + 1)) if j != i]
        ids = np.array([t for d in docs for t in d], dtype=np.int64)
        offsets = np.cumsum([0] + [len(d) for d in docs])
        got = PEmb.skipgram_pairs(ids, offsets, window)
        np.testing.assert_array_equal(got, np.asarray(ref, dtype=np.int32).reshape(-1, 2))


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------
def _counts(n, v, seed):
    rng = np.random.default_rng(seed)
    X = rng.poisson(0.3, (n, v)).astype(np.float32)
    X[3] = 0.0                                   # an empty document
    return X


def test_lda_e_step_plain_matches_jax():
    X = _counts(48, 30, 7)
    lam = np.random.default_rng(8).gamma(2.0, 1.0, (6, 30)).astype(np.float32)
    jg, jeb = JEmb._lda_e_step_jit(jnp.asarray(lam), jnp.asarray(X), 0.1, 30)
    eb = E.lda_beta(torch.from_numpy(lam))
    np.testing.assert_allclose(eb.numpy(), np.asarray(jeb), rtol=2e-6, atol=0)
    g = E.lda_estep(eb, torch.from_numpy(X), 0.1, 30)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=GAMMA_RTOL, atol=0)
    np.testing.assert_array_equal(g.numpy()[3], np.full(6, 0.1, np.float32))


def _lda_fit(pkg, X, **kw):
    if pkg == "jax":
        jf = J.FeatureBuilder("X", JT.OPVector).extract(field="X").as_predictor()
        return JEmb.OpLDA(**kw).set_input(jf).fit(JDataset({"X": JVectorColumn(JT.OPVector, X)}))
    pf = P.FeatureBuilder("X", PT.OPVector).extract(field="X").as_predictor()
    return PEmb.OpLDA(**kw).to("cpu").set_input(pf).fit(
        PDataset({"X": PVectorColumn(PT.OPVector, X)}))


def test_lda_fit_and_transform_match_jax():
    """An OpLDA fit at max_iter 5 (k 4 over 30 terms), its topic-word matrix
    within ``LAMBDA_RTOL``; the scored topic mixtures of held-out rows within
    ``THETA_ATOL``, by the port's model and by the JAX package's matrix."""
    X, Xh = _counts(64, 30, 9), _counts(20, 30, 10)
    jm = _lda_fit("jax", X, k=4, max_iter=5)
    pm = _lda_fit("port", X, k=4, max_iter=5)
    np.testing.assert_allclose(pm.topic_word, jm.topic_word, rtol=LAMBDA_RTOL, atol=0)
    jt = np.asarray(jm.transform_columns([JVectorColumn(JT.OPVector, Xh)]).values)
    pt = pm.transform_columns([PVectorColumn(PT.OPVector, Xh)]).numpy()
    np.testing.assert_allclose(pt, jt, rtol=0, atol=THETA_ATOL)
    pm.topic_word = jm.topic_word
    pt = pm.transform_columns([PVectorColumn(PT.OPVector, Xh)]).numpy()
    np.testing.assert_allclose(pt, jt, rtol=0, atol=THETA_ATOL)
    np.testing.assert_allclose(pt.sum(1), 1.0, atol=1e-6)


def _jax_m_step(lam, X, gamma, eta):
    """The M-step lines of the JAX package's ``OpLDA.fit_columns`` ``em``
    program (``embeddings.py:208-211``) at a given gamma."""
    exp_beta = jnp.exp(jax_digamma(lam) - jax_digamma(lam.sum(axis=1, keepdims=True)))
    exp_theta = jnp.exp(jax_digamma(gamma) - jax_digamma(gamma.sum(axis=1, keepdims=True)))
    phi_norm = exp_theta @ exp_beta + 1e-100
    return eta + exp_beta * (exp_theta.T @ (X / phi_norm))


def test_lda_m_step_plain_matches_jax():
    X = _counts(40, 25, 14)
    lam = np.random.default_rng(15).gamma(2.0, 1.0, (5, 25)).astype(np.float32)
    gamma = np.random.default_rng(16).gamma(2.0, 1.0, (40, 5)).astype(np.float32) + 0.1
    want = np.asarray(jax.jit(_jax_m_step)(jnp.asarray(lam), jnp.asarray(X),
                                           jnp.asarray(gamma), 0.01))
    got = E.lda_sstats(E.lda_beta(torch.from_numpy(lam)), torch.from_numpy(X),
                       torch.from_numpy(gamma), 0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_lda_zero_phi_norm_gives_nan_as_jax():
    """A term whose lambda is eta in every topic has exp_beta 0 (exp(-108)
    underflows) and phi_norm 0 in every document: the JAX package's dense
    0/0 makes every gamma NaN, and the M-step's lambda NaN in that term's
    column (everywhere once the gammas are NaN).  A count matrix with an
    all-zero column reaches it within a fit.  The port's plain versions do
    the same (the kernels are held to them on the card).  At the text
    flow's settings the case does not arise: every count vectorizer term
    occurs in the rows its LDA fits on, and no held-out row scored NaN."""
    X = _counts(16, 12, 11)
    lam = np.random.default_rng(12).gamma(2.0, 1.0, (3, 12)).astype(np.float32) * 100
    lam[:, 5] = 0.01
    jg, jeb = JEmb._lda_e_step_jit(jnp.asarray(lam), jnp.asarray(X), 0.1, 30)
    assert np.asarray(jeb)[:, 5].max() == 0.0 and np.isnan(np.asarray(jg)).all()
    eb = E.lda_beta(torch.from_numpy(lam))
    assert eb[:, 5].max() == 0.0
    assert torch.isnan(E.lda_estep(eb, torch.from_numpy(X), 0.1, 30)).all()
    gamma = np.ones((16, 3), np.float32)
    want = np.asarray(jax.jit(_jax_m_step)(jnp.asarray(lam), jnp.asarray(X),
                                           jnp.asarray(gamma), 0.01))
    got = E.lda_sstats(eb, torch.from_numpy(X), torch.from_numpy(gamma), 0.01).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[:, 5]).all() and not np.isnan(np.delete(want, 5, 1)).any()
    # a fit over a count matrix with an empty term: NaN in both packages
    X[:, 5] = 0.0
    jm = _lda_fit("jax", X, k=3, max_iter=3)
    pm = _lda_fit("port", X, k=3, max_iter=3)
    assert np.isnan(jm.topic_word).all() and np.isnan(pm.topic_word).all()
    # without the dead term, nothing is NaN
    keep = [j for j in range(12) if j != 5]
    eb2 = E.lda_beta(torch.from_numpy(lam[:, keep].copy()))
    assert torch.isfinite(E.lda_estep(eb2, torch.from_numpy(X[:, keep].copy()), 0.1, 30)).all()


def test_lda_docs_lists_the_nonzeros():
    X = torch.from_numpy(_counts(10, 7, 13))
    docs = E.lda_docs(X)
    dense = torch.zeros_like(X)
    off = docs.offsets.tolist()
    for i in range(10):
        dense[i, docs.terms[off[i]:off[i + 1]].long()] = docs.counts[off[i]:off[i + 1]]
    assert torch.equal(dense, X)


def test_wrappers_check_shapes():
    W, C, pairs, negs = (torch.from_numpy(a) for a in _sgns_inputs(0))
    with pytest.raises(ValueError):
        E.sgns_epoch(W, C[:3], pairs, negs, 0.1)
    with pytest.raises(ValueError):
        E.sgns_epoch(W, C, pairs.long(), negs, 0.1)
    with pytest.raises(ValueError):
        E.lda_estep(torch.ones(3, 5), torch.ones(4, 6), 0.1, 3)
    with pytest.raises(ValueError):
        E.lda_sstats(torch.ones(3, 5), torch.ones(4, 5), torch.ones(4, 2), 0.01)
