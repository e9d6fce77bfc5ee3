"""Text embeddings: Word2Vec and LDA, fitted on the stage's device.

The port's counterpart of ``transmogrifai_tpu/impl/feature/embeddings.py``
(reference OpWord2Vec.scala:41, OpLDA.scala:41):

- ``OpWord2Vec``: TextList -> OPVector, the mean of the tokens' learned word
  vectors.  The fit builds the vocabulary (count >= ``min_count``, ordered
  by (-count, token)), the skip-gram pairs of every document (each token
  with its neighbours within ``window``, in document, position, neighbour
  order: the JAX package's int32 array bit for bit), a subsample of
  ``max_pairs`` of them when there are more, ``num_negatives`` negatives a
  pair from the unigram^0.75 distribution, and ``W0`` (the numpy generator's
  calls in the JAX package's order), then ``epochs`` full-batch SGNS epochs
  (``ops/embeddings.sgns_epoch``: K-AA on the card).
- ``OpLDA``: OPVector term counts -> OPVector topic mixture by online
  variational Bayes, ``max_iter`` EM steps from ``lam0 ~ Gamma(100,
  0.01)``, each K-AB's beta, estep (30 iterations) and sstats (the M-step)
  on the card; ``OpLDAModel`` scores by one beta and one estep.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from ... import types as T
from ...columns import Column, Dataset, ObjectColumn, VectorColumn
from ...features.metadata import VectorColumnMetadata
from ...ops import embeddings as E
from ...stages.base import Model, UnaryEstimator
from ._util import finalize_vector, stage_device

#: the E-step's fixed iteration count (``_lda_e_step``'s ``n_iter``)
LDA_E_STEPS = 30


def _token_ids(docs: Sequence[Sequence[str]], index: dict):
    """(ids i64[N], doc offsets i64[n + 1]) of the in-vocabulary tokens of
    each document, in document and token order."""
    lens = np.zeros(len(docs) + 1, dtype=np.int64)
    ids: List[int] = []
    for i, doc in enumerate(docs):
        before = len(ids)
        ids.extend(index[t] for t in doc if t in index)
        lens[i + 1] = len(ids) - before
    return np.asarray(ids, dtype=np.int64), np.cumsum(lens)


def skipgram_pairs(ids: np.ndarray, offsets: np.ndarray, window: int) -> np.ndarray:
    """The skip-gram pairs i32[P, 2] (centre, context) of the documents'
    token ids: each token with every other token of its document within
    ``window`` positions, in (document, position, neighbour position) order
    -- the JAX package's Python loop (``embeddings.py:83-89``), vectorized."""
    n_tok = ids.size
    if n_tok == 0:
        return np.zeros((0, 2), dtype=np.int32)
    doc = np.repeat(np.arange(offsets.size - 1), np.diff(offsets))
    start, end = offsets[:-1][doc], offsets[1:][doc]
    pos = np.arange(n_tok)
    deltas = np.array([d for d in range(-window, window + 1) if d != 0], dtype=np.int64)
    other = pos[:, None] + deltas[None, :]                                # [N, 2w]
    valid = (other >= start[:, None]) & (other < end[:, None])
    centre, slot = np.nonzero(valid)                                      # row-major order
    return np.stack([ids[centre], ids[other[centre, slot]]], axis=1).astype(np.int32)


class OpWord2Vec(UnaryEstimator):
    """TextList -> OPVector document embedding (mean of word vectors)
    (OpWord2Vec.scala:41)."""

    def __init__(self, vector_size: int = 64, min_count: int = 2, window: int = 5,
                 num_negatives: int = 5, epochs: int = 30, learning_rate: float = 0.2,
                 max_pairs: int = 200_000, seed: int = 42, uid: Optional[str] = None):
        super().__init__(operation_name="w2v", input_type=T.TextList,
                         output_type=T.OPVector, uid=uid,
                         vector_size=vector_size, min_count=min_count, window=window,
                         num_negatives=num_negatives, epochs=epochs,
                         learning_rate=learning_rate, max_pairs=max_pairs, seed=seed)

    def _model(self, vocab: List[str], vectors: np.ndarray) -> "OpWord2VecModel":
        return OpWord2VecModel(vocabulary=vocab, vectors=vectors,
                               operation_name=self.operation_name,
                               output_type=self.output_type)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "OpWord2VecModel":
        col = cols[0]
        assert isinstance(col, ObjectColumn)
        docs = [list(toks or []) for toks in col.values]
        counts = Counter(t for d in docs for t in d)
        vocab = [t for t, c in sorted(counts.items(), key=lambda tc: (-tc[1], tc[0]))
                 if c >= int(self.get_param("min_count"))]
        d = int(self.get_param("vector_size"))
        if not vocab:
            return self._model([], np.zeros((0, d), np.float32))
        rng = np.random.default_rng(int(self.get_param("seed")))
        pairs = skipgram_pairs(*_token_ids(docs, {t: i for i, t in enumerate(vocab)}),
                               int(self.get_param("window")))
        if pairs.shape[0] == 0:
            return self._model(vocab, np.zeros((len(vocab), d), np.float32))
        max_pairs = int(self.get_param("max_pairs"))
        if pairs.shape[0] > max_pairs:
            pairs = pairs[rng.choice(pairs.shape[0], max_pairs, replace=False)]
        V, K = len(vocab), int(self.get_param("num_negatives"))
        # unigram^0.75 negative-sampling distribution (word2vec's choice)
        freq = np.array([counts[t] for t in vocab], dtype=np.float64) ** 0.75
        freq /= freq.sum()
        negs = rng.choice(V, size=(pairs.shape[0], K), p=freq).astype(np.int32)
        W0 = (rng.standard_normal((V, d)) / np.sqrt(d)).astype(np.float32)
        W, loss = self.train(W0, pairs, negs, stage_device(self))
        self.metadata["final_loss"] = loss
        return self._model(vocab, W)

    def train(self, W0: np.ndarray, pairs: np.ndarray, negs: np.ndarray, device
              ) -> tuple:
        """(W f32[V, d] after ``epochs`` SGNS epochs from ``W0`` and C = 0,
        the last epoch's loss) on ``device``; on the card the index lists
        are built once and the epochs alternate between two buffer pairs
        (the plain version returns new tensors)."""
        lr = float(self.get_param("learning_rate"))
        epochs = int(self.get_param("epochs"))
        W = torch.from_numpy(W0).to(device)
        C = torch.zeros_like(W)
        p = torch.from_numpy(pairs).to(device)
        ng = torch.from_numpy(negs).to(device)
        lists = E.sgns_lists(p, ng, W.shape[0]) if device.type == "cuda" else None
        spare, loss = (torch.empty_like(W), torch.empty_like(C)), None
        for e in range(epochs):
            W2, C2, loss = E.sgns_epoch(W, C, p, ng, lr, lists=lists, out=spare,
                                        want_loss=e == epochs - 1)
            spare, (W, C) = (W, C), (W2, C2)
        return W.cpu().numpy(), (float("nan") if loss is None else float(loss))


class OpWord2VecModel(Model):
    def __init__(self, vocabulary: List[str], vectors: np.ndarray,
                 operation_name: str = "w2v", output_type=T.OPVector,
                 uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.vocabulary = list(vocabulary)
        self.vectors = np.asarray(vectors, dtype=np.float32)

    @property
    def _index(self) -> dict:
        # cached vocab index keyed by list identity (a swapped vocabulary
        # invalidates it), as the JAX package keeps it
        if getattr(self, "_index_cache_src", None) is not self.vocabulary:
            self._index_cache = {t: i for i, t in enumerate(self.vocabulary)}
            self._index_cache_src = self.vocabulary
        return self._index_cache

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        """Each row's mean word vector (zeros without a known token): the JAX
        package's per-row ``vectors[ids].mean(axis=0)``: float32 sums in
        token order, divided by the count in float64."""
        col = cols[0]
        assert isinstance(col, ObjectColumn)
        n = len(col)
        d = self.vectors.shape[1] if self.vectors.size else 0
        out = np.zeros((n, d), dtype=np.float32)
        ids, offsets = _token_ids([toks or () for toks in col.values], self._index)
        lens = np.diff(offsets)
        if ids.size and d:
            # token by token across all rows: numpy's sequential float32 sum
            # of vectors[ids] (np.add.reduceat would sum pairwise)
            sums = np.zeros((n, d), dtype=np.float32)
            for j in range(int(lens.max())):
                rows = np.nonzero(lens > j)[0]
                sums[rows] += self.vectors[ids[offsets[rows] + j]]
            has = lens > 0
            # numpy's mean divides by the integer count in float64, rounds once
            out[has] = sums[has] / lens[has].astype(np.float64)[:, None]
        f = self.inputs[0]
        meta = [VectorColumnMetadata((f.name,), (f.ftype.__name__,),
                                     descriptor_value=f"w2v_{j}") for j in range(d)]
        return finalize_vector(self, [out], meta, n)


class OpLDA(UnaryEstimator):
    """OPVector term counts -> OPVector topic distribution (OpLDA.scala:41)."""

    def __init__(self, k: int = 10, alpha: float = 0.1, eta: float = 0.01,
                 max_iter: int = 20, seed: int = 42, uid: Optional[str] = None):
        super().__init__(operation_name="lda", input_type=T.OPVector,
                         output_type=T.OPVector, uid=uid, k=k, alpha=alpha, eta=eta,
                         max_iter=max_iter, seed=seed)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "OpLDAModel":
        col = cols[0]
        assert isinstance(col, VectorColumn)
        device = stage_device(self)
        X = torch.clamp_min(col.tensor(device), 0.0)
        n, v = X.shape
        k = int(self.get_param("k"))
        alpha = float(self.get_param("alpha"))
        eta = float(self.get_param("eta"))
        rng = np.random.default_rng(int(self.get_param("seed")))
        lam = torch.from_numpy(rng.gamma(100.0, 0.01, size=(k, v)).astype(np.float32)).to(device)
        docs = E.lda_docs(X) if device.type == "cuda" else None
        for _ in range(int(self.get_param("max_iter"))):
            exp_beta = E.lda_beta(lam)
            gamma = E.lda_estep(exp_beta, X, alpha, LDA_E_STEPS, docs=docs)
            lam = E.lda_sstats(exp_beta, X, gamma, eta, docs=docs)
        return OpLDAModel(topic_word=lam.cpu().numpy(), alpha=alpha,
                          operation_name=self.operation_name, output_type=self.output_type)


class OpLDAModel(Model):
    def __init__(self, topic_word: np.ndarray, alpha: float = 0.1,
                 operation_name: str = "lda", output_type=T.OPVector,
                 uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.topic_word = np.asarray(topic_word, dtype=np.float32)
        self.alpha = float(alpha)

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        """Each row's topic mixture gamma / sum(gamma) after one E-step (the
        normalisation in float64 on the host, as the JAX package's)."""
        col = cols[0]
        assert isinstance(col, VectorColumn)
        device = stage_device(self)
        X = torch.clamp_min(col.tensor(device), 0.0)
        exp_beta = E.lda_beta(torch.from_numpy(self.topic_word).to(device))
        gamma = E.lda_estep(exp_beta, X, self.alpha, LDA_E_STEPS)
        gamma = gamma.cpu().numpy().astype(np.float64)
        theta = (gamma / gamma.sum(axis=1, keepdims=True)).astype(np.float32)
        f = self.inputs[0]
        meta = [VectorColumnMetadata((f.name,), (f.ftype.__name__,),
                                     descriptor_value=f"topic_{j}")
                for j in range(theta.shape[1])]
        return finalize_vector(self, [theta], meta, theta.shape[0])
