"""The text embeddings' device programs: one Word2Vec SGNS epoch and the LDA
variational steps, with the port's float32 ``digamma``.

The port's counterpart of ``transmogrifai_tpu/impl/feature/embeddings.py``'s
``_sgns_epoch`` (``:37``, run by the ``lax.scan`` of
``OpWord2Vec.fit_columns``), ``_lda_e_step`` (``:160``, jitted at ``:181``,
``OpLDAModel.transform_columns``) and the M-step of ``OpLDA.fit_columns``'s
``em`` program (``:204-215``).  The JAX package writes them densely for the
TPU: a gather of every pair's rows and an autodiff scatter for SGNS, and
[n, v] x [v, k] products over the whole count matrix for LDA.  Two
hand-written CUDA kernels replace them:

- K-AA ``sgns_epoch`` (``csrc/sgns.cu``): one full-batch epoch from index
  lists built once a fit (``sgns_lists``): the pairs grouped by centre word
  (for the gradient of ``W``) and the (pair, slot) entries grouped by
  output word (slot 0 the context, 1..K the negatives; for ``C``), each
  list cut into segments of at most ``SGNS_SEGMENT`` entries.  A warp a
  segment scores its entries and sums coefficient x partner row (past 256
  dimensions, up to ``SGNS_MAX_DIM`` = 1,024, in slabs of 256 values); a warp
  a vocabulary row sums its segments in order and writes ``row - lr * grad``
  into the other buffer of a pair.  Two launches an epoch (a third for the
  loss, when asked), no atomics: runs repeat bit for bit.
- K-AB, three modes (``csrc/lda.cu``): ``lda_beta`` (``exp(digamma(lam) -
  digamma(sum_w lam))``), ``lda_estep`` (gamma after ``n_iter`` fixed-point
  iterations in one launch, over each document's nonzero counts only; past
  32 topics, up to ``LDA_MAX_TOPICS`` = 256, the topics across a warp's
  lanes) and ``lda_sstats`` (the M-step's ``eta + exp_beta * (exp_theta^T
  (X / phi_norm))`` over nonzeros: each nonzero's ``x / phi``, fixed-order
  sums over segments of each term's nonzeros, a fixed-order merge).
  ``exp_beta`` is bounded by the card's memory alone.  The documents'
  nonzero lists, by document and by term, are built once a fit or a score
  (``lda_docs``).

The plain versions (``*_plain``) follow the JAX math densely and run for CPU
tensors; a CUDA tensor launches the kernel or raises ``KernelError``.  Past
their bounds both devices raise one ``ValueError``.  Each wrapper counts its
launches in ``<wrapper>.launches``.

``digamma`` is ``chlo.digamma``'s Lanczos form (g = 7, nine coefficients,
Euler's reflection below 0.5), the lowering of ``jax.scipy.special.digamma``,
in float32 with every operation rounded once; the kernels evaluate the same
sequence.  ``torch.special.digamma`` differs from the JAX package's by up to
4.6e-5 on [0.005, 5000]; this replica by at most ``DIGAMMA_ATOL``.

The zero ``phi_norm``: the JAX package adds 1e-100 to ``phi_norm``, which is
0 in float32, so where ``exp_theta @ exp_beta`` underflows to 0 the dense
``X / phi_norm`` is 0/0 (a term the document lacks) or x/0, and the
document's gamma turns NaN (in the M-step, the new lambda's column of that
term; a NaN gamma makes the whole new lambda NaN).  The kernels read only
nonzero counts, so they look for a zero ``phi_norm`` over the whole
vocabulary themselves (a cheap bound first: ``min_t exp_theta * min_w max_t
exp_beta``) and write NaN where the dense form does.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build
from .linear import _sigmoid

# ---------------------------------------------------------------------------
# digamma: chlo.digamma's Lanczos approximation in float32
# ---------------------------------------------------------------------------
LANCZOS_G = 7.0
LANCZOS_BASE = 0.99999999999980993227684700473478
LANCZOS_COEFFS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
                  771.3234287776530788486528258894, -176.61502916214059906584551354,
                  12.507343278686904814458936853, -0.13857109526572011689554707,
                  9.984369578019570859563e-6, 1.50563273514931155834e-7)
#: the largest gap of ``digamma`` to ``jax.scipy.special.digamma`` on a
#: grid of [0.005, 5000] (tests/test_torch_embeddings.py)
DIGAMMA_ATOL = 2e-5


def digamma(x: torch.Tensor) -> torch.Tensor:
    """``chlo.digamma`` in float32: ``log(t) + b / a - g / t`` with the
    Lanczos sums ``a``, ``b`` at ``z`` (``-x`` below 0.5, else ``x - 1``),
    ``t = g + 1/2 + z``, ``log(t) = log(g + 1/2) + log1p(z / (g + 1/2))``;
    below 0.5 Euler's reflection ``- pi cos(pi r) / sin(pi r)`` with ``r``
    reduced to [-0.5, 0.5]; NaN at the poles (integers <= 0)."""
    f = lambda c: torch.tensor(c, dtype=torch.float32, device=x.device)  # noqa: E731
    x = x.to(torch.float32)
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1.0)
    a = f(LANCZOS_BASE).expand_as(z)
    b = torch.zeros_like(z)
    for i, c in enumerate(LANCZOS_COEFFS):
        dz = z + f(i + 1.0)
        b = b - f(c) / (dz * dz)
        a = a + f(c) / dz
    t = f(LANCZOS_G + 0.5) + z
    log_t = f(math.log(LANCZOS_G + 0.5)) + torch.log1p(z / f(LANCZOS_G + 0.5))
    out = (log_t + b / a) - f(LANCZOS_G) / t
    r = x + torch.abs(torch.floor(x + 0.5))
    pr = f(math.pi) * r
    out = torch.where(reflect, out - (f(math.pi) * torch.cos(pr)) / torch.sin(pr), out)
    pole = (x <= 0.0) & (x == torch.floor(x))
    return torch.where(pole, torch.full_like(x, float("nan")), out)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------------
# K-AA sgns_epoch
# ---------------------------------------------------------------------------
#: the most entries a warp of K-AA sums (a vocabulary row's list is cut into
#: segments of this length, so the Zipf head's long lists spread over warps)
SGNS_SEGMENT = 128
#: the widest embedding K-AA takes (four slabs of 256 values)
SGNS_MAX_DIM = 1024
#: pairs a block of the plain version gathers at once on the host
SGNS_PLAIN_BLOCK = 4096


class SgnsLists(NamedTuple):
    """The index lists of one fit's pairs and negatives (``sgns_lists``):
    ``w_pairs`` i32[P], the pairs sorted by centre word (stable);
    ``c_entries`` i32[P * (K + 1)], the (pair, slot) entries ``p * (K + 1)
    + slot`` sorted by output word (stable); ``seg_row`` i32[S] each
    segment's row (``0..V-1`` a row of ``W``, ``V..2V-1`` of ``C``),
    ``seg_lo`` / ``seg_hi`` i32[S] its entry range in its list;
    ``row_seg`` i32[2V + 1] each row's first segment."""

    w_pairs: torch.Tensor
    c_entries: torch.Tensor
    seg_row: torch.Tensor
    seg_lo: torch.Tensor
    seg_hi: torch.Tensor
    row_seg: torch.Tensor


def _segments(keys: torch.Tensor, n_rows: int, row0: int, length: int = SGNS_SEGMENT):
    """(segment rows, lo, hi, per-row segment counts) of a list sorted by
    ``keys`` (i64, values in [0, n_rows)), segments of ``length``."""
    counts = torch.bincount(keys.long(), minlength=n_rows)
    starts = torch.cumsum(counts, 0) - counts
    nseg = (counts + length - 1) // length
    rows = torch.repeat_interleave(torch.arange(n_rows, device=keys.device), nseg)
    first = torch.cumsum(nseg, 0) - nseg
    k = torch.arange(rows.numel(), device=keys.device) - first[rows]
    lo = starts[rows] + k * length
    hi = torch.minimum(lo + length, starts[rows] + counts[rows])
    return rows + row0, lo, hi, nseg


def sgns_lists(pairs: torch.Tensor, negs: torch.Tensor, V: int) -> SgnsLists:
    """K-AA's index lists for the pairs i32[P, 2] and negatives i32[P, K] of
    a fit over ``V`` words, built on their device once a fit (stable sorts,
    so each list keeps pair order)."""
    P, K = negs.shape
    centre = pairs[:, 0].long()
    out = torch.cat([pairs[:, 1:2], negs], 1).reshape(-1).long()   # [P * (K + 1)]
    w_pairs = torch.sort(centre, stable=True).indices
    c_entries = torch.sort(out, stable=True).indices
    wr, wlo, whi, wn = _segments(centre[w_pairs], V, 0)
    cr, clo, chi, cn = _segments(out[c_entries], V, V)
    nseg = torch.cat([wn, cn])
    row_seg = torch.cat([torch.zeros(1, dtype=torch.long, device=pairs.device),
                         torch.cumsum(nseg, 0)])
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    return SgnsLists(i32(w_pairs), i32(c_entries), i32(torch.cat([wr, cr])),
                     i32(torch.cat([wlo, clo])), i32(torch.cat([whi, chi])), i32(row_seg))


def _check_sgns(W, C, pairs, negs):
    if W.dtype != torch.float32 or W.ndim != 2 or C.dtype != torch.float32 \
            or tuple(C.shape) != tuple(W.shape):
        raise ValueError("W and C must be float32[V, d] of one shape")
    if pairs.dtype != torch.int32 or pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError("pairs must be int32[P, 2]")
    if negs.dtype != torch.int32 or negs.ndim != 2 or negs.shape[0] != pairs.shape[0]:
        raise ValueError(f"negs must be int32[{pairs.shape[0]}, K]")


def sgns_epoch_plain(W: torch.Tensor, C: torch.Tensor, pairs: torch.Tensor,
                     negs: torch.Tensor, lr: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K-AA, ``_sgns_epoch`` densely: the pairs'
    rows gathered, the scores, the loss ``mean(softplus(-pos) +
    sum_k softplus(neg_k))`` and its gradients scattered back
    (``index_add_``); on the host a block of ``SGNS_PLAIN_BLOCK`` pairs at
    a time (the pairs' [block, K, d] rows stay in cache; the scatter keeps
    pair order).  Returns (W - lr dW, C - lr dC, loss)."""
    P, d = pairs.shape[0], W.shape[1]
    gW, gC = torch.zeros_like(W), torch.zeros_like(C)
    losses = []
    block = max(P, 1) if W.is_cuda else SGNS_PLAIN_BLOCK
    for p0 in range(0, P, block):
        c = pairs[p0:p0 + block, 0].long()
        o = pairs[p0:p0 + block, 1].long()
        ng = negs[p0:p0 + block].long()
        wc, co, cn = W[c], C[o], C[ng]                                 # [B,d], [B,d], [B,K,d]
        pos = (wc * co).sum(1)
        neg = (wc[:, None, :] * cn).sum(2)
        losses.append(_softplus(-pos) + _softplus(neg).sum(1))
        gpos = -_sigmoid(-pos) / P                                     # d loss / d pos
        gneg = _sigmoid(neg) / P                                       # d loss / d neg
        gW.index_add_(0, c, gpos[:, None] * co + (gneg[..., None] * cn).sum(1))
        gC.index_add_(0, o, gpos[:, None] * wc)
        gC.index_add_(0, ng.reshape(-1), (gneg[..., None] * wc[:, None, :]).reshape(-1, d))
    return W - lr * gW, C - lr * gC, torch.cat(losses).mean()


_SGNS_SIGNATURES = {
    "sgns_epoch": ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_void_p], ctypes.c_int),
    "sgns_loss": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
}


def sgns_epoch(W: torch.Tensor, C: torch.Tensor, pairs: torch.Tensor, negs: torch.Tensor,
               lr: float, lists: Optional[SgnsLists] = None, out=None, want_loss: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One full-batch SGNS epoch: (W', C', the loss at the old parameters)
    for the input and output embeddings ``W``, ``C`` f32[V, d], the pairs
    i32[P, 2] (centre, context) and negatives i32[P, K], learning rate
    ``lr``.  On the card ``lists`` (``sgns_lists``, built if None) and
    ``out`` (a pair of f32[V, d] buffers for W', C') may be passed; the loss
    is computed only with ``want_loss``.  At most ``SGNS_MAX_DIM``
    dimensions."""
    _check_sgns(W, C, pairs, negs)
    V, d = W.shape
    if d > SGNS_MAX_DIM:
        raise ValueError(f"sgns_epoch takes at most {SGNS_MAX_DIM} dimensions, got {d}")
    if not _on_cuda(W, C, pairs, negs):
        return sgns_epoch_plain(W, C, pairs, negs, lr)
    P, K = negs.shape
    if lists is None:
        lists = sgns_lists(pairs, negs, V)
    W, C, pairs, negs = W.contiguous(), C.contiguous(), pairs.contiguous(), negs.contiguous()
    S = lists.seg_row.numel()
    W2, C2 = out if out is not None else (torch.empty_like(W), torch.empty_like(C))
    partial = torch.empty((S, d), dtype=torch.float32, device=W.device)
    loss_part = torch.empty(S, dtype=torch.float32, device=W.device)
    lib = cuda_build.load("sgns", _SGNS_SIGNATURES)
    stream = ctypes.c_void_p(torch.cuda.current_stream(W.device).cuda_stream)
    with torch.cuda.device(W.device):
        rc = lib.sgns_epoch(W.data_ptr(), C.data_ptr(), pairs.data_ptr(), negs.data_ptr(),
                            lists.w_pairs.data_ptr(), lists.c_entries.data_ptr(),
                            lists.seg_row.data_ptr(), lists.seg_lo.data_ptr(),
                            lists.seg_hi.data_ptr(), lists.row_seg.data_ptr(),
                            partial.data_ptr(), loss_part.data_ptr(), W2.data_ptr(),
                            C2.data_ptr(), V, d, P, K, S, ctypes.c_float(lr), stream)
        cuda_build.check_launch("sgns_epoch", rc)
        sgns_epoch.launches += 1
        loss = None
        if want_loss:
            loss = torch.empty((), dtype=torch.float32, device=W.device)
            rc = lib.sgns_loss(loss_part.data_ptr(), loss.data_ptr(), S, P, stream)
            cuda_build.check_launch("sgns_loss", rc)
    return W2, C2, loss


sgns_epoch.launches = 0


# ---------------------------------------------------------------------------
# K-AB lda: beta, estep, sstats
# ---------------------------------------------------------------------------
#: the most topics K-AB takes (past 32, the topics across a warp's lanes)
LDA_MAX_TOPICS = 256
#: the most nonzeros of one term a warp of the sstats mode sums
LDA_SEGMENT = 128


class LdaDocs(NamedTuple):
    """The nonzero counts of a count matrix X f32[n, v] (``lda_docs``):
    ``offsets`` i32[n + 1] (row starts), ``terms`` i32[nnz], ``counts``
    f32[nnz], in row-major order; and the same nonzeros grouped by term
    (a stable sort, so document order within a term): ``col_entry`` i32[nnz]
    their row-major positions, ``col_doc`` i32[nnz] their documents, each
    term's list cut into segments of at most ``LDA_SEGMENT`` (``seg_lo`` /
    ``seg_hi`` i32[S]) with ``term_seg`` i32[v + 1] each term's first."""

    offsets: torch.Tensor
    terms: torch.Tensor
    counts: torch.Tensor
    col_entry: torch.Tensor
    col_doc: torch.Tensor
    seg_lo: torch.Tensor
    seg_hi: torch.Tensor
    term_seg: torch.Tensor


def lda_docs(X: torch.Tensor) -> LdaDocs:
    """K-AB's document and term lists of X f32[n, v] on its device (once a
    fit or a score)."""
    n, v = X.shape
    rows, terms = torch.nonzero(X > 0, as_tuple=True)
    counts = X[rows, terms].contiguous()
    per_row = torch.bincount(rows, minlength=n)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=X.device),
                         torch.cumsum(per_row, 0)])
    col_entry = torch.sort(terms, stable=True).indices
    _, lo, hi, nseg = _segments(terms[col_entry], v, 0, LDA_SEGMENT)
    term_seg = torch.cat([torch.zeros(1, dtype=torch.long, device=X.device),
                          torch.cumsum(nseg, 0)])
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    return LdaDocs(i32(offsets), i32(terms), counts, i32(col_entry), i32(rows[col_entry]),
                   i32(lo), i32(hi), i32(term_seg))


def _check_lda(exp_beta: torch.Tensor, X: torch.Tensor) -> None:
    if exp_beta.dtype != torch.float32 or exp_beta.ndim != 2:
        raise ValueError("exp_beta must be float32[k, v]")
    k, v = exp_beta.shape
    if X.dtype != torch.float32 or X.ndim != 2 or X.shape[1] != v:
        raise ValueError(f"X must be float32[n, {v}]")
    if k > LDA_MAX_TOPICS:
        raise ValueError(f"K-AB takes at most {LDA_MAX_TOPICS} topics, got {k}")


def _exp_theta_plain(gamma: torch.Tensor) -> torch.Tensor:
    return torch.exp(digamma(gamma) - digamma(gamma.sum(1, keepdim=True)))


def lda_beta_plain(lam: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-AB's beta mode."""
    return torch.exp(digamma(lam) - digamma(lam.sum(1, keepdim=True)))


def lda_estep_plain(exp_beta: torch.Tensor, X: torch.Tensor, alpha: float,
                    n_iter: int) -> torch.Tensor:
    """Plain PyTorch version of K-AB's estep mode: ``_lda_e_step``'s loop
    densely (``phi_norm``'s 1e-100 is 0 in float32, so a zero ``phi_norm``
    gives NaN, as in the JAX package)."""
    gamma = torch.ones((X.shape[0], exp_beta.shape[0]), dtype=torch.float32, device=X.device)
    for _ in range(n_iter):
        exp_theta = _exp_theta_plain(gamma)
        phi_norm = exp_theta @ exp_beta
        gamma = alpha + exp_theta * ((X / phi_norm) @ exp_beta.T)
    return gamma


def lda_sstats_plain(exp_beta: torch.Tensor, X: torch.Tensor, gamma: torch.Tensor,
                     eta: float) -> torch.Tensor:
    """Plain PyTorch version of K-AB's sstats mode: the M-step's new lambda
    ``eta + exp_beta * (exp_theta^T (X / phi_norm))`` densely."""
    exp_theta = _exp_theta_plain(gamma)
    phi_norm = exp_theta @ exp_beta
    return eta + exp_beta * (exp_theta.T @ (X / phi_norm))


_LDA_SIGNATURES = {
    "lda_beta": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
    "lda_estep": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float]
                  + [ctypes.c_void_p], ctypes.c_int),
    "lda_sstats": ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p], ctypes.c_int),
}


def _beta_scratch(k: int, v: int, dev) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The [v][k] copy of exp_beta, its per-term maxima and their minimum."""
    return (torch.empty((v, k), dtype=torch.float32, device=dev),
            torch.empty(v, dtype=torch.float32, device=dev),
            torch.empty(1, dtype=torch.float32, device=dev))


def _lda_lib():
    return cuda_build.load("lda", _LDA_SIGNATURES)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def lda_beta(lam: torch.Tensor) -> torch.Tensor:
    """exp_beta f32[k, v] = ``exp(digamma(lam) - digamma(sum_w lam))`` for
    the topic-word lambda f32[k, v]."""
    if lam.dtype != torch.float32 or lam.ndim != 2:
        raise ValueError("lam must be float32[k, v]")
    if not _on_cuda(lam):
        return lda_beta_plain(lam)
    k, v = lam.shape
    lam = lam.contiguous()
    out = torch.empty_like(lam)
    with torch.cuda.device(lam.device):
        rc = _lda_lib().lda_beta(lam.data_ptr(), out.data_ptr(), k, v, _stream(lam))
    cuda_build.check_launch("lda_beta", rc)
    lda_beta.launches += 1
    return out


lda_beta.launches = 0


def lda_estep(exp_beta: torch.Tensor, X: torch.Tensor, alpha: float, n_iter: int = 30,
              docs: Optional[LdaDocs] = None) -> torch.Tensor:
    """The documents' gamma f32[n, k] after ``n_iter`` E-step iterations
    from gamma = 1, for the count matrix X f32[n, v] and exp_beta f32[k, v]
    (``_lda_e_step``).  On the card ``docs`` (``lda_docs(X)``, built if
    None) carries X's nonzero counts.  At most ``LDA_MAX_TOPICS`` topics:
    the kernel's narrow entry to 16, the topics across a warp's lanes
    above."""
    _check_lda(exp_beta, X)
    if not _on_cuda(exp_beta, X):
        return lda_estep_plain(exp_beta, X, alpha, n_iter)
    k, v = exp_beta.shape
    n = X.shape[0]
    docs = lda_docs(X) if docs is None else docs
    exp_beta = exp_beta.contiguous()
    gamma = torch.empty((n, k), dtype=torch.float32, device=X.device)
    ebT, colmax, cmin = _beta_scratch(k, v, X.device)
    with torch.cuda.device(X.device):
        rc = _lda_lib().lda_estep(exp_beta.data_ptr(), ebT.data_ptr(), colmax.data_ptr(),
                                  cmin.data_ptr(), docs.offsets.data_ptr(),
                                  docs.terms.data_ptr(), docs.counts.data_ptr(),
                                  gamma.data_ptr(), n, k, v, n_iter, ctypes.c_float(alpha),
                                  _stream(X))
    cuda_build.check_launch("lda_estep", rc)
    lda_estep.launches += 1
    return gamma


lda_estep.launches = 0


def lda_sstats(exp_beta: torch.Tensor, X: torch.Tensor, gamma: torch.Tensor, eta: float,
               docs: Optional[LdaDocs] = None) -> torch.Tensor:
    """The M-step's new lambda f32[k, v] = ``eta + exp_beta * (exp_theta^T
    (X / phi_norm))`` with ``exp_theta`` from gamma f32[n, k] (the end of
    ``OpLDA.fit_columns``'s EM step); the arguments as ``lda_estep``'s."""
    _check_lda(exp_beta, X)
    k, v = exp_beta.shape
    n = X.shape[0]
    if gamma.dtype != torch.float32 or tuple(gamma.shape) != (n, k):
        raise ValueError(f"gamma must be float32[{n}, {k}]")
    if not _on_cuda(exp_beta, X, gamma):
        return lda_sstats_plain(exp_beta, X, gamma, eta)
    docs = lda_docs(X) if docs is None else docs
    exp_beta, gamma = exp_beta.contiguous(), gamma.contiguous()
    dev = X.device
    S = int(docs.seg_lo.numel())
    ebT, colmax, cmin = _beta_scratch(k, v, dev)
    exp_theta = torch.empty((n, k), dtype=torch.float32, device=dev)
    ratio = torch.empty(max(1, docs.terms.numel()), dtype=torch.float32, device=dev)
    partial = torch.empty((max(1, S), k), dtype=torch.float32, device=dev)
    dead = torch.zeros(1, dtype=torch.int32, device=dev)
    zero_col = torch.zeros(v, dtype=torch.int32, device=dev)
    out = torch.empty((k, v), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (
        exp_beta, gamma, docs.offsets, docs.terms, docs.counts, docs.col_entry, docs.col_doc,
        docs.seg_lo, docs.seg_hi, docs.term_seg, ebT, colmax, cmin, exp_theta, ratio, partial,
        dead, zero_col, out)]
    with torch.cuda.device(dev):
        rc = _lda_lib().lda_sstats(*ptrs, n, k, v, S, ctypes.c_float(eta), _stream(X))
    cuda_build.check_launch("lda_sstats", rc)
    lda_sstats.launches += 1
    return out


lda_sstats.launches = 0
