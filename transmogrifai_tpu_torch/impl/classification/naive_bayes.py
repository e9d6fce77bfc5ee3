"""OpNaiveBayes: multinomial and Bernoulli naive Bayes, and its kernel K-V.

The port's counterpart of
``transmogrifai_tpu/impl/classification/naive_bayes.py`` (reference:
OpNaiveBayes.scala wrapping Spark's NaiveBayes: smoothing, modelType
multinomial | bernoulli; non-negative features).  A fit is one weighted
aggregation pass and a few log tables, no iterations.

``nb_tables_mass`` and ``nb_tables_score`` (K-V ``nb_tables``,
``csrc/naive_bayes.cu``) replace the two einsums of the reference's
``_nb_grid_z`` (:21): the class and feature masses of every fold in one pass
over the rows, and the joint log-likelihoods ``z = pi + Xd theta^T`` (plus
``(1 - Xd) tn^T`` for Bernoulli) of every (fold, smoothing) table set.  The
log tables between them are torch ops on [F, k, d]; the fold sweep's
softmax and argmax stay in numpy on the host, as the reference's do.  The
wrappers take the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise ``KernelError``;
``<wrapper>.launches`` counts their launches.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import cuda_build
from ...ops.linear import _softmax
from ...utils.device import on_cuda as _on_cuda
from ..feature._util import stage_device
from ..selector.predictor import PredictorEstimator, as_matrix

#: the most features and classes K-V takes
NB_MAX_FEATURES = 256
NB_MAX_CLASSES = 8
_MASS_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SCORE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_NB_SIGNATURES = {"nb_tables_mass": (_MASS_ARGS, ctypes.c_int),
                  "nb_tables_score": (_SCORE_ARGS, ctypes.c_int)}
#: rows of a mass-mode block's chunk: at least 1024, else enough chunks to
#: give every SM two blocks over the folds
_MIN_CHUNK = 1024
_TARGET_BLOCKS = 2 * 132


def _check_limits(d: int, k: int) -> None:
    if d > NB_MAX_FEATURES or k > NB_MAX_CLASSES:
        raise NotImplementedError(
            f"nb_tables takes at most {NB_MAX_FEATURES} features and {NB_MAX_CLASSES} "
            f"classes, got {d} and {k}")


def nb_tables_mass_plain(Xd: torch.Tensor, y: torch.Tensor, w: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K-V's mass mode: both sums in float64,
    rounded once, as the kernel's."""
    Y = torch.nn.functional.one_hot(y.long(), k).double()                      # [n, k]
    wd = w.double()
    cls = (wd @ Y).to(torch.float32)                                           # [F, k]
    feat = torch.einsum("fn,nk,nd->fkd", wd, Y, Xd.double()).to(torch.float32)
    return cls, feat


def nb_tables_mass(Xd: torch.Tensor, y: torch.Tensor, w: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(class masses f32[F, k], feature masses f32[F, k, d]) of F folds:
    ``sum_r w[f, r] [y_r == c]`` and ``sum_r w[f, r] [y_r == c] Xd[r, j]``.
    ``Xd`` f32[n, d] the (binarized, for Bernoulli) features, ``y`` f32[n]
    the class labels 0 .. k - 1, ``w`` f32[F, n] the folds' row weights."""
    n, d = Xd.shape
    if Xd.dtype != torch.float32 or y.dtype != torch.float32 or tuple(y.shape) != (n,) \
            or w.dtype != torch.float32 or w.ndim != 2 or w.shape[1] != n:
        raise ValueError(f"nb_tables_mass takes Xd f32[n, d], y f32[{n}], w f32[F, {n}]")
    if not _on_cuda(Xd, y, w):
        return nb_tables_mass_plain(Xd, y, w, k)
    _check_limits(d, k)
    F = w.shape[0]
    dev = Xd.device
    cls = torch.zeros((F, k), dtype=torch.float32, device=dev)
    feat = torch.zeros((F, k, d), dtype=torch.float32, device=dev)
    if n == 0:
        return cls, feat
    Xd, y, w = Xd.contiguous(), y.contiguous(), w.contiguous()
    chunk_rows = max(_MIN_CHUNK, -(-n * F // _TARGET_BLOCKS))
    chunks = -(-n // chunk_rows)
    partial = torch.empty((chunks, F, k * (d + 1)), dtype=torch.float64, device=dev)
    lib = cuda_build.load("naive_bayes", _NB_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.nb_tables_mass(Xd.data_ptr(), y.data_ptr(), w.data_ptr(), partial.data_ptr(),
                                cls.data_ptr(), feat.data_ptr(), n, d, k, F, chunks, chunk_rows,
                                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check_launch("nb_tables_mass", rc)
    nb_tables_mass.launches += 1
    return cls, feat


nb_tables_mass.launches = 0


def nb_tables_score_plain(Xd: torch.Tensor, pi: torch.Tensor, theta: torch.Tensor,
                          tn: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of K-V's score mode: each dot product in
    float64, rounded once, added to pi in float32 in the reference's order."""
    Xdd = Xd.double()
    z = pi[:, None, :] + torch.einsum("nd,qkd->qnk", Xdd, theta.double()).to(torch.float32)
    if tn is not None:
        z = z + torch.einsum("nd,qkd->qnk", (1.0 - Xd).double(),
                             tn.double()).to(torch.float32)
    return z


def nb_tables_score(Xd: torch.Tensor, pi: torch.Tensor, theta: torch.Tensor,
                    tn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The joint log-likelihoods z f32[Q, n, k] of Q table sets: ``pi[q] +
    Xd theta[q]^T``, plus ``(1 - Xd) tn[q]^T`` with Bernoulli's ``tn``.
    ``Xd`` f32[n, d], ``pi`` f32[Q, k], ``theta`` and ``tn`` f32[Q, k, d]."""
    n, d = Xd.shape
    Q, k = pi.shape
    for name, a, shape in (("pi", pi, (Q, k)), ("theta", theta, (Q, k, d)),
                           ("tn", tn, (Q, k, d))):
        if a is not None and (a.dtype != torch.float32 or tuple(a.shape) != shape):
            raise ValueError(f"{name} must be float32{list(shape)}")
    others = () if tn is None else (tn,)
    if not _on_cuda(Xd, pi, theta, *others):
        return nb_tables_score_plain(Xd, pi, theta, tn)
    _check_limits(d, k)
    dev = Xd.device
    z = torch.empty((Q, n, k), dtype=torch.float32, device=dev)
    if n == 0:
        return z
    Xd, pi, theta = Xd.contiguous(), pi.contiguous(), theta.contiguous()
    tn_t = theta if tn is None else tn.contiguous()
    lib = cuda_build.load("naive_bayes", _NB_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.nb_tables_score(Xd.data_ptr(), pi.data_ptr(), theta.data_ptr(),
                                 tn_t.data_ptr(), z.data_ptr(), n, d, k, Q, int(tn is not None),
                                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check_launch("nb_tables_score", rc)
    nb_tables_score.launches += 1
    return z


nb_tables_score.launches = 0


def _log_tables(cls: torch.Tensor, feat: torch.Tensor, s: torch.Tensor, bernoulli: bool):
    """(pi [..., k], theta [..., k, d], tn or None) from the masses at the
    float32 smoothing ``s`` (broadcast against ``cls``), in the reference's
    float32 operations."""
    k, d = feat.shape[-2], feat.shape[-1]
    pi = torch.log(cls + s) - torch.log(cls.sum(-1, keepdim=True) + s * k)
    s3 = s[..., None]
    if bernoulli:
        p = (feat + s3) / (cls[..., None] + 2.0 * s3)
        return pi, torch.log(p), torch.log1p(-p)
    theta = torch.log(feat + s3) - torch.log(feat.sum(-1, keepdim=True) + s3 * d)
    return pi, theta, None


def _nb_grid_z(Xd: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, smoothings,
               bernoulli: bool, k: int) -> torch.Tensor:
    """The joint log-likelihoods z f32[F, G, n, k] for every (fold,
    smoothing): the masses by K-V once per fold, the log tables per
    smoothing, the scores by K-V for all F x G table sets at once."""
    cls, feat = nb_tables_mass(Xd, y, train_w, k)                             # [F, k], [F, k, d]
    F, d = cls.shape[0], Xd.shape[1]
    s = torch.as_tensor(np.asarray(smoothings, np.float32), device=Xd.device)  # [G]
    G = s.shape[0]
    pi, theta, tn = _log_tables(cls[:, None], feat[:, None], s[None, :, None], bernoulli)
    z = nb_tables_score(Xd, pi.reshape(F * G, k).contiguous(),
                        theta.reshape(F * G, k, d).contiguous(),
                        None if tn is None else tn.reshape(F * G, k, d).contiguous())
    return z.reshape(F, G, -1, k)


def _require_non_negative(X: torch.Tensor) -> None:
    if bool((X < 0).any()):
        raise ValueError("Naive Bayes requires non-negative feature values "
                         "(Spark NaiveBayes semantics)")


class OpNaiveBayes(PredictorEstimator):
    is_classifier = True

    def __init__(self, smoothing: float = 1.0, model_type: str = "multinomial",
                 uid: Optional[str] = None, **extra):
        if model_type not in ("multinomial", "bernoulli"):
            raise ValueError("model_type must be multinomial or bernoulli")
        super().__init__(operation_name="OpNaiveBayes", uid=uid,
                         smoothing=smoothing, model_type=model_type, **extra)

    def fit_arrays(self, X, y: np.ndarray, w: Optional[np.ndarray] = None) -> Dict[str, Any]:
        X = as_matrix(X, stage_device(self))
        _require_non_negative(X)
        dev = X.device
        y = np.asarray(y)
        sw = np.ones(len(y), np.float32) if w is None else np.asarray(w, np.float32)
        k = max(int(y.max()) + 1 if len(y) else 2, 2)
        smoothing = float(self.get_param("smoothing", 1.0))
        model_type = self.get_param("model_type", "multinomial")
        Xd = X if model_type == "multinomial" else (X > 0).to(torch.float32)
        cls, feat = nb_tables_mass(Xd, torch.from_numpy(np.asarray(y, np.float32)).to(dev),
                                   torch.from_numpy(sw).to(dev)[None], k)
        pi, theta, tn = _log_tables(cls[0], feat[0],
                                    torch.tensor(smoothing, dtype=torch.float32, device=dev),
                                    model_type == "bernoulli")
        out = {"pi": pi.cpu().numpy(), "theta": theta.cpu().numpy(), "num_classes": k,
               "model_type": model_type}
        if tn is not None:
            out["theta_neg"] = tn.cpu().numpy()
        return out

    _GRID_KEYS = ("smoothing", "model_type")

    def fit_grid_folds(self, X, y, train_w, grids):
        """The fold x grid sweep: per model type, the masses of every fold by
        one K-V pass and the scores of every (fold, smoothing) by another;
        the softmax and argmax on the host in numpy, ``[fold][grid]``."""
        grids = [dict(g) for g in (grids or [{}])]
        for g in grids:
            for key in g:
                if key not in self._GRID_KEYS:
                    raise NotImplementedError(f"non-batchable NB grid key {key}")
        X = as_matrix(X, stage_device(self))
        _require_non_negative(X)
        dev = X.device
        candidates = [self.copy_with_params(g) for g in grids]
        n_folds = train_w.shape[0]
        k = max(int(np.max(y)) + 1 if len(y) else 2, 2)
        out = [[None] * len(grids) for _ in range(n_folds)]
        groups: Dict[str, list] = {}
        for ci, cand in enumerate(candidates):
            groups.setdefault(cand.get_param("model_type", "multinomial"), []).append(ci)
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        twd = torch.from_numpy(np.asarray(train_w, np.float32)).to(dev)
        for model_type, cis in groups.items():
            Xd = X if model_type == "multinomial" else (X > 0).to(torch.float32)
            sm = [float(candidates[ci].get_param("smoothing", 1.0)) for ci in cis]
            z = _nb_grid_z(Xd, yd, twd, sm, model_type == "bernoulli", k).cpu().numpy()
            prob = np.exp(z - z.max(axis=-1, keepdims=True))
            prob /= prob.sum(axis=-1, keepdims=True)
            pred = z.argmax(axis=-1).astype(np.float64)
            for gi, ci in enumerate(cis):
                for f in range(n_folds):
                    out[f][ci] = (pred[f, gi], z[f, gi], prob[f, gi])
        return out

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        out = {"bernoulli": params.get("model_type") == "bernoulli"}
        for key in ("pi", "theta", "theta_neg"):
            if key in params:
                out[key] = torch.tensor(np.asarray(params[key], np.float32), device=device)
        return out

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        Xd = (X > 0).to(torch.float32) if dparams["bernoulli"] else X
        z = nb_tables_score(Xd, dparams["pi"][None], dparams["theta"][None],
                            dparams["theta_neg"][None] if dparams["bernoulli"] else None)[0]
        prob = _softmax(z)
        pred = torch.argmax(z, dim=-1).to(torch.float32)
        return pred.cpu().numpy(), z.cpu().numpy(), prob.cpu().numpy()
