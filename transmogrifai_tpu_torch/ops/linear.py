"""Linear models on the device: the elastic-net, Newton and ridge solvers and prediction.

The port's counterpart of ``transmogrifai_tpu/ops/linear.py``:
``fit_logistic_fista``, ``fit_linear_fista`` and ``fit_softmax`` and
their fold x grid batches ``fit_logistic_grid_folds_fista``,
``fit_linear_grid_folds_fista`` and ``fit_softmax_grid_folds`` (FISTA
proximal gradient, a fixed iteration count); ``fit_logistic_newton`` and
``fit_logistic_grid_folds_newton`` (full-batch Newton for the pure-L2
logistic fits, a fixed step count); ``fit_ridge`` and
``fit_ridge_grid_folds`` (the closed-form ridge fits);
``predict_binary_logistic``, ``predict_softmax``, ``predict_softmax_grid``
and ``predict_linear``, and ``predict_head`` (K-AF, ``csrc/predict_head.cu``:
a fitted linear family's prediction head in one launch, the product, the
link and the stacked outputs, which the predictors' ``predict_tensors`` and
``predict_program`` call; the three plain heads are its plain version).
Five hand-written kernels carry the solvers; three are in one CUDA source
(``csrc/fista.cu``):

- ``fista_grad`` (K-K) replaces the gradient of ``fit_logistic_fista``'s
  body for all fits of the batch at once:
  ``X1^T (w * (sigmoid(X1 z) - y)) / sum(w) + l2 * z``;
- ``linear_fista_grad`` (K-N) replaces the gradient of
  ``fit_linear_fista``'s body: ``X1^T (w * (X1 z - y)) / sum(w) + l2 * z``;
- ``softmax_fista_grad`` (K-P) replaces the gradient of ``fit_softmax``'s
  body, a matrix of coefficients [p, k] per fit:
  ``X1^T (w * (softmax(X1 B) - Y)) / sum(w) + l2 * B`` with Y the one-hot
  labels;

``svc_grad`` (K-T, ``csrc/svc.cu``) replaces the gradient of
``fit_linear_svc``'s body (the squared hinge):
``X1^T (w * (-2 ypm max(1 - ypm X1 z, 0))) / sum(w) + l2 * z`` with ``ypm
= 2 y - 1``, the fits' accelerated gradient steps sharing FISTA's loop (no
L1 term: the threshold is 0).  Past 64 coefficients K-P (at up to 8 classes)
and K-T take one kernel over staged row tiles, ``csrc/wide_rows.cuh``,
launched by the plan of ``wide_rows_plan``;

and ``weighted_gram`` (K-S, ``csrc/weighted_gram.cu``) forms the weighted
Gram matrix and moment vector of every Newton step (``X1^T diag(w mu (1 -
mu)) X1`` and ``X1^T (w (mu - y))`` at each fit's coefficients), of the
ridge normal equations (``X1^T diag(w) X1`` and ``X1^T (w y)``, once a
fold) and of every GLM IRLS step.  The proximal step, the soft threshold
and the momentum are elementwise torch on [C, p] (or [C, p, k]); the
shared momentum scalars are float32 on the host.  The Newton and ridge solves of the small [p, p]
systems are batched ``torch.linalg.solve_ex`` in float64 (LU with partial
pivoting, as the reference's float32 ``jnp.linalg.solve``; see ``_ridge``
for why float64; no singularity check), each result rounded to float32.  The wrappers take
the plain version only for tensors on the CPU; for CUDA tensors they
launch the kernel or raise ``KernelError``; ``<wrapper>.launches`` counts
their launches.  The sweeps' fold x grid predictions (``predict_*_grid``)
are plain products: ``torch.matmul`` in full float32 (see
``utils/device.apply_f32_policy``).

The GLM (``fit_glm_irls``, ``fit_glm_grid_folds``, ``predict_glm``,
``predict_glm_grid``, with the reference's ``_GLM_LINKS``,
``_GLM_VARIANCE`` and ``GLM_DEFAULT_LINK``) runs IRLS on K-S in its GLM
mode: each step forms every fit's IRLS weights and working responses in
the kernel's prologue, its Gram and moments, and one float64 solve a fit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build


class LinearFit(NamedTuple):
    """Fitted linear parameters: coefficients [..., d] and intercept [..., 1]."""

    coef: torch.Tensor
    intercept: torch.Tensor


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), the expansion XLA uses for ``jax.nn.sigmoid``."""
    return 1.0 / (1.0 + torch.exp(-x))


def _soft_threshold(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thr, 0.0)


# ---------------------------------------------------------------------------
# K-K fista_grad
# ---------------------------------------------------------------------------
def _check_fista(X1, y, w, fold, z, l2v, wsum):
    if not (X1.dtype == torch.float32 and X1.ndim == 2):
        raise ValueError("X1 must be float32[n, p]")
    n, p = X1.shape
    C = z.shape[0]
    for name, a, shape in (("y", y, (n,)), ("z", z, (C, p)), ("l2v", l2v, (C, p)),
                           ("wsum", wsum, (C,))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}")
    if w.dtype != torch.float32 or w.ndim != 2 or w.shape[1] != n:
        raise ValueError(f"w must be float32[F, {n}]")
    if fold.dtype != torch.int32 or tuple(fold.shape) != (C,):
        raise ValueError(f"fold must be int32[{C}]")


def fista_grad_plain(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                     z: torch.Tensor, l2v: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-K: two products and the elementwise terms."""
    r = w[fold.long()] * (_sigmoid(z @ X1.T) - y)                      # [C, n]
    return (r @ X1) / wsum[:, None] + l2v * z


def linear_fista_grad_plain(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                            fold: torch.Tensor, z: torch.Tensor, l2v: torch.Tensor,
                            wsum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-N: two products and the elementwise terms."""
    r = w[fold.long()] * (z @ X1.T - y)                                 # [C, n]
    return (r @ X1) / wsum[:, None] + l2v * z


_FISTA_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SOFTMAX_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SOFTMAX_TILED_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_SOFTMAX_WIDE_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
#: the entry points of csrc/fista.cu (the library is loaded once, with all)
_FISTA_SIGNATURES = {"fista_grad": (_FISTA_ARGS, ctypes.c_int),
                     "linear_fista_grad": (_FISTA_ARGS, ctypes.c_int),
                     "softmax_fista_grad": (_SOFTMAX_ARGS, ctypes.c_int),
                     "softmax_fista_grad_tiled": (_SOFTMAX_TILED_ARGS, ctypes.c_int),
                     "softmax_fista_grad_wide": (_SOFTMAX_WIDE_ARGS, ctypes.c_int)}
#: the most dynamic shared memory one block takes on the H100
SMEM_BLOCK_BYTES = 232448
#: rows of one block's chunk: at least 2048 (8 rows a thread), else enough
#: chunks to give every SM two blocks
_FISTA_MIN_CHUNK = 2048
_FISTA_TARGET_CHUNKS = 2 * 132
#: the most coefficients (features + intercept) K-K and K-N take: up to 64 a
#: thread a row, above a warp a row (``csrc/fista.cu``'s wide entry), whose
#: chunks are smaller (at least 256 rows, else 512 chunks: a block's 8 warps
#: take 32 rows each, and a tile of 8 fits still fills the SMs)
FISTA_MAX_COEFS = 1024
_FISTA_WIDE_MIN_CHUNK = 256
_FISTA_WIDE_TARGET_CHUNKS = 512


def _fista_launch(entry: str, X1, y, w, fold, z, l2v, wsum) -> torch.Tensor:
    """Launch ``csrc/fista.cu``'s ``entry`` (``fista_grad`` or
    ``linear_fista_grad``) on CUDA tensors; returns the gradients."""
    n, p = X1.shape
    C = z.shape[0]
    if p > FISTA_MAX_COEFS:
        raise ValueError(f"{entry} takes at most {FISTA_MAX_COEFS} coefficients, got {p}")
    X1, y, w, fold = X1.contiguous(), y.contiguous(), w.contiguous(), fold.contiguous()
    z, l2v, wsum = z.contiguous(), l2v.contiguous(), wsum.contiguous()
    chunk_rows = (max(_FISTA_MIN_CHUNK, -(-n // _FISTA_TARGET_CHUNKS)) if p <= 64 else
                  max(_FISTA_WIDE_MIN_CHUNK, -(-n // _FISTA_WIDE_TARGET_CHUNKS)))
    chunks = -(-n // chunk_rows)
    partial = torch.empty((chunks, C, p), dtype=torch.float32, device=X1.device)
    grad = torch.empty((C, p), dtype=torch.float32, device=X1.device)
    lib = cuda_build.load("fista", _FISTA_SIGNATURES)
    with torch.cuda.device(X1.device):
        rc = getattr(lib, entry)(X1.data_ptr(), y.data_ptr(), w.data_ptr(), fold.data_ptr(),
                                 z.data_ptr(), wsum.data_ptr(), l2v.data_ptr(),
                                 partial.data_ptr(), grad.data_ptr(), n, p, C, chunks,
                                 chunk_rows,
                                 ctypes.c_void_p(torch.cuda.current_stream(X1.device).cuda_stream))
    cuda_build.check_launch(entry, rc)
    return grad


def fista_grad(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
               z: torch.Tensor, l2v: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """The gradients f32[C, p] of C logistic fits at their points ``z``:
    ``X1^T (w[fold[c]] * (sigmoid(X1 z_c) - y)) / wsum[c] + l2v[c] * z_c``.

    ``X1`` f32[n, p] (the features with the intercept column), ``y`` f32[n],
    ``w`` f32[F, n] the folds' row weights, ``fold`` i32[C] each fit's fold,
    ``l2v`` f32[C, p] each fit's L2 penalty per coefficient, ``wsum`` f32[C]
    each fit's weight total.  At most ``FISTA_MAX_COEFS`` coefficients."""
    _check_fista(X1, y, w, fold, z, l2v, wsum)
    if not _on_cuda(X1, y, w, fold, z, l2v, wsum):
        return fista_grad_plain(X1, y, w, fold, z, l2v, wsum)
    grad = _fista_launch("fista_grad", X1, y, w, fold, z, l2v, wsum)
    fista_grad.launches += 1
    return grad


fista_grad.launches = 0


def linear_fista_grad(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                      z: torch.Tensor, l2v: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """The gradients f32[C, p] of C squared-loss linear fits at their points
    ``z``: ``X1^T (w[fold[c]] * (X1 z_c - y)) / wsum[c] + l2v[c] * z_c``;
    the arguments as ``fista_grad``'s."""
    _check_fista(X1, y, w, fold, z, l2v, wsum)
    if not _on_cuda(X1, y, w, fold, z, l2v, wsum):
        return linear_fista_grad_plain(X1, y, w, fold, z, l2v, wsum)
    grad = _fista_launch("linear_fista_grad", X1, y, w, fold, z, l2v, wsum)
    linear_fista_grad.launches += 1
    return grad


linear_fista_grad.launches = 0


# ---------------------------------------------------------------------------
# K-P softmax_fista_grad
# ---------------------------------------------------------------------------
#: the most classes and coefficients (features + intercept) K-P and its plain
#: version take: up to 64 coefficients a thread a row, above the wide entry
#: (``csrc/wide_rows.cuh``, by ``wide_rows_plan``); above 8 classes the tiled
#: entry
SOFTMAX_MAX_CLASSES = 128
SOFTMAX_MAX_COEFS = 1024
#: the wide and tiled entries' (K-P's, K-T's) float64 partials stay under this
_WIDE_PARTIAL_BYTES = 1 << 28
#: up to here K-P and K-T take their narrow entries
_NARROW_COEFS = 64


def _narrow_chunking(n: int) -> Tuple[int, int]:
    """(chunk_rows, chunks) of a narrow K-P or K-T launch (K-K's)."""
    chunk_rows = max(_FISTA_MIN_CHUNK, -(-n // _FISTA_TARGET_CHUNKS))
    return chunk_rows, -(-n // chunk_rows)


#: K-P's tiled entry (past 8 classes, ``csrc/fista.cu``): a block's threads
#: hold at most two 4 x 4 output micro-tiles (kOutTiles) each, 8,192 outputs;
#: a group's columns (fits x classes) at most 512, so that its margins and
#: coefficients fit shared memory at any p; row tiles of at most 64 rows;
#: blocks a launch, one wave of two an SM (no tail of a partial wave)
_SOFTMAX_BLOCK_OUTPUTS = 2 * 16 * 256
_SOFTMAX_GROUP_COLUMNS = 512
_SOFTMAX_TILE_ROWS = 64
_SOFTMAX_TARGET_BLOCKS = 2 * 132
#: coefficients of a margin's float32 block (kMarginBlock)
_SOFTMAX_MARGIN_BLOCK = 32
#: past this many classes K-P takes its tiled entry (kSoftNarrowK)
_SOFTMAX_NARROW_CLASSES = 8


class SoftmaxTiledPlan(NamedTuple):
    """The launch of K-P's tiled entry: ``fits`` fits a block (``groups``
    groups), ``rows`` rows a staged tile, ``out_rows`` output coefficient
    rows a block (``out_slabs`` slabs), the fits' coefficients resident in
    shared memory or streamed in blocks of 32, the row chunks, the dynamic
    shared bytes of a block and the float64 partials' bytes."""

    fits: int
    groups: int
    rows: int
    out_rows: int
    out_slabs: int
    z_resident: bool
    chunk_rows: int
    chunks: int
    smem_bytes: int
    partial_bytes: int


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def softmax_tiled_plan(n: int, p: int, k: int, C: int) -> SoftmaxTiledPlan:
    """The launch of K-P's tiled entry for C fits of k classes over X1 f32[n,
    p]: as many fits a block as keep its outputs (p padded to 4, times the
    fits' classes padded to 4) within ``_SOFTMAX_BLOCK_OUTPUTS``, balanced over
    the groups, at most ``_SOFTMAX_GROUP_COLUMNS`` columns; past one fit's
    outputs, slabs of output coefficient rows; the largest row tile (64, else
    32 rows) whose shared memory holds the fits' coefficients resident, else
    the coefficients streamed and the largest row tile that fits; row chunks
    for at most one wave of two blocks an SM, within the partial budget."""
    PP = _round4(p)
    G = max(1, min(C, _SOFTMAX_GROUP_COLUMNS // k, _SOFTMAX_BLOCK_OUTPUTS // (PP * _round4(k))))
    while G > 1 and PP * _round4(G * k) > _SOFTMAX_BLOCK_OUTPUTS:
        G -= 1
    groups = -(-C // G)
    G = -(-C // groups)
    NP = _round4(G * k)
    PA = min(PP, _SOFTMAX_BLOCK_OUTPUTS // NP // 4 * 4)
    out_slabs = -(-PP // PA)

    def smem(R, resident):  # row tiles, coefficients, margins, labels and weights
        return 4 * (2 * R * PP + (p if resident else _SOFTMAX_MARGIN_BLOCK) * NP + R * NP
                    + 2 * (G + 1) * R)

    R, resident = next((R, res) for res, R in ((True, _SOFTMAX_TILE_ROWS), (True, 32),
                                               (False, 64), (False, 32), (False, 16),
                                               (False, 8), (False, 4))
                       if smem(R, res) <= SMEM_BLOCK_BYTES)
    want = max(1, _SOFTMAX_TARGET_BLOCKS // (groups * out_slabs))
    per_chunk = C * p * k * 8
    chunks = max(1, min(want, _WIDE_PARTIAL_BYTES // per_chunk, -(-n // R)))
    chunk_rows = -(-(-(-n // chunks)) // R) * R
    chunks = -(-n // chunk_rows)
    return SoftmaxTiledPlan(G, groups, R, PA, out_slabs, resident, chunk_rows, chunks,
                            smem(R, resident), chunks * per_chunk)


#: K-P's (k <= 8) and K-T's wide entries (``csrc/wide_rows.cuh``): a thread
#: holds 32 float64 sums of a fit group's gradient [p x G k] (kOutputs), as two
#: 4 x 4 output micro-tiles at 256 threads a block (two blocks an SM, 128
#: registers a thread) or, where those do not hold the group, as one 8 x 4
#: micro-tile at up to 352 threads (one block an SM: 8 x 4 tiles load less
#: from shared memory a product); groups of at most 352 such 8 x 4 tiles, so
#: one fit (k <= 8, p <= 1,024) always fits; row tiles of at most 64 rows, 16
#: or more for two blocks an SM; about one wave of blocks
_WIDE_OUTPUTS = 32
_WIDE_THREADS = {4: 256, 8: 352}
_WIDE_TILE_ROWS = (64, 48, 32, 24, 16, 12, 8, 4)
_WIDE_TWO_BLOCK_ROWS = 16
#: fits a group at most, whose folds a block keeps in static shared memory
_WIDE_MAX_FITS = 256
_WIDE_STATIC_BYTES = 4 * _WIDE_MAX_FITS
#: the H100's SMs and the shared memory of one (228 KB, of which each block
#: takes 1 KB for itself)
_SMS = 132
_SM_SMEM_BYTES = 233472
_BLOCK_RESERVED_BYTES = 1024


class WideRowsPlan(NamedTuple):
    """The launch of K-P's (k <= 8) or K-T's wide entry: ``fits`` fits a
    block (``groups`` groups), ``rows`` rows a staged tile, each thread's
    output micro-tiles (``tile_rows`` x 4) summed over ``splits`` splits of a
    tile's rows, ``threads`` threads a block, the row chunks, the dynamic
    shared bytes of a block and the float64 partials' bytes."""

    fits: int
    groups: int
    rows: int
    splits: int
    threads: int
    tile_rows: int
    chunk_rows: int
    chunks: int
    smem_bytes: int
    partial_bytes: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def wide_tile_floats(p: int, MR: int, R: int) -> int:
    """A staged row tile's floats in shared memory (``tile_floats``): R rows
    of p rounded up to the micro-tile's rows and then to 32 (a bank row),
    and the skew of the rows' groups (4 floats more a group of MR rows)."""
    return R * _round_up(_round_up(p, MR), 32) + 4 * (R // MR)


def wide_rows_smem(p: int, k: int, G: int, R: int, MR: int) -> int:
    """The dynamic shared bytes of a wide-entry block (``smem_bytes``): a row
    tile strided and the next one packed, the fits' coefficients, the
    margins' 32-coefficient blocks, two tiles' labels and weights; at least
    the chunk's float64 partial of the group, which reuses them at the end."""
    PP, NP = _round_up(p, MR), _round4(G * k)
    nb = -(-p // _SOFTMAX_MARGIN_BLOCK)
    b = 4 * (wide_tile_floats(p, MR, R) + _round4(R * p) + PP * NP + nb * R * NP
             + 2 * (G + 1) * R)
    return max(b, 8 * PP * NP)


def _aligned16(X1: torch.Tensor) -> torch.Tensor:
    """X1 itself where its data is 16-byte aligned (the wide entries here and
    K-I in ``ops/stats.py`` stage a tile's rows by 16-byte copies), else an
    aligned copy."""
    return X1 if X1.data_ptr() % 16 == 0 else X1.clone()


def wide_rows_plan(n: int, p: int, k: int, C: int) -> WideRowsPlan:
    """The launch of K-P's wide entry (C fits of k <= 8 classes over X1
    f32[n, p]) or K-T's (k = 1): as many fits a group as keep its outputs
    within 352 8 x 4 micro-tiles (every fit in one group at the text flow's
    shapes), balanced over the groups; 4 x 4 micro-tiles at 256 threads where
    those hold the group (two a thread, the tile's rows split among the
    threads where the outputs are few), else 8 x 4 ones at a thread each;
    the largest row tile whose shared memory lets two blocks share an SM
    (256 threads, at least 16 rows), else one; row chunks for about one wave
    of blocks, within the partial budget."""
    cap = _WIDE_THREADS[8]
    G = max(1, min(C, _WIDE_MAX_FITS, 4 * (cap // (_round_up(p, 8) // 8)) // k))
    groups = -(-C // G)
    G = -(-C // groups)
    NCG = _round4(G * k) // 4
    MR = 4 if (_round4(p) // 4) * NCG <= 2 * _WIDE_THREADS[4] else 8
    Q = _WIDE_OUTPUTS // (MR * 4)
    MC = (_round_up(p, MR) // MR) * NCG
    T = _WIDE_THREADS[4] if MR == 4 else _round_up(MC, 32)

    def splits(R):
        S = max(1, min(R // 4, Q * T // MC))
        return -(-R // -(-R // S))

    for per_sm in ((2, 1) if MR == 4 else (1,)):
        limit = min(SMEM_BLOCK_BYTES, _SM_SMEM_BYTES // per_sm - _BLOCK_RESERVED_BYTES) \
            - _WIDE_STATIC_BYTES
        R = next((R for R in _WIDE_TILE_ROWS
                  if R % MR == 0 and wide_rows_smem(p, k, G, R, MR) <= limit), None)
        if R is not None and (per_sm == 1 or R >= _WIDE_TWO_BLOCK_ROWS):
            break
    S = splits(R)
    per_chunk = C * p * k * 8
    chunks = max(1, min(-(-per_sm * _SMS // groups), -(-n // R),
                        _WIDE_PARTIAL_BYTES // per_chunk))
    chunk_rows = _round_up(-(-n // chunks), R)
    chunks = -(-n // chunk_rows)
    return WideRowsPlan(G, groups, R, S, T, MR, chunk_rows, chunks,
                        wide_rows_smem(p, k, G, R, MR), chunks * per_chunk)


def _check_softmax(X1, y, w, fold, z, l2m, wsum):
    if not (X1.dtype == torch.float32 and X1.ndim == 2):
        raise ValueError("X1 must be float32[n, p]")
    n, p = X1.shape
    if z.dtype != torch.float32 or z.ndim != 3 or z.shape[1] != p:
        raise ValueError(f"z must be float32[C, {p}, k]")
    C, _, k = z.shape
    for name, a, shape in (("y", y, (n,)), ("l2m", l2m, (C, p, k)), ("wsum", wsum, (C,))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}")
    if w.dtype != torch.float32 or w.ndim != 2 or w.shape[1] != n:
        raise ValueError(f"w must be float32[F, {n}]")
    if fold.dtype != torch.int32 or tuple(fold.shape) != (C,):
        raise ValueError(f"fold must be int32[{C}]")
    if k > SOFTMAX_MAX_CLASSES or p > SOFTMAX_MAX_COEFS:
        raise ValueError(f"softmax_fista_grad takes at most {SOFTMAX_MAX_CLASSES} classes and "
                         f"{SOFTMAX_MAX_COEFS} coefficients, got {k} and {p}")


def _softmax(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` as the reference writes it: exp(z - max) / sum."""
    e = torch.exp(z - z.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def softmax_fista_grad_plain(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                             fold: torch.Tensor, z: torch.Tensor, l2m: torch.Tensor,
                             wsum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-P: two products and the elementwise terms;
    the second product sums in float64 and rounds once, as the kernel's
    reduction does."""
    k = z.shape[2]
    Y = torch.nn.functional.one_hot(y.long(), k).to(z.dtype)                 # [n, k]
    mu = _softmax(torch.einsum("np,cpk->cnk", X1, z))                         # [C, n, k]
    r = w[fold.long()][..., None] * (mu - Y)
    g = torch.einsum("np,cnk->cpk", X1.double(), r.double()).to(z.dtype)
    return g / wsum[:, None, None] + l2m * z


def softmax_fista_grad(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                       z: torch.Tensor, l2m: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """The gradients f32[C, p, k] of C multinomial (softmax) fits at their
    points ``z`` f32[C, p, k]: ``X1^T (w[fold[c]] * (softmax(X1 z_c) - Y)) /
    wsum[c] + l2m[c] * z_c`` with Y the one-hot of the class labels ``y``
    f32[n] (0 .. k - 1); the other arguments as ``fista_grad``'s, ``l2m``
    f32[C, p, k] each fit's L2 penalty per coefficient.  At most
    ``SOFTMAX_MAX_CLASSES`` classes and ``SOFTMAX_MAX_COEFS``
    coefficients."""
    _check_softmax(X1, y, w, fold, z, l2m, wsum)
    if not _on_cuda(X1, y, w, fold, z, l2m, wsum):
        return softmax_fista_grad_plain(X1, y, w, fold, z, l2m, wsum)
    n, p = X1.shape
    C, _, k = z.shape
    X1, y, w, fold = X1.contiguous(), y.contiguous(), w.contiguous(), fold.contiguous()
    z, l2m, wsum = z.contiguous(), l2m.contiguous(), wsum.contiguous()
    tiled = softmax_tiled_plan(n, p, k, C) if k > _SOFTMAX_NARROW_CLASSES else None
    wide = wide_rows_plan(n, p, k, C) if tiled is None and p > _NARROW_COEFS else None
    if wide:
        X1 = _aligned16(X1)
    plan = tiled or wide
    chunk_rows, chunks = (plan.chunk_rows, plan.chunks) if plan else _narrow_chunking(n)
    partial = torch.empty((chunks, C, p, k), dtype=torch.float64, device=X1.device)
    grad = torch.empty((C, p, k), dtype=torch.float32, device=X1.device)
    lib = cuda_build.load("fista", _FISTA_SIGNATURES)
    args = (X1.data_ptr(), y.data_ptr(), w.data_ptr(), fold.data_ptr(), z.data_ptr(),
            wsum.data_ptr(), l2m.data_ptr(), partial.data_ptr(), grad.data_ptr(), n, p, k, C,
            chunks, chunk_rows)
    stream = ctypes.c_void_p(torch.cuda.current_stream(X1.device).cuda_stream)
    with torch.cuda.device(X1.device):
        if tiled:
            rc = lib.softmax_fista_grad_tiled(*args, tiled.fits, tiled.rows, tiled.out_rows,
                                              int(tiled.z_resident), tiled.smem_bytes, stream)
        elif wide:
            rc = lib.softmax_fista_grad_wide(*args, wide.fits, wide.rows, wide.splits,
                                             wide.threads, wide.tile_rows, wide.smem_bytes,
                                             stream)
        else:
            rc = lib.softmax_fista_grad(*args, stream)
    cuda_build.check_launch("softmax_fista_grad", rc)
    softmax_fista_grad.launches += 1
    return grad


softmax_fista_grad.launches = 0


# ---------------------------------------------------------------------------
# K-T svc_grad
# ---------------------------------------------------------------------------
def svc_grad_plain(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                   z: torch.Tensor, l2v: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-T: the hinge residuals in float32, the
    product with X1 summed in float64 and rounded once, as the kernel's."""
    ypm = 2.0 * y - 1.0
    active = torch.clamp_min(1.0 - ypm * (z @ X1.T), 0.0)                     # [C, n]
    r = w[fold.long()] * ((-2.0 * ypm) * active)
    g = (r.double() @ X1.double()).to(torch.float32)
    return g / wsum[:, None] + l2v * z


_SVC_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SVC_SIGNATURES = {"svc_grad": (_SVC_ARGS, ctypes.c_int),
                   "svc_grad_wide": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                                     + [ctypes.c_void_p], ctypes.c_int)}


def svc_grad(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
             z: torch.Tensor, l2v: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """The gradients f32[C, p] of C squared-hinge SVC fits at their points
    ``z``: ``X1^T (w[fold[c]] * (-2 ypm max(1 - ypm X1 z_c, 0))) / wsum[c] +
    l2v[c] * z_c`` with ``ypm = 2 y - 1`` for the 0/1 labels ``y``; the
    arguments as ``fista_grad``'s.  At most ``FISTA_MAX_COEFS`` coefficients."""
    _check_fista(X1, y, w, fold, z, l2v, wsum)
    if not _on_cuda(X1, y, w, fold, z, l2v, wsum):
        return svc_grad_plain(X1, y, w, fold, z, l2v, wsum)
    n, p = X1.shape
    C = z.shape[0]
    if p > FISTA_MAX_COEFS:
        raise ValueError(f"svc_grad takes at most {FISTA_MAX_COEFS} coefficients, got {p}")
    X1, y, w, fold = X1.contiguous(), y.contiguous(), w.contiguous(), fold.contiguous()
    z, l2v, wsum = z.contiguous(), l2v.contiguous(), wsum.contiguous()
    plan = wide_rows_plan(n, p, 1, C) if p > _NARROW_COEFS else None
    if plan:
        X1 = _aligned16(X1)
    chunk_rows, chunks = (plan.chunk_rows, plan.chunks) if plan else _narrow_chunking(n)
    partial = torch.empty((chunks, C, p), dtype=torch.float64, device=X1.device)
    grad = torch.empty((C, p), dtype=torch.float32, device=X1.device)
    lib = cuda_build.load("svc", _SVC_SIGNATURES)
    args = (X1.data_ptr(), y.data_ptr(), w.data_ptr(), fold.data_ptr(), z.data_ptr(),
            wsum.data_ptr(), l2v.data_ptr(), partial.data_ptr(), grad.data_ptr(), n, p, C,
            chunks, chunk_rows)
    stream = ctypes.c_void_p(torch.cuda.current_stream(X1.device).cuda_stream)
    with torch.cuda.device(X1.device):
        if plan:
            rc = lib.svc_grad_wide(*args, plan.fits, plan.rows, plan.splits, plan.threads,
                                   plan.tile_rows, plan.smem_bytes, stream)
        else:
            rc = lib.svc_grad(*args, stream)
    cuda_build.check_launch("svc_grad", rc)
    svc_grad.launches += 1
    return grad


svc_grad.launches = 0


# ---------------------------------------------------------------------------
# The solver: FISTA for every (fold, grid) fit at once
# ---------------------------------------------------------------------------
def _momentum(max_iter: int):
    """The FISTA momentum factors (t - 1) / t_next of each step, in float32
    as the reference's scan carries t (the same for every fit)."""
    one, t, out = np.float32(1.0), np.float32(1.0), []
    for _ in range(max_iter):
        t_next = np.float32(0.5) * (one + np.sqrt(one + np.float32(4.0) * t * t))
        out.append(float((t - one) / t_next))
        t = t_next
    return out


#: the Lipschitz factor of each loss's curvature bound (the reference's
#: ``L = factor * sum(w x^2) / sum(w) + l2 + 1e-6``)
_LIPSCHITZ = {"logistic": 0.25, "linear": 1.0, "softmax": 0.5, "svc": 2.0}


def _fista_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, l1s, l2s,
                      max_iter: int, fit_intercept: bool, loss: str, k: int = 1) -> LinearFit:
    """FISTA for every (fold, grid) fit at once: the logistic fits through
    K-K, the linear ones through K-N, the softmax ones (``k`` classes, a
    coefficient matrix [p, k] per fit) through K-P, the squared-hinge SVC
    ones (``l1s`` 0) through K-T (the reference's four solvers differ only
    in the loss's gradient and the Lipschitz bound's factor; the SVC's
    Nesterov steps are FISTA's with a threshold of 0, which leaves every
    coefficient as it is)."""
    dev = X.device
    n, d = X.shape
    F = train_w.shape[0]
    l1 = torch.as_tensor(np.asarray(l1s, np.float32).reshape(-1), device=dev)
    l2 = torch.as_tensor(np.asarray(l2s, np.float32).reshape(-1), device=dev)
    G = l1.shape[0]
    C = F * G
    X1 = torch.cat([X, torch.ones((n, 1), dtype=torch.float32, device=dev)], 1) \
        if fit_intercept else X
    X1 = X1.contiguous()
    p = X1.shape[1]
    w = train_w.to(dev, torch.float32).contiguous()
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)   # [C]
    l1_c, l2_c = l1.repeat(F), l2.repeat(F)                                      # [C]
    pen = torch.ones(p, dtype=torch.float32, device=dev)
    if fit_intercept:
        pen[-1] = 0.0
    l1v, l2v = l1_c[:, None] * pen, (l2_c[:, None] * pen).contiguous()          # [C, p]
    w_sum = torch.clamp_min(w.sum(1), 1e-12)                                      # [F]
    sq = ((X1 * X1).T * w[:, None, :]).sum((1, 2))
    lip = _LIPSCHITZ[loss] * sq / w_sum                                           # [F]
    L = (lip[fold.long()] + l2_c) + 1e-6
    step = (1.0 / L)[:, None]                                                     # [C, 1]
    shape = (C, p)
    if loss == "softmax":  # a [p, k] matrix per fit
        shape = (C, p, k)
        l1v, l2v = l1v[..., None].expand(shape), l2v[..., None].expand(shape).contiguous()
        step = step[..., None]
    thr = step * l1v
    wsum_c = w_sum[fold.long()].contiguous()
    beta = torch.zeros(shape, dtype=torch.float32, device=dev)
    z = beta
    yd = y.to(dev, torch.float32).contiguous()
    grad_fn = {"logistic": fista_grad, "linear": linear_fista_grad,
               "softmax": softmax_fista_grad, "svc": svc_grad}[loss]
    for coef in _momentum(max_iter):
        grad = grad_fn(X1, yd, w, fold, z.contiguous(), l2v, wsum_c)
        beta_next = _soft_threshold(z - step * grad, thr)
        z = beta_next + coef * (beta_next - beta)
        beta = beta_next
    beta = beta.reshape((F, G) + shape[1:])
    if loss == "softmax":
        if fit_intercept:
            return LinearFit(beta[:, :, :-1].contiguous(), beta[:, :, -1].contiguous())
        return LinearFit(beta, torch.zeros((F, G, k), dtype=torch.float32, device=dev))
    if fit_intercept:
        return LinearFit(beta[..., :-1].contiguous(), beta[..., -1:].contiguous())
    return LinearFit(beta, torch.zeros((F, G, 1), dtype=torch.float32, device=dev))


def fit_logistic_grid_folds_fista(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor,
                                  l1s, l2s, max_iter: int = 200,
                                  fit_intercept: bool = True) -> LinearFit:
    """Elastic-net logistic fits for every (fold, grid) pair, on X's device.

    X f32[n, d]; y f32[n]; train_w f32[F, n]; l1s / l2s the G candidates'
    penalties.  Returns LinearFit with coef [F, G, d], intercept [F, G, 1].
    Each fit is the reference's ``fit_logistic_fista``: the step 1 / L with
    ``L = 0.25 sum(w x^2) / sum(w) + l2 + 1e-6``, the intercept unpenalized,
    ``max_iter`` FISTA steps with one shared momentum sequence."""
    return _fista_grid_folds(X, y, train_w, l1s, l2s, max_iter, fit_intercept, "logistic")


def fit_linear_grid_folds_fista(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor,
                                l1s, l2s, max_iter: int = 300,
                                fit_intercept: bool = True) -> LinearFit:
    """Elastic-net linear-regression fits for every (fold, grid) pair, on X's
    device: the reference's ``fit_linear_fista`` (the step 1 / L with
    ``L = sum(w x^2) / sum(w) + l2 + 1e-6``, the intercept unpenalized,
    ``max_iter`` FISTA steps); shapes as ``fit_logistic_grid_folds_fista``'s."""
    return _fista_grid_folds(X, y, train_w, l1s, l2s, max_iter, fit_intercept, "linear")


def fit_softmax_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, l1s, l2s,
                           num_classes: int, max_iter: int = 100,
                           fit_intercept: bool = True) -> LinearFit:
    """Elastic-net multinomial (softmax) fits for every (fold, grid) pair,
    on X's device: the reference's ``fit_softmax`` (the step 1 / L with
    ``L = 0.5 sum(w x^2) / sum(w) + l2 + 1e-6``, the intercept row
    unpenalized, ``max_iter`` FISTA steps) with ``y`` the class labels 0 ..
    ``num_classes`` - 1.  Returns coef [F, G, d, k], intercept [F, G, k]."""
    return _fista_grid_folds(X, y, train_w, l1s, l2s, max_iter, fit_intercept, "softmax",
                             k=int(num_classes))


def fit_svc_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, l2s,
                       max_iter: int = 200, fit_intercept: bool = True) -> LinearFit:
    """Squared-hinge L2 linear SVC fits for every (fold, grid) pair, on X's
    device: the reference's ``fit_linear_svc`` for each fit (the step 1 / L
    with ``L = 2 sum(w x^2) / sum(w) + l2 + 1e-6``, the intercept
    unpenalized, ``max_iter`` Nesterov steps) with ``y`` the 0/1 labels.
    Returns coef [F, G, d], intercept [F, G, 1]."""
    l2 = np.asarray(l2s, np.float32).reshape(-1)
    return _fista_grid_folds(X, y, train_w, np.zeros_like(l2), l2, max_iter, fit_intercept,
                             "svc")


def fit_linear_svc(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor, l2: float,
                   max_iter: int = 200, fit_intercept: bool = True) -> LinearFit:
    """One squared-hinge L2 linear SVC fit: coef [d], intercept [1]."""
    fit = fit_svc_grid_folds(X, y, sample_weight[None], [l2], max_iter=max_iter,
                             fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


def predict_svc(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw [n, 2], pred [n]) of an SVC fit: the margin ``z = X @ coef +
    intercept[0]`` as [-z, z] and the hard prediction ``z >= 0`` (no
    probability, as Spark's LinearSVC)."""
    z = X @ coef + intercept[0]
    return torch.stack([-z, z], dim=-1), (z >= 0.0).to(torch.float32)


def fit_logistic_fista(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor,
                       l1: float, l2: float, max_iter: int = 200,
                       fit_intercept: bool = True) -> LinearFit:
    """One elastic-net logistic fit (``l1 = reg * alpha``, ``l2 = reg * (1 -
    alpha)``, Spark's parameterization): coef [d], intercept [1]."""
    fit = fit_logistic_grid_folds_fista(X, y, sample_weight[None], [l1], [l2],
                                        max_iter=max_iter, fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


def fit_linear_fista(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor,
                     l1: float, l2: float, max_iter: int = 300,
                     fit_intercept: bool = True) -> LinearFit:
    """One elastic-net linear-regression fit: coef [d], intercept [1]."""
    fit = fit_linear_grid_folds_fista(X, y, sample_weight[None], [l1], [l2],
                                      max_iter=max_iter, fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


def fit_softmax(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor, l2: float,
                num_classes: int, max_iter: int = 100, fit_intercept: bool = True,
                l1: float = 0.0) -> LinearFit:
    """One elastic-net multinomial fit: coef [d, k], intercept [k]."""
    fit = fit_softmax_grid_folds(X, y, sample_weight[None], [l1], [l2], num_classes,
                                 max_iter=max_iter, fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


# ---------------------------------------------------------------------------
# K-S weighted_gram, and the Newton and ridge solvers on it
# ---------------------------------------------------------------------------
#: the most coefficients (features + intercept) K-S takes: up to 64 in fit
#: tiles whose threads hold every entry, above in 64 x 64 float64
#: tensor-core tiles (``csrc/weighted_gram.cu``'s wide entry)
GRAM_MAX_COEFS = 1024
_GRAM_NARROW_COEFS = 64
_GRAM_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_GRAM_WIDE_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_GRAM_SIGNATURES = {"weighted_gram": (_GRAM_ARGS, ctypes.c_int),
                    "weighted_gram_wide": (_GRAM_WIDE_ARGS, ctypes.c_int)}
#: K-S's tiles: 32 rows staged a step, at most 32 fits a block and 16 output
#: entries a thread (256 threads)
_GRAM_MAX_FITS = 32
_GRAM_MAX_ENTRIES = 16 * 256
#: the wide entry's float64 partials (chunks x C x E) stay under this
_GRAM_WIDE_PARTIAL_BYTES = 1 << 30
#: the wide entry's tile blocks a launch: eight waves of one block an SM
#: (the blocks' work differs by their tiles' share of the triangle)
_GRAM_WIDE_TARGET_BLOCKS = 8 * 132
#: the wide entry's tile kernel (``csrc/weighted_gram.cu``'s kGT, kGFits,
#: kGSlab, kGLd): 64 x 64 output tiles, up to 4 fits a block, 32-row slabs;
#: its shared memory, two raw float stages (the slab's 128 columns of X1 and
#: each fit's v and u) and two stages of the float64 operands (A, and B per
#: fit, rows of 68)
_GRAM_WIDE_TILE = 64
_GRAM_WIDE_FITS = 4
_GRAM_WIDE_SLAB = 32
_GRAM_WIDE_SMEM = (2 * (_GRAM_WIDE_SLAB * 2 * _GRAM_WIDE_TILE * 4 + _GRAM_WIDE_FITS * 2
                        * _GRAM_WIDE_SLAB * 8)
                   + 2 * (1 + _GRAM_WIDE_FITS) * _GRAM_WIDE_SLAB * (_GRAM_WIDE_TILE + 4) * 8)


class GramWidePlan(NamedTuple):
    """The launch of K-S's wide tile kernel: ``fits`` fits a block
    (``groups`` groups), ``tiles`` 64-column tiles of the p + 1 augmented
    columns (``pairs`` upper-triangle tile pairs), the row chunks, the
    dynamic shared bytes of a block and the float64 partials' bytes."""

    fits: int
    groups: int
    tiles: int
    pairs: int
    chunk_rows: int
    chunks: int
    smem_bytes: int
    partial_bytes: int


def gram_wide_plan(n: int, p: int, C: int) -> GramWidePlan:
    """The launch of K-S's wide entry for C fits over X1 f32[n, p]: the fits
    in groups of at most 4 (balanced), every upper-triangle pair of the 64
    -column tiles, row chunks of whole 32-row slabs for eight waves of one
    block an SM, within the partial budget."""
    groups = -(-C // _GRAM_WIDE_FITS)
    G = -(-C // groups)
    nt = -(-(p + 1) // _GRAM_WIDE_TILE)
    pairs = nt * (nt + 1) // 2
    per_chunk = C * (p * (p + 1) // 2 + p) * 8
    want = -(-_GRAM_WIDE_TARGET_BLOCKS // (groups * pairs))
    chunks = max(1, min(want, _GRAM_WIDE_PARTIAL_BYTES // per_chunk, -(-n // _GRAM_WIDE_SLAB)))
    chunk_rows = -(-(-(-n // chunks)) // _GRAM_WIDE_SLAB) * _GRAM_WIDE_SLAB
    chunks = -(-n // chunk_rows)
    return GramWidePlan(G, groups, nt, pairs, chunk_rows, chunks, _GRAM_WIDE_SMEM,
                        chunks * per_chunk)


def _check_gram(X1, y, w, fold, beta, glm):
    if not (X1.dtype == torch.float32 and X1.ndim == 2):
        raise ValueError("X1 must be float32[n, p]")
    n, p = X1.shape
    if y.dtype != torch.float32 or tuple(y.shape) != (n,):
        raise ValueError(f"y must be float32[{n}]")
    if w.dtype != torch.float32 or w.ndim != 2 or w.shape[1] != n:
        raise ValueError(f"w must be float32[F, {n}]")
    if fold.dtype != torch.int32 or fold.ndim != 1:
        raise ValueError("fold must be int32[C]")
    C = fold.shape[0]
    if beta is not None and (beta.dtype != torch.float32 or tuple(beta.shape) != (C, p)):
        raise ValueError(f"beta must be float32[{C}, {p}]")
    if p > GRAM_MAX_COEFS:
        raise ValueError(f"weighted_gram takes at most {GRAM_MAX_COEFS} coefficients, got {p}")
    if glm is not None:
        family, link, vp = glm
        if beta is None:
            raise ValueError("the GLM mode needs beta")
        if family not in _GLM_VARIANCE or link not in _GLM_LINKS:
            raise ValueError(f"unknown GLM family {family!r} or link {link!r}")
        if vp.dtype != torch.float32 or tuple(vp.shape) != (C,):
            raise ValueError(f"vp must be float32[{C}]")


def _gram_weights(X1, y, w, fold, beta, glm=None):
    """Each fit's row weights (v, u) f32[C, n]: Newton's ``max(mu (1 - mu),
    1e-6) w`` and ``w (mu - y)`` at ``beta``, ridge's ``w`` and ``w y``, or
    the GLM's IRLS weights and working responses (``_glm_weights``)."""
    wf = w[fold.long()]
    if beta is None:
        return wf, wf * y
    if glm is not None:
        return _glm_weights(beta @ X1.T, y, wf, *glm)
    mu = _sigmoid(beta @ X1.T)
    return torch.clamp_min(mu * (1.0 - mu), 1e-6) * wf, wf * (mu - y)


def weighted_gram_plain(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                        beta: Optional[torch.Tensor] = None, glm=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K-S: the row weights in float32, both
    products summed in float64 and rounded once, as the kernel's sums are."""
    v, u = _gram_weights(X1, y, w, fold, beta, glm)
    Xd = X1.double()
    H = torch.einsum("cn,np,nq->cpq", v.double(), Xd, Xd)
    return H.to(torch.float32), (u.double() @ Xd).to(torch.float32)


def weighted_gram(X1: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold: torch.Tensor,
                  beta: Optional[torch.Tensor] = None, glm=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H f32[C, p, p], g f32[C, p]) of C fits: ``H_c = X1^T diag(v_c) X1``
    and ``g_c = X1^T u_c`` with, given ``beta`` f32[C, p] (a Newton step),
    ``mu = sigmoid(X1 beta_c)``, ``v_c = max(mu (1 - mu), 1e-6) w_f`` and
    ``u_c = w_f (mu - y)``; without ``beta`` (ridge), ``v_c = w_f`` and
    ``u_c = w_f y``; given ``beta`` and ``glm = (family, link, vp f32[C])``
    (an IRLS step), the IRLS weights ``v_c`` and ``u_c = v_c z_c`` of
    ``_glm_weights``.  ``X1`` f32[n, p] (the features with the intercept
    column), ``y`` f32[n], ``w`` f32[F, n] the folds' row weights, ``fold``
    i32[C] each fit's fold.  At most ``GRAM_MAX_COEFS`` coefficients."""
    _check_gram(X1, y, w, fold, beta, glm)
    others = () if beta is None else (beta,)
    if glm is not None:
        others += (glm[2],)
    if not _on_cuda(X1, y, w, fold, *others):
        return weighted_gram_plain(X1, y, w, fold, beta, glm)
    n, p = X1.shape
    C = fold.shape[0]
    dev = X1.device
    X1, y, w, fold = X1.contiguous(), y.contiguous(), w.contiguous(), fold.contiguous()
    beta_t = X1 if beta is None else beta.contiguous()
    vp_t = X1 if glm is None else glm[2].contiguous()
    mode = 0 if beta is None else (1 if glm is None else 2)
    family, link = (0, 0) if glm is None else (_GLM_FAMILY_CODE[glm[0]], _GLM_LINK_CODE[glm[1]])
    E = p * (p + 1) // 2 + p
    if p > _GRAM_NARROW_COEFS:
        return _weighted_gram_wide(X1, y, w, fold, beta_t, vp_t, mode, family, link)
    ct = max(1, min(C, _GRAM_MAX_FITS, _GRAM_MAX_ENTRIES // E))
    tiles = -(-C // ct)
    chunk_rows = max(8 * 32, -(-n // max(_FISTA_TARGET_CHUNKS // tiles, 1)))
    chunk_rows = -(-chunk_rows // 32) * 32
    chunks = -(-n // chunk_rows)
    partial = torch.empty((chunks, C, E), dtype=torch.float64, device=dev)
    H = torch.empty((C, p, p), dtype=torch.float32, device=dev)
    g = torch.empty((C, p), dtype=torch.float32, device=dev)
    if n == 0:
        return H.zero_(), g.zero_()
    lib = cuda_build.load("weighted_gram", _GRAM_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.weighted_gram(X1.data_ptr(), y.data_ptr(), w.data_ptr(), fold.data_ptr(),
                               beta_t.data_ptr(), vp_t.data_ptr(), partial.data_ptr(),
                               H.data_ptr(), g.data_ptr(), n, p, C, ct, chunks, chunk_rows,
                               mode, family, link,
                               ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check_launch("weighted_gram", rc)
    weighted_gram.launches += 1
    return H, g


weighted_gram.launches = 0


def _weighted_gram_wide(X1, y, w, fold, beta_t, vp_t, mode, family, link):
    """K-S's wide entry (64 < p <= ``GRAM_MAX_COEFS``) on contiguous CUDA
    tensors: the prologue's float32 (v, u) widened into f64[C, n], then the
    float64 tensor-core tiles of ``gram_wide_plan``."""
    n, p = X1.shape
    C = fold.shape[0]
    dev = X1.device
    if n == 0:
        return (torch.zeros((C, p, p), dtype=torch.float32, device=dev),
                torch.zeros((C, p), dtype=torch.float32, device=dev))
    plan = gram_wide_plan(n, p, C)
    E = p * (p + 1) // 2 + p
    v = torch.empty((C, n), dtype=torch.float64, device=dev)
    u = torch.empty((C, n), dtype=torch.float64, device=dev)
    partial = torch.empty((plan.chunks, C, E), dtype=torch.float64, device=dev)
    H = torch.empty((C, p, p), dtype=torch.float32, device=dev)
    g = torch.empty((C, p), dtype=torch.float32, device=dev)
    lib = cuda_build.load("weighted_gram", _GRAM_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.weighted_gram_wide(X1.data_ptr(), y.data_ptr(), w.data_ptr(), fold.data_ptr(),
                                    beta_t.data_ptr(), vp_t.data_ptr(), v.data_ptr(),
                                    u.data_ptr(), partial.data_ptr(), H.data_ptr(),
                                    g.data_ptr(), n, p, C, plan.chunks, plan.chunk_rows, mode,
                                    family, link, plan.fits, plan.smem_bytes,
                                    ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check_launch("weighted_gram_wide", rc)
    weighted_gram.launches += 1
    return H, g


def _with_intercept(X: torch.Tensor, fit_intercept: bool) -> torch.Tensor:
    n = X.shape[0]
    X1 = torch.cat([X, torch.ones((n, 1), dtype=torch.float32, device=X.device)], 1) \
        if fit_intercept else X
    return X1.contiguous()


def _penalty(l2s, F: int, p: int, fit_intercept: bool, dev) -> torch.Tensor:
    """Each (fold, grid) fit's L2 penalty per coefficient f32[F G, p], the
    intercept's 0 (Spark's semantics)."""
    l2 = torch.as_tensor(np.asarray(l2s, np.float32).reshape(-1), device=dev)
    reg = l2.repeat(F)[:, None].expand(-1, p).clone()
    if fit_intercept:
        reg[:, -1] = 0.0
    return reg


def _split_beta(beta: torch.Tensor, F: int, G: int, fit_intercept: bool) -> LinearFit:
    beta = beta.reshape(F, G, -1)
    if fit_intercept:
        return LinearFit(beta[..., :-1].contiguous(), beta[..., -1:].contiguous())
    return LinearFit(beta, torch.zeros((F, G, 1), dtype=torch.float32, device=beta.device))


def fit_logistic_grid_folds_newton(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor,
                                   l2s, max_iter: int = 25,
                                   fit_intercept: bool = True) -> LinearFit:
    """Pure-L2 logistic fits for every (fold, grid) pair by full-batch
    Newton, on X's device: the reference's ``fit_logistic_newton`` for each
    fit, ``max_iter`` steps from 0, each solving ``(X1^T diag(w mu (1 - mu))
    X1 / sum(w) + diag(l2) + 1e-8 I) delta = X1^T (w (mu - y)) / sum(w) +
    l2 beta`` (the intercept unpenalized), the products by K-S for all fits
    at once.  Returns coef [F, G, d], intercept [F, G, 1]."""
    dev = X.device
    F = train_w.shape[0]
    G = int(np.asarray(l2s).size)
    X1 = _with_intercept(X.to(torch.float32), fit_intercept)
    p = X1.shape[1]
    w = train_w.to(dev, torch.float32).contiguous()
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    reg = _penalty(l2s, F, p, fit_intercept, dev)                             # [C, p]
    w_sum = torch.clamp_min(w.sum(1), 1e-12)[fold.long()]                     # [C]
    ridge = _ridge(reg, 1e-8)
    yd = y.to(dev, torch.float32).contiguous()
    beta = torch.zeros((F * G, p), dtype=torch.float32, device=dev)
    for _ in range(max_iter):
        H, g = weighted_gram(X1, yd, w, fold, beta)
        grad = g / w_sum[:, None] + reg * beta
        H = H.double() / w_sum.double()[:, None, None] + ridge
        beta = beta - torch.linalg.solve_ex(H, grad.double())[0].to(torch.float32)
    return _split_beta(beta, F, G, fit_intercept)


def _ridge(reg: torch.Tensor, eps: float) -> torch.Tensor:
    """``diag(reg) + eps I`` f64[..., p, p]: the solves' system is assembled
    and solved in float64.  K-S's Gram is rounded once from exact sums, so a
    one-hot pivot beside the intercept keeps it exactly singular in
    float32, and the reference's ``eps`` (1e-8, 1e-9) is below half an ulp
    of its diagonal there: only float64 keeps the system regular, as the
    reference's own float32 summation noise happens to keep its own."""
    p = reg.shape[-1]
    return torch.diag_embed(reg.double()) + eps * torch.eye(p, dtype=torch.float64,
                                                             device=reg.device)


def fit_ridge_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, l2s,
                         fit_intercept: bool = True) -> LinearFit:
    """Closed-form ridge fits for every (fold, grid) pair, on X's device: the
    reference's ``fit_ridge`` for each fit, ``(X1^T diag(w) X1 / sum(w) +
    diag(l2) + 1e-9 I) beta = X1^T (w y) / sum(w)`` (the intercept
    unpenalized); K-S forms each fold's products once (only the diagonal
    differs across the grid).  Returns coef [F, G, d], intercept [F, G, 1]."""
    dev = X.device
    F = train_w.shape[0]
    G = int(np.asarray(l2s).size)
    X1 = _with_intercept(X.to(torch.float32), fit_intercept)
    p = X1.shape[1]
    w = train_w.to(dev, torch.float32).contiguous()
    A, b = weighted_gram(X1, y.to(dev, torch.float32).contiguous(), w,
                         torch.arange(F, dtype=torch.int32, device=dev))
    w_sum = torch.clamp_min(w.sum(1), 1e-12).double()                         # [F]
    reg = _penalty(l2s, 1, p, fit_intercept, dev)                             # [G, p]
    A = (A.double() / w_sum[:, None, None])[:, None] + _ridge(reg, 1e-9)[None]
    b = (b.double() / w_sum[:, None])[:, None].expand(F, G, p)
    return _split_beta(torch.linalg.solve_ex(A, b)[0].to(torch.float32), F, G, fit_intercept)


def fit_logistic_newton(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor,
                        l2: float, max_iter: int = 25, fit_intercept: bool = True) -> LinearFit:
    """One L2 logistic fit by Newton: coef [d], intercept [1]."""
    fit = fit_logistic_grid_folds_newton(X, y, sample_weight[None], [l2], max_iter=max_iter,
                                         fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


def fit_ridge(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor, l2: float,
              fit_intercept: bool = True) -> LinearFit:
    """One closed-form ridge fit: coef [d], intercept [1]."""
    fit = fit_ridge_grid_folds(X, y, sample_weight[None], [l2], fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


# ---------------------------------------------------------------------------
# The GLM: IRLS on K-S (GLM mode)
# ---------------------------------------------------------------------------
_GLM_LINKS = {
    # link: (eta_of_mu, mu_of_eta, dmu_deta), the reference's float32 formulas
    "identity": (lambda mu: mu, lambda e: e, lambda e: torch.ones_like(e)),
    "log": (lambda mu: torch.log(torch.clamp_min(mu, 1e-10)),
            lambda e: torch.exp(torch.clamp(e, -30.0, 30.0)),
            lambda e: torch.exp(torch.clamp(e, -30.0, 30.0))),
    "logit": (lambda mu: torch.log(mu / (1.0 - mu)), _sigmoid,
              lambda e: _sigmoid(e) * (1.0 - _sigmoid(e))),
    "inverse": (lambda mu: 1.0 / torch.clamp_min(mu, 1e-10),
                lambda e: 1.0 / torch.clamp_min(e, 1e-10),
                lambda e: -1.0 / torch.clamp_min(e * e, 1e-10)),
    "sqrt": (lambda mu: torch.sqrt(torch.clamp_min(mu, 0.0)),
             lambda e: e * e, lambda e: 2.0 * e),
}

_GLM_VARIANCE = {
    "gaussian": lambda mu, p: torch.ones_like(mu),
    "binomial": lambda mu, p: torch.clamp_min(mu * (1.0 - mu), 1e-10),
    "poisson": lambda mu, p: torch.clamp_min(mu, 1e-10),
    "gamma": lambda mu, p: torch.clamp_min(mu * mu, 1e-10),
    "tweedie": lambda mu, p: torch.pow(torch.clamp_min(mu, 1e-10), p),
}

GLM_DEFAULT_LINK = {"gaussian": "identity", "binomial": "logit",
                    "poisson": "log", "gamma": "inverse", "tweedie": "log"}

#: the family and link codes of K-S's GLM mode (``csrc/weighted_gram.cu``)
_GLM_FAMILY_CODE = {"gaussian": 0, "binomial": 1, "poisson": 2, "gamma": 3, "tweedie": 4}
_GLM_LINK_CODE = {"identity": 0, "log": 1, "logit": 2, "inverse": 3, "sqrt": 4}


def _glm_weights(eta: torch.Tensor, y: torch.Tensor, wf: torch.Tensor, family: str, link: str,
                 vp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One IRLS step's row weights (v, u) f32[C, n] at the margins ``eta``
    [C, n]: ``v = w g^2 / var(mu)`` and ``u = v z`` with ``z = eta + (y -
    mu) / g`` (``g`` floored at 1e-10 in magnitude), the reference's float32
    operations in its order; ``vp`` f32[C] each fit's variance power."""
    _, mu_of, dmu = _GLM_LINKS[link]
    mu = mu_of(eta)
    if family == "binomial":
        mu = torch.clamp(mu, 1e-10, 1.0 - 1e-10)
    g = dmu(eta)
    z = eta + (y - mu) / torch.where(torch.abs(g) < 1e-10, torch.full_like(g, 1e-10), g)
    v = wf * g * g / _GLM_VARIANCE[family](mu, vp[:, None])
    return v, v * z


def fit_glm_grid_folds(X: torch.Tensor, y: torch.Tensor, train_w: torch.Tensor, l2s, vps,
                       family: str, link: str, max_iter: int = 25,
                       fit_intercept: bool = True) -> LinearFit:
    """IRLS GLM fits for every (fold, grid) pair of one (family, link), on
    X's device: the reference's ``fit_glm_irls`` for each fit, ``max_iter``
    steps (no tolerance test) from the fold's weighted mean response
    (clipped at 1e-6, and to [1e-6, 1 - 1e-6] for binomial) through the
    link, each solving ``(X1^T diag(v) X1 / sum(w) + diag(l2) + 1e-8 I) beta
    = X1^T (v z) / sum(w)`` (the intercept unpenalized), the products by
    K-S in GLM mode for all fits at once and the system in float64.
    ``l2s``, ``vps``: each grid point's L2 penalty and tweedie variance
    power.  Returns coef [F, G, d], intercept [F, G, 1]."""
    dev = X.device
    F = train_w.shape[0]
    G = int(np.asarray(l2s).size)
    X1 = _with_intercept(X.to(torch.float32), fit_intercept)
    p = X1.shape[1]
    w = train_w.to(dev, torch.float32).contiguous()
    yd = y.to(dev, torch.float32).contiguous()
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    reg = _penalty(l2s, F, p, fit_intercept, dev)                             # [C, p]
    vp = torch.as_tensor(np.asarray(vps, np.float32).reshape(-1), device=dev).repeat(F)
    w_fold = torch.clamp_min(w.sum(1), 1e-12)                                 # [F]
    beta = torch.zeros((F * G, p), dtype=torch.float32, device=dev)
    if fit_intercept:
        mu0 = torch.clamp_min((yd * w).sum(1) / w_fold, 1e-6)
        if family == "binomial":
            mu0 = torch.clamp(mu0, 1e-6, 1.0 - 1e-6)
        beta[:, -1] = _GLM_LINKS[link][0](mu0)[fold.long()]
    w_sum = w_fold.double()[fold.long()]                                      # [C]
    ridge = _ridge(reg, 1e-8)
    for _ in range(max_iter):
        H, g = weighted_gram(X1, yd, w, fold, beta, (family, link, vp))
        A = H.double() / w_sum[:, None, None] + ridge
        beta = torch.linalg.solve_ex(A, g.double() / w_sum[:, None])[0].to(torch.float32)
    return _split_beta(beta, F, G, fit_intercept)


def fit_glm_irls(X: torch.Tensor, y: torch.Tensor, sample_weight: torch.Tensor, l2: float,
                 family: str, link: str, max_iter: int = 25, fit_intercept: bool = True,
                 variance_power: float = 1.5) -> LinearFit:
    """One IRLS GLM fit (Spark's GeneralizedLinearRegression): coef [d],
    intercept [1]."""
    fit = fit_glm_grid_folds(X, y, sample_weight[None], [l2], [variance_power], family, link,
                             max_iter=max_iter, fit_intercept=fit_intercept)
    return LinearFit(fit.coef[0, 0], fit.intercept[0, 0])


def predict_glm(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor, link: str
                ) -> torch.Tensor:
    """The GLM's mean response f32[n]: the link's inverse of ``X @ coef +
    intercept[0]``."""
    return _GLM_LINKS[link][1](X @ coef + intercept[0])


def predict_glm_grid(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor, link: str
                     ) -> torch.Tensor:
    """Every (fold, grid) fit's mean response [F, G, n] from coef [F, G, d],
    intercept [F, G, 1]."""
    eta = torch.einsum("nd,fgd->fgn", X, coef) + intercept[..., :1]
    return _GLM_LINKS[link][1](eta)


def predict_linear(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                   ) -> torch.Tensor:
    """The linear prediction f32[n]: ``X @ coef + intercept[0]``."""
    return X @ coef + intercept[0]


def predict_binary_logistic_grid(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every (fold, grid) fit's (raw [F, G, n, 2], prob [F, G, n, 2], pred
    [F, G, n]) from coef [F, G, d], intercept [F, G, 1]."""
    z = torch.einsum("nd,fgd->fgn", X, coef) + intercept
    p1 = _sigmoid(z)
    raw = torch.stack([-z, z], dim=-1)
    prob = torch.stack([1.0 - p1, p1], dim=-1)
    return raw, prob, (p1 >= 0.5).to(torch.float32)


def predict_binary_logistic(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(raw [n, 2], prob [n, 2], pred [n]) matching the reference's
    Prediction schema (rawPrediction_*, probability_*, prediction)."""
    z = X @ coef + intercept[0]
    p1 = torch.sigmoid(z)
    raw = torch.stack([-z, z], dim=-1)
    prob = torch.stack([1.0 - p1, p1], dim=-1)
    pred = (p1 >= 0.5).to(torch.float32)
    return raw, prob, pred


def predict_softmax_grid(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every (fold, grid) fit's (raw [F, G, n, k], prob [F, G, n, k], pred
    [F, G, n]) from coef [F, G, d, k], intercept [F, G, k]; the softmax as
    the reference's ``jax.nn.softmax`` writes it."""
    z = torch.einsum("nd,fgdk->fgnk", X, coef) + intercept[:, :, None, :]
    return z, _softmax(z), torch.argmax(z, dim=-1).to(torch.float32)


def predict_softmax(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(raw [n, k], prob [n, k], pred [n]) of a multinomial fit."""
    z = X @ coef + intercept
    prob = torch.softmax(z, dim=-1)
    pred = torch.argmax(z, dim=-1).to(torch.float32)
    return z, prob, pred


# ---------------------------------------------------------------------------
# K-AF predict_head
# ---------------------------------------------------------------------------
#: the heads K-AF computes, in ``csrc/predict_head.cu``'s order
HEAD_MODES = ("binary", "softmax", "linear")
#: the most classes K-AF's softmax mode takes: the softmax fits' bound
HEAD_MAX_CLASSES = SOFTMAX_MAX_CLASSES
_HEAD_SIGNATURES = {"predict_head_f32": ([ctypes.c_void_p] * 6
                                         + [ctypes.c_longlong] + [ctypes.c_int] * 7
                                         + [ctypes.c_void_p], ctypes.c_int)}
#: K-AF's entries (``csrc/predict_head.cu``): the softmax head a warp a row;
#: the dot heads a row on a lane group (up to ``HEAD_NARROW_MAX``
#: coefficients), past that four quarters of a row over 1, 2 or 4 warps
HEAD_ENTRIES = ("softmax", "lane_groups", "quarters")
# the constants of csrc/predict_head.cu: warps a block, the quarters a dot
# head's row is cut into, the lane groups' widest row and the most row sets
# a warp keeps in flight
HEAD_WARPS = 8
HEAD_QUARTERS = 4
HEAD_NARROW_MAX = 32
HEAD_GROUP_BATCHES = 4
#: the dot heads' blocks an SM at most (past them the rows are grid-strided)
_HEAD_BLOCKS_PER_SM = 8
#: the softmax head's blocks, at most
_HEAD_SOFTMAX_BLOCKS = 4096


class HeadPlan(NamedTuple):
    """The launch of K-AF over n rows (``head_plan``)."""

    entry: str            # one of ``HEAD_ENTRIES``
    split: int            # lanes a row (lane groups), warps a row (quarters), 1 (softmax)
    batches: int          # the lane groups' row sets a warp at once (else 1)
    rows_per_block: int   # rows a block takes at a time
    blocks: int


def head_plan(n: int, p: int, k: int, sm_count: int, mode: str = "binary") -> HeadPlan:
    """K-AF's launch for ``mode`` over X [n, p] (k classes in the softmax
    mode): the softmax head a warp a row; a dot head (binary, linear) at 1
    to ``HEAD_NARROW_MAX`` coefficients a warp a row while that fills no
    more than the card's blocks, past that a row on the fewest lanes (a
    power of two) that hold it, 32 / lanes rows a warp, in 4 sets at once
    (at 32 lanes only where one set a warp would more than fill them; the
    sums are the same on any lanes: the lanes past p add 0); past 32
    coefficients its quarters over 2 or 4 warps a row while the rows alone
    leave the card's ``sm_count`` SMs short of a block each and each warp
    keeps at least two 4-coefficient chunks a lane, 8 / warps rows a block;
    at most 8 blocks an SM, the rows grid-strided past them.  The entry and
    a row's sums hang on p alone."""
    if mode not in HEAD_MODES:
        raise ValueError(f"unknown head mode {mode!r}: one of {HEAD_MODES}")
    if n < 1 or p < 0 or k < 1 or sm_count < 1:
        raise ValueError("head_plan takes n >= 1, p >= 0, k >= 1 and sm_count >= 1")
    if mode == "softmax":
        return HeadPlan("softmax", 1, 1, HEAD_WARPS, min(-(-n // HEAD_WARPS), _HEAD_SOFTMAX_BLOCKS))
    if 1 <= p <= HEAD_NARROW_MAX:
        cap = sm_count * _HEAD_BLOCKS_PER_SM
        # a warp a row while that fills no more than the card's blocks
        lanes = 32 if n <= HEAD_WARPS * cap else 1 << (p - 1).bit_length()
        rows = HEAD_WARPS * (32 // lanes)
        batches = HEAD_GROUP_BATCHES if lanes < 32 or n > rows * cap else 1
        rows *= batches
        return HeadPlan("lane_groups", lanes, batches, rows, min(-(-n // rows), cap))
    chunks = -(-p // 4)
    warps = 1
    while (warps < HEAD_QUARTERS and n * warps < sm_count * HEAD_WARPS
           and chunks >= 2 * 32 * 2 * warps):
        warps *= 2
    rows = HEAD_WARPS // warps
    return HeadPlan("quarters", warps, 1, rows, min(-(-n // rows), sm_count * _HEAD_BLOCKS_PER_SM))


_SM_COUNTS: dict = {}


def _sm_count(device: torch.device) -> int:
    """The card's SMs, read once a device (before any graph capture: the
    head's first call is a bucket's eager warm-up)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


def predict_head_plain(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor,
                       mode: str) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                           Optional[torch.Tensor]]:
    """Plain PyTorch version of K-AF: ``predict_binary_logistic``,
    ``predict_softmax`` or ``predict_linear`` as (pred, raw, prob)."""
    if mode == "linear":
        return predict_linear(X, coef, intercept), None, None
    predict = predict_softmax if mode == "softmax" else predict_binary_logistic
    raw, prob, pred = predict(X, coef, intercept)
    return pred, raw, prob


def _check_head(X, coef, intercept, mode):
    if mode not in HEAD_MODES:
        raise ValueError(f"unknown head mode {mode!r}: one of {HEAD_MODES}")
    if X.dtype != torch.float32 or X.ndim != 2:
        raise ValueError("X must be float32[n, p]")
    p = X.shape[1]
    if mode == "softmax":
        if coef.ndim != 2 or coef.shape[0] != p:
            raise ValueError(f"coef must be float32[{p}, k]")
        k = coef.shape[1]
        if not 1 <= k <= HEAD_MAX_CLASSES:
            raise ValueError(f"predict_head takes 1 to {HEAD_MAX_CLASSES} classes, got {k}")
        shapes = (("coef", coef, (p, k)), ("intercept", intercept, (k,)))
    else:
        shapes = (("coef", coef, (p,)), ("intercept", intercept, (intercept.numel(),)))
        if intercept.numel() < 1:
            raise ValueError("intercept must hold at least one value")
    for name, a, shape in shapes:
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}")


def predict_head(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor, mode: str
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """A linear family's prediction head in one launch: (pred f32[n], raw
    f32[n, k'] | None, prob f32[n, k'] | None) of ``X`` f32[n, p].

    ``binary``: coef f32[p], intercept f32[1]: raw [-z, z], prob [1 - s, s]
    (s the sigmoid of z = X coef + intercept[0]), pred s >= 0.5.
    ``softmax``: coef f32[p, k], intercept f32[k] (k <= ``HEAD_MAX_CLASSES``):
    raw z, prob the softmax of z, pred its first arg-max.  ``linear``: coef
    f32[p], intercept f32[1..]: pred ``X coef + intercept[0]``, no raw or
    prob.  On the card one launch of ``head_plan``; a row's answer does not
    depend on the plan, the batch or X's alignment."""
    _check_head(X, coef, intercept, mode)
    if not _on_cuda(X, coef, intercept):
        return predict_head_plain(X, coef, intercept, mode)
    X, coef, intercept = X.contiguous(), coef.contiguous(), intercept.contiguous()
    n, p = X.shape
    k = coef.shape[1] if mode == "softmax" else 1
    width = 2 if mode == "binary" else k
    pred = torch.empty(n, dtype=torch.float32, device=X.device)
    raw = prob = None
    if mode != "linear":
        raw = torch.empty((n, width), dtype=torch.float32, device=X.device)
        prob = torch.empty((n, width), dtype=torch.float32, device=X.device)
    if n == 0:
        return pred, raw, prob
    plan = head_plan(n, p, k, _sm_count(X.device), mode)
    lib = cuda_build.load("predict_head", _HEAD_SIGNATURES)
    with torch.cuda.device(X.device):
        rc = lib.predict_head_f32(X.data_ptr(), coef.data_ptr(), intercept.data_ptr(),
                                  pred.data_ptr(), None if raw is None else raw.data_ptr(),
                                  None if prob is None else prob.data_ptr(), n, p, k,
                                  HEAD_MODES.index(mode), HEAD_ENTRIES.index(plan.entry),
                                  plan.split, plan.batches, plan.blocks,
                                  ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream))
    cuda_build.check_launch("predict_head", rc)
    predict_head.launches += 1
    return pred, raw, prob


predict_head.launches = 0
