"""The sanity checker's column statistics on the device: the correlation
matrix (K-I), the contingency counts (K-J), and the streamed statistics'
chunk moments (K-X), centered Gram (K-I centered mode) and midranks (K-Y).

Replace the two jit'd products of ``transmogrifai_tpu/utils/stats.py``:

- ``corr_gram`` (K-I) — ``_corr_matrix_kernel`` (:47): ``Z^T Z / max(n-1, 1)``
  of the standardized columns Z f32[n, d].
- ``contingency_counts`` (K-J) — ``_contingency_kernel`` (:137):
  ``X^T onehot(y)`` of the indicator columns X f32[n, d] against the label
  classes y i32[n], without building the one-hot (a class outside
  [0, n_classes) adds to no column).

and the device programs of ``transmogrifai_tpu/parallel/stats.py``:

- ``chunk_moments`` (K-X, ``csrc/stream_stats.cu``) — ``_moments_step`` (:48)
  in raw mode (sum, sum of squares, min, max of each column of a chunk),
  and the moments of ``_fused_stats_step`` (:190) and ``_chan_moments_step``
  (:230) in Chan mode (the chunk's mean, centered sum of squares, min, max);
  float64 out.
- ``centered_gram`` (K-I centered mode) — ``_gram_step`` (:62) and the Gram
  of ``_fused_stats_step``: ``Z^T Z`` of ``Z = [X | y] - centers``, float64.
- ``midranks`` (K-Y, ``csrc/stream_stats.cu``) — ``_midrank_cols`` (:487):
  each column's average-tie midranks (1-based), float32; ``torch.sort``
  sorts the columns, the kernel finds the tie runs and writes each rank
  through the permutation by the route of ``midrank_plan``.

All are CUDA, with fixed-order partial sums, so runs repeat bit for bit (K-Y's
partition route places its items through atomic cursors, in a free order,
and each rank once by its row); K-I's launches (both modes) are planned by
``gram_plan``.  The
plain PyTorch version of each sits beside it; a wrapper takes it only for
CPU tensors, and for CUDA tensors launches its kernel or raises.
``<wrapper>.launches`` counts the wrapper's launches, and
``chunk_moments.launches_by_mode`` those of its ``raw`` and ``chan`` modes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build
from .linear import _aligned16
from .trees import _require, _stream

_SIGNATURES = {
    "col_products_chunks": ([ctypes.c_int] * 3, ctypes.c_int),
    "centered_gram_f64": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
                          ctypes.c_int),
    "corr_gram_f32": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                     ctypes.c_void_p],
                      ctypes.c_int),
    "contingency_counts_f32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                               ctypes.c_int),
}
_STREAM_SIGNATURES = {
    "chunk_moments_chunks": ([ctypes.c_int] * 2, ctypes.c_int),
    "chunk_moments_f64": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                          ctypes.c_int),
    "midranks_f32": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "midranks_f64": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}
#: K-X's modes: the raw sums of ``_moments_step``, Chan's centered moments
MOMENT_MODES = ("raw", "chan")


def _denominator(n: int) -> float:
    return float(max(n - 1, 1))


# ---------------------------------------------------------------------------
# K-I's launch plan
# ---------------------------------------------------------------------------
#: K-I's modes: the correlation matrix (float32 products) and the centered
#: Gram (float64)
GRAM_MODES = ("corr", "centered")
#: the widest Gram (D columns) of the narrow entry: one 64-column tile
GRAM_NARROW_MAX = 64
# the constants of csrc/col_stats.cu: the CUDA-core pass's tile side, staged
# rows and most threads a block; the tensor-core pass's tile side, slab rows
# and threads
_NARROW_TILE = 64
_NARROW_ROWS = 64        # past 64 columns (two raw stages)
_NARROW_SPAN_ROWS = 128  # at D <= 64 (four raw stages)
_NARROW_THREADS = 256
_WIDE_TILE = 128
_WIDE_SLAB = 32
_WIDE_THREADS = 512
_WIDE_SMEM = 2 * (_WIDE_SLAB * 2 * _WIDE_TILE + _WIDE_SLAB) * 4 \
    + 2 * 2 * _WIDE_SLAB * (_WIDE_TILE + 4) * 8
_SMS = 132
#: blocks a launch aims at: the CUDA-core pass one or two waves of its
#: small blocks, the tensor-core pass (one block an SM) eight waves
_NARROW_TARGET_BLOCKS = 2 * _SMS
_WIDE_TARGET_BLOCKS = 8 * _SMS
#: the float64 partials' budget (a chunk's is the whole packed triangle)
_GRAM_PARTIAL_BYTES = 1 << 30
#: the finish's threads, at least, where the chunks allow (lanes a cell)
_FINISH_THREADS = 1 << 16


class GramPlan(NamedTuple):
    """The launch of K-I over [n, d] (``gram_plan``)."""

    entry: str            # "narrow": D <= 64, one diagonal tile; "wide" above
    tensor_cores: bool    # the float64 mma.sync pass (the centered mode past 64)
    D: int                # the Gram's columns: d, or d + 1 with the label
    tile: int             # the side of a column tile
    tiles: int            # column tiles (of the d features on the tensor cores)
    pairs: int            # tile pairs ti <= tj (blocks a chunk)
    threads: int          # threads a block
    rows: int             # rows a staged row tile (slab)
    chunk_rows: int       # rows a chunk (a multiple of ``rows``)
    chunks: int
    cells: int            # D (D + 1) / 2: the packed upper triangle
    lanes: int            # the finish's lanes a cell (a power of two, at most 32)
    partial_bytes: int    # the chunks' float64 partials of the cells
    smem_bytes: int       # dynamic shared bytes a block


def _narrow_smem(d: int, D: int, rows: int, threads: int, span: bool, esize: int,
                 centered: bool) -> int:
    """The CUDA-core pass's dynamic shared bytes (``narrow_smem``): the
    operands [rows][width + 4] or, after the last row tile, the splits'
    float64 sums [16][threads], whichever is larger; then the raw stages (four
    at D <= 64, two past it)."""
    width = -(-D // 4) * 4 if span else 2 * _NARROW_TILE
    union = -(-max(rows * (width + 4) * esize, threads * 16 * 8) // 16) * 16
    raw = (-(-(rows * d) // 4) * 4 + (rows if centered else 0)) if span \
        else rows * 2 * _NARROW_TILE
    return union + (4 if span else 2) * raw * 4


def narrow_micro_tiles(D: int, ti: int, tj: int) -> int:
    """The 4 x 4 micro-tiles of the CUDA-core pass's tile pair (ti, tj):
    those on and above the diagonal of a diagonal pair, all of an
    off-diagonal one."""
    ma = -(-min(_NARROW_TILE, D - ti * _NARROW_TILE) // 4)
    mb = -(-min(_NARROW_TILE, D - tj * _NARROW_TILE) // 4)
    return ma * (ma + 1) // 2 if ti == tj else ma * mb


def gram_plan(n: int, d: int, mode: str) -> GramPlan:
    """The launch of K-I's ``mode`` (``GRAM_MODES``) over n rows of d
    columns (and the label in the centered mode): the entry, the column
    tiles and their upper-triangle pairs, the threads, the row chunks (one
    or two waves of the CUDA-core pass's blocks, eight of the tensor-core
    pass's, within the partial budget) and the finish's lanes a cell (enough
    threads to fill the card, at most one a chunk)."""
    _require(mode in GRAM_MODES, f"mode must be one of {GRAM_MODES}, got {mode!r}")
    _require(n >= 1 and d >= 0, "gram_plan takes n >= 1 rows")
    D = d + (mode == "centered")
    _require(D >= 1, "gram_plan takes d >= 1 columns")
    wide = D > GRAM_NARROW_MAX
    tensor_cores = wide and mode == "centered"
    if tensor_cores:
        tile, rows, threads, target = _WIDE_TILE, _WIDE_SLAB, _WIDE_THREADS, _WIDE_TARGET_BLOCKS
    else:
        tile, target = _NARROW_TILE, _NARROW_TARGET_BLOCKS
        rows = _NARROW_ROWS if wide else _NARROW_SPAN_ROWS
        if wide:
            threads = _NARROW_THREADS
        else:  # the splits of a row tile: as many as fit 256 threads, 4 rows each at least
            mt = narrow_micro_tiles(D, 0, 0)
            splits = max(1, min(_NARROW_THREADS // mt, rows // 4))
            threads = -(-(mt * splits) // 32) * 32
    # the tensor-core pass tiles the d feature columns; its diagonal blocks'
    # idle warps take the label's column
    tiles = -(-(d if tensor_cores else D) // tile)
    pairs = tiles * (tiles + 1) // 2
    cells = D * (D + 1) // 2
    want = -(-target // pairs)
    budget = max(1, _GRAM_PARTIAL_BYTES // (cells * 8))
    chunks = max(1, min(want, budget, -(-n // rows), 65535))
    chunk_rows = -(-(-(-n // chunks)) // rows) * rows
    chunks = -(-n // chunk_rows)
    lanes = 1
    while lanes < 32 and 2 * lanes <= chunks and cells * lanes < _FINISH_THREADS:
        lanes *= 2
    smem = _WIDE_SMEM if tensor_cores else _narrow_smem(
        d, D, rows, threads, tiles == 1, 8 if mode == "centered" else 4, mode == "centered")
    return GramPlan("wide" if wide else "narrow", tensor_cores, D, tile, tiles, pairs, threads,
                    rows, chunk_rows, chunks, cells, lanes, chunks * cells * 8, smem)


# ---------------------------------------------------------------------------
# K-I corr_gram
# ---------------------------------------------------------------------------
def corr_gram_plain(Z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-I."""
    return (Z.T @ Z) / _denominator(Z.shape[0])


def corr_gram(Z: torch.Tensor) -> torch.Tensor:
    """The correlation matrix f32[d, d] of standardized columns Z f32[n, d]:
    ``Z^T Z / max(n - 1, 1)``, summed in float32 within a row tile and in
    float64 across tiles, rounded once and divided in float32; on the card
    one launch of ``gram_plan(n, d, "corr")`` and its finish."""
    _require(Z.dtype == torch.float32 and Z.ndim == 2, "Z must be float32[n, d]")
    n, d = Z.shape
    if not _on_cuda(Z):
        return corr_gram_plain(Z)
    if n == 0 or d == 0:
        return torch.zeros((d, d), dtype=torch.float32, device=Z.device)
    plan = gram_plan(n, d, "corr")
    lib = cuda_build.load("col_stats", _SIGNATURES)
    Z = _aligned16(Z.contiguous())
    partial = torch.empty(plan.partial_bytes // 8, dtype=torch.float64, device=Z.device)
    out = torch.empty((d, d), dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = lib.corr_gram_f32(Z.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d,
                               plan.tiles, plan.chunk_rows, plan.chunks, plan.lanes,
                               plan.threads, plan.rows, plan.smem_bytes, _denominator(n),
                               _stream(Z))
    cuda_build.check_launch("corr_gram", rc)
    corr_gram.launches += 1
    return out


corr_gram.launches = 0


# ---------------------------------------------------------------------------
# K-J contingency_counts
# ---------------------------------------------------------------------------
def contingency_counts_plain(X: torch.Tensor, cls: torch.Tensor, n_classes: int
                             ) -> torch.Tensor:
    """Plain PyTorch version of K-J."""
    onehot = cls.long()[:, None] == torch.arange(n_classes, device=X.device)[None]
    return X.T @ onehot.to(torch.float32)


def contingency_counts(X: torch.Tensor, cls: torch.Tensor, n_classes: int) -> torch.Tensor:
    """``counts[j, k] = sum_i X[i, j] * (cls[i] == k)`` as f32[d, n_classes]
    for the columns X f32[n, d] and the label classes cls i32[n]."""
    _require(X.dtype == torch.float32 and X.ndim == 2, "X must be float32[n, d]")
    n, d = X.shape
    _require(cls.dtype == torch.int32 and tuple(cls.shape) == (n,), f"cls must be int32[{n}]")
    _require(n_classes >= 1, "need n_classes >= 1")
    if not _on_cuda(X, cls):
        return contingency_counts_plain(X, cls, n_classes)
    if n == 0 or d == 0:
        return torch.zeros((d, n_classes), dtype=torch.float32, device=X.device)
    lib = cuda_build.load("col_stats", _SIGNATURES)
    X, cls = X.contiguous(), cls.contiguous()
    partial = torch.empty((lib.col_products_chunks(n, d, n_classes), d, n_classes),
                          dtype=torch.float32, device=X.device)
    out = torch.empty((d, n_classes), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        rc = lib.contingency_counts_f32(X.data_ptr(), cls.data_ptr(), partial.data_ptr(),
                                        out.data_ptr(), n, d, n_classes, _stream(X))
    cuda_build.check_launch("contingency_counts", rc)
    contingency_counts.launches += 1
    return out


contingency_counts.launches = 0


# ---------------------------------------------------------------------------
# K-X chunk_moments
# ---------------------------------------------------------------------------
def _with_label(X: torch.Tensor, y) -> torch.Tensor:
    return X if y is None else torch.cat([X, y[:, None]], 1)


def chunk_moments_plain(X: torch.Tensor, y=None, mode: str = "chan") -> torch.Tensor:
    """Plain PyTorch version of K-X."""
    Z = _with_label(X, y).to(torch.float64)
    if mode == "raw":
        first, second = Z.sum(0), (Z * Z).sum(0)
    else:
        first = Z.mean(0)
        second = ((Z - first) ** 2).sum(0)
    return torch.stack([first, second, Z.amin(0), Z.amax(0)])


def _check_chunk(X: torch.Tensor, y) -> None:
    _require(X.dtype == torch.float32 and X.ndim == 2 and X.shape[0] > 0,
             "X must be float32[rows, d] with rows > 0")
    _require(y is None or (y.dtype == torch.float32 and tuple(y.shape) == (X.shape[0],)),
             f"y must be float32[{X.shape[0]}]")


def chunk_moments(X: torch.Tensor, y=None, mode: str = "chan") -> torch.Tensor:
    """The column moments f64[4, d'] of one row chunk [X | y] (X f32[rows,
    d], the label y f32[rows] or None; d' = d + 1 with a label): in ``raw``
    mode each column's sum, sum of squares, min and max, in ``chan`` mode
    its mean, centered sum of squares, min and max.  The count is the
    chunk's rows."""
    _require(mode in MOMENT_MODES, f"mode must be one of {MOMENT_MODES}, got {mode!r}")
    _check_chunk(X, y)
    if not _on_cuda(*(t for t in (X, y) if t is not None)):
        return chunk_moments_plain(X, y, mode)
    n, d = X.shape
    dc = d + (y is not None)
    lib = cuda_build.load("stream_stats", _STREAM_SIGNATURES)
    X = X.contiguous()
    y = None if y is None else y.contiguous()
    partial = torch.empty((4, lib.chunk_moments_chunks(n, dc), dc), dtype=torch.float64,
                          device=X.device)
    out = torch.empty((4, dc), dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        rc = lib.chunk_moments_f64(X.data_ptr(), None if y is None else y.data_ptr(),
                                   partial.data_ptr(), out.data_ptr(), n, d, dc,
                                   int(mode == "chan"), _stream(X))
    cuda_build.check_launch("chunk_moments", rc)
    chunk_moments.launches += 1
    chunk_moments.launches_by_mode[mode] += 1
    return out


chunk_moments.launches = 0
chunk_moments.launches_by_mode = dict.fromkeys(MOMENT_MODES, 0)


# ---------------------------------------------------------------------------
# K-I centered_gram
# ---------------------------------------------------------------------------
def centered_gram_plain(X: torch.Tensor, y: torch.Tensor, centers: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of K-I's centered mode."""
    Z = _with_label(X, y).to(torch.float64) - centers
    return Z.T @ Z


def centered_gram(X: torch.Tensor, y: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The unscaled Gram f64[d + 1, d + 1] of the centered chunk ``Z = [X | y]
    - centers`` (X f32[rows, d], y f32[rows], centers f64[d + 1]): the
    feature Gram, the label cross terms (last column) and the label's sum
    of squares (last entry).  On the card one launch of ``gram_plan(rows,
    d, "centered")`` (the float64 tensor cores past 64 columns) and its
    finish."""
    _check_chunk(X, y)
    _require(y is not None, "centered_gram takes the label y")
    d = X.shape[1]
    _require(centers.dtype == torch.float64 and tuple(centers.shape) == (d + 1,),
             f"centers must be float64[{d + 1}]")
    if not _on_cuda(X, y, centers):
        return centered_gram_plain(X, y, centers)
    n = X.shape[0]
    plan = gram_plan(n, d, "centered")
    lib = cuda_build.load("col_stats", _SIGNATURES)
    X, y, centers = _aligned16(X.contiguous()), _aligned16(y.contiguous()), centers.contiguous()
    partial = torch.empty(plan.partial_bytes // 8, dtype=torch.float64, device=X.device)
    out = torch.empty((d + 1, d + 1), dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        rc = lib.centered_gram_f64(X.data_ptr(), y.data_ptr(), centers.data_ptr(),
                                   partial.data_ptr(), out.data_ptr(), n, d,
                                   int(plan.tensor_cores), plan.tiles, plan.chunk_rows,
                                   plan.chunks, plan.lanes, plan.threads, plan.rows,
                                   plan.smem_bytes, _stream(X))
    cuda_build.check_launch("centered_gram", rc)
    centered_gram.launches += 1
    return out


centered_gram.launches = 0


# ---------------------------------------------------------------------------
# K-Y midranks
# ---------------------------------------------------------------------------
#: the routes of K-Y's ranks (``csrc/stream_stats.cu``): straight to the
#: output; through row buckets (a block's items sorted by bucket in shared
#: memory, written as runs, then each bucket placed in shared memory and
#: written as whole rows of 8-column groups)
MIDRANK_ROUTES = ("direct", "partition")
# the constants of csrc/stream_stats.cu: positions a direct block (8 warps
# of 8 32-position steps); the partition's positions a column a block (one
# warp's), its column group, rows a bucket and most buckets
RANK_SEG = 2048
RANK_WARP_SPAN = 256
PART_SPAN = 1024
PART_WARP_SPAN = 1024
PART_GROUP_COLS = 8
PART_BUCKET_ROWS = 2048
PART_MAX_BUCKETS = 1024
#: the widest output the direct route writes below the partition's bucket
#: limit, between the sides timed on the H100 (``kernel_turns.py --set
#: ranks``): the direct route ahead on the sanity checker's 100,000 x 24
#: (9.6 MB, its random writes merging in L2), the partition on tie-heavy
#: [2^20, 4] (16.8 MB) and on every wider output
MIDRANK_DIRECT_BYTES = 12 << 20


class MidrankPlan(NamedTuple):
    """The launch of K-Y over k sorted columns of n rows into out f32[n,
    ld] (``midrank_plan``)."""

    route: str          # one of ``MIDRANK_ROUTES``
    segments: int       # ranking blocks a column (a column group, partition)
    groups: int         # the partition's 8-column groups (else 0)
    buckets: int        # its row buckets (else 0)
    scratch_bytes: int  # the buckets' 8-byte items (partition; else 0)
    cursors: int        # int32 cursors, one a (group, bucket) (partition)


def midrank_plan(n: int, k: int, ld: int, route: Optional[str] = None) -> MidrankPlan:
    """K-Y's route over [n, k] into an output of leading dimension ld:
    direct where the output's span fits ``MIDRANK_DIRECT_BYTES`` or the rows
    pass the partition's ``PART_MAX_BUCKETS`` buckets (2^21 rows); else the
    partition.  ``route`` asks for one route (to time both on one shape);
    the partition takes at most 2^21 rows."""
    _require(n >= 1 and k >= 1 and ld >= k, "midrank_plan takes n, k >= 1 and ld >= k")
    buckets = -(-n // PART_BUCKET_ROWS)
    if route is None:
        direct = n * ld * 4 <= MIDRANK_DIRECT_BYTES or buckets > PART_MAX_BUCKETS
        route = "direct" if direct else "partition"
    _require(route in MIDRANK_ROUTES, f"route must be one of {MIDRANK_ROUTES}")
    if route == "direct":
        return MidrankPlan("direct", -(-n // RANK_SEG), 0, 0, 0, 0)
    _require(buckets <= PART_MAX_BUCKETS,
             f"the partition takes at most {PART_MAX_BUCKETS * PART_BUCKET_ROWS} rows")
    groups = -(-k // PART_GROUP_COLS)
    return MidrankPlan("partition", -(-n // PART_SPAN), groups, buckets,
                       groups * buckets * PART_BUCKET_ROWS * PART_GROUP_COLS * 8,
                       groups * buckets)


def _sorted_columns(X: torch.Tensor):
    """(values [k, n], their rows [k, n]) of each column of X [n, k] sorted."""
    return torch.sort(X.T.contiguous(), dim=1)


def midranks_plain(X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-Y: the reference's sort, two searchsorteds
    and scatter."""
    ss, order = _sorted_columns(X)
    lo = torch.searchsorted(ss, ss, right=False)
    hi = torch.searchsorted(ss, ss, right=True)
    mid = (lo + hi + 1).to(torch.float32) * 0.5
    return torch.empty_like(mid).scatter_(1, order, mid).T.contiguous()


def _check_out(out, X: torch.Tensor) -> None:
    n, k = X.shape
    _require(out.dtype == torch.float32 and tuple(out.shape) == (n, k)
             and out.device == X.device and (n <= 1 or out.stride(1) == 1)
             and out.stride(0) >= k,
             f"out must be float32[{n}, {k}] on {X.device} with unit column stride")


def midranks(X: torch.Tensor, out=None) -> torch.Tensor:
    """The average-tie midranks (1-based) f32[n, k] of each column of X
    f32 or f64[n, k], as ``_midrank_cols``: exact below 2^23 rows.  With
    ``out`` (f32[n, k], rows ``out.stride(0)`` apart: a slice of a wider
    matrix) the ranks are written there and ``out`` is returned."""
    _require(X.dtype in (torch.float32, torch.float64) and X.ndim == 2,
             "X must be float32 or float64[n, k]")
    n, k = X.shape
    _require(n < (1 << 30), "midranks takes fewer than 2^30 rows")
    if out is not None:
        _check_out(out, X)
    if not _on_cuda(X):
        ranks = midranks_plain(X)
        return ranks if out is None else out.copy_(ranks)
    if out is None:
        out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    if n == 0 or k == 0:
        return out
    ss, order = _sorted_columns(X)
    _midrank_launch(ss, order, out)
    return out


def _midrank_launch(ss: torch.Tensor, order: torch.Tensor, out: torch.Tensor,
                    route: Optional[str] = None) -> None:
    """K-Y on sorted columns ss [k, n] and their rows order i64[k, n], into
    out f32[n, k] (rows ``out.stride(0)`` apart; every entry written), by
    ``midrank_plan``'s route or by ``route``."""
    k, n = ss.shape
    ld = out.stride(0) if n > 1 else k
    plan = midrank_plan(n, k, ld, route)
    lib = cuda_build.load("stream_stats", _STREAM_SIGNATURES)
    scratch = cursors = None
    if plan.scratch_bytes:
        scratch = torch.empty(-(-plan.scratch_bytes // 8), dtype=torch.int64, device=ss.device)
    if plan.cursors:
        cursors = torch.empty(plan.cursors, dtype=torch.int32, device=ss.device)
    fn = lib.midranks_f32 if ss.dtype == torch.float32 else lib.midranks_f64
    with torch.cuda.device(ss.device):
        rc = fn(ss.data_ptr(), order.data_ptr(), None if scratch is None else scratch.data_ptr(),
                None if cursors is None else cursors.data_ptr(), out.data_ptr(), n, k, ld,
                MIDRANK_ROUTES.index(plan.route), _stream(ss))
    cuda_build.check_launch("midranks", rc)
    midranks.launches += 1


midranks.launches = 0
