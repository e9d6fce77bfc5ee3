"""Tree-ensemble scoring on the device: binning (K-A) and the walk (K-B).

The port's counterpart of the scoring half of ``transmogrifai_tpu/ops/trees.py``:
``Tree``, ``_bin_dtype``, ``bin_with_edges``, ``predict_tree``,
``predict_forest`` and ``predict_gbt``.  Training (``sketch_edges``,
``quantize``, the growers and boosting) is not ported.

Two hand-written CUDA kernels carry the path (sources in ``csrc/``):

- ``bin_rows`` replaces ``_bin_chunk``: per-feature left searchsorted of a
  float32 matrix into the fitted quantile edges.
- ``ensemble_walk`` replaces ``predict_tree`` under ``predict_gbt`` /
  ``predict_forest``: a ``max_depth``-step pointer walk per (row, tree) and
  the sum (``base + eta * sum``) or mean over trees.

Each kernel has a plain PyTorch version of the same signature beside it.  A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``<wrapper>.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build


class Tree(NamedTuple):
    """Trees as flat node pools on one device; leading axis = tree."""

    split_feat: torch.Tensor  # i32[T, P]  (-1 => leaf)
    split_bin: torch.Tensor   # i32[T, P]  (go right if bin > split_bin)
    left: torch.Tensor        # i32[T, P]  pool index of left child
    right: torch.Tensor       # i32[T, P]  pool index of right child
    leaf_val: torch.Tensor    # f32[T, P, c]


def _bin_dtype(n_bins: int) -> torch.dtype:
    """Narrowest dtype holding every bin id in [0, n_bins): int8 through
    ``n_bins == 128``, int32 beyond (the JAX package's rule)."""
    if n_bins < 2:
        raise ValueError(f"n_bins must be >= 2 (one split edge), got {n_bins}")
    return torch.int8 if n_bins <= 128 else torch.int32


def _search_levels(n_edges: int) -> int:
    """Halving steps of JAX's scan searchsorted: ceil(log2(E + 1))."""
    return int(math.ceil(math.log2(n_edges + 1)))


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K-A bin_rows
# ---------------------------------------------------------------------------
def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys ordering float32 as JAX's sort comparator does:
    -inf < ... < -0 == +0 < ... < inf < NaN, every NaN equal."""
    x = torch.where(x == 0, torch.zeros_like(x), x).contiguous()
    bits = x.view(torch.int32)
    bits = torch.where(torch.isnan(x), torch.full_like(bits, 0x7FC00000), bits)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def bin_rows_plain(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-A: the same fixed-step search."""
    n, d = X.shape
    n_edges = edges.shape[1]
    q = _total_order_key(X)
    ek = _total_order_key(edges).reshape(-1)
    base = (torch.arange(d, device=X.device) * n_edges)[None, :]
    low = torch.zeros((n, d), dtype=torch.long, device=X.device)
    high = torch.full((n, d), n_edges, dtype=torch.long, device=X.device)
    for _ in range(_search_levels(n_edges)):
        mid = (low + high) // 2
        go_left = q <= ek[base + mid]
        high = torch.where(go_left, mid, high)
        low = torch.where(go_left, low, mid)
    return high.to(_bin_dtype(n_edges + 1))


_BIN_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def bin_rows(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin ids int8/int32[n, d] of X f32[n, d] against edges f32[d, B-1].

    Bin b holds values in (edges[b-1], edges[b]]; NaN goes to the last bin.
    """
    _require(X.dtype == torch.float32 and X.ndim == 2, "X must be float32[n, d]")
    _require(edges.dtype == torch.float32 and edges.ndim == 2
             and edges.shape[0] == X.shape[1] and edges.shape[1] >= 1,
             f"edges must be float32[{X.shape[1]}, B-1], got {tuple(edges.shape)}")
    if not _on_cuda(X, edges):
        return bin_rows_plain(X, edges)
    X, edges = X.contiguous(), edges.contiguous()
    n, d = X.shape
    n_edges = edges.shape[1]
    dt = _bin_dtype(n_edges + 1)
    out = torch.empty((n, d), dtype=dt, device=X.device)
    if n == 0:
        return out
    lib = cuda_build.load("bin_rows", {"bin_rows_i8": (_BIN_ARGS, ctypes.c_int),
                                       "bin_rows_i32": (_BIN_ARGS, ctypes.c_int)})
    fn = lib.bin_rows_i8 if dt == torch.int8 else lib.bin_rows_i32
    with torch.cuda.device(X.device):
        rc = fn(X.data_ptr(), edges.data_ptr(), out.data_ptr(), n, d, n_edges,
                _search_levels(n_edges), _stream(X))
    if rc != 0:
        raise RuntimeError(f"bin_rows kernel launch failed: CUDA error {rc}")
    bin_rows.launches += 1
    return out


bin_rows.launches = 0


def bin_with_edges(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Apply fitted edges: value <= edges[0] is bin 0, value > edges[-1] is
    the last bin (``transmogrifai_tpu.ops.trees.bin_with_edges``)."""
    return bin_rows(X.to(torch.float32), edges)


# ---------------------------------------------------------------------------
# K-B ensemble_walk
# ---------------------------------------------------------------------------
_MODES = {"sum": 0, "mean": 1}


def _check_walk(Xb: torch.Tensor, tree: Tree, mode: str) -> None:
    _require(Xb.ndim == 2 and Xb.dtype in (torch.int8, torch.int32),
             "Xb must be int8 or int32 [n, d]")
    _require(mode in _MODES, f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    T, P = tree.split_feat.shape
    for name in ("split_feat", "split_bin", "left", "right"):
        a = getattr(tree, name)
        _require(a.dtype == torch.int32 and tuple(a.shape) == (T, P),
                 f"tree.{name} must be int32[{T}, {P}]")
    _require(tree.leaf_val.dtype == torch.float32 and tree.leaf_val.ndim == 3
             and tuple(tree.leaf_val.shape[:2]) == (T, P),
             f"tree.leaf_val must be float32[{T}, {P}, c]")


def ensemble_walk_plain(Xb: torch.Tensor, tree: Tree, max_depth: int,
                        mode: str = "sum", eta: float = 1.0, base: float = 0.0,
                        return_leaves: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K-B: the reference's gather walk over all
    trees at once, then the sum or mean over trees."""
    T = tree.split_feat.shape[0]
    n = Xb.shape[0]
    Xl = Xb.long()
    sf, sb = tree.split_feat.long(), tree.split_bin.long()
    lt, rt = tree.left.long(), tree.right.long()
    node = torch.zeros((T, n), dtype=torch.long, device=Xb.device)
    for _ in range(max_depth):
        nf = sf.gather(1, node)
        row_bin = Xl.gather(1, nf.clamp(min=0).T).T
        child = torch.where(row_bin > sb.gather(1, node), rt.gather(1, node),
                            lt.gather(1, node))
        node = torch.where(nf >= 0, child, node)
    leaf = tree.leaf_val[torch.arange(T, device=Xb.device)[:, None], node]  # [T, n, c]
    F = base + eta * leaf.sum(0) if mode == "sum" else leaf.mean(0)
    return F, (node.T.to(torch.int32).contiguous() if return_leaves else None)


_WALK_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 8 \
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_WALK_CHANNELS = 4  # kChannels of ensemble_walk.cu


def ensemble_walk(Xb: torch.Tensor, tree: Tree, max_depth: int, mode: str = "sum",
                  eta: float = 1.0, base: float = 0.0, return_leaves: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(F f32[n, c], leaves i32[n, T] or None): ``base + eta * sum`` over
    trees (mode "sum") or the mean (mode "mean") of each row's leaf values.
    """
    _check_walk(Xb, tree, mode)
    if not _on_cuda(Xb, *tree):
        return ensemble_walk_plain(Xb, tree, max_depth, mode, eta, base, return_leaves)
    Xb = Xb.contiguous()
    tree = Tree(*(a.contiguous() for a in tree))
    n, d = Xb.shape
    T, P, c = tree.leaf_val.shape
    out = torch.empty((n, c), dtype=torch.float32, device=Xb.device)
    leaves = torch.empty((n, T), dtype=torch.int32, device=Xb.device) \
        if return_leaves else None
    if n == 0:
        return out, leaves
    lib = cuda_build.load("ensemble_walk",
                          {"ensemble_walk_i8": (_WALK_ARGS, ctypes.c_int),
                           "ensemble_walk_i32": (_WALK_ARGS, ctypes.c_int)})
    fn = lib.ensemble_walk_i8 if Xb.dtype == torch.int8 else lib.ensemble_walk_i32
    with torch.cuda.device(Xb.device):
        for ch0 in range(0, c, _WALK_CHANNELS):
            rc = fn(Xb.data_ptr(), tree.split_feat.data_ptr(), tree.split_bin.data_ptr(),
                    tree.left.data_ptr(), tree.right.data_ptr(), tree.leaf_val.data_ptr(),
                    out.data_ptr(), leaves.data_ptr() if leaves is not None else None,
                    n, d, T, P, c, ch0, min(_WALK_CHANNELS, c - ch0), max_depth,
                    _MODES[mode], eta, base, _stream(Xb))
            if rc != 0:
                raise RuntimeError(f"ensemble_walk kernel launch failed: CUDA error {rc}")
            ensemble_walk.launches += 1
    return out, leaves


ensemble_walk.launches = 0


def predict_tree(Xb: torch.Tensor, tree: Tree, max_depth: int) -> torch.Tensor:
    """f32[n, c]: the leaf value each row reaches in one tree (pool arrays
    without the leading tree axis)."""
    one = Tree(*(a.unsqueeze(0) for a in tree))
    return ensemble_walk(Xb, one, max_depth, "sum")[0]


def predict_forest(Xb: torch.Tensor, forest: Tree, max_depth: int) -> torch.Tensor:
    """Average the trees' leaf vectors: f32[n, c]."""
    return ensemble_walk(Xb, forest, max_depth, "mean")[0]


def predict_gbt(Xb: torch.Tensor, trees: Tree, max_depth: int, eta: float,
                base_score: float = 0.0) -> torch.Tensor:
    """Sum of shrunken tree outputs: f32[n, c]."""
    return ensemble_walk(Xb, trees, max_depth, "sum", eta=eta, base=base_score)[0]


def leaf_indices(Xb: torch.Tensor, trees: Tree, max_depth: int) -> torch.Tensor:
    """i32[n, T]: the pool index of the leaf each row reaches in each tree."""
    return ensemble_walk(Xb, trees, max_depth, "sum", return_leaves=True)[1]
