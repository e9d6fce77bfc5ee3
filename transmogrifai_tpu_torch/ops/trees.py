"""Tree ensembles on the device: binning (K-A), the walk (K-B), the
histogram boosting and forest fits (K-E … K-H) and the forests' leaf read
(K-M).

The port's counterpart of ``transmogrifai_tpu/ops/trees.py``.  Scoring:
``Tree``, ``_bin_dtype``, ``bin_with_edges``, ``predict_tree``,
``predict_forest``, ``predict_gbt``, ``predict_forest_groups``.  Fitting:
``sketch_edges``, ``quantize``, ``frontier_cap``, ``_pool_size``,
``frontier_is_exact``, the threefry draws (``rng_keys``,
``bootstrap_weights``, ``feature_masks``, ``subsample_weights``, bit-equal
to the JAX package's; on the card each one launch of K-W, ``threefry_draws``
in ``ops/threefry.py``), the level-wise tree grower over c gradient channels
(c = 1 for binary and regression trees, c = k classes for the multiclass
forests' -onehot gradients and the softmax boosting, up to
``MAX_CHANNELS``), boosting (``fit_gbt``, ``fit_gbt_batch``) with the
logistic, squared and softmax losses, and the forests (``grow_forest``,
``fit_forest``, ``fit_forest_chunked``): one-channel leaves for binary
classification and regression, class-distribution leaves for multiclass.
Round-collapsed boosting (``trees_per_round`` = K > 1) grows K trees a
boosting step on shared gradients at learning rate eta / K, in
``n_rounds / K`` steps.

Hand-written kernels carry the path (CUDA sources in ``csrc/``, the Triton
ones in ``ops/triton_boost.py`` and ``ops/triton_forest.py``):

- ``bin_rows`` (K-A) replaces ``_bin_chunk``: per-feature left searchsorted
  of a float32 matrix into the fitted quantile edges.
- ``ensemble_walk`` (K-B) replaces ``predict_tree`` under ``predict_gbt`` /
  ``predict_forest``: a ``max_depth``-step pointer walk per (row, tree) and
  the sum (``base + eta * sum``) or mean over trees.
- ``level_hist`` (K-E) replaces ``_level_histograms`` and the light-child
  pass of ``_grow_level``: per (tree, slot, channel, feature, bin) sums of
  the weighted gradients and hessian, or only the lighter child of each
  sibling pair with the heavy one taken as parent minus light.
- ``split_scan`` (K-F) replaces the split scan, compaction and records of
  ``_grow_level``: prefix sums over bins, the XGBoost gain summed over the
  gradient channels, the first argmax, the beam cap, the node and leaf
  records (a leaf value per channel), the sibling pairs of the next
  level.
- ``route_rows`` (K-G) replaces the row routing of ``_grow_level``: each
  row's child slot, its pool node, and its pair id for the next level.
- ``boost_step`` (K-H) replaces the margin update and ``_grad_hess``
  (logistic and squared): ``F += eta * leaf[row_node]`` (a fused
  multiply-add for the logistic loss) and the weighted gradient and
  hessian of the new margins.  Its collapse mode (``rw`` given: K trees
  a batch element) sums each row's K leaves in XLA's order, adds them at
  ``eta / K`` and writes K weighted gradient planes, one a tree.
- ``softmax_boost_step`` (K-R, Triton, the ``LOSS`` 2 branch of
  ``ops/triton_boost.py``) replaces the same for the softmax loss over k
  class margins: the update per channel, the row's softmax, the k weighted
  gradients and the one scalar hessian of the row; and its collapse mode,
  as K-H's.
- ``forest_leaf_mean`` (K-M, Triton, ``ops/triton_forest.py``) replaces the
  fused sweep's forest leaf read and tree mean: each row's mean leaf value
  (per channel) over each (fold, candidate)'s trees.

Each kernel has a plain PyTorch version of the same signature beside it.  A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``<wrapper>.launches`` counts the
wrapper's launches.  Every tree batch carries a leading tree axis T: the
folds x candidates of a sweep grow together.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build
from . import threefry as R


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
    cuda_build.check_launch("bin_rows", rc)
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
            cuda_build.check_launch("ensemble_walk", rc)
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


# ---------------------------------------------------------------------------
# Quantization (host numpy, as in the JAX package) and frontier sizing
# ---------------------------------------------------------------------------
_SKETCH_ROWS = 1 << 18  # 262144 rows are plenty for <= 256 quantile edges


def sketch_edges(X: np.ndarray, n_bins: int, seed: int = 0) -> np.ndarray:
    """Quantile split candidates f32[d, n_bins-1] from a row subsample."""
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    if n > _SKETCH_ROWS:
        idx = np.random.default_rng(seed).choice(n, _SKETCH_ROWS, replace=False)
        X = X[idx]
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float32)  # [d, n_bins-1]


def quantize(X: torch.Tensor, n_bins: int = 32, seed: int = 0
             ) -> Tuple[torch.Tensor, np.ndarray]:
    """Equi-depth binning of X f32[n, d] on its device: (Xb int8/i32[n, d]
    through K-A, edges f32[d, n_bins-1] sketched on the host)."""
    edges = sketch_edges(X.detach().cpu().numpy(), n_bins, seed=seed)
    ed = torch.from_numpy(edges).to(X.device)
    return bin_rows(X.to(torch.float32).contiguous(), ed), edges


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def frontier_cap(n: int, max_depth: int, min_child_weight: float = 1.0,
                 h_max: float = 1.0, max_frontier: int = 512,
                 total_weight: float = None) -> int:
    """Frontier slots M of the level grower (a power of two): at most
    ``H_total / (2 * mcw)`` nodes can split per level, so ``H_total / mcw``
    slots lose nothing; beyond ``max_frontier`` growth is a gain-ranked beam.
    ``total_weight`` is the largest row-weight sum of the tree batch
    (1.25 n when None)."""
    if max_depth <= 1:
        return 2
    tw = 1.25 * n if total_weight is None else float(total_weight)
    exact = int(np.ceil(h_max * tw / max(min_child_weight, 1e-3)))
    m = min(1 << max_depth, max(exact, 2), max_frontier, _next_pow2(n))
    return max(_next_pow2(m) if m & (m - 1) else m, 2)


def _pool_size(max_depth: int, frontier: int) -> int:
    """Node-pool capacity: the exact heap of the unrolled levels plus M slots
    per deeper level.  Level t < log2(M) occupies [2^t - 1, 2^(t+1) - 1);
    level t >= L = log2(M) occupies [M - 1 + (t - L) M, ... + M)."""
    if max_depth <= 0:
        return 1
    L = frontier.bit_length() - 1
    u = min(max_depth, L)
    return (1 << (u + 1)) - 1 + max(max_depth - L, 0) * frontier


def frontier_is_exact(n: int, max_depth: int, min_child_weight: float,
                      h_max: float, frontier: int,
                      total_weight: float = None) -> bool:
    """True when ``frontier`` provably cannot overflow, so the beam's gain
    ranking is replaced by a count clamp."""
    tw = 1.25 * n if total_weight is None else float(total_weight)
    exact = int(np.ceil(h_max * tw / max(min_child_weight, 1e-3)))
    return frontier >= min(1 << max_depth, exact)


# ---------------------------------------------------------------------------
# Subsample draws (K8): threefry, bit for bit as the JAX package draws them
# ---------------------------------------------------------------------------
def rng_keys(seed: int) -> Tuple[R.Key, R.Key]:
    """(bootstrap / row key, feature key): ``jax.random.split`` of the
    seed's key, the split every fit and the sweep share."""
    kb, kf = R.split(R.key(seed))
    return kb, kf


def bootstrap_weights_plain(key: R.Key, n: int, n_trees: int, bootstrap: bool = True,
                            rate: float = 1.0, device=None) -> torch.Tensor:
    """Plain version of ``bootstrap_weights``: Knuth's loop as whole-array
    torch integer ops, one key split, one full-shape uniform and one host
    sync a step."""
    if not bootstrap:
        return torch.ones((n_trees, n), dtype=torch.float32, device=device)
    lam = torch.tensor(float(np.float32(rate)), dtype=torch.float32, device=device)
    k = torch.zeros((n_trees, n), dtype=torch.int32, device=device)
    if float(lam) == 0.0:
        return k.to(torch.float32)
    log_prod = torch.zeros((n_trees, n), dtype=torch.float32, device=device)
    rng = key
    while True:
        live = log_prod > -lam
        if not bool(live.any()):
            break
        rng, sub = R.split(rng)
        k += live.to(torch.int32)
        u = R.uniform_plain(sub, (n_trees, n), device)
        log_prod = log_prod + torch.log(u.to(torch.float64)).to(torch.float32)
    return (k - 1).to(torch.float32)


def bootstrap_weights(key: R.Key, n: int, n_trees: int, bootstrap: bool = True,
                      rate: float = 1.0, device=None) -> torch.Tensor:
    """Poisson(rate) bootstrap weights f32[T, n] on ``device``: Knuth's loop
    as ``jax.random.poisson`` runs it (one key split and one full-shape
    uniform a step, while any lane's log-product is above -rate), with each
    log taken in float64 and rounded to float32.  That rounding is what
    matches XLA's float32 log on every lane drawn at the sweep's shapes
    ([50, 891] and [50, 2^18], checked against ``jax.random.poisson``); a
    float32 log, which differs from XLA's on about 14% of the uniform's
    values, is not used.  On a CUDA device one launch of K-W (each lane
    runs its own loop); ``bootstrap=False`` gives ones and rate 0 zeros,
    without a launch."""
    if not bootstrap or float(np.float32(rate)) == 0.0 or not R.is_cuda(device):
        return bootstrap_weights_plain(key, n, n_trees, bootstrap, rate, device)
    return R.threefry_draws("poisson", key, (n_trees, n), device, float(np.float32(rate)))


def feature_masks_plain(key: R.Key, d: int, n_trees: int, frac: float,
                        device=None) -> torch.Tensor:
    """Plain version of ``feature_masks``: the uniforms sorted per tree."""
    if frac >= 1.0:
        return torch.ones((n_trees, d), dtype=torch.float32, device=device)
    k = max(1, int(round(frac * d)))
    r = R.uniform_plain(key, (n_trees, d), device)
    thresh = torch.sort(r, dim=1).values[:, k - 1:k]
    return (r <= thresh).to(torch.float32)


def feature_masks(key: R.Key, d: int, n_trees: int, frac: float,
                  device=None) -> torch.Tensor:
    """Per-tree feature masks f32[T, d] with exactly ``k = max(1,
    round(frac d))`` features each: the uniforms at or below each tree's
    k-th smallest.  On a CUDA device one launch of K-W (a warp a tree)."""
    if frac >= 1.0 or not R.is_cuda(device):
        return feature_masks_plain(key, d, n_trees, frac, device)
    return R.threefry_draws("masks", key, (n_trees, d), device,
                            keep=max(1, int(round(frac * d))))


def subsample_weights_plain(key: R.Key, n: int, n_rounds: int, frac: float,
                            device=None) -> torch.Tensor:
    """Plain version of ``subsample_weights``."""
    if frac >= 1.0:
        return torch.ones((n_rounds, n), dtype=torch.float32, device=device)
    return (R.uniform_plain(key, (n_rounds, n), device) < np.float32(frac)).to(torch.float32)


def subsample_weights(key: R.Key, n: int, n_rounds: int, frac: float,
                      device=None) -> torch.Tensor:
    """Per-round row-subsample masks f32[R, n]: uniform < frac.  On a CUDA
    device one launch of K-W."""
    if frac >= 1.0 or not R.is_cuda(device):
        return subsample_weights_plain(key, n, n_rounds, frac, device)
    return R.threefry_draws("below", key, (n_rounds, n), device, float(np.float32(frac)))


# ---------------------------------------------------------------------------
# K-E level_hist
# ---------------------------------------------------------------------------
#: the most gradient channels (classes) K-E, K-F and K-R and their plain
#: versions take (K-E cuts the c + 1 channels into slabs past 9, K-F keeps
#: its running sums in shared memory past 8)
MAX_CHANNELS = 128


def _check_level_hist(Xb, ghw, ids, m, n_bins, parent, pair_parent, pair_light):
    _require(Xb.ndim == 2 and Xb.dtype in (torch.int8, torch.int32),
             "Xb must be int8 or int32 [n, d]")
    n, d = Xb.shape
    _require(ghw.dtype == torch.float32 and ghw.ndim == 3 and ghw.shape[1] == n
             and ghw.shape[2] >= 2, f"ghw must be float32[T, {n}, c + 1]")
    C1 = ghw.shape[2]
    _require(C1 <= MAX_CHANNELS + 1,
             f"level_hist takes at most {MAX_CHANNELS} gradient channels (classes) and the "
             f"hessian, got {C1 - 1}")
    T = ghw.shape[0]
    _require(ids.dtype == torch.int32 and tuple(ids.shape) == (T, n),
             f"ids must be int32[{T}, {n}]")
    _require(n_bins >= 2 and m >= 1, "need n_bins >= 2 and m >= 1")
    if parent is not None:
        _require(m % 2 == 0, "a light-only build needs an even slot count")
        _require(parent.dtype == torch.float32 and parent.ndim == 5
                 and parent.shape[0] == T and parent.shape[2:] == (C1, d, n_bins),
                 f"parent must be float32[{T}, m_prev, {C1}, {d}, {n_bins}]")
        for name, a in (("pair_parent", pair_parent), ("pair_light", pair_light)):
            _require(a is not None and a.dtype == torch.int32
                     and tuple(a.shape) == (T, m // 2), f"{name} must be int32[{T}, {m // 2}]")


#: the fixed point of K-E's sums: each channel's value (w*g per gradient
#: channel, w*h) times 2^bits, rounded to the nearest int64; integer sums
#: give the same total in any order.  The kernel takes the scale from the
#: wrapper.  ``bits`` is 32 wherever the level's row count x largest channel
#: value stays below ``HIST_RANGE`` (every binary gradient and every
#: multiclass -onehot one does), and fewer where it does not
HIST_SCALE_BITS = 32
HIST_RANGE = 2.0 ** (63 - HIST_SCALE_BITS)


def hist_scale_bits(n: int, big: float) -> int:
    """The fixed-point scale bits of a level of ``n`` rows whose largest
    |w*g|, |w*h| is ``big``: ``HIST_SCALE_BITS`` where ``n * big`` is below
    ``HIST_RANGE``, else the most bits that keep ``n * big * 2^bits`` at or
    below 2^62, so that no sum leaves int64 (regression gradients: a target
    of 1e6 at 2^12 rows takes 30 bits).  Raises on a non-finite value."""
    _require(math.isfinite(big),
             f"level_hist sums out of its fixed-point range: the largest |w*g|, |w*h| is {big}")
    total = big * max(n, 1)
    if total < HIST_RANGE:
        return HIST_SCALE_BITS
    return 62 - math.ceil(math.log2(total))


def level_hist_plain(Xb: torch.Tensor, ghw: torch.Tensor, ids: torch.Tensor, m: int,
                     n_bins: int, parent: Optional[torch.Tensor] = None,
                     pair_parent: Optional[torch.Tensor] = None,
                     pair_light: Optional[torch.Tensor] = None,
                     scale_bits: int = HIST_SCALE_BITS) -> torch.Tensor:
    """Plain PyTorch version of K-E: the same fixed-point sums, as an int64
    ``index_add_`` over rows a feature, then the parent - light assembly."""
    T, n, C1 = ghw.shape
    d, B = Xb.shape[1], n_bins
    mp = m // 2 if parent is not None else m
    seg_n = mp * B + 1
    idl = ids.long()
    dead = idl < 0
    base = torch.where(dead, torch.full_like(idl, mp * B), idl * B)      # [T, n]
    offs = (torch.arange(T, device=Xb.device) * (d * seg_n)).view(T, 1)
    fixed = torch.round(ghw * float(2.0 ** scale_bits)).to(torch.int64).reshape(T * n, C1)
    acc = torch.zeros((T * d * seg_n, C1), dtype=torch.int64, device=Xb.device)
    Xl = Xb.long()
    for j in range(d):  # integer sums: the order changes no bit
        seg = base + torch.where(dead, 0, Xl[:, j][None]) + offs + j * seg_n
        acc.index_add_(0, seg.reshape(-1), fixed)
    light = acc.view(T, d, seg_n, C1)[:, :, :mp * B].reshape(T, d, mp, B, C1) \
        .permute(0, 2, 4, 1, 3).to(torch.float32) * float(2.0 ** -scale_bits)
    light = light.contiguous()                                            # [T, mp, C1, d, B]
    if parent is None:
        return light
    pp = pair_parent.long()
    par = parent[torch.arange(T, device=Xb.device)[:, None], pp.clamp(min=0)]
    par = torch.where((pp >= 0)[:, :, None, None, None], par, torch.zeros_like(par))
    heavy = par - light
    lp = (pair_light != 0)[:, :, None, None, None]
    return torch.stack([torch.where(lp, light, heavy), torch.where(lp, heavy, light)],
                       dim=2).reshape(T, m, C1, d, B)


_HIST_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p]


def level_hist(Xb: torch.Tensor, ghw: torch.Tensor, ids: torch.Tensor, m: int,
               n_bins: int, parent: Optional[torch.Tensor] = None,
               pair_parent: Optional[torch.Tensor] = None,
               pair_light: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Level histograms f32[T, m, c + 1, d, B] of ``ghw`` f32[T, n, c + 1]
    (channels 0 .. c - 1: sums of the weighted gradients, c: of w*h; at
    most ``MAX_CHANNELS`` gradient channels), summed in 64-bit fixed point
    at the scale ``hist_scale_bits`` picks from the row count and the
    largest channel value (one reduction and one host sync): the same on
    every run, exact where the inputs are multiples of the scale's quantum
    (2^-32 for every binary and every -onehot gradient).  Raises on a
    non-finite value.

    Direct build (``parent`` None): rows with ``ids == s`` go to slot s (-1
    rests).  Light-only build: ``ids`` are pair ids in [0, m/2) of the
    lighter child of each sibling pair; the heavy child is
    ``parent[pair_parent[j]] - light`` (zero when ``pair_parent`` is -1) and
    ``pair_light[j]`` says the light child is the left (even) slot.
    """
    _check_level_hist(Xb, ghw, ids, m, n_bins, parent, pair_parent, pair_light)
    big = float(ghw.abs().amax()) if ghw.numel() else 0.0
    bits = hist_scale_bits(Xb.shape[0], big)
    tensors = [Xb, ghw, ids] + ([parent, pair_parent, pair_light] if parent is not None else [])
    if not _on_cuda(*tensors):
        return level_hist_plain(Xb, ghw, ids, m, n_bins, parent, pair_parent, pair_light, bits)
    return level_hist_launch(Xb, ghw, ids, m, n_bins, parent, pair_parent, pair_light, bits)


def level_hist_launch(Xb: torch.Tensor, ghw: torch.Tensor, ids: torch.Tensor, m: int,
                      n_bins: int, parent: Optional[torch.Tensor] = None,
                      pair_parent: Optional[torch.Tensor] = None,
                      pair_light: Optional[torch.Tensor] = None,
                      scale_bits: int = HIST_SCALE_BITS) -> torch.Tensor:
    """K-E's launch on CUDA tensors at ``scale_bits``, without
    ``level_hist``'s checks (whose scale choice waits for the card); counts
    in ``level_hist.launches``."""
    _require(_on_cuda(Xb, ghw, ids), "level_hist_launch takes CUDA tensors")
    Xb, ghw, ids = Xb.contiguous(), ghw.contiguous(), ids.contiguous()
    T, n, C1 = ghw.shape
    d = Xb.shape[1]
    mp = m // 2 if parent is not None else m
    acc = torch.empty((T, mp, C1, d, n_bins), dtype=torch.int64, device=Xb.device)
    out = torch.empty((T, m, C1, d, n_bins), dtype=torch.float32, device=Xb.device)
    lib = cuda_build.load("level_hist", {"level_hist_i8": (_HIST_ARGS, ctypes.c_int),
                                         "level_hist_i32": (_HIST_ARGS, ctypes.c_int)})
    fn = lib.level_hist_i8 if Xb.dtype == torch.int8 else lib.level_hist_i32
    light = parent is not None
    # bound to names while the kernels are queued (later reuse of their
    # memory is ordered after them on the stream)
    par, pp, pl = ((parent.contiguous(), pair_parent.contiguous(), pair_light.contiguous())
                   if light else (None, None, None))
    m_prev = parent.shape[1] if light else 0
    with torch.cuda.device(Xb.device):
        rc = fn(Xb.data_ptr(), ghw.data_ptr(), ids.data_ptr(),
                par.data_ptr() if light else None, pp.data_ptr() if light else None,
                pl.data_ptr() if light else None, acc.data_ptr(), out.data_ptr(), n, d,
                n_bins, C1, T, mp, m_prev, float(2.0 ** scale_bits),
                float(2.0 ** -scale_bits), _stream(Xb))
    cuda_build.check_launch("level_hist", rc)
    level_hist.launches += 1
    return out


level_hist.launches = 0


# ---------------------------------------------------------------------------
# K-F split_scan
# ---------------------------------------------------------------------------
#: cap modes of a level: no cap (next_cap = 2m), the count clamp of a
#: provably exact frontier, or the gain-ranked beam
CAP_NONE, CAP_CLAMP, CAP_BEAM = 0, 1, 2


def _check_split_scan(hist, feat_mask, params, n_active, nodes, leaf, slot_base,
                      next_free, next_cap):
    _require(hist.dtype == torch.float32 and hist.ndim == 5 and hist.shape[2] >= 2,
             "hist must be float32[T, m, c + 1, d, B]")
    T, m, C1, d, B = hist.shape
    c = C1 - 1
    _require(c <= MAX_CHANNELS,
             f"split_scan takes at most {MAX_CHANNELS} gradient channels (classes), got {c}")
    _require(m <= 1024, f"at most 1024 frontier slots, got {m}")
    _require(feat_mask.dtype == torch.float32 and tuple(feat_mask.shape) == (T, d),
             f"feat_mask must be float32[{T}, {d}]")
    _require(params.dtype == torch.float32 and tuple(params.shape) == (T, 4),
             f"params must be float32[{T}, 4] (lambda, gamma, mcw, min_info_gain)")
    _require(n_active.dtype == torch.int32 and tuple(n_active.shape) == (T,),
             f"n_active must be int32[{T}]")
    _require(nodes.dtype == torch.int32 and nodes.ndim == 3 and nodes.shape[0] == T
             and nodes.shape[2] == 4, f"nodes must be int32[{T}, P, 4]")
    P = nodes.shape[1]
    _require(leaf.dtype == torch.float32 and (tuple(leaf.shape) == (T, P, c)
                                              or (c == 1 and tuple(leaf.shape) == (T, P))),
             f"leaf must be float32[{T}, {P}, {c}]" + (f" or [{T}, {P}]" if c == 1 else ""))
    _require(slot_base + m <= P and next_free + next_cap <= P and next_cap % 2 == 0,
             "level blocks must fit the node pool")


def _sum_sq(v: torch.Tensor) -> torch.Tensor:
    """The sum over axis 2 of v * v as XLA's CPU code takes the reference's
    ``(Gp * Gp).sum(axis)``: v0 * v0, then one fused multiply-add per
    channel in order (each rounded once: the float64 product and sum are
    exact for the forests' integer-valued gradient sums)."""
    out = v[:, :, 0] * v[:, :, 0]
    for ch in range(1, v.shape[2]):
        x = v[:, :, ch].double()
        out = (x * x + out.double()).float()
    return out


def split_scan_plain(hist: torch.Tensor, feat_mask: torch.Tensor, params: torch.Tensor,
                     n_active: torch.Tensor, nodes: torch.Tensor, leaf: torch.Tensor,
                     slot_base: int, next_free: int, next_cap: int, cap_mode: int,
                     root: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K-F (the reference's association: prefix
    sums bin by bin, ``(sL + sR) - sP``, node totals from feature 0, the
    squares summed over the channels in order)."""
    T, m, C1, d, B = hist.shape
    c = C1 - 1
    dev = hist.device
    lam, gam, mcw, mig = (params[:, i] for i in range(4))
    G, H = hist[:, :, :c], hist[:, :, c]                    # [T, m, c, d, B], [T, m, d, B]
    GL, HL = torch.empty_like(G), torch.empty_like(H)
    ag, ah = G[..., 0].clone(), H[..., 0].clone()
    GL[..., 0], HL[..., 0] = ag, ah
    for b in range(1, B):
        ag, ah = ag + G[..., b], ah + H[..., b]
        GL[..., b], HL[..., b] = ag, ah
    GT, HT = GL[:, :, :, 0, B - 1], HL[:, :, 0, B - 1]      # [T, m, c], [T, m]
    GR = GT[..., None, None] - GL
    HR = HT[..., None, None] - HL
    l4 = lam[:, None, None, None]
    parent = (_sum_sq(GT) / (HT + lam[:, None]))[..., None, None]
    gain = (_sum_sq(GL) / (HL + l4) + _sum_sq(GR) / (HR + l4)) - parent
    m4 = mcw[:, None, None, None]
    valid = (HL >= m4) & (HR >= m4) & (feat_mask[:, None, :, None] > 0) \
        & (torch.arange(B, device=dev) < B - 1)
    flat = torch.where(valid, gain, torch.full_like(gain, -math.inf)).reshape(T, m, d * B)
    best = torch.argmax(flat, dim=2)                         # first max
    best_gain = flat.gather(2, best[..., None])[..., 0]
    bf, bb = best // B, best % B
    in_use = torch.arange(m, device=dev)[None] < n_active[:, None]
    do = (best_gain > gam[:, None]) & (best_gain >= mig[:, None] * HT) & in_use
    half = next_cap // 2
    if cap_mode == CAP_BEAM:
        key = torch.where(do, -best_gain, torch.full_like(best_gain, math.inf))
        rank = torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1, stable=True)
        do &= rank < half
        k = torch.cumsum(do.int(), dim=1)
    else:
        k = torch.cumsum(do.int(), dim=1)
        if cap_mode == CAP_CLAMP:
            do &= k <= half
            k = k.clamp(max=half)
    n_split = k[:, -1]
    child = (k - 1) * 2
    lp = next_free + child
    rec = torch.stack([torch.where(do, bf, -1), torch.where(do, bb, 0),
                       torch.where(do, lp, 0), torch.where(do, lp + 1, 0)], dim=-1)
    nodes[:, slot_base:slot_base + m] = rec.to(torch.int32)
    nodes[:, next_free:next_free + next_cap] = torch.tensor([-1, 0, 0, 0], dtype=torch.int32,
                                                            device=dev)
    GLb = GL.reshape(T, m, c, d * B).gather(3, best[:, :, None, None].expand(T, m, c, 1))[..., 0]
    HLb = HL.reshape(T, m, d * B).gather(2, best[..., None])[..., 0]
    GRb, HRb = GT - GLb, HT - HLb                            # [T, m, c], [T, m]
    zero = torch.zeros_like(GLb)
    lval = torch.where(do[..., None], -GLb / (HLb + lam[:, None])[..., None], zero)
    rval = torch.where(do[..., None], -GRb / (HRb + lam[:, None])[..., None], zero)
    vals = torch.zeros((T, next_cap, c), dtype=torch.float32, device=dev)
    tt, ss = torch.nonzero(do, as_tuple=True)
    vals[tt, child[tt, ss]] = lval[tt, ss]
    vals[tt, child[tt, ss] + 1] = rval[tt, ss]
    lv = leaf.view(T, -1, c)
    lv[:, next_free:next_free + next_cap] = vals
    if root:
        lv[:, 0] = -GT[:, 0] / (HT[:, 0] + lam)[:, None]
    split = torch.stack([torch.where(do, bf, -1), bb, child, torch.zeros_like(bb)],
                        dim=-1).to(torch.int32)
    pair_parent = torch.full((T, half), -1, dtype=torch.int32, device=dev)
    pair_light = torch.zeros((T, half), dtype=torch.int32, device=dev)
    pair_parent[tt, child[tt, ss] // 2] = ss.to(torch.int32)
    pair_light[tt, child[tt, ss] // 2] = (HLb <= HRb)[tt, ss].to(torch.int32)
    return split, pair_parent, pair_light, (2 * n_split).to(torch.int32)


_SCAN_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def split_scan(hist: torch.Tensor, feat_mask: torch.Tensor, params: torch.Tensor,
               n_active: torch.Tensor, nodes: torch.Tensor, leaf: torch.Tensor,
               slot_base: int, next_free: int, next_cap: int, cap_mode: int,
               root: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level's split choice, compaction and records, per tree.

    Reads the level histogram ``hist`` f32[T, m, c + 1, d, B] (c gradient
    channels, at most ``MAX_CHANNELS``, then the hessian), the feature
    masks, ``params`` f32[T, 4] (lambda, gamma, min_child_weight,
    min_info_gain) and the live width ``n_active`` i32[T].  Writes the slot
    records into ``nodes`` i32[T, P, 4] at ``slot_base``, a leaf record for
    every slot of the child block at ``next_free``, the child leaf values
    into ``leaf`` f32[T, P, c] (f32[T, P] at c = 1; the root's at level 0).
    Returns ``split`` i32[T, m, 4] (feature or -1, bin, left child's slot,
    0); for the next level's ``next_cap / 2`` sibling pairs, the parent
    slot (-1 none) and the light-left flag; and the next level's live width
    (2 x splits).
    """
    _check_split_scan(hist, feat_mask, params, n_active, nodes, leaf, slot_base,
                      next_free, next_cap)
    _require(cap_mode in (CAP_NONE, CAP_CLAMP, CAP_BEAM), f"bad cap mode {cap_mode}")
    if not _on_cuda(hist, feat_mask, params, n_active, nodes, leaf):
        return split_scan_plain(hist, feat_mask, params, n_active, nodes, leaf,
                                slot_base, next_free, next_cap, cap_mode, root)
    for name, a in (("nodes", nodes), ("leaf", leaf)):
        _require(a.is_contiguous(), f"{name} must be contiguous (written in place)")
    hist, feat_mask, params = hist.contiguous(), feat_mask.contiguous(), params.contiguous()
    n_active = n_active.contiguous()
    T, m, C1, d, B = hist.shape
    half = next_cap // 2
    dev = hist.device
    split = torch.empty((T, m, 4), dtype=torch.int32, device=dev)
    pair_parent = torch.empty((T, half), dtype=torch.int32, device=dev)
    pair_light = torch.empty((T, half), dtype=torch.int32, device=dev)
    n_next = torch.empty((T,), dtype=torch.int32, device=dev)
    scratch = torch.empty((4 + 2 * (C1 - 1), T, m), dtype=torch.float32, device=dev)
    lib = cuda_build.load("split_scan", {"split_scan": (_SCAN_ARGS, ctypes.c_int)})
    with torch.cuda.device(dev):
        rc = lib.split_scan(hist.data_ptr(), feat_mask.data_ptr(), params.data_ptr(),
                            n_active.data_ptr(), n_next.data_ptr(), nodes.data_ptr(),
                            leaf.data_ptr(),
                            split.data_ptr(), pair_parent.data_ptr(), pair_light.data_ptr(),
                            scratch.data_ptr(), T, m, C1 - 1, d, B, nodes.shape[1], slot_base,
                            next_free, next_cap,
                            cap_mode | (4 if root else 0), _stream(hist))
    cuda_build.check_launch("split_scan", rc)
    split_scan.launches += 1
    return split, pair_parent, pair_light, n_next


split_scan.launches = 0


# ---------------------------------------------------------------------------
# K-G route_rows
# ---------------------------------------------------------------------------
def route_rows_plain(Xb: torch.Tensor, row_slot: torch.Tensor, row_node: torch.Tensor,
                     split: torch.Tensor, pair_light: torch.Tensor,
                     next_free: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K-G."""
    T = row_slot.shape[0]
    s = row_slot.long()
    tt = torch.arange(T, device=Xb.device)[:, None]
    sp = split.long()[tt, s.clamp(min=0)]                    # [T, n, 4]
    feat, bins, child = sp[..., 0], sp[..., 1], sp[..., 2]
    here = (s >= 0) & (feat >= 0)
    rows = torch.arange(Xb.shape[0], device=Xb.device)[None]
    right = (Xb.long()[rows, feat.clamp(min=0)] > bins).long()
    new = torch.where(here, child + right, torch.full_like(s, -1))
    node = torch.where(here, next_free + child + right, row_node.long()).int()
    lp = pair_light.long()[tt, (new.clamp(min=0) >> 1)] != 0
    light = torch.where((new & 1) == 0, lp, ~lp) & (new >= 0)
    return new.int(), node, torch.where(light, new >> 1, torch.full_like(new, -1)).int()


_ROUTE_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def route_rows(Xb: torch.Tensor, row_slot: torch.Tensor, row_node: torch.Tensor,
               split: torch.Tensor, pair_light: torch.Tensor, next_free: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Send each (tree, row) to its child: ``Xb[r, feat] > bin`` goes right.

    From the rows' slots and pool nodes i32[T, n] and the level's ``split``
    records, returns the new slots (-1: the row rests at a leaf), the new
    pool nodes, and the rows' pair ids for the next level's light-only
    histogram (-1 unless the row's new slot is the light child of its
    pair)."""
    _require(Xb.ndim == 2 and Xb.dtype in (torch.int8, torch.int32),
             "Xb must be int8 or int32 [n, d]")
    T, n = row_slot.shape
    _require(n == Xb.shape[0] and row_slot.dtype == torch.int32
             and row_node.dtype == torch.int32 and tuple(row_node.shape) == (T, n),
             f"row_slot / row_node must be int32[T, {Xb.shape[0]}]")
    _require(split.dtype == torch.int32 and split.ndim == 3 and split.shape[0] == T
             and split.shape[2] == 4, f"split must be int32[{T}, m, 4]")
    _require(pair_light.dtype == torch.int32 and pair_light.ndim == 2
             and pair_light.shape[0] == T, f"pair_light must be int32[{T}, pairs]")
    if not _on_cuda(Xb, row_slot, row_node, split, pair_light):
        return route_rows_plain(Xb, row_slot, row_node, split, pair_light, next_free)
    Xb, split, pair_light = Xb.contiguous(), split.contiguous(), pair_light.contiguous()
    row_slot, row_node = row_slot.contiguous(), row_node.contiguous()
    new_slot, new_node, ids = (torch.empty((T, n), dtype=torch.int32, device=Xb.device)
                               for _ in range(3))
    if n == 0:
        return new_slot, new_node, ids
    lib = cuda_build.load("route_rows", {"route_rows_i8": (_ROUTE_ARGS, ctypes.c_int),
                                         "route_rows_i32": (_ROUTE_ARGS, ctypes.c_int)})
    fn = lib.route_rows_i8 if Xb.dtype == torch.int8 else lib.route_rows_i32
    with torch.cuda.device(Xb.device):
        rc = fn(Xb.data_ptr(), row_slot.data_ptr(), row_node.data_ptr(), split.data_ptr(),
                pair_light.data_ptr(), new_slot.data_ptr(), new_node.data_ptr(),
                ids.data_ptr(), n, Xb.shape[1], T, split.shape[1],
                pair_light.shape[1], next_free, _stream(Xb))
    cuda_build.check_launch("route_rows", rc)
    route_rows.launches += 1
    return new_slot, new_node, ids


route_rows.launches = 0


# ---------------------------------------------------------------------------
# K-H boost_step
# ---------------------------------------------------------------------------
def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) in float32, the expansion XLA uses for
    ``jax.nn.sigmoid``."""
    return 1.0 / (1.0 + torch.exp(-x))


#: the losses of the boosting kernels (their LOSS constant): K-H takes the
#: logistic and squared losses, K-R the softmax
BOOST_LOSSES = {"logistic": 0, "squared": 1, "softmax": 2}


def collapse_leaf_sum(lv: torch.Tensor) -> torch.Tensor:
    """The sum over axis 1 of the K trees' leaf values ``lv`` [B, K, ...] in
    the order XLA's CPU code reduces the reference's ``leaves.sum`` over K:
    pairwise halving (tree k with tree k + K / 2, again on the halves) when
    K is a power of two, in tree order otherwise.  (Checked bit for bit
    against the JAX package's collapsed fits at K = 2, 3, 4, 8 and 12:
    ``tests/test_torch_round_collapse.py``.)"""
    K = lv.shape[1]
    if K & (K - 1) == 0:
        while lv.shape[1] > 1:
            h = lv.shape[1] // 2
            lv = lv[:, :h] + lv[:, h:]
        return lv[:, 0]
    acc = lv[:, 0]
    for k in range(1, K):
        acc = acc + lv[:, k]
    return acc


def collapse_scale(eta: torch.Tensor, K: int) -> torch.Tensor:
    """``eta / K`` as XLA's CPU code computes it: a product with the float32
    reciprocal of K."""
    return eta * float(np.float32(1.0 / K))


def _collapse_update(F: torch.Tensor, eta: torch.Tensor, leaf: torch.Tensor,
                     row_node: torch.Tensor, K: int) -> None:
    """``F[b] += (eta_b / K) * sum_k leaf[bK + k, row_node[bK + k]]`` over
    F [B, n] or [B, n, c], in place, the product and the sum one fused
    multiply-add (for every loss: XLA's CPU code contracts the reference's
    collapsed update so)."""
    from .metrics import fma

    B, n = F.shape[:2]
    c = F.shape[2] if F.ndim == 3 else 1
    lv = leaf.reshape(B * K, -1, c).gather(1, row_node.long()[..., None].expand(-1, -1, c))
    s = collapse_leaf_sum(lv.reshape(B, K, n, c)).reshape(F.shape)
    a = collapse_scale(eta, K).reshape((B,) + (1,) * (F.ndim - 1)).expand_as(s)
    F.copy_(fma(a, s, F))


def _collapse_planes(ghw: torch.Tensor, g: torch.Tensor, h: Optional[torch.Tensor],
                     w: torch.Tensor, rw: torch.Tensor) -> None:
    """Write tree bK + k's weighted gradients ``g * (w[b] * rw[k])`` (``g``
    [B, n, C]) and hessian ``h * (w[b] * rw[k])`` (``h`` [B, n], or the
    weights themselves when ``h`` is None) into ``ghw`` [B K, n, C + 1]."""
    B, n = w.shape
    K = rw.shape[0]
    wk = (w[:, None, :] * rw[None]).reshape(B * K, n)
    C = g.shape[2]
    ghw[..., :C] = g.repeat_interleave(K, dim=0) * wk[..., None]
    ghw[..., C] = wk if h is None else h.repeat_interleave(K, dim=0) * wk


def boost_step_plain(F: torch.Tensor, y: torch.Tensor, w: torch.Tensor, eta: torch.Tensor,
                     leaf: Optional[torch.Tensor], row_node: Optional[torch.Tensor],
                     ghw: Optional[torch.Tensor], loss: str = "logistic",
                     rw: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of K-H: the logistic margin update one fused
    multiply-add, as XLA's CPU code contracts the reference's; the squared
    one rounded twice (see ``boost_step``).  With ``rw``, the collapse
    mode."""
    from .metrics import fma

    if rw is not None:
        if leaf is not None:
            _collapse_update(F, eta, leaf, row_node, rw.shape[0])
        if ghw is None:
            return
        if loss == "squared":
            _collapse_planes(ghw, (F - y[None])[..., None], None, w, rw)
            return
        p = _sigmoid(F)
        _collapse_planes(ghw, (p - y[None])[..., None],
                         torch.clamp_min(p * (1 - p), 1e-6), w, rw)
        return
    if leaf is not None:
        lv = leaf.gather(1, row_node.long())
        eta_t = eta[:, None].expand_as(lv)
        F.copy_(F + eta_t * lv if loss == "squared" else fma(eta_t, lv, F))
    if ghw is None:
        return
    if loss == "squared":
        ghw[..., 0] = (F - y[None]) * w
        ghw[..., 1] = w
        return
    p = _sigmoid(F)
    ghw[..., 0] = (p - y[None]) * w
    ghw[..., 1] = torch.maximum(p * (1 - p), torch.tensor(1e-6, dtype=torch.float32,
                                                         device=F.device)) * w


def _check_boost(F, y, w, eta, leaf, row_node, ghw, c: int, rw=None) -> None:
    """Shapes of a boosting step over [T, n] (``c`` 0) or [T, n, c]; with
    ``rw`` [K, n], K trees a batch element."""
    T, n = F.shape[:2]
    if rw is not None:
        _require(rw.dtype == torch.float32 and rw.ndim == 2 and rw.shape[0] >= 1
                 and rw.shape[1] == n, f"rw must be float32[K, {n}]")
    K = 1 if rw is None else rw.shape[0]
    lead = (T, n) if c == 0 else (T, n, c)
    _require(F.dtype == torch.float32 and tuple(F.shape) == lead,
             "F must be float32[T, n]" if c == 0 else "F must be float32[T, n, k]")
    _require(y.dtype == torch.float32 and tuple(y.shape) == (n,), f"y must be float32[{n}]")
    _require(w.dtype == torch.float32 and tuple(w.shape) == (T, n), f"w must be float32[{T}, {n}]")
    _require(eta.dtype == torch.float32 and tuple(eta.shape) == (T,), f"eta must be float32[{T}]")
    _require((leaf is None) == (row_node is None), "leaf and row_node go together")
    if leaf is not None:
        _require(leaf.dtype == torch.float32 and leaf.ndim == (2 if c == 0 else 3)
                 and leaf.shape[0] == T * K
                 and tuple(leaf.shape[2:]) == (() if c == 0 else (c,))
                 and row_node.dtype == torch.int32 and tuple(row_node.shape) == (T * K, n),
                 f"leaf must be float32[{T * K}, P{'' if c == 0 else f', {c}'}] and row_node "
                 f"int32[{T * K}, {n}]")
    if ghw is not None:
        C1 = 2 if c == 0 else c + 1
        _require(ghw.dtype == torch.float32 and tuple(ghw.shape) == (T * K, n, C1),
                 f"ghw must be float32[{T * K}, {n}, {C1}]")


def boost_step(F: torch.Tensor, y: torch.Tensor, w: torch.Tensor, eta: torch.Tensor,
               leaf: Optional[torch.Tensor] = None, row_node: Optional[torch.Tensor] = None,
               ghw: Optional[torch.Tensor] = None, loss: str = "logistic",
               rw: Optional[torch.Tensor] = None) -> None:
    """One boosting step over [T, n], in place.

    With ``leaf`` f32[T, P] and ``row_node`` i32[T, n]: the margin update
    ``F += eta[t] * leaf[t, row_node[t, r]]``: for the logistic loss one
    fused multiply-add, as XLA's CPU code contracts the reference's update;
    for the squared loss the product and the sum rounded apart.  The
    reference contracts that one too, but the Boston fixture's GBT folds
    and refit are held within their tolerances only by the two roundings:
    K-E's exact histogram sums already move a leaf value by a few ulps
    against XLA's float32 sums, and with the fused update other near-tied
    splits flip (fold RMSE 7.4e-4 from the fixture's, relative, against the
    2e-4 tolerance).  With
    ``ghw`` f32[T, n, 2]: the gradient and hessian of ``loss`` at the
    (updated) margins, times the row weights ``w`` f32[T, n]: logistic
    ``(p - y) w`` and ``max(p (1 - p), 1e-6) w`` with ``p = 1 / (1 +
    exp(-F))``; squared ``(F - y) w`` and ``w``.

    The collapse mode, with ``rw`` f32[K, n] (the K rounds' subsample rows
    of a round-collapsed step): ``leaf`` f32[T K, P] and ``row_node`` i32[T
    K, n] hold K trees a batch element (tree tK + k), and the update is
    ``F[t] += (eta[t] / K) * sum_k leaf[tK + k, row_node[tK + k, r]]``, the
    K leaves summed in XLA's order (``collapse_leaf_sum``), ``eta / K`` as
    ``collapse_scale``, the product and the sum one fused multiply-add for
    both losses, as XLA's CPU code contracts the reference's collapsed
    update (the squared loss too, unlike its K = 1 mode: with the
    reference's rounding the Boston flow's collapsed GBT folds stay within
    3.5e-5 of the JAX package's, relative, as with two roundings); ``ghw``
    f32[T K, n, 2] gets the gradient and hessian at the new margins times
    ``w[t] * rw[k]`` for tree tK + k.
    """
    _require(loss in ("logistic", "squared"),
             f"loss must be logistic or squared (softmax_boost_step takes the softmax), "
             f"got {loss!r}")
    _check_boost(F, y, w, eta, leaf, row_node, ghw, 0, rw)
    T, n = F.shape
    others = [t for t in (leaf, row_node, ghw, rw) if t is not None]
    if not _on_cuda(F, y, w, eta, *others):
        return boost_step_plain(F, y, w, eta, leaf, row_node, ghw, loss, rw)
    if rw is not None:
        return _collapse_launch(boost_step, F, y, w, eta, leaf, row_node, ghw, rw,
                                BOOST_LOSSES[loss], 1)
    for name, a in (("F", F), ("ghw", ghw)):
        _require(a is None or a.is_contiguous(), f"{name} must be contiguous (written in place)")
    if n == 0 or (leaf is None and ghw is None):
        return None
    with cuda_build.kernel_errors("boost_step"):
        from . import triton_boost as tb

    y, w, eta = y.contiguous(), w.contiguous(), eta.contiguous()
    upd = leaf is not None
    leaf_t = leaf.contiguous() if upd else F
    node_t = row_node.contiguous() if upd else F
    block = 1024
    grid = (-(-n // block), T)
    with torch.cuda.device(F.device), cuda_build.kernel_errors("boost_step"):
        tb.boost_step_kernel[grid](F, y, w, eta, leaf_t, node_t,
                                   ghw if ghw is not None else F, n,
                                   leaf_t.shape[1] if upd else 0, 1.0, UPDATE=upd,
                                   GRAD=ghw is not None, LOSS=BOOST_LOSSES[loss], K=1, KP=1,
                                   BLOCK=block, num_warps=4)
    boost_step.launches += 1
    return None


boost_step.launches = 0
boost_step.collapse_launches = 0


# ---------------------------------------------------------------------------
# K-R softmax_boost_step
# ---------------------------------------------------------------------------
def softmax_boost_step_plain(F: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                             eta: torch.Tensor, leaf: Optional[torch.Tensor],
                             row_node: Optional[torch.Tensor],
                             ghw: Optional[torch.Tensor],
                             rw: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of K-R: the reference's float32 operations in
    its order, with the multiply-adds XLA's CPU code fuses: the margin
    update one fused multiply-add a channel, the softmax's sum in channel
    order, the hessian's channel sum as ``softmax_hessian``.  With ``rw``,
    the collapse mode."""
    from .metrics import fma

    k = F.shape[2]
    if leaf is not None:
        if rw is not None:
            _collapse_update(F, eta, leaf, row_node, rw.shape[0])
        else:
            lv = leaf.gather(1, row_node.long()[..., None].expand(-1, -1, k))
            F.copy_(fma(eta[:, None, None].expand_as(lv), lv, F))
    if ghw is None:
        return
    e = torch.exp(F - F.max(dim=-1, keepdim=True).values)
    s = e[..., 0]
    for j in range(1, k):
        s = s + e[..., j]
    p = e / s[..., None]
    Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
    if rw is not None:
        _collapse_planes(ghw, p - Y[None], softmax_hessian(p), w, rw)
        return
    ghw[..., :k] = (p - Y[None]) * w[..., None]
    ghw[..., k] = softmax_hessian(p) * w


#: XLA's CPU compiler splits a reduction of more than this many elements
#: into windows of this size (its tree-reduction rewrite)
XLA_REDUCE_WINDOW = 32


def hessian_windows(k: int) -> List[Tuple[int, int]]:
    """The [start, stop) class ranges whose sums XLA's CPU code adds for the
    reference's class mean past ``XLA_REDUCE_WINDOW`` classes: the k classes
    padded to a multiple of the window, half the padding (rounded down) in
    front, cut into windows."""
    w = XLA_REDUCE_WINDOW
    lo = (-(-k // w) * w - k) // 2
    return [(max(0, s - lo), min(k, s - lo + w)) for s in range(0, k + lo, w)]


def softmax_hessian(p: torch.Tensor) -> torch.Tensor:
    """The softmax loss's scalar hessian of each row of probabilities ``p``
    [..., k]: ``max(mean_j p_j (1 - p_j), 1e-6)`` as XLA's CPU code computes
    the reference's ``(p * (1 - p)).mean(-1)``, the mean a product by
    float32(1 / k).  Up to ``XLA_REDUCE_WINDOW`` classes the first product
    is rounded and the others added by fused multiply-adds in channel order;
    past it XLA splits the sum into ``hessian_windows`` (the products
    rounded apart, each window summed in channel order, the windows' sums
    added in order)."""
    from .metrics import fma

    k = p.shape[-1]
    q = 1.0 - p
    if k <= XLA_REDUCE_WINDOW:
        h = p[..., 0] * q[..., 0]
        for j in range(1, k):
            h = fma(p[..., j], q[..., j], h)
    else:
        r = p * q
        h = None
        for a, b in hessian_windows(k):
            s = r[..., a]
            for j in range(a + 1, b):
                s = s + r[..., j]
            h = s if h is None else h + s
    return torch.clamp_min(h * float(np.float32(1.0 / k)), 1e-6)


def softmax_boost_step(F: torch.Tensor, y: torch.Tensor, w: torch.Tensor, eta: torch.Tensor,
                       leaf: Optional[torch.Tensor] = None,
                       row_node: Optional[torch.Tensor] = None,
                       ghw: Optional[torch.Tensor] = None,
                       rw: Optional[torch.Tensor] = None) -> None:
    """One softmax boosting step over k class margins ``F`` f32[T, n, k], in
    place.

    With ``leaf`` f32[T, P, k] and ``row_node`` i32[T, n]: the margin update
    ``F[t, r, j] += eta[t] * leaf[t, row_node[t, r], j]``, one fused
    multiply-add (XLA's CPU code contracts the reference's update so, but
    for one channel of three at k = 3, which it rounds twice: a last-bit
    gap there).
    With ``ghw`` f32[T, n, k + 1]: at the (updated) margins, ``p =
    softmax(F[t, r])`` (exp(F - max) over its sum), the k weighted gradients
    ``(p_j - [y_r == j]) w`` and the one scalar hessian ``max(mean_j p_j (1 -
    p_j), 1e-6) w``, with ``y`` f32[n] the class labels 0 .. k - 1 and ``w``
    f32[T, n] the row weights.  2 <= k <= ``MAX_CHANNELS``.

    The collapse mode, with ``rw`` f32[K, n]: as ``boost_step``'s, over the
    k channels (``leaf`` f32[T K, P, k], ``ghw`` f32[T K, n, k + 1]), each
    channel's update one fused multiply-add."""
    _require(F.ndim == 3 and 2 <= F.shape[2] <= MAX_CHANNELS,
             f"F must be float32[T, n, k] with 2 <= k <= {MAX_CHANNELS}")
    T, n, k = F.shape
    _check_boost(F, y, w, eta, leaf, row_node, ghw, k, rw)
    others = [t for t in (leaf, row_node, ghw, rw) if t is not None]
    if not _on_cuda(F, y, w, eta, *others):
        return softmax_boost_step_plain(F, y, w, eta, leaf, row_node, ghw, rw)
    if rw is not None:
        return _collapse_launch(softmax_boost_step, F, y, w, eta, leaf, row_node, ghw, rw,
                                BOOST_LOSSES["softmax"], k)
    for name, a in (("F", F), ("ghw", ghw)):
        _require(a is None or a.is_contiguous(), f"{name} must be contiguous (written in place)")
    if n == 0 or (leaf is None and ghw is None):
        return None
    with cuda_build.kernel_errors("softmax_boost_step"):
        from . import triton_boost as tb

    y, w, eta = y.contiguous(), w.contiguous(), eta.contiguous()
    upd = leaf is not None
    leaf_t = leaf.contiguous() if upd else F
    node_t = row_node.contiguous() if upd else F
    kp = 1 << (k - 1).bit_length()
    block = 256 if k <= 8 else max(16, 2048 // kp)  # a [block, kp] tile of 2,048 values
    grid = (-(-n // block), T)
    with torch.cuda.device(F.device), cuda_build.kernel_errors("softmax_boost_step"):
        tb.boost_step_kernel[grid](F, y, w, eta, leaf_t, node_t,
                                   ghw if ghw is not None else F, n,
                                   leaf_t.shape[1] if upd else 0, float(np.float32(1.0 / k)),
                                   UPDATE=upd, GRAD=ghw is not None,
                                   LOSS=BOOST_LOSSES["softmax"], K=k, KP=kp, BLOCK=block,
                                   num_warps=4)
    softmax_boost_step.launches += 1
    return None


softmax_boost_step.launches = 0
softmax_boost_step.collapse_launches = 0


def _collapse_launch(wrapper, F, y, w, eta, leaf, row_node, ghw, rw, loss: int, c: int) -> None:
    """Launch the collapse mode of K-H (``c`` 1) or K-R (``c`` classes)
    (``ops/triton_boost.py::collapse_step_kernel``) and count it on
    ``wrapper``."""
    for name, a in (("F", F), ("ghw", ghw)):
        _require(a is None or a.is_contiguous(), f"{name} must be contiguous (written in place)")
    T, n = F.shape[:2]
    K = rw.shape[0]
    if n == 0 or (leaf is None and ghw is None):
        return None
    name = wrapper.__name__
    with cuda_build.kernel_errors(name):
        from . import triton_boost as tb

    y, w, eta, rw = y.contiguous(), w.contiguous(), eta.contiguous(), rw.contiguous()
    upd = leaf is not None
    leaf_t = leaf.contiguous() if upd else F
    node_t = row_node.contiguous() if upd else F
    cp = max(2, 1 << (c - 1).bit_length())
    pow2 = K & (K - 1) == 0
    # a power of two K loads a [block, K cs] leaf tile of at most 8,192
    # values: past 8 classes the rows a block keep a [block, cp] tile of
    # 2,048, and the update walks class slabs of cs channels where K cp is
    # too wide for that
    block = 1024 if c == 1 else 256 if c <= 8 else max(16, 2048 // cp)
    cs = cp
    if pow2:
        if c <= 8:
            block = max(16, min(block, 8192 // (K * cp)))
        else:
            cs = max(1, min(cp, 8192 // (K * block)))
    with torch.cuda.device(F.device), cuda_build.kernel_errors(name):
        tb.collapse_step_kernel[(-(-n // block), T)](
            F, y, w, rw, eta, leaf_t, node_t, ghw if ghw is not None else F, n,
            leaf_t.shape[1] if upd else 0, float(np.float32(1.0 / K)),
            float(np.float32(1.0 / c)), UPDATE=upd, GRAD=ghw is not None, LOSS=loss, KT=K,
            HALVINGS=K.bit_length() - 1 if pow2 else 0, C=c, CP=cp, CS=cs, BLOCK=block,
            num_warps=4)
    wrapper.launches += 1
    wrapper.collapse_launches += 1
    return None


# ---------------------------------------------------------------------------
# Tree growth and boosting (the reference's grow_tree / _grow_level loops,
# _gbt_impl, fit_gbt, fit_gbt_batch on the segment-sum backends)
# ---------------------------------------------------------------------------
def level_schedule(max_depth: int, frontier: int, exact_cap: bool
                   ) -> List[Tuple[int, int, int, int, int]]:
    """Static (m, slot_base, next_free, next_cap, cap_mode) per level: exact
    unrolled widths 1, 2, 4, ... up to M / 2, then M slots per level."""
    M = frontier
    L = M.bit_length() - 1
    out = [(1 << t, (1 << t) - 1, (1 << (t + 1)) - 1, 1 << (t + 1), CAP_NONE)
           for t in range(min(max_depth, L))]
    for t in range(L, max_depth):
        sb = M - 1 + (t - L) * M
        out.append((M, sb, sb + M, M, CAP_CLAMP if exact_cap else CAP_BEAM))
    return out


def grow_trees(Xb: torch.Tensor, ghw: torch.Tensor, feat_mask: torch.Tensor,
               params: torch.Tensor, max_depth: int, n_bins: int, frontier: int,
               exact_cap: bool = False, nodes: Optional[torch.Tensor] = None,
               leaf: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grow T second-order histogram trees together, level by level.

    ``ghw`` f32[T, n, c + 1] holds the c weighted gradient channels and the
    weighted hessian, ``params`` f32[T, 4] each tree's (lambda, gamma,
    min_child_weight, min_info_gain).  Returns (nodes i32[T, P, 4], leaf
    f32[T, P] at c = 1 or f32[T, P, c], row_node i32[T, n]): the node pool
    (feature, bin, left, right; feature -1 is a leaf), the leaf values, and
    the node each row rests at.  Every level runs K-E, K-F and K-G; from
    level 1 on, only the lighter child of each sibling pair is summed
    (histogram subtraction).
    """
    T, n, C1 = ghw.shape
    c = C1 - 1
    dev = ghw.device
    P = _pool_size(max_depth, frontier)
    nodes = torch.empty((T, P, 4), dtype=torch.int32, device=dev) if nodes is None else nodes
    if leaf is None:
        leaf = torch.empty((T, P) if c == 1 else (T, P, c), dtype=torch.float32, device=dev)
    row_node = torch.zeros((T, n), dtype=torch.int32, device=dev)
    if max_depth <= 0:  # a single leaf
        nodes[:] = torch.tensor([-1, 0, 0, 0], dtype=torch.int32, device=dev)
        leaf.view(T, P, c)[:, 0] = -ghw[..., :c].sum(1) / (ghw[..., c].sum(1)
                                                          + params[:, 0])[:, None]
        return nodes, leaf, row_node
    row_slot = torch.zeros((T, n), dtype=torch.int32, device=dev)
    n_active = torch.ones((T,), dtype=torch.int32, device=dev)
    ids, hist, pair_parent, pair_light = row_slot.clone(), None, None, None
    for t, (m, sb, nf, nc, cap) in enumerate(level_schedule(max_depth, frontier, exact_cap)):
        if t == 0:
            hist = level_hist(Xb, ghw, ids, m, n_bins)
        else:
            hist = level_hist(Xb, ghw, ids, m, n_bins, hist, pair_parent, pair_light)
        split, pair_parent, pair_light, n_active = split_scan(
            hist, feat_mask, params, n_active, nodes, leaf, sb, nf, nc, cap, root=t == 0)
        row_slot, row_node, ids = route_rows(Xb, row_slot, row_node, split, pair_light, nf)
    return nodes, leaf, row_node


def as_tree(nodes: torch.Tensor, leaf: torch.Tensor) -> Tree:
    """The ``Tree`` of node pools i32[..., P, 4] and leaf values f32[..., P]
    (one channel) or f32[..., P, c]."""
    lv = leaf if leaf.ndim == nodes.ndim else leaf.unsqueeze(-1)
    return Tree(nodes[..., 0].contiguous(), nodes[..., 1].contiguous(),
                nodes[..., 2].contiguous(), nodes[..., 3].contiguous(), lv.contiguous())


def _f32(v, T: int, dev) -> torch.Tensor:
    """A per-tree float32 vector [T] on ``dev`` from a scalar, array or tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(dev, torch.float32).reshape(T)
    return torch.as_tensor(np.broadcast_to(np.asarray(v, np.float32), (T,)).copy(),
                           device=dev)


def _boost(Xb, y, w, row_w_rounds, feat_mask_rounds, loss, n_rounds, max_depth, n_bins,
           frontier, eta, params, base, exact_cap, keep_trees, n_classes=1, trees_per_round=1):
    """Boosting over the tree batch from the margins ``base`` [T]: per round
    one boosting step (K-H, or K-R over the ``n_classes`` margins of the
    softmax loss: margin update + gradients) and one tree grown per batch
    element, then a last update.  With ``trees_per_round`` = K > 1 (K
    divides ``n_rounds``), ``n_rounds / K`` steps, each one launch of the
    step kernel's collapse mode and T K trees grown together on the step's
    gradients, tree tK + k with round sK + k's subsample and feature mask.
    Returns (F f32[T, n, c], the rounds' (nodes, leaves) when
    ``keep_trees``, on the flat [n_rounds, T, ...] tree axis)."""
    T, n = w.shape
    dev = Xb.device
    K = trees_per_round
    P = _pool_size(max_depth, frontier)
    c = n_classes if loss == "softmax" else 1
    F = base[:, None, None].expand(T, n, c).contiguous()
    Fs = F if loss == "softmax" else F.view(T, n)
    lshape = (T * K, P, c) if loss == "softmax" else (T * K, P)
    ghw = torch.empty((T * K, n, c + 1), dtype=torch.float32, device=dev)
    if keep_trees:
        _require(K == 1 or T == 1, "keep_trees with trees_per_round > 1 takes one batch element")
        nodes_all = torch.empty((n_rounds // K, T * K, P, 4), dtype=torch.int32, device=dev)
        leaf_all = torch.empty((n_rounds // K,) + lshape, dtype=torch.float32, device=dev)
    nodes = torch.empty((T * K, P, 4), dtype=torch.int32, device=dev)
    leaf = torch.empty(lshape, dtype=torch.float32, device=dev)
    if loss == "softmax":
        step = softmax_boost_step
    else:
        def step(F_, y_, w_, eta_, lf_=None, rn_=None, ghw_=None, rw_=None):
            boost_step(F_, y_, w_, eta_, lf_, rn_, ghw_, loss, rw_)
    if K > 1:
        params = params.repeat_interleave(K, dim=0)
    prev = (None, None)
    rw = None
    for r in range(n_rounds // K):
        if K == 1:
            w_r = w * row_w_rounds[r][None]
            fm = feat_mask_rounds[r][None].expand(T, -1).contiguous()
            step(Fs, y, w_r, eta, prev[0], prev[1], ghw)
        else:
            rw = row_w_rounds[r * K:(r + 1) * K].to(dev, torch.float32).contiguous()
            fm = feat_mask_rounds[r * K:(r + 1) * K][None].expand(T, -1, -1).reshape(T * K, -1)
            step(Fs, y, w, eta, prev[0], prev[1], ghw, rw)
        nd, lf = (nodes_all[r], leaf_all[r]) if keep_trees else (nodes, leaf)
        _, _, row_node = grow_trees(Xb, ghw, fm.contiguous(), params, max_depth, n_bins,
                                    frontier, exact_cap, nd, lf)
        prev = (lf, row_node)
    if n_rounds:
        step(Fs, y, w, eta, prev[0], prev[1], None, rw)
    trees = None
    if keep_trees:  # step r's tree tK + k is round rK + k's
        trees = (nodes_all.reshape((n_rounds, T) + nodes_all.shape[2:]),
                 leaf_all.reshape((n_rounds, T) + leaf_all.shape[2:]))
    return F, trees


def _boost_args(loss: str, n_classes: int, n_rounds: int, trees_per_round: int) -> int:
    """Check a boosting call's loss and classes; the collapse factor K (1
    for ``trees_per_round`` <= 1), which must divide ``n_rounds``."""
    if loss not in BOOST_LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    if loss == "softmax" and not 2 <= int(n_classes) <= MAX_CHANNELS:
        raise ValueError(f"softmax boosting takes 2 to {MAX_CHANNELS} classes, got {n_classes}")
    K = max(int(trees_per_round), 1)
    if n_rounds % K:
        raise ValueError(f"trees_per_round={K} must divide n_rounds={n_rounds}")
    return K


def fit_gbt(Xb: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
            row_w_rounds: torch.Tensor, feat_mask_rounds: torch.Tensor, loss: str,
            n_rounds: int, max_depth: int, n_bins: int, frontier: int, eta: float = 0.3,
            reg_lambda: float = 1.0, gamma: float = 0.0, min_child_weight: float = 1.0,
            base_score: float = 0.0, n_classes: int = 1, min_info_gain: float = 0.0,
            exact_cap: bool = False, trees_per_round: int = 1) -> Tuple[Tree, torch.Tensor]:
    """XGBoost-style boosting (logistic, squared, or softmax over
    ``n_classes`` with multi-output trees: a leaf vector per class), one
    histogram tree per round from the margin ``base_score``, on Xb's
    device.

    ``row_w_rounds`` f32[R, n] and ``feat_mask_rounds`` f32[R, d] are the
    per-round subsample and colsample masks.  ``trees_per_round`` = K > 1
    collapses the chain: ``n_rounds / K`` steps of K trees on shared
    gradients at ``eta / K`` (K must divide ``n_rounds``), each tree with
    its round's masks; ``predict_gbt`` at ``eta / K`` scores the stacked
    trees.  Returns (the stacked ``Tree`` [R, P] with leaves [R, P, c],
    final margins F f32[n, c]; c = 1 but for the softmax's
    ``n_classes``)."""
    K = _boost_args(loss, n_classes, n_rounds, trees_per_round)
    dev = Xb.device
    params = torch.tensor([[reg_lambda, gamma, min_child_weight, min_info_gain]],
                          dtype=torch.float32, device=dev)
    F, (nodes, leaf) = _boost(
        Xb, y.to(dev, torch.float32), w.to(dev, torch.float32)[None], row_w_rounds,
        feat_mask_rounds, loss, n_rounds, max_depth, n_bins, frontier, _f32(eta, 1, dev), params,
        _f32(base_score, 1, dev), exact_cap, keep_trees=True, n_classes=n_classes,
        trees_per_round=K)
    return as_tree(nodes[:, 0], leaf[:, 0]), F[0]


def fit_gbt_batch(Xb: torch.Tensor, y: torch.Tensor, w_batch: torch.Tensor,
                  row_w_rounds: torch.Tensor, feat_mask_rounds: torch.Tensor, loss: str,
                  n_rounds: int, max_depth: int, n_bins: int, frontier: int, eta_b,
                  reg_lambda_b, gamma_b, min_child_weight_b, base_score_b=None,
                  n_classes: int = 1, min_info_gain_b=None, exact_cap: bool = False,
                  trees_per_round: int = 1) -> torch.Tensor:
    """The fold x grid boosting sweep: ``w_batch`` f32[B, n] carries each
    batch element's fold-mask x sample weights, the ``*_b`` arrays its
    hyperparameters and starting margin.  All B trees of a round grow
    together (B K trees a step with ``trees_per_round`` = K > 1, as
    ``fit_gbt``).  Returns the final margins F f32[B, n, c] on every row."""
    K = _boost_args(loss, n_classes, n_rounds, trees_per_round)
    dev = Xb.device
    B = w_batch.shape[0]
    zeros = np.zeros(B, np.float32)
    params = torch.stack([_f32(reg_lambda_b, B, dev), _f32(gamma_b, B, dev),
                          _f32(min_child_weight_b, B, dev),
                          _f32(zeros if min_info_gain_b is None else min_info_gain_b, B, dev)],
                         dim=1)
    F, _ = _boost(Xb, y.to(dev, torch.float32), w_batch.to(dev, torch.float32).contiguous(),
                  row_w_rounds, feat_mask_rounds, loss, n_rounds, max_depth, n_bins, frontier,
                  _f32(eta_b, B, dev), params,
                  _f32(zeros if base_score_b is None else base_score_b, B, dev),
                  exact_cap, keep_trees=False, n_classes=n_classes, trees_per_round=K)
    return F


# ---------------------------------------------------------------------------
# Forests (the reference's grow_forest, fit_forest, fit_forest_chunked,
# forest_chunk_size, balanced_chunk, predict_forest_groups): K-E, K-F and
# K-G grow the trees, K-M reads the sweep's leaves
# ---------------------------------------------------------------------------
def grow_forest(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor, w_t: torch.Tensor,
                feat_mask_t: torch.Tensor, max_depth: int, n_bins: int, frontier: int,
                reg_lambda_t, gamma_t, mcw_t, mig_t, exact_cap: bool = False,
                return_row_node: bool = False):
    """Grow T trees together on shared gradients ``g`` f32[n, c] and ``h``
    f32[n] (the forests' g = -y or, multiclass, g = -onehot(y); h = 1),
    each tree with its row weights ``w_t`` f32[T, n], feature mask and
    (lambda, gamma, min_child_weight, min_info_gain) f32[T].  Returns the
    ``Tree`` [T, P] with leaf values [T, P, c] (and each row's node i32[T,
    n] when ``return_row_node``: growth routes every row, so it is the leaf
    the row reaches)."""
    _require(g.ndim == 2 and 1 <= g.shape[1] <= MAX_CHANNELS,
             f"g must be float32[n, c] with 1 <= c <= {MAX_CHANNELS}, got {tuple(g.shape)}")
    dev = Xb.device
    T = w_t.shape[0]
    ghw = torch.cat([w_t[..., None] * g[None], (w_t * h[None])[..., None]], dim=-1).contiguous()
    params = torch.stack([_f32(v, T, dev) for v in (reg_lambda_t, gamma_t, mcw_t, mig_t)],
                         dim=1)
    nodes, leaf, row_node = grow_trees(Xb, ghw, feat_mask_t.to(dev, torch.float32).contiguous(),
                                       params, max_depth, n_bins, frontier, exact_cap)
    tree = as_tree(nodes, leaf)
    return (tree, row_node) if return_row_node else tree


def fit_forest(Xb, g, h, w_trees, feat_masks, max_depth: int, n_bins: int, frontier: int,
               reg_lambda: float = 1e-6, min_child_weight: float = 1.0,
               min_info_gain: float = 0.0, exact_cap: bool = False) -> Tree:
    """All trees of one forest in one batch: ``w_trees`` f32[T, n] bootstrap
    weights, ``feat_masks`` f32[T, d]."""
    T = w_trees.shape[0]
    return grow_forest(Xb, g, h, w_trees, feat_masks, max_depth, n_bins, frontier,
                       np.full(T, reg_lambda, np.float32), np.zeros(T, np.float32),
                       np.full(T, min_child_weight, np.float32),
                       np.full(T, min_info_gain, np.float32), exact_cap=exact_cap)


def fit_forest_chunked(Xb, g, h, w_trees, feat_masks, mcw_trees, max_depth: int,
                       n_bins: int, chunk: int, frontier: int, reg_lambda: float = 1e-6,
                       mig_trees=None, exact_cap: bool = False) -> Tree:
    """A tree population grown ``chunk`` trees at a time (trees are
    independent, so the chunking changes no result), with per-tree
    min_child_weight and min_info_gain."""
    TT = w_trees.shape[0]
    dev = Xb.device
    mcw = _f32(mcw_trees, TT, dev)
    mig = torch.zeros(TT, device=dev) if mig_trees is None else _f32(mig_trees, TT, dev)
    parts = []
    for lo in range(0, TT, chunk):
        hi = min(lo + chunk, TT)
        k = hi - lo
        parts.append(grow_forest(Xb, g, h, w_trees[lo:hi], feat_masks[lo:hi], max_depth,
                                 n_bins, frontier, torch.full((k,), reg_lambda, device=dev),
                                 torch.zeros(k, device=dev), mcw[lo:hi], mig[lo:hi],
                                 exact_cap=exact_cap))
    return Tree(*(torch.cat(a) for a in zip(*parts)))


def forest_chunk_size(max_depth: int, n_bins: int, d: int, c: int, frontier: int,
                      budget_bytes: float = 3e9, n_rows: int = 0) -> int:
    """The JAX package's trees per chunk (its spec records it): a level's
    histograms and temporaries (x3.5 with histogram subtraction) and its
    slot one-hot [M, n] (``2 * n_rows``) per tree within the budget."""
    per_tree = frontier * (n_bins * d * (c + 1) * 3.5 + 2 * n_rows) * 4
    return max(1, int(budget_bytes / max(per_tree, 1)))


def balanced_chunk(total: int, chunk_max: int) -> int:
    """Even chunk size: the fewest chunks within ``chunk_max``, sized alike."""
    total = max(int(total), 1)
    n_chunks = -(-total // max(int(chunk_max), 1))
    return -(-total // n_chunks)


#: the port's own bound on the buffers of one batch of forest trees
FOREST_BATCH_BYTES = 8e9


def forest_batch_size(n: int, d: int, n_bins: int, frontier: int, c: int = 1) -> int:
    """Trees the port grows in one batch: per tree, the weights and ghw
    (4 + 4 (c + 1) bytes a row), the grower's row arrays and their
    next-level copies (24 bytes a row), and a level's histograms, parent
    histograms and int64 sums (16 bytes a cell of [M, c + 1, d, B]), within
    ``FOREST_BATCH_BYTES``.  The reference's ``forest_chunk_size`` budgets a
    slot one-hot [M, n] that K-E never builds."""
    per_tree = (28 + 4 * (c + 1)) * n + 16 * frontier * (c + 1) * d * n_bins
    return max(1, int(FOREST_BATCH_BYTES // per_tree))


def predict_forest_groups(Xb: torch.Tensor, forest: Tree, max_depth: int,
                          n_groups: int) -> torch.Tensor:
    """Mean leaf vector per group of consecutive trees: f32[n_groups, n, c]
    (K-B in mean mode, one launch a group)."""
    TT = forest.split_feat.shape[0]
    per = TT // n_groups
    return torch.stack([predict_forest(Xb, Tree(*(a[i * per:(i + 1) * per] for a in forest)),
                                       max_depth) for i in range(n_groups)])


# ---------------------------------------------------------------------------
# K-M forest_leaf_mean
# ---------------------------------------------------------------------------
#: the tree mean's summation order is XLA's CPU reduction of the reference's
#: ``mean(axis=trees)`` over the materialized leaf values (the sweep reads
#: the leaves inside its ``lax.map`` body and takes the mean after it):
#: above 32 trees it sums windows of 32 (the tree axis zero-padded evenly at
#: both ends to whole windows), each in tree order, and again windows of 32
#: of those sums above 1,024 trees, then the last level's sums in order,
#: and multiplies by float32(1 / T); up to 32 trees it is one window.
#: (Checked bit for bit against ``jax.jit`` of that expression at every T
#: from 1 to 64 and at 300, 700, 1,000 and 1,100, for 1 and 3 channels and
#: several row counts: ``tests/test_torch_forest_mean.py``.)
MEAN_WINDOW = 32


def _mean_windows(T: int) -> Tuple[int, int, int, int]:
    """(windows, leading zero pad) of the tree sum's two window levels: the
    trees' windows (W1, lo1) and the windows of their sums (W2, lo2); one
    window where a level holds at most ``MEAN_WINDOW``.  At most
    ``MEAN_WINDOW ** 3`` trees."""
    levels = []
    L = T
    for _ in range(2):
        W = -(-L // MEAN_WINDOW) if L > MEAN_WINDOW else 1
        levels += [W, (W * MEAN_WINDOW - L) // 2 if W > 1 else 0]
        L = W
    _require(L <= MEAN_WINDOW, f"at most {MEAN_WINDOW ** 3} trees a group, got {T}")
    return tuple(levels)


def forest_leaf_mean_plain(leaf: torch.Tensor, row_node: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K-M: the gather, the windowed tree sum per
    channel, the multiplication by float32(1 / T)."""
    G, T, P = leaf.shape[:3]
    lv = leaf.reshape(G, T, P, -1)
    node = row_node.long()[..., None].expand(-1, -1, -1, lv.shape[3])
    vals = lv.gather(2, node)                                   # [G, T, n, c]
    W1, lo1, W2, lo2 = _mean_windows(T)

    def windows(parts, W, lo):
        out = []
        for w in range(W):
            part = torch.zeros_like(vals[:, 0])
            for t in range(max(w * MEAN_WINDOW - lo, 0), min((w + 1) * MEAN_WINDOW - lo,
                                                             len(parts))):
                part = part + parts[t]
            out.append(part)
        return out

    sums = windows(windows([vals[:, t] for t in range(T)], W1, lo1), W2, lo2)
    total = torch.zeros_like(vals[:, 0])
    for part in sums:
        total = total + part
    out = total * float(np.float32(1.0 / T))
    return out if leaf.ndim == 4 else out[..., 0]


def forest_leaf_mean(leaf: torch.Tensor, row_node: torch.Tensor) -> torch.Tensor:
    """The mean leaf value of each row over each group's T trees: ``leaf``
    f32[G, T, P, c] the trees' leaf values (or f32[G, T, P], one channel),
    ``row_node`` i32[G, T, n] the leaf each row reaches; f32[G, n, c] (or
    f32[G, n]), each channel summed in the order of ``MEAN_WINDOW``; at
    most ``MEAN_WINDOW ** 3`` trees a group."""
    _require(leaf.dtype == torch.float32 and leaf.ndim in (3, 4),
             "leaf must be float32[G, T, P] or [G, T, P, c]")
    G, T, P = leaf.shape[:3]
    c = leaf.shape[3] if leaf.ndim == 4 else 1
    _require(row_node.dtype == torch.int32 and row_node.ndim == 3
             and tuple(row_node.shape[:2]) == (G, T), f"row_node must be int32[{G}, {T}, n]")
    _require(T >= 1, "need at least one tree")
    W1, lo1, W2, lo2 = _mean_windows(T)
    if not _on_cuda(leaf, row_node):
        return forest_leaf_mean_plain(leaf, row_node)
    with cuda_build.kernel_errors("forest_leaf_mean"):
        from . import triton_forest as tf

    leaf, row_node = leaf.contiguous(), row_node.contiguous()
    n = row_node.shape[2]
    out = torch.empty((G, n, c) if leaf.ndim == 4 else (G, n), dtype=torch.float32,
                      device=leaf.device)
    if n == 0 or G == 0:
        return out
    block = 512
    with torch.cuda.device(leaf.device), cuda_build.kernel_errors("forest_leaf_mean"):
        tf.forest_leaf_mean_kernel[(-(-(n * c) // block), G)](
            leaf, row_node, out, n, c, T, P, W1, lo1, W2, lo2, float(np.float32(1.0 / T)),
            WINDOW=MEAN_WINDOW, BLOCK=block, num_warps=4)
    forest_leaf_mean.launches += 1
    return out


forest_leaf_mean.launches = 0
