"""PyTorch port vs JAX package: tree binning (K-A) and the ensemble walk (K-B).

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are held against those on the card by ``chip_smoke.py``).  The same
numpy inputs go through ``transmogrifai_tpu.ops.trees`` and
``transmogrifai_tpu_torch.ops.trees``:

- bins are bit-equal, dtype included, at 32 / 128 / 129 bins and for NaN,
  +-inf, -0.0 and values equal to an edge;
- per-(row, tree) leaf indices are bit-equal (the JAX side reads them
  through its own ``predict_tree`` with leaf values set to the pool index);
- margins agree within atol=rtol=1e-5: float32 sums over trees run in
  another order than XLA's reduction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.ops import trees as JTr

from transmogrifai_tpu_torch.ops import trees as Tr

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_tree(tree: Tr.Tree) -> JTr.Tree:
    return JTr.Tree(*(jnp.asarray(a.numpy()) for a in tree))


def _port_tree(tree: JTr.Tree) -> Tr.Tree:
    return Tr.Tree(*(_t(np.asarray(a)) for a in tree))


def _jax_leaves(Xb, tree: JTr.Tree, max_depth: int) -> np.ndarray:
    """[n, T] leaf pool indices from the JAX walk itself (``predict_tree``
    over every tree, leaf values replaced by the pool index)."""
    T, P = tree.split_feat.shape
    idx = jnp.broadcast_to(jnp.arange(P, dtype=jnp.float32)[None, :, None], (T, P, 1))
    walk = jax.jit(jax.vmap(lambda t: JTr.predict_tree(jnp.asarray(Xb), t, max_depth)))
    out = np.asarray(walk(tree._replace(leaf_val=idx)))[:, :, 0]  # [T, n]
    return out.T.astype(np.int32)


# ---------------------------------------------------------------------------
# K-A binning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_bins", [32, 128, 129])
def test_bin_with_edges_bit_equal(n_bins):
    rng = np.random.default_rng(n_bins)
    n, d = 300, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    edges = JTr.sketch_edges(X, n_bins)
    X[:d, :] = edges[:, : d].T                      # exactly on an edge
    X[d:2 * d, :] = edges[:, -d:].T
    X[20, :] = np.nan
    X[21, :] = np.inf
    X[22, :] = -np.inf
    X[23, :] = -0.0
    X[24, :] = 0.0
    X[rng.random((n, d)) < 0.05] = np.nan
    edges[1, 3] = edges[1, 2]                       # a repeated edge
    want = JTr.bin_with_edges(X, edges)
    got = Tr.bin_with_edges(_t(X), _t(edges)).numpy()
    assert got.dtype == want.dtype == (np.int8 if n_bins <= 128 else np.int32)
    np.testing.assert_array_equal(got, want)


def test_bin_rows_nan_edges_follow_jax():
    # the fixed-step search is reproduced step for step, so even unsorted
    # edges (NaN inside) give JAX's answer
    X = np.array([[np.nan], [-np.inf], [np.inf], [0.0], [1.0], [1.5], [2.5], [3.0]],
                 np.float32)
    edges = np.array([[1.0, np.nan, 3.0]], np.float32)
    want = JTr.bin_with_edges(X, edges)
    np.testing.assert_array_equal(Tr.bin_rows(_t(X), _t(edges)).numpy(), want)


def test_bin_dtype_rule():
    assert Tr._bin_dtype(128) == torch.int8 and Tr._bin_dtype(129) == torch.int32
    with pytest.raises(ValueError):
        Tr._bin_dtype(1)


def test_wrappers_check_inputs():
    X = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        Tr.bin_rows(X, torch.zeros((2, 7)))           # wrong feature count
    with pytest.raises(ValueError):
        Tr.bin_rows(X.double(), torch.zeros((3, 7)))  # wrong dtype
    tree = Tr.Tree(*(torch.zeros((1, 3), dtype=torch.int32) for _ in range(4)),
                   torch.zeros((1, 3, 1)))
    with pytest.raises(ValueError):
        Tr.ensemble_walk(X.to(torch.int8), tree, 2, mode="median")


# ---------------------------------------------------------------------------
# K-B walk
# ---------------------------------------------------------------------------
def _gbt(seed=0, n=512, d=6, rounds=8, depth=4, n_bins=32):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    Xb, _ = JTr.quantize(X, n_bins)
    ks, kf = JTr.rng_keys(seed)
    rw = JTr.subsample_weights(ks, n, rounds, 1.0)
    fms = JTr.feature_masks(kf, d, rounds, 1.0)
    trees, F = JTr.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.ones(n), rw, fms,
                           loss="logistic", n_rounds=rounds, max_depth=depth,
                           n_bins=n_bins, frontier=16, eta=0.3)
    return Xb, trees, F


def _forest(seed=0, n=512, d=6, n_trees=5, depth=4, n_bins=32, c=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 1] > 0).astype(np.int64)
    Xb, _ = JTr.quantize(X, n_bins)
    kb, kf = JTr.rng_keys(seed)
    wt = JTr.bootstrap_weights(kb, n, n_trees)
    fms = JTr.feature_masks(kf, d, n_trees, 0.5)
    G = -np.eye(c, dtype=np.float32)[y]
    forest = JTr.fit_forest(jnp.asarray(Xb), jnp.asarray(G), jnp.ones(n), wt, fms,
                            max_depth=depth, n_bins=n_bins, frontier=16)
    return Xb, forest


def _uneven_pool():
    """Hand-built trees whose leaves sit at depths 1 to 4, with unused pool
    slots, so rows stop at different steps of the walk."""
    P = 15
    sf = np.full((2, P), -1, np.int32)
    sb = np.zeros((2, P), np.int32)
    lt = np.zeros((2, P), np.int32)
    rt = np.zeros((2, P), np.int32)
    # tree 0: root splits f0; left is a leaf, right splits f1, then f2 deep
    for node, f, b, l, r in [(0, 0, 3, 1, 2), (2, 1, 1, 3, 4), (4, 2, 0, 5, 6), (6, 0, 5, 7, 8)]:
        sf[0, node], sb[0, node], lt[0, node], rt[0, node] = f, b, l, r
    # tree 1: a single leaf at the root
    leaf = np.random.default_rng(3).normal(size=(2, P, 1)).astype(np.float32)
    return Tr.Tree(_t(sf), _t(sb), _t(lt), _t(rt), _t(leaf))


def _check_walk(Xb, jtree, depth, mode, eta=0.3):
    ptree = _port_tree(jtree)
    leaves = Tr.leaf_indices(_t(np.asarray(Xb)), ptree, depth).numpy()
    np.testing.assert_array_equal(leaves, _jax_leaves(Xb, jtree, depth))
    if mode == "gbt":
        want = np.asarray(JTr.predict_gbt(jnp.asarray(Xb), jtree, depth, eta))
        got = Tr.predict_gbt(_t(np.asarray(Xb)), ptree, depth, eta).numpy()
    else:
        want = np.asarray(JTr.predict_forest(jnp.asarray(Xb), jtree, depth))
        got = Tr.predict_forest(_t(np.asarray(Xb)), ptree, depth).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_walk_matches_jax_on_fitted_gbt():
    Xb, trees, F = _gbt()
    _check_walk(Xb, trees, 4, "gbt")
    # and the stored trees reproduce the JAX training margins
    got = Tr.predict_gbt(_t(np.asarray(Xb)), _port_tree(trees), 4, 0.3).numpy()
    np.testing.assert_allclose(got, np.asarray(F), **TOL)


def test_walk_matches_jax_on_uneven_pool():
    rng = np.random.default_rng(7)
    Xb = rng.integers(0, 8, size=(200, 3)).astype(np.int8)
    jtree = _jax_tree(_uneven_pool())
    for depth in (0, 2, 6):
        _check_walk(Xb, jtree, depth, "gbt", eta=0.7)
        _check_walk(Xb, jtree, depth, "forest")


def test_walk_matches_jax_on_forest():
    Xb, forest = _forest()
    _check_walk(Xb, forest, 4, "forest")


@pytest.mark.parametrize("bin_dtype", [np.int8, np.int32])
def test_walk_reads_int8_and_int32_bins(bin_dtype):
    Xb, trees, _ = _gbt(seed=1)
    Xb = np.asarray(Xb).astype(bin_dtype)
    _check_walk(Xb, trees, 4, "gbt")


def test_predict_tree_is_one_tree_walk():
    Xb, trees, _ = _gbt(seed=2)
    t0 = JTr.Tree(*(a[0] for a in trees))
    want = np.asarray(JTr.predict_tree(jnp.asarray(Xb), t0, 4))
    got = Tr.predict_tree(_t(np.asarray(Xb)), _port_tree(t0), 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_tree_params_round_trip_and_validation():
    from transmogrifai_tpu_torch.impl.trees_common import tree_from_params, tree_params

    _, trees, _ = _gbt(seed=3)
    params = {k: np.asarray(v) for k, v in zip(JTr.Tree._fields, trees)}
    params["edges"] = np.zeros((6, 31), np.float32)
    tree = tree_from_params(params, "cpu")
    back = tree_params(tree)
    for name in JTr.Tree._fields:
        np.testing.assert_array_equal(back[name], params[name])
    bad = dict(params, split_feat=np.where(params["split_feat"] >= 0, 6, -1))
    with pytest.raises(ValueError, match="split_feat out of range"):
        tree_from_params(bad, "cpu")
    bad = dict(params, left=np.full_like(params["left"], 10 ** 6))
    with pytest.raises(ValueError, match="left child index out of range"):
        tree_from_params(bad, "cpu")
