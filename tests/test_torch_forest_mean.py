"""K-M's tree-mean order against the JAX package's, on the CPU.

The fused sweep of the JAX package reads each forest's leaves inside the
body of its ``lax.map`` over tree chunks and takes the mean over each
(fold, candidate)'s trees after it
(``transmogrifai_tpu/ops/sweep.py:248-272``), so XLA reduces a
materialized [F, Gc, T, n, c] array.  Its CPU reduction sums up to 32
trees in tree order, windows of 32 above (the tree axis zero-padded evenly
at both ends), windows of 32 window sums above 1,024 trees, and multiplies
by float32(1 / T).  ``ops/trees.py::forest_leaf_mean_plain`` (and the
Triton kernel, on the card) replays it: bit-equal to ``jax.jit`` of that
expression at every T from 1 to 64 and at 300 and 1,100, for one and three
channels, at two row counts; and to the reference's own
``_forest_group_scores`` on grown forests of 20, 24 and 32 trees.

Fusing the gather into the reduction, as ``jax.jit(take_along_axis +
mean)`` of one expression does, is another program: LLVM vectorizes that
loop (8 lanes, halved pairwise, a 2-lane epilogue) from 18 to 20 trees up
depending on the shapes, and its sums differ from these in the last bit.
The reference's sweep never compiles that fusion.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from transmogrifai_tpu.ops import sweep as JS
from transmogrifai_tpu.ops import trees as JT

from transmogrifai_tpu_torch.ops import sweep as PS
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

TREES = list(range(1, 65)) + [300, 1100]


def _sweep_mean(leaf, row_node, F, Gc, chunk):
    """The reference sweep's leaf read and tree mean: a ``lax.map`` over
    tree chunks gathering each tree's leaf values, then the mean over each
    (fold, candidate)'s trees of the sliced, reshaped result."""
    G, T, P, c = leaf.shape
    n = row_node.shape[2]
    TT = G * T
    pad = (-TT) % chunk
    lv = jnp.concatenate([leaf.reshape(TT, P, c), jnp.zeros((pad, P, c), leaf.dtype)])
    rn = jnp.concatenate([row_node.reshape(TT, n), jnp.zeros((pad, n), row_node.dtype)])

    def one_chunk(args):
        lvs, rns = args
        return jnp.take_along_axis(lvs, rns[:, :, None].repeat(c, axis=2), axis=1)

    preds = lax.map(one_chunk, (lv.reshape(-1, chunk, P, c), rn.reshape(-1, chunk, n)))
    preds = preds.reshape((-1,) + preds.shape[2:])[:TT]
    return preds.reshape(F, Gc, T, n, -1).mean(axis=2)


_sweep_mean_jit = jax.jit(_sweep_mean, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("n", [7, 45])
def test_plain_tree_mean_is_bit_equal_to_the_sweeps(c, n):
    F, Gc, P = 1, 2, 13
    rng = np.random.default_rng(100 * c + n)
    bad = []
    for T in TREES:
        leaf = rng.standard_normal((F * Gc, T, P, c)).astype(np.float32)
        node = rng.integers(0, P, (F * Gc, T, n)).astype(np.int32)
        want = np.asarray(_sweep_mean_jit(jnp.asarray(leaf), jnp.asarray(node), F, Gc,
                                          max(T // 3, 1))).reshape(F * Gc, n, c)
        got = PT.forest_leaf_mean_plain(torch.from_numpy(leaf), torch.from_numpy(node))
        got = got.numpy().reshape(F * Gc, n, c)
        if not np.array_equal(got, want):
            bad.append((T, float(np.mean(got != want))))
    assert not bad, f"(trees, share of means that differ): {bad}"


def test_one_channel_leaves_take_the_same_order():
    rng = np.random.default_rng(1)
    leaf = rng.standard_normal((3, 1100, 9)).astype(np.float32)
    node = rng.integers(0, 9, (3, 1100, 20)).astype(np.int32)
    got = PT.forest_leaf_mean_plain(torch.from_numpy(leaf), torch.from_numpy(node))
    want = PT.forest_leaf_mean_plain(torch.from_numpy(leaf[..., None]), torch.from_numpy(node))
    assert torch.equal(got, want[..., 0])


def test_window_levels():
    assert PT._mean_windows(32) == (1, 0, 1, 0)
    assert PT._mean_windows(50) == (2, 7, 1, 0)
    assert PT._mean_windows(1024) == (32, 0, 1, 0)
    assert PT._mean_windows(1100) == (35, 10, 2, 14)
    with pytest.raises(ValueError, match="trees a group"):
        PT._mean_windows(32 ** 3 + 1)


@pytest.mark.parametrize("c", [1, 3])
def test_forest_group_scores_equal_the_references_at_20_to_32_trees(c):
    """Grown forests (integer weights: the trees are bit-equal), scored by
    each package's fused-sweep group: the same means bit for bit."""
    rng = np.random.default_rng(11)
    n, d = 90, 4
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, 2 if c == 1 else 3, n).astype(np.float32)
    Xb = np.asarray(JT.quantize(jnp.asarray(X), 8)[0])
    tw = np.ones((2, n), np.float32)
    tw[0, :30] = 0.0
    tw[1, 30:60] = 0.0
    blob = np.array([1.0, 2.0, 0.0, 0.0], np.float32)
    # (trees, trees a chunk of the reference's lax.map)
    for T, chunk in ((20, 20), (24, 7), (32, 32)):
        group = ((0, 1), 3, T, 0, 8, 0.5, 1.0, True, 42, 8, False, chunk, 0, 2)
        want = np.asarray(jax.jit(
            lambda xb, yy, w, b: JS._forest_group_scores(group, (xb,), yy, w, b, c))(
                jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(tw), jnp.asarray(blob)))
        got = PS._forest_group_scores(group, (torch.from_numpy(Xb),), torch.from_numpy(y),
                                      torch.from_numpy(tw), blob, c).numpy()
        np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=f"T={T}")
