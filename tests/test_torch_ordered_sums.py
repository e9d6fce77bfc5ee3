"""K-E's histogram sums in the reference's float32 row order, K-H's squared
update as one fused multiply-add, and K-V's and K-U's plain versions at
their redesigned entries' shapes, on the port against the JAX package, on
the CPU.

- ``level_hist_plain`` (K-E's plain version) on real-valued channels: bit
  for bit the JAX package's ``_level_histograms`` (XLA's ``segment_sum``,
  each bucket summed in float32 in row order) at 2, 4 and 27 channels with
  dead rows, and a sequential float32 sum in row order; the light-child
  build with the heavy sibling as parent - light over several levels of one
  tree (the reference's ``grow_tree``: nodes and leaf values bit for bit).
- ``hist_exact`` sends to the fixed-point path only the inputs whose sums
  every order gives alike, and both paths agree there.
- ``boost_step_plain``'s squared update: the reference's margins bit for
  bit over a replay of its own trees (the twin of
  ``tests/test_torch_boost_update.py``'s logistic test).
- ``fit_gbt`` (squared and logistic, subsampled) and ``fit_forest`` on a
  real target: trees node for node, the squared loss's and the forest's
  leaf values bit for bit (the logistic loss's within the last bits of
  ``exp``).
- K-V's score mode and K-U's plain versions at the shapes of the entries
  this redesign added (naive Bayes at 26 classes, Bernoulli; the "bow" MLP
  (2110, 10, 2) past ``MLP_BLOCK_PARAMS``), within the tolerances of
  ``tests/test_torch_wide_families.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.impl.classification import naive_bayes as JNB
from transmogrifai_tpu.ops import mlp as JM
from transmogrifai_tpu.ops import trees as JT

from transmogrifai_tpu_torch.impl.classification import naive_bayes as PNB
from transmogrifai_tpu_torch.ops import metrics as PMET
from transmogrifai_tpu_torch.ops import mlp as PM
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)

#: K-U's gradients, logits and probabilities and K-V's joint
#: log-likelihoods against the JAX package (tests/test_torch_wide_families.py)
MLP_GRAD_RTOL = 1e-5
MLP_LOGIT_ATOL = 2e-5
MLP_PROB_ATOL = 2e-6
NB_Z_RTOL = 2e-6


def _real_inputs(seed, n, d, B, C1):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, (n, d)).astype(np.int8)
    Xb[:, 0] = rng.integers(0, 2, n)  # a binary feature: two large buckets
    scale = np.exp(rng.standard_normal((n, 1)) * 2)
    ghw = (rng.standard_normal((n, C1)) * scale).astype(np.float32)
    return rng, Xb, ghw


def _sequential(Xb, ghw, slot, m, B):
    """Each bucket summed in float32, row by row in increasing row order."""
    n, d = Xb.shape
    out = np.zeros((m, ghw.shape[1], d, B), np.float32)
    for r in range(n):
        if slot[r] >= 0:
            for j in range(d):
                out[slot[r], :, j, Xb[r, j]] += ghw[r]
    return out


# ---------------------------------------------------------------------------
# K-E: the direct build and the path choice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C1", [2, 4, 27])
def test_level_hist_sums_real_channels_as_the_reference(C1):
    n, d, B, m = 3000, 4, 32, 6
    rng, Xb, ghw = _real_inputs(C1, n, d, B, C1)
    slot = rng.integers(-1, m, n).astype(np.int32)  # a seventh of the rows rest
    G, H = JT._level_histograms(jnp.asarray(Xb), jnp.asarray(ghw), jnp.asarray(slot), m, B)
    want = np.concatenate([np.asarray(G), np.asarray(H)[:, None]], axis=1)
    ghw_t = torch.from_numpy(ghw)[None]
    assert not PT.hist_exact(ghw_t)
    got = PT.level_hist(torch.from_numpy(Xb), ghw_t, torch.from_numpy(slot)[None], m, B)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), _sequential(Xb, ghw, slot, m, B))
    assert PT.level_hist.launches == 0


def test_the_fixed_point_path_takes_only_inputs_every_order_sums_alike():
    rng = np.random.default_rng(3)
    n, d, B, m = 2000, 3, 16, 4
    Xb = torch.from_numpy(rng.integers(0, B, (n, d)).astype(np.int8))
    ids = torch.from_numpy(rng.integers(-1, m, (2, n)).astype(np.int32))
    onehot = torch.from_numpy(rng.integers(-1, 1, (2, n, 3)).astype(np.float32))
    poisson = torch.from_numpy(rng.poisson(1.0, (2, n, 1)).astype(np.float32))
    ghw = torch.cat([onehot * poisson, poisson], dim=2)  # -onehot x Poisson weights, w*h
    assert PT.hist_exact(ghw)
    exact = PT.level_hist(Xb, ghw, ids, m, B)
    assert torch.equal(exact, PT.level_hist_plain(Xb, ghw, ids, m, B))
    assert torch.equal(exact, PT.level_hist_plain(Xb, ghw, ids, m, B,
                                                  scale_bits=PT.HIST_SCALE_BITS))
    # a half-integer, or integers whose sums pass 2^24, take the ordered sums
    assert not PT.hist_exact(ghw * 0.5)
    assert not PT.hist_exact(torch.full((1, 2, 2), 2.0 ** 23 + 2.0))
    assert PT.hist_exact(torch.full((1, 2, 2), 2.0 ** 23))
    with pytest.raises(ValueError, match="fixed-point range"):
        PT.hist_exact(torch.full((1, 2, 2), float("inf")))


def _assert_same_leaves(got, want, split_feat):
    """Every leaf's values bit for bit.  (The root's stored value, which no
    walk reads once it splits, is the reference's ``gw.sum()`` over the rows
    in XLA's reduction order, not a histogram sum: it may differ in the
    last bit.)"""
    leaves = split_feat < 0
    assert leaves.sum() > 1
    np.testing.assert_array_equal(got[leaves], want[leaves])


# ---------------------------------------------------------------------------
# K-E through the grower: the light child and parent - light, level by level
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [1, 3])
def test_grow_trees_on_real_gradients_equals_the_reference_bit_for_bit(c):
    """Depth 5 over 3,000 rows: every level past the root builds the light
    children alone and derives the heavy ones as parent - light in float32,
    so the leaf values equal the reference's only if every level's sums
    do."""
    n, d, B, depth = 3000, 5, 16, 5
    rng, Xb, _ = _real_inputs(10 + c, n, d, B, 1)
    g = rng.standard_normal((n, c)).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    w = rng.integers(0, 3, n).astype(np.float32)
    fm = np.ones(d, np.float32)
    fr = JT.frontier_cap(n, depth, 1.0, h_max=0.25, max_frontier=16)
    jt = JT.grow_tree(jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
                      jnp.asarray(fm), depth, B, fr, reg_lambda=1.0, gamma=0.0,
                      min_child_weight=1.0)
    gt, ht, wt = (torch.from_numpy(a) for a in (g, h, w))
    ghw = torch.cat([wt[:, None] * gt, (wt * ht)[:, None]], dim=1)[None].contiguous()
    params = torch.tensor([[1.0, 0.0, 1.0, 0.0]])
    nodes, leaf, _ = PT.grow_trees(torch.from_numpy(Xb), ghw, torch.from_numpy(fm)[None],
                                   params, depth, B, fr)
    for i, name in enumerate(("split_feat", "split_bin", "left", "right")):
        np.testing.assert_array_equal(nodes[0, :, i].numpy(), np.asarray(getattr(jt, name)),
                                      name)
    assert (nodes[0, :, 0] >= 0).sum() >= 2 ** (depth - 1)  # it grew
    _assert_same_leaves(leaf[0].reshape(-1, c).numpy(), np.asarray(jt.leaf_val),
                        np.asarray(jt.split_feat))


# ---------------------------------------------------------------------------
# K-H: the squared update, one fused multiply-add
# ---------------------------------------------------------------------------
def _frame(loss, seed=3, n=3000, d=6, n_bins=16):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, (n, d)).astype(np.int8)
    z = Xb[:, 0].astype(np.float32) - 0.6 * Xb[:, 1] + rng.standard_normal(n) * 2
    if loss == "logistic":
        return Xb, (z > 0).astype(np.float32)
    return Xb, (z * 3.7 + 20.0).astype(np.float32)


def test_plain_squared_update_equals_the_reference_margins_bit_for_bit():
    Xb, y = _frame("squared")
    n, d = Xb.shape
    R, depth, B = 12, 4, 16
    rng = np.random.default_rng(9)
    rw = (rng.random((R, n)) < 0.8).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    base = float(np.float32(y.mean()))
    trees, Fj = JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(rw),
                           jnp.asarray(np.ones((R, d), np.float32)), "squared", R, depth, B, 16,
                           eta=0.1, base_score=base)
    tree = PT.Tree(*(torch.from_numpy(np.array(a)) for a in trees))
    _, leaves = PT.ensemble_walk_plain(torch.from_numpy(Xb), tree, depth, return_leaves=True)
    F = torch.full((1, n), base, dtype=torch.float32)
    eta = torch.tensor([0.1], dtype=torch.float32)
    two = F.clone()
    for t in range(R):
        PT.boost_step_plain(F, torch.from_numpy(y), torch.ones((1, n)), eta,
                            tree.leaf_val[t:t + 1, :, 0], leaves[:, t:t + 1].T.contiguous(),
                            None, "squared")
        two = two + eta * tree.leaf_val[t, :, 0][leaves[:, t].long()][None]
    ref = np.asarray(Fj)[:, 0]
    differ = int(np.sum(F[0].numpy() != ref))
    assert differ == 0, f"{differ} of {n} margins differ from the reference's"
    assert int(np.sum(two[0].numpy() != ref)) > 0  # two roundings miss


def test_squared_step_gradients_at_the_fused_margins():
    rng = np.random.default_rng(4)
    T, n, P = 3, 500, 9
    F0 = (20.0 + rng.normal(size=(T, n))).astype(np.float32)
    y = (20.0 + 3.0 * rng.normal(size=n)).astype(np.float32)
    w = rng.integers(0, 3, size=(T, n)).astype(np.float32)
    eta = np.full(T, 0.1, np.float32)
    leaf = rng.normal(size=(T, P)).astype(np.float32)
    node = rng.integers(0, P, size=(T, n)).astype(np.int32)
    F = torch.from_numpy(F0.copy())
    ghw = torch.empty((T, n, 2))
    PT.boost_step(F, torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(eta),
                  torch.from_numpy(leaf), torch.from_numpy(node), ghw, "squared")
    lv = torch.from_numpy(np.take_along_axis(leaf, node, axis=1))
    want = PMET.fma(torch.from_numpy(eta)[:, None].expand_as(lv), lv, torch.from_numpy(F0))
    assert torch.equal(F, want)
    np.testing.assert_array_equal(ghw[..., 0].numpy(), (F.numpy() - y[None]) * w)
    np.testing.assert_array_equal(ghw[..., 1].numpy(), w)
    assert PT.boost_step.launches == 0


# ---------------------------------------------------------------------------
# Whole fits on real targets: node for node
# ---------------------------------------------------------------------------
def _assert_same_trees(pt, jt):
    for name in ("split_feat", "split_bin", "left", "right"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(jt, name)),
                                      name)
    _assert_same_leaves(pt.leaf_val.numpy(), np.asarray(jt.leaf_val), np.asarray(jt.split_feat))


@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_fit_gbt_on_real_gradients_equals_the_reference_node_for_node(loss):
    Xb, y = _frame(loss, seed=7, n=2000)
    n, d = Xb.shape
    R, depth, B = 10, 5, 16
    rng = np.random.default_rng(8)
    rw = (rng.random((R, n)) < 0.8).astype(np.float32)
    fm = (rng.random((R, d)) < 0.8).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    base = float(np.float32(y.mean())) if loss == "squared" else 0.0
    kw = dict(eta=0.1, reg_lambda=1.0, gamma=0.0, min_child_weight=1.0, base_score=base)
    jt, jF = JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(rw),
                        jnp.asarray(fm), loss, R, depth, B, 32, **kw)
    pt, pF = PT.fit_gbt(torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(w),
                        torch.from_numpy(rw), torch.from_numpy(fm), loss, R, depth, B, 32, **kw)
    assert (pt.split_feat >= 0).sum() > R * 4
    if loss == "squared":
        _assert_same_trees(pt, jt)
        np.testing.assert_array_equal(pF.numpy(), np.asarray(jF))
        return
    # the logistic gradients take exp, whose last bit differs between
    # torch's and XLA's CPU code (ops/trees.py::_sigmoid): the splits are
    # the reference's, the leaf values and margins within a few ulps
    for name in ("split_feat", "split_bin", "left", "right"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(jt, name)),
                                      name)
    np.testing.assert_allclose(pt.leaf_val.numpy(), np.asarray(jt.leaf_val), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pF.numpy(), np.asarray(jF), rtol=0, atol=1e-5)


def test_fit_forest_on_a_real_target_equals_the_reference_node_for_node():
    Xb, y = _frame("squared", seed=11, n=2000)
    n, d = Xb.shape
    T, depth, B = 6, 6, 16
    rng = np.random.default_rng(12)
    w_trees = rng.poisson(1.0, (T, n)).astype(np.float32)
    fm = (rng.random((T, d)) < 0.7).astype(np.float32)
    fm[:, 0] = 1.0
    g = -y[:, None]
    h = np.ones(n, np.float32)
    fr = JT.frontier_cap(n, depth, 10.0, max_frontier=32)
    jt = JT.fit_forest(jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w_trees),
                       jnp.asarray(fm), depth, B, fr, min_child_weight=10.0)
    ghw = torch.cat([torch.from_numpy(w_trees)[..., None] * torch.from_numpy(g)[None],
                     torch.from_numpy(w_trees)[..., None]], dim=-1)
    assert not PT.hist_exact(ghw)  # a real target takes the ordered sums
    pt = PT.fit_forest(torch.from_numpy(Xb), torch.from_numpy(g), torch.from_numpy(h),
                       torch.from_numpy(w_trees), torch.from_numpy(fm), depth, B, fr,
                       min_child_weight=10.0)
    _assert_same_trees(pt, jt)


# ---------------------------------------------------------------------------
# K-V's score mode and K-U's GEMM-shaped entry: their plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bernoulli", [False, True])
def test_nb_plain_matches_jax_at_26_classes(bernoulli):
    n, d, k = 700, 32, 26
    rng = np.random.default_rng(21)
    X = rng.integers(0, 16, (n, d)).astype(np.float32)
    Xd = (X > 3).astype(np.float32) if bernoulli else X
    y = rng.integers(0, k, n).astype(np.float32)
    y[:k] = np.arange(k)
    tw = np.ones((3, n), np.float32)
    for f in range(3):
        tw[f, f::3] = 0.0
    sm = np.array([1.0], np.float32)
    zj = np.asarray(JNB._nb_grid_z(jnp.asarray(Xd), jnp.asarray(np.eye(k, dtype=np.float32)[
        y.astype(int)]), jnp.asarray(tw), jnp.asarray(sm), bernoulli))
    zp = PNB._nb_grid_z(torch.from_numpy(Xd), torch.from_numpy(y), torch.from_numpy(tw), sm,
                        bernoulli, k).numpy()
    assert zp.shape == zj.shape == (3, 1, n, k)
    np.testing.assert_allclose(zp, zj, rtol=NB_Z_RTOL, atol=2e-4)
    assert PNB.nb_tables_score.launches == 0


def test_mlp_plain_matches_jax_at_the_bag_of_words_network():
    layers = (2110, 10, 2)
    assert PM.gemm_entry(layers) and not PM.gemm_entry((32, 128, 64, 26))
    n, G = 200, 2
    rng = np.random.default_rng(22)
    X = rng.poisson(0.05, (n, layers[0])).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    w = rng.integers(0, 3, (2, n)).astype(np.float32)
    flat = (rng.normal(size=(2 * G, PM.param_count(layers))) * 0.1).astype(np.float32)
    fold = torch.arange(2 * G, dtype=torch.int32) // G
    wsum = torch.clamp_min(torch.from_numpy(w).sum(1), 1e-12)[fold.long()].contiguous()
    got = PM.mlp_grad(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w), fold, wsum,
                      torch.from_numpy(flat), layers).numpy()
    Y = jax.nn.one_hot(jnp.asarray(y).astype(jnp.int32), 2, dtype=jnp.float32)
    for c in range(2 * G):
        params = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy()))
                  for W, b in PM.unflatten(torch.from_numpy(flat[c]), layers)]
        wc = jnp.asarray(w[c // G])

        def loss_fn(p, wc=wc):
            ll = jax.nn.log_softmax(JM.forward(p, jnp.asarray(X)), axis=-1)
            return -(wc[:, None] * Y * ll).sum() / jnp.maximum(wc.sum(), 1e-12)

        want = np.concatenate([np.concatenate([np.asarray(a).reshape(-1), np.asarray(b)])
                               for a, b in jax.grad(loss_fn)(params)])
        np.testing.assert_allclose(got[c], want, rtol=0,
                                   atol=MLP_GRAD_RTOL * np.abs(want).max())
        jz, jp, _ = JM.predict_mlp(params, jnp.asarray(X))
        z, prob = PM.mlp_forward(torch.from_numpy(X), torch.from_numpy(flat[c:c + 1]), layers)
        np.testing.assert_allclose(z[0].numpy(), np.asarray(jz), rtol=0, atol=MLP_LOGIT_ATOL)
        np.testing.assert_allclose(prob[0].numpy(), np.asarray(jp), rtol=0, atol=MLP_PROB_ATOL)
    assert PM.mlp_grad.launches == 0 and PM.mlp_forward.launches == 0
