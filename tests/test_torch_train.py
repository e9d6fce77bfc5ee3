"""The port's boosting fit against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
functions of ``transmogrifai_tpu/ops/trees.py`` (its segment-sum CPU path)
and through the plain PyTorch versions of the port's kernels
(``transmogrifai_tpu_torch/ops/trees.py``: K-E ``level_hist``, K-F
``split_scan``, K-G ``route_rows``, K-H ``boost_step``) and its level loop:

- histograms, direct and light-only: bit-equal with integer-valued g and h
  (every float32 sum exact); within rtol 1e-6 on logistic gradients (the
  port sums in 64-bit fixed point, the JAX package in float32);
- one level of the grower (with and without the parent histograms, with
  the beam cap and the count clamp): nodes, leaf values, row slots and
  nodes, pair flags and pair histograms bit-equal on exact sums;
- the boosting step: the margin update bit-equal; the gradient and hessian
  within 2.5e-7 (the JAX package's sigmoid is XLA's expansion
  1 / (1 + exp(-x)) with its own exp, at most an ulp from torch's);
- ``fit_gbt`` / ``fit_gbt_batch``, 8 rounds at depth 4, both
  min_child_weight values: tree structure equal, leaves and margins within
  1e-5;
- quantization, frontier sizing and the draws at and below fraction 1;
- the sanity checker's statistics (``utils/stats.py``, the plain versions
  of K-I ``corr_gram`` and K-J ``contingency_counts``): contingency counts
  bit-equal; moments and label correlations within 1e-12 (float64, in
  another summation order); the float32 correlation matrix within 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.ops import trees as JT
from transmogrifai_tpu.utils import stats as JS
from transmogrifai_tpu_torch.ops import stats as PK
from transmogrifai_tpu_torch.ops import trees as PT
from transmogrifai_tpu_torch.utils import stats as PS

torch.set_num_threads(1)


def _exact_level_inputs(seed, n=400, d=5, B=16, m=8):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, size=(n, d)).astype(np.int8)
    gh = np.stack([rng.integers(-2, 3, n), rng.integers(1, 3, n)], axis=1).astype(np.float32)
    w = rng.integers(0, 2, n).astype(np.float32)
    return rng, Xb, gh, w


# ---------------------------------------------------------------------------
# K1 -> K-E level_hist
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exact", [True, False])
def test_level_hist_direct_matches_jax(exact):
    rng = np.random.default_rng(1)
    n, d, B, m = 3000, 6, 32, 8
    Xb = rng.integers(0, B, size=(n, d)).astype(np.int8)
    if exact:
        ghw = rng.integers(-3, 4, size=(n, 2)).astype(np.float32)
    else:  # logistic gradients and hessians of random margins
        p = 1.0 / (1.0 + np.exp(-rng.normal(size=n) * 2))
        y = rng.random(n) < 0.4
        ghw = np.stack([p - y, np.maximum(p * (1 - p), 1e-6)], 1).astype(np.float32)
    slot = rng.integers(-1, m, size=n).astype(np.int32)
    G, H = JT._level_histograms(jnp.asarray(Xb), jnp.asarray(ghw), jnp.asarray(slot), m, B)
    got = PT.level_hist(torch.from_numpy(Xb), torch.from_numpy(ghw)[None],
                        torch.from_numpy(slot)[None], m, B)[0]
    want = np.stack([np.asarray(G)[:, 0], np.asarray(H)], axis=1)
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:  # the port sums in 64-bit fixed point, XLA in float32 row order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_level_hist_light_only_assembles_parent_minus_light():
    rng = np.random.default_rng(2)
    n, d, B, m, m_prev = 500, 4, 8, 6, 5
    Xb = rng.integers(0, B, size=(n, d)).astype(np.int8)
    ghw = rng.integers(-3, 4, size=(2, n, 2)).astype(np.float32)
    ids = rng.integers(-1, m // 2, size=(2, n)).astype(np.int32)
    parent = rng.integers(-20, 20, size=(2, m_prev, 2, d, B)).astype(np.float32)
    pp = np.array([[4, -1, 0], [2, 3, -1]], np.int32)
    pl = np.array([[1, 0, 0], [0, 1, 1]], np.int32)
    got = PT.level_hist(*(torch.from_numpy(a) for a in (Xb, ghw, ids)), m, B,
                        *(torch.from_numpy(a) for a in (parent, pp, pl))).numpy()
    light = PT.level_hist(*(torch.from_numpy(a) for a in (Xb, ghw, ids)), m // 2, B).numpy()
    for t in range(2):
        for j in range(m // 2):
            par = parent[t, pp[t, j]] if pp[t, j] >= 0 else np.zeros_like(parent[t, 0])
            heavy = par - light[t, j]
            left, right = (light[t, j], heavy) if pl[t, j] else (heavy, light[t, j])
            np.testing.assert_array_equal(got[t, 2 * j], left)
            np.testing.assert_array_equal(got[t, 2 * j + 1], right)


@pytest.mark.parametrize("big,bits", [(2.0 ** 30 - 64, 32), (2.0 ** 30, 31),
                                      (float("nan"), None)])
def test_level_hist_fixed_point_range_edge(big, bits):
    """Two rows of |w*g| = big in one cell: the 2^32 scale holds up to its
    range (row count x largest value below 2^31); at the edge and beyond,
    the scale drops to fewer bits so that the int64 sums cannot saturate or
    wrap, and the sum stays exact; a NaN raises."""
    Xb = torch.zeros((2, 1), dtype=torch.int8)
    ghw = torch.tensor([[[big, 1.0], [-big, 1.0]]], dtype=torch.float32)
    ids = torch.zeros((1, 2), dtype=torch.int32)
    assert PT.HIST_RANGE == 2.0 ** 31
    if bits is None:
        with pytest.raises(ValueError, match="fixed-point range"):
            PT.level_hist(Xb, ghw, ids, 1, 2)
        return
    assert PT.hist_scale_bits(2, big) == bits
    ghw[0, 1, 0] = big  # both rows add up: 2^31 - 128 or 2^31, exact in float32
    got = PT.level_hist(Xb, ghw, ids, 1, 2)
    assert got[0, 0, 0, 0, 0].item() == 2 * big
    assert got[0, 0, 1, 0, 0].item() == 2.0


# ---------------------------------------------------------------------------
# K2 / K2b / K3 -> K-F split_scan + K-G route_rows: one level of the grower
# ---------------------------------------------------------------------------
def _pair_ids(row_slot, pair_light):
    """The rows' light-child pair ids of a level (the reference's :418-422)."""
    s = np.maximum(row_slot, 0)
    lp = pair_light[s >> 1] > 0.5
    light = np.where(s % 2 == 0, lp, ~lp) & (row_slot >= 0)
    return np.where(light, row_slot >> 1, -1).astype(np.int32)


LEVELS = [  # (m, next_cap, exact_cap, with parent histograms)
    (1, 2, False, False),      # the root
    (4, 8, False, True),       # an unrolled level, light-only build
    (8, 8, False, True),       # a loop level under the beam cap
    (8, 8, True, True),        # a loop level under the count clamp
    (8, 8, False, False),      # the beam cap on a direct build
]


@pytest.mark.parametrize("m,next_cap,exact_cap,with_pairs", LEVELS)
def test_grow_level_matches_jax(m, next_cap, exact_cap, with_pairs):
    rng, Xb, gh, w = _exact_level_inputs(10 + m + next_cap + int(exact_cap))
    n, d, B = Xb.shape[0], Xb.shape[1], 16
    P_ = 64
    slot_base, next_free = m - 1, 2 * m - 1
    n_active = m - 1 if m > 2 else m
    row_slot = rng.integers(-1, n_active, size=n).astype(np.int32)
    row_node = rng.integers(0, slot_base + 1, size=n).astype(np.int32)
    nodes = np.tile(np.array([-1, 0, 0, 0], np.int32), (P_, 1))
    leaf = np.zeros((P_, 1), np.float32)
    fm = np.ones(d, np.float32)
    fm[2] = 0.0
    lam, gamma, mcw = 1.0, 0.5, 2.0
    kw = dict(m=m, next_cap=next_cap, n_bins=B, reg_lambda=lam, gamma=gamma,
              min_child_weight=mcw, exact_cap=exact_cap, want_pairs=True)
    ghw = gh * w[:, None]
    if with_pairs:
        # the previous level's full histograms and its pairs' parents
        m_prev = m
        prev = PT.level_hist_plain(torch.from_numpy(Xb), torch.from_numpy(ghw)[None],
                                   torch.from_numpy(rng.integers(-1, m_prev, size=(1, n))
                                                    .astype(np.int32)), m_prev, B)
        pair_parent = rng.permutation(m_prev)[:m // 2].astype(np.int32)
        pair_parent[-1] = -1
        pair_light = rng.integers(0, 2, size=m // 2).astype(np.int32)
        pair_hist = np.where((pair_parent >= 0)[:, None, None, None],
                             prev[0].numpy()[np.maximum(pair_parent, 0)], 0.0)
        kw.update(pair_light=jnp.asarray(pair_light.astype(np.float32)),
                  pair_hist=jnp.asarray(pair_hist.astype(np.float32)))
    out = JT._grow_level(jnp.asarray(Xb.astype(np.int32)), jnp.asarray(gh), jnp.asarray(w),
                         jnp.asarray(fm), jnp.asarray(nodes), jnp.asarray(leaf), slot_base,
                         next_free, jnp.asarray(n_active, jnp.int32), jnp.asarray(row_slot),
                         jnp.asarray(row_node), **kw)
    j_nodes, j_leaf, j_active, j_slot, j_node, j_pl, j_ph = (np.asarray(a) for a in out)

    Xt = torch.from_numpy(Xb)
    ghw_t = torch.from_numpy(ghw)[None]
    if with_pairs:
        ids = torch.from_numpy(_pair_ids(row_slot, pair_light))[None]
        hist = PT.level_hist(Xt, ghw_t, ids, m, B, prev, torch.from_numpy(pair_parent)[None],
                             torch.from_numpy(pair_light)[None])
    else:
        hist = PT.level_hist(Xt, ghw_t, torch.from_numpy(row_slot)[None], m, B)
    nodes_t = torch.from_numpy(nodes.copy())[None]
    leaf_t = torch.from_numpy(leaf[:, 0].copy())[None]
    active = torch.tensor([n_active], dtype=torch.int32)
    params = torch.tensor([[lam, gamma, mcw, 0.0]])
    cap = PT.CAP_NONE if next_cap == 2 * m else (PT.CAP_CLAMP if exact_cap else PT.CAP_BEAM)
    split, p_parent, p_light, active = PT.split_scan(
        hist, torch.from_numpy(fm)[None], params, active, nodes_t, leaf_t, slot_base,
        next_free, next_cap, cap, root=False)
    rs, rn, _ = PT.route_rows(Xt, torch.from_numpy(row_slot)[None],
                              torch.from_numpy(row_node)[None], split, p_light, next_free)

    np.testing.assert_array_equal(nodes_t[0].numpy(), j_nodes)
    np.testing.assert_array_equal(leaf_t[0].numpy(), j_leaf[:, 0])
    assert int(active[0]) == int(j_active)
    np.testing.assert_array_equal(rs[0].numpy(), j_slot)
    np.testing.assert_array_equal(rn[0].numpy(), j_node)
    np.testing.assert_array_equal(p_light[0].numpy(), j_pl.astype(np.int32))
    pp = p_parent[0].numpy()
    hist_np = hist[0].numpy()
    mine = np.where((pp >= 0)[:, None, None, None], hist_np[np.maximum(pp, 0)], 0.0)
    np.testing.assert_array_equal(mine, j_ph)
    assert int(active[0]) > 0  # the level split something


def test_beam_cap_ranks_by_gain_then_slot():
    """More valid splits than the next frontier holds: the beam keeps the
    top gains (ties to the lower slot), as the reference's double argsort."""
    T, m, d, B = 1, 6, 1, 4
    hist = torch.zeros((T, m, 2, d, B))
    gains_order = [3.0, 5.0, 5.0, 1.0, 4.0, 2.0]
    for s, g in enumerate(gains_order):  # separable slots of rising strength
        hist[0, s, 0, 0, :2] = -g
        hist[0, s, 0, 0, 2:] = g
        hist[0, s, 1, 0, :] = 2.0
    nodes = torch.zeros((T, 32, 4), dtype=torch.int32)
    leaf = torch.zeros((T, 32))
    active = torch.tensor([m], dtype=torch.int32)
    params = torch.tensor([[1.0, 0.0, 1.0, 0.0]])
    split, _, _, active = PT.split_scan(hist, torch.ones((T, d)), params, active, nodes, leaf,
                                        0, m, 6, PT.CAP_BEAM, root=True)
    kept = (split[0, :, 0] >= 0).nonzero().flatten().tolist()
    assert kept == [1, 2, 4] and int(active[0]) == 6


# ---------------------------------------------------------------------------
# K5 -> K-H boost_step
# ---------------------------------------------------------------------------
def test_boost_step_matches_jax_grad_hess():
    rng = np.random.default_rng(3)
    T, n, P_ = 2, 5000, 31
    F = (rng.normal(size=(T, n)) * 3).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.integers(0, 3, size=(T, n)).astype(np.float32)
    leaf = rng.normal(size=(T, P_)).astype(np.float32)
    node = rng.integers(0, P_, size=(T, n)).astype(np.int32)
    eta = np.array([0.3, 0.02], np.float32)
    Ft, ghw = torch.from_numpy(F.copy()), torch.empty((T, n, 2))
    PT.boost_step(Ft, torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(eta),
                  torch.from_numpy(leaf), torch.from_numpy(node), ghw)
    # the reference's update as XLA compiles it inside its boosting program:
    # one fused multiply-add
    update = jax.jit(lambda F, leaf, node, eta: F + eta * leaf[node][:, None])
    for t in range(T):
        Fj = update(jnp.asarray(F[t][:, None]), jnp.asarray(leaf[t]), jnp.asarray(node[t]),
                    eta[t])
        np.testing.assert_array_equal(Ft[t].numpy(), np.asarray(Fj)[:, 0])
        g, h = JT._grad_hess("logistic", Fj, jnp.asarray(y), None)
        np.testing.assert_allclose(ghw[t, :, 0].numpy(), np.asarray(g)[:, 0] * w[t],
                                   rtol=0, atol=2.5e-7)
        np.testing.assert_allclose(ghw[t, :, 1].numpy(), np.asarray(h) * w[t],
                                   rtol=0, atol=2.5e-7)


# ---------------------------------------------------------------------------
# boosting: fit_gbt and fit_gbt_batch
# ---------------------------------------------------------------------------
def _gbt_data(seed=0, n=300, d=6, B=16):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Xb, _ = JT.quantize(X, B)
    y = ((X[:, 0] + 0.5 * rng.normal(size=n)) > 0).astype(np.float32)
    w = (rng.random(n) < 0.7).astype(np.float32)
    return np.asarray(Xb), y, w


@pytest.mark.parametrize("mcw", [1.0, 10.0])
@pytest.mark.parametrize("exact_cap", [True, False])
def test_fit_gbt_matches_jax(mcw, exact_cap):
    Xb, y, w = _gbt_data()
    n, d = Xb.shape
    R, depth, B = 8, 4, 16
    fr = JT.frontier_cap(n, depth, mcw, h_max=0.25, max_frontier=4)
    ones_r, ones_f = np.ones((R, n), np.float32), np.ones((R, d), np.float32)
    tj, Fj = JT.fit_gbt(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(ones_r),
                        jnp.asarray(ones_f), loss="logistic", n_rounds=R, max_depth=depth,
                        n_bins=B, frontier=fr, eta=0.3, reg_lambda=1.0, gamma=0.1,
                        min_child_weight=mcw, exact_cap=exact_cap)
    tp, Fp = PT.fit_gbt(torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(w),
                        torch.from_numpy(ones_r), torch.from_numpy(ones_f), "logistic", R,
                        depth, B, fr, eta=0.3, reg_lambda=1.0, gamma=0.1,
                        min_child_weight=mcw, exact_cap=exact_cap)
    for k in ("split_feat", "split_bin", "left", "right"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(tj, k)), k)
    assert (np.asarray(tj.split_feat) >= 0).sum() > R  # the trees do split
    np.testing.assert_allclose(tp.leaf_val.numpy(), np.asarray(tj.leaf_val), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Fp.numpy(), np.asarray(Fj), rtol=1e-5, atol=1e-5)


def test_fit_gbt_batch_matches_jax():
    Xb, y, _ = _gbt_data(seed=4)
    n, d = Xb.shape
    R, depth, B = 8, 4, 16
    rng = np.random.default_rng(5)
    w_b = np.stack([(rng.random(n) < 0.67).astype(np.float32) for _ in range(4)])
    mcw = np.array([1.0, 10.0, 1.0, 10.0], np.float32)
    eta = np.full(4, 0.3, np.float32)
    lam = np.ones(4, np.float32)
    gam = np.full(4, 0.8, np.float32)
    fr = JT.frontier_cap(n, depth, 1.0, h_max=0.25, max_frontier=256,
                         total_weight=float(w_b.sum(1).max()))
    ones_r, ones_f = np.ones((R, n), np.float32), np.ones((R, d), np.float32)
    Fj = JT.fit_gbt_batch(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w_b),
                          jnp.asarray(ones_r), jnp.asarray(ones_f), loss="logistic",
                          n_rounds=R, max_depth=depth, n_bins=B, frontier=fr, eta_b=eta,
                          reg_lambda_b=lam, gamma_b=gam, min_child_weight_b=mcw,
                          exact_cap=True)
    Fp = PT.fit_gbt_batch(torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(w_b),
                          torch.from_numpy(ones_r), torch.from_numpy(ones_f), "logistic", R,
                          depth, B, fr, eta, lam, gam, mcw, exact_cap=True)
    np.testing.assert_allclose(Fp.numpy(), np.asarray(Fj), rtol=1e-5, atol=1e-5)


def test_boosting_raises_on_unported_losses_and_undivided_collapse():
    Xb, y, w = _gbt_data(n=50)
    args = (torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(w),
            torch.ones((2, 50)), torch.ones((2, 6)))
    # the softmax loss is ported (tests/test_torch_softmax_boost.py); an
    # unknown loss and a class count outside 2 .. 128 raise
    with pytest.raises(ValueError, match="unknown loss"):
        PT.fit_gbt(*args, "hinge", 2, 2, 16, 4)
    with pytest.raises(ValueError, match="2 to 128 classes"):
        PT.fit_gbt(*args, "softmax", 2, 2, 16, 4, n_classes=129)
    # round collapse is ported (tests/test_torch_round_collapse.py); as in the
    # reference, the collapse factor must divide the rounds
    with pytest.raises(ValueError, match="must divide"):
        PT.fit_gbt(*args, "logistic", 2, 2, 16, 4, trees_per_round=3)


# ---------------------------------------------------------------------------
# quantization, frontier sizing, draws
# ---------------------------------------------------------------------------
def test_quantize_matches_jax():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(2000, 5)).astype(np.float32)
    X[::7, 1] = np.nan
    Xb_j, e_j = JT.quantize(X, 32)
    Xb_p, e_p = PT.quantize(torch.from_numpy(X), 32)
    np.testing.assert_array_equal(e_p, e_j)
    np.testing.assert_array_equal(Xb_p.numpy(), np.asarray(Xb_j))
    assert Xb_p.dtype == torch.int8


@pytest.mark.parametrize("n,depth,mcw,h_max,mf,tw", [
    (891, 10, 1.0, 0.25, 256, None), (594, 10, 10.0, 0.25, 256, 594.0),
    (262144, 10, 1.0, 0.25, 256, None), (50, 3, 1.0, 1.0, 512, None), (10, 1, 1.0, 1.0, 8, None)])
def test_frontier_sizing_matches_jax(n, depth, mcw, h_max, mf, tw):
    fj = JT.frontier_cap(n, depth, mcw, h_max=h_max, max_frontier=mf, total_weight=tw)
    assert PT.frontier_cap(n, depth, mcw, h_max=h_max, max_frontier=mf, total_weight=tw) == fj
    assert PT._pool_size(depth, fj) == JT._pool_size(depth, fj)
    assert PT.frontier_is_exact(n, depth, mcw, h_max, fj, total_weight=tw) == \
        JT.frontier_is_exact(n, depth, mcw, h_max, fj, total_weight=tw)


def test_draws_at_fraction_one_only():
    """The draws: all ones at fraction 1, and below 1 the JAX package's
    threefry draws bit for bit (``tests/test_torch_random.py`` covers more
    shapes)."""
    ks, kf = PT.rng_keys(42)
    assert torch.equal(PT.subsample_weights(ks, 7, 3, 1.0), torch.ones((3, 7)))
    assert torch.equal(PT.feature_masks(kf, 4, 3, 1.0), torch.ones((3, 4)))
    jks, jkf = JT.rng_keys(42)
    np.testing.assert_array_equal(PT.subsample_weights(ks, 7, 3, 0.5).numpy(),
                                  np.asarray(JT.subsample_weights(jks, 7, 3, 0.5)))
    np.testing.assert_array_equal(PT.feature_masks(kf, 4, 3, 0.5).numpy(),
                                  np.asarray(JT.feature_masks(jkf, 4, 3, 0.5)))


# ---------------------------------------------------------------------------
# K12 -> K-I corr_gram, K-J contingency_counts: the sanity checker's stats
# ---------------------------------------------------------------------------
def _stats_inputs(seed, n=700, d=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.1, 10, d)
    X[:, 2] = 3.25                                   # a constant column
    X[:, 4] = (rng.random(n) < 0.3).astype(float)    # an indicator
    X[:, 5] = 2 * X[:, 0] + 1e-3 * rng.normal(size=n)  # a near-copy of column 0
    y = (X[:, 0] + rng.normal(size=n) > 0).astype(float)
    return X, y


def test_correlations_with_label_match_jax():
    X, y = _stats_inputs(7)
    js, jc, jm = JS.correlations_with_label(X, y, with_corr_matrix=True)
    ps, pc, pm = PS.correlations_with_label(torch.from_numpy(X), torch.from_numpy(y),
                                            with_corr_matrix=True)
    for a in ("mean", "variance", "min", "max"):
        np.testing.assert_allclose(getattr(ps, a), getattr(js, a), rtol=1e-12, atol=1e-12)
    assert ps.count == js.count
    # float64 moments in another summation order
    np.testing.assert_allclose(pc, jc, rtol=1e-12, atol=1e-12)
    assert np.isnan(pc[2]) and np.isnan(pm[2]).all() and np.isnan(pm[:, 2]).all()
    # the product is float32 in both, summed in another order
    np.testing.assert_allclose(pm, jm, rtol=0, atol=2e-6)
    cs = PS.col_stats(torch.from_numpy(X))
    np.testing.assert_allclose(cs.variance, JS.col_stats(X).variance, rtol=1e-12, atol=1e-12)


def test_corr_gram_matches_jax_kernel():
    rng = np.random.default_rng(8)
    Z = rng.normal(size=(3001, 17)).astype(np.float32)
    want = np.asarray(JS._corr_matrix_kernel(jnp.asarray(Z)))
    got = PK.corr_gram(torch.from_numpy(Z)).numpy()
    assert got.dtype == np.float32 and got.shape == (17, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_contingency_counts_match_jax(n_classes):
    rng = np.random.default_rng(9 + n_classes)
    n, d = 2500, 11
    X = (rng.random((n, d)) < 0.35).astype(np.float32)
    cls = rng.integers(0, n_classes, n)
    want = JS.contingency_all_columns(X, cls, n_classes)
    got = PS.contingency_all_columns(torch.from_numpy(X), torch.from_numpy(cls), n_classes)
    np.testing.assert_array_equal(got, want)  # integer counts: exact in any order
    # a class outside [0, n_classes) adds to no column
    cls_out = cls.astype(np.int32).copy()
    cls_out[:10] = n_classes
    got = PK.contingency_counts(torch.from_numpy(X), torch.from_numpy(cls_out), n_classes)
    np.testing.assert_array_equal(got.numpy(), X[10:].T @ np.eye(n_classes)[cls_out[10:]])
