"""The port's kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test needs a CUDA device and skips without one (the
CPU suite runs the plain versions through the parity tests instead).  Run
on a GPU host with ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(the suite's ``conftest.py`` imports JAX).
Imports nothing of JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.ops import stats as K
from transmogrifai_tpu_torch.ops import trees as Tr
from transmogrifai_tpu_torch.ops import vectorize as V

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counted(fn, call):
    before = fn.launches
    out = call()
    torch.cuda.synchronize()
    assert fn.launches > before
    return out


@pytest.mark.parametrize("n_bins", [2, 32, 128, 129, 256])
def test_bin_rows_matches_plain(dev, n_bins):
    rng = np.random.default_rng(n_bins)
    n, d = 5000, 7
    X = rng.normal(size=(n, d)).astype(np.float32)
    E = np.sort(rng.normal(size=(d, n_bins - 1)).astype(np.float32), axis=1)
    X[:3] = E[:, :3].T
    X[3], X[4], X[5], X[6] = np.nan, np.inf, -np.inf, -0.0
    E[0, 0] = np.nan  # an unsorted row follows the reference's fixed steps
    Xt, Et = torch.from_numpy(X).to(dev), torch.from_numpy(E).to(dev)
    got = _counted(Tr.bin_rows, lambda: Tr.bin_rows(Xt, Et))
    want = Tr.bin_rows_plain(Xt, Et)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_ensemble_walk_matches_plain(dev, c, mode):
    rng = np.random.default_rng(c)
    T, P, depth, d = 20, 63, 6, 5
    sf = rng.integers(-1, d, size=(T, P)).astype(np.int32)
    sf[:, 31:] = -1
    kids = np.arange(P)
    lt = np.minimum(2 * kids + 1, P - 1).astype(np.int32)[None].repeat(T, 0)
    rt = np.minimum(2 * kids + 2, P - 1).astype(np.int32)[None].repeat(T, 0)
    sb = rng.integers(0, 8, size=(T, P)).astype(np.int32)
    lv = rng.normal(size=(T, P, c)).astype(np.float32)
    tree = Tr.Tree(*(torch.from_numpy(a).to(dev) for a in (sf, sb, lt, rt, lv)))
    for dt in (np.int8, np.int32):
        Xb = torch.from_numpy(rng.integers(0, 9, size=(3000, d)).astype(dt)).to(dev)
        F, L = _counted(Tr.ensemble_walk, lambda: Tr.ensemble_walk(
            Xb, tree, depth, mode, 0.1, 0.5, return_leaves=True))
        F0, L0 = Tr.ensemble_walk_plain(Xb, tree, depth, mode, 0.1, 0.5, return_leaves=True)
        assert torch.equal(L, L0)
        torch.testing.assert_close(F, F0, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("track", [True, False])
def test_fill_indicator_matches_plain(dev, track):
    rng = np.random.default_rng(1)
    k, n = 4, 10007
    v = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.random((k, n)) < 0.7).to(dev)
    f = torch.tensor([0.5, -1.0, float("nan"), 2.0], device=dev)
    got = _counted(V.fill_indicator, lambda: V.fill_indicator(v, m, f, track))
    torch.testing.assert_close(got, V.fill_indicator_plain(v, m, f, track),
                               atol=0, rtol=0, equal_nan=True)


def test_one_hot_codes_matches_plain(dev):
    rng = np.random.default_rng(2)
    widths = [3, 1, 70]
    codes = np.stack([rng.integers(-1, w + 2, size=10007) for w in widths]).astype(np.int32)
    c = torch.from_numpy(codes).to(dev)
    got = _counted(V.one_hot_codes, lambda: V.one_hot_codes(c, widths))
    assert torch.equal(got, V.one_hot_codes_plain(c, widths))


# ---------------------------------------------------------------------------
# the boosting fit's kernels (K-E ... K-H)
# ---------------------------------------------------------------------------
def _level_inputs(rng, n, d, B, T, m, integer):
    Xb = rng.integers(0, B, size=(n, d)).astype(np.int8)
    if integer:  # every float32 sum exact: any summation order agrees
        ghw = rng.integers(-3, 4, size=(T, n, 2)).astype(np.float32)
    else:
        ghw = rng.normal(size=(T, n, 2)).astype(np.float32)
    ids = rng.integers(-1, m, size=(T, n)).astype(np.int32)
    return Xb, ghw, ids


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("light", [False, True])
def test_level_hist_matches_plain(dev, integer, light):
    rng = np.random.default_rng(3)
    n, d, B, T, m = 20011, 10, 32, 3, 16  # three row chunks
    Xb, ghw, ids = _level_inputs(rng, n, d, B, T, m // 2 if light else m, integer)
    args = [torch.from_numpy(a).to(dev) for a in (Xb, ghw, ids)]
    extra = []
    if light:
        parent = torch.from_numpy(rng.integers(-50, 50, size=(T, 12, 2, d, B))
                                  .astype(np.float32)).to(dev)
        pp = torch.from_numpy(rng.integers(-1, 12, size=(T, m // 2)).astype(np.int32)).to(dev)
        pl = torch.from_numpy(rng.integers(0, 2, size=(T, m // 2)).astype(np.int32)).to(dev)
        extra = [parent, pp, pl]
    got = _counted(Tr.level_hist, lambda: Tr.level_hist(*args, m, B, *extra))
    want = Tr.level_hist_plain(*args, m, B, *extra)
    # both sum in 64-bit fixed point, where the order of the sums is immaterial
    assert torch.equal(got, want)
    assert torch.equal(got, Tr.level_hist(*args, m, B, *extra))


@pytest.mark.parametrize("cap_mode", [Tr.CAP_NONE, Tr.CAP_CLAMP, Tr.CAP_BEAM])
def test_split_scan_and_route_match_plain(dev, cap_mode):
    rng = np.random.default_rng(4 + cap_mode)
    n, d, B, T, m = 3001, 10, 32, 4, 64
    Xb, ghw, ids = _level_inputs(rng, n, d, B, T, m, integer=False)
    Xb_t, ghw_t, ids_t = (torch.from_numpy(a).to(dev) for a in (Xb, ghw, ids))
    hist = Tr.level_hist_plain(Xb_t, ghw_t.abs(), ids_t, m, B)  # one histogram for both
    fm = torch.ones((T, d), device=dev)
    fm[1, 3] = 0.0
    params = torch.tensor([[1.0, 0.0, 1.0, 0.0], [1.0, 0.5, 10.0, 0.0],
                           [1e-6, 0.0, 1.0, 0.001], [2.0, 0.8, 5.0, 0.0]], device=dev)
    next_cap = 2 * m if cap_mode == Tr.CAP_NONE else m
    P = 4 * m
    outs = []
    n_act = torch.tensor([m, m - 5, 7, 0], dtype=torch.int32, device=dev)
    for fn in (Tr.split_scan, Tr.split_scan_plain):
        nodes = torch.full((T, P, 4), 9, dtype=torch.int32, device=dev)
        leaf = torch.full((T, P), 9.0, device=dev)
        res = fn(hist, fm, params, n_act, nodes, leaf, m - 1, 2 * m - 1, next_cap,
                 cap_mode, True)
        outs.append((nodes, leaf) + tuple(res))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    split, pl = outs[0][2], outs[0][4]
    rs = torch.from_numpy(rng.integers(-1, m, size=(T, n)).astype(np.int32)).to(dev)
    rn = torch.from_numpy(rng.integers(0, m, size=(T, n)).astype(np.int32)).to(dev)
    got = _counted(Tr.route_rows, lambda: Tr.route_rows(Xb_t, rs, rn, split, pl, 2 * m - 1))
    want = Tr.route_rows_plain(Xb_t, rs, rn, split, pl, 2 * m - 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_boost_step_matches_plain(dev):
    rng = np.random.default_rng(5)
    T, n, P = 3, 10007, 63
    F = torch.from_numpy(rng.normal(size=(T, n)).astype(np.float32) * 3).to(dev)
    y = torch.from_numpy((rng.random(n) < 0.4).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.integers(0, 3, size=(T, n)).astype(np.float32)).to(dev)
    eta = torch.tensor([0.3, 0.02, 1.0], device=dev)
    leaf = torch.from_numpy(rng.normal(size=(T, P)).astype(np.float32)).to(dev)
    node = torch.from_numpy(rng.integers(0, P, size=(T, n)).astype(np.int32)).to(dev)
    F1, F2 = F.clone(), F.clone()
    g1, g2 = torch.empty((T, n, 2), device=dev), torch.empty((T, n, 2), device=dev)
    _counted(Tr.boost_step, lambda: Tr.boost_step(F1, y, w, eta, leaf, node, g1))
    Tr.boost_step_plain(F2, y, w, eta, leaf, node, g2)
    assert torch.equal(F1, F2)  # the update is two correctly rounded operations
    # expf of libdevice and of the host may differ by an ulp
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=2e-7)


def test_boost_step_squared_matches_plain(dev):
    rng = np.random.default_rng(15)
    T, n, P = 18, 20011, 63
    F = torch.from_numpy(20.0 + rng.normal(size=(T, n)).astype(np.float32) * 3).to(dev)
    y = torch.from_numpy((20.0 + 9.0 * rng.normal(size=n)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.integers(0, 3, size=(T, n)).astype(np.float32)).to(dev)
    eta = torch.full((T,), 0.1, device=dev)
    leaf = torch.from_numpy(rng.normal(size=(T, P)).astype(np.float32)).to(dev)
    node = torch.from_numpy(rng.integers(0, P, size=(T, n)).astype(np.int32)).to(dev)
    F1, F2 = F.clone(), F.clone()
    g1, g2 = torch.empty((T, n, 2), device=dev), torch.empty((T, n, 2), device=dev)
    _counted(Tr.boost_step, lambda: Tr.boost_step(F1, y, w, eta, leaf, node, g1, "squared"))
    Tr.boost_step_plain(F2, y, w, eta, leaf, node, g2, "squared")
    assert torch.equal(F1, F2) and torch.equal(g1, g2)  # correctly rounded, no exp


def test_grow_trees_matches_plain_on_exact_sums(dev):
    rng = np.random.default_rng(6)
    n, d, B, T, depth = 5000, 10, 32, 2, 6
    Xb = torch.from_numpy(rng.integers(0, B, size=(n, d)).astype(np.int8))
    g = rng.integers(-2, 3, size=(T, n)).astype(np.float32)
    h = rng.integers(1, 3, size=(T, n)).astype(np.float32)
    ghw = torch.from_numpy(np.stack([g, h], axis=2))
    fm = torch.ones((T, d))
    params = torch.tensor([[1.0, 0.0, 1.0, 0.0], [1.0, 0.8, 10.0, 0.0]])
    for exact in (True, False):
        want = Tr.grow_trees(Xb, ghw, fm, params, depth, B, 16, exact)
        got = Tr.grow_trees(Xb.to(dev), ghw.to(dev), fm.to(dev), params.to(dev), depth, B,
                            16, exact)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_level_hist_raises_beyond_its_fixed_point_range(dev):
    """At the 2^32 scale's edge and past it (a smaller scale) the kernel
    equals its plain version; a non-finite value raises."""
    Xb = torch.zeros((2, 1), dtype=torch.int8, device=dev)
    ids = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    for big, bits in ((2.0 ** 30 - 64, 32), (2.0 ** 30, 31), (1e9 * 3, 29)):
        edge = torch.full((1, 2, 2), big, device=dev)
        assert Tr.hist_scale_bits(2, big) == bits
        got = Tr.level_hist(Xb, edge, ids, 1, 2)
        assert torch.equal(got, Tr.level_hist_plain(Xb, edge, ids, 1, 2, scale_bits=bits))
        assert got[0, 0, 0, 0, 0].item() == float(np.float32(2 * np.float32(big)))
    with pytest.raises(ValueError, match="fixed-point range"):
        Tr.level_hist(Xb, torch.full((1, 2, 2), float("inf"), device=dev), ids, 1, 2)


@pytest.mark.parametrize("n,d", [(1, 3), (257, 16), (100000, 41)])
def test_corr_gram_matches_plain(dev, n, d):
    rng = np.random.default_rng(n + d)
    Z = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    got = _counted(K.corr_gram, lambda: K.corr_gram(Z))
    want = K.corr_gram_plain(Z)
    # float32 sums in another order: a few ulps of sqrt(n) x |z|^2 / n
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    assert torch.equal(got, K.corr_gram(Z))  # runs repeat bit for bit


@pytest.mark.parametrize("c", [1, 2, 17])
def test_contingency_counts_matches_plain(dev, c):
    rng = np.random.default_rng(c)
    n, d = 100000, 23
    X = torch.from_numpy((rng.random((n, d)) < 0.3).astype(np.float32)).to(dev)
    cls = torch.from_numpy(rng.integers(-1, c + 1, n).astype(np.int32)).to(dev)
    got = _counted(K.contingency_counts, lambda: K.contingency_counts(X, cls, c))
    assert torch.equal(got, K.contingency_counts_plain(X, cls, c))  # integer counts


# ---------------------------------------------------------------------------
# the sweep's kernels: K-K fista_grad, K-N linear_fista_grad, K-O
# regression_metrics, K-L binary_metrics, K-M forest_leaf_mean
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,p,C,F", [(1, 3, 1, 1), (5000, 11, 8, 1), (70000, 11, 9, 3),
                                     (3000, 40, 5, 2)])
def test_fista_grad_matches_plain(dev, n, p, C, F):
    from transmogrifai_tpu_torch.ops import linear as L

    rng = np.random.default_rng(n + p)
    X1 = rng.normal(size=(n, p)).astype(np.float32)
    X1[:, -1] = 1.0
    args = [X1, (rng.random(n) < 0.4).astype(np.float32),
            rng.integers(0, 3, (F, n)).astype(np.float32),
            rng.integers(0, F, C).astype(np.int32), rng.normal(size=(C, p)).astype(np.float32),
            np.full((C, p), 0.01, np.float32)]
    args.append(np.maximum(args[2].sum(1), 1.0)[args[3]].astype(np.float32))
    ts = [torch.from_numpy(a).to(dev) for a in args]
    got = _counted(L.fista_grad, lambda: L.fista_grad(*ts))
    want = L.fista_grad_plain(*ts)
    assert torch.equal(got, L.fista_grad(*ts))  # no atomics: repeats bit for bit
    scale = float(want.abs().max()) + 1e-30
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n,p,C,F", [(1, 3, 1, 1), (5000, 17, 24, 3), (70000, 24, 9, 3),
                                     (3000, 11, 8, 1), (3000, 40, 5, 2)])
def test_linear_fista_grad_matches_plain(dev, n, p, C, F):
    from transmogrifai_tpu_torch.ops import linear as L

    rng = np.random.default_rng(n + p + 1)
    X1 = rng.normal(size=(n, p)).astype(np.float32)
    X1[:, 1] *= 300.0  # unstandardized, as Boston's tax
    X1[:, -1] = 1.0
    args = [X1, (20.0 + 9.0 * rng.normal(size=n)).astype(np.float32),
            rng.integers(0, 3, (F, n)).astype(np.float32),
            rng.integers(0, F, C).astype(np.int32), 0.1 * rng.normal(size=(C, p)).astype(np.float32),
            np.full((C, p), 0.01, np.float32)]
    args.append(np.maximum(args[2].sum(1), 1.0)[args[3]].astype(np.float32))
    ts = [torch.from_numpy(a).to(dev) for a in args]
    got = _counted(L.linear_fista_grad, lambda: L.linear_fista_grad(*ts))
    want = L.linear_fista_grad_plain(*ts)
    assert torch.equal(got, L.linear_fista_grad(*ts))  # no atomics: repeats bit for bit
    scale = float(want.abs().max()) + 1e-30
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n,F,C", [(1, 1, 1), (455, 3, 44), (262144, 3, 44), (5000, 1, 3)])
def test_regression_metrics_matches_plain(dev, n, F, C):
    from transmogrifai_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(n + C)
    y = (22.0 + 9.0 * rng.normal(size=n)).astype(np.float32)
    preds = (y + rng.normal(size=(F * C, n)) * 3.0).astype(np.float32)
    vm = (rng.random((F, n)) < 0.34).astype(np.float32)
    if F > 1:
        y[vm[1] > 0] = 21.5  # a constant-label fold: R2 is 0
    preds[-1] = preds[0]  # equal rows tie exactly
    ts = [torch.from_numpy(a).to(dev) for a in (preds, y, vm)]
    got = _counted(M.regression_metrics, lambda: M.regression_metrics(*ts, C))
    want = M.regression_metrics_plain(*ts, C)
    assert torch.equal(got, M.regression_metrics(*ts, C))  # a fixed order: repeats
    if F == 1 and C > 1:
        assert torch.equal(got[-1], got[0])
    # float64 sums in another order, each rounded to float32 once
    torch.testing.assert_close(got, want, rtol=2e-7, atol=1e-30)


@pytest.mark.parametrize("n,F,C,ties", [(1, 1, 1, False), (257, 3, 5, True),
                                        (5000, 2, 7, True), (300000, 1, 3, False)])
def test_binary_metrics_matches_plain(dev, n, F, C, ties):
    from transmogrifai_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(n)
    y = torch.from_numpy(rng.integers(0, 2, n).astype(np.float32)).to(dev)
    s = rng.random((F, C, n)).astype(np.float32)
    if ties:
        s = np.round(s, 2).astype(np.float32)
        s[..., ::5] = 0.5
    vm = torch.from_numpy((rng.random((F, n)) < 0.4).astype(np.float32)).to(dev)
    strict = torch.from_numpy((np.arange(C) % 2).astype(np.int32)).to(dev)
    ss, order = M.sort_scores(torch.from_numpy(s).to(dev), vm)
    got = _counted(M.binary_metrics, lambda: M.binary_metrics(ss, order, y, vm, strict, C))
    assert torch.equal(got, M.binary_metrics_plain(ss, order, y, vm, strict, C))


@pytest.mark.parametrize("G,T,n", [(1, 1, 7), (6, 50, 20000), (2, 300, 5000), (3, 17, 1000),
                                   (2, 24, 3000), (1, 1100, 3000)])
def test_forest_leaf_mean_matches_plain(dev, G, T, n):
    rng = np.random.default_rng(T)
    P = 63
    leaf = torch.from_numpy(rng.random((G, T, P)).astype(np.float32)).to(dev)
    node = torch.from_numpy(rng.integers(0, P, (G, T, n)).astype(np.int32)).to(dev)
    got = _counted(Tr.forest_leaf_mean, lambda: Tr.forest_leaf_mean(leaf, node))
    assert torch.equal(got, Tr.forest_leaf_mean_plain(leaf, node))


# ---------------------------------------------------------------------------
# the multiclass sweep's kernels: K-P softmax_fista_grad, K-Q
# multiclass_metrics, and K-E / K-F / K-M over c = 3 class channels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,p,k,C,F", [(1, 3, 3, 1, 1), (135, 9, 3, 24, 3),
                                       (70000, 9, 3, 24, 3), (5000, 20, 5, 6, 2),
                                       (3000, 64, 8, 4, 1)])
def test_softmax_fista_grad_matches_plain(dev, n, p, k, C, F):
    from transmogrifai_tpu_torch.ops import linear as L

    rng = np.random.default_rng(n + p + k)
    X1 = rng.normal(size=(n, p)).astype(np.float32)
    X1[:, -1] = 1.0
    args = [X1, rng.integers(0, k, n).astype(np.float32),
            rng.integers(0, 3, (F, n)).astype(np.float32),
            rng.integers(0, F, C).astype(np.int32),
            rng.normal(size=(C, p, k)).astype(np.float32), np.full((C, p, k), 0.01, np.float32)]
    args[5][:, -1] = 0.0
    args.append(np.maximum(args[2].sum(1), 1.0)[args[3]].astype(np.float32))
    ts = [torch.from_numpy(a).to(dev) for a in args]
    got = _counted(L.softmax_fista_grad, lambda: L.softmax_fista_grad(*ts))
    want = L.softmax_fista_grad_plain(*ts)
    assert torch.equal(got, L.softmax_fista_grad(*ts))  # no atomics: repeats bit for bit
    scale = float(want.abs().max()) + 1e-30
    assert float((got - want).abs().max()) <= 1e-6 * scale


def test_softmax_fista_grad_raises_above_its_limits(dev):
    from transmogrifai_tpu_torch.ops import linear as L

    for p, k in ((3, 9), (65, 3)):
        X1 = torch.ones((4, p), device=dev)
        args = (X1, torch.zeros(4, device=dev), torch.ones((1, 4), device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), torch.zeros((1, p, k), device=dev),
                torch.zeros((1, p, k), device=dev), torch.ones(1, device=dev))
        with pytest.raises(ValueError, match="at most 8 classes and 64 coefficients"):
            L.softmax_fista_grad(*args)


@pytest.mark.parametrize("n,F,C,k", [(1, 1, 1, 3), (135, 3, 26, 3), (262144, 3, 26, 3),
                                     (5000, 2, 7, 8)])
def test_multiclass_metrics_matches_plain(dev, n, F, C, k):
    from transmogrifai_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(n + k)
    y = torch.from_numpy(rng.integers(0, k, n).astype(np.float32)).to(dev)
    probs = rng.random((F * C, n, k)).astype(np.float32)
    probs[::2] = np.round(probs[::2] * 4) / 4  # ties: the first class wins
    vm = torch.from_numpy((rng.random((F, n)) < 0.34).astype(np.float32)).to(dev)
    pt = torch.from_numpy(probs).to(dev)
    got = _counted(M.multiclass_metrics, lambda: M.multiclass_metrics(pt, y, vm, C))
    assert torch.equal(got, M.multiclass_metrics_plain(pt, y, vm, C))
    assert torch.equal(got, M.multiclass_metrics(pt, y, vm, C))  # integer counts: repeats


@pytest.mark.parametrize("light", [False, True])
def test_level_hist_matches_plain_over_class_channels(dev, light):
    rng = np.random.default_rng(7)
    n, d, B, T, m, c = 20011, 8, 32, 6, 16, 3
    Xb = rng.integers(0, B, size=(n, d)).astype(np.int8)
    w = rng.poisson(1.0, size=(T, n)).astype(np.float32)
    g = -np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    ghw = np.concatenate([w[..., None] * g[None], w[..., None]], axis=2)
    mh = m // 2 if light else m
    ids = rng.integers(-1, mh, size=(T, n)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (Xb, ghw, ids)]
    extra = []
    if light:
        extra = [torch.from_numpy(rng.integers(-50, 50, size=(T, 12, c + 1, d, B))
                                  .astype(np.float32)).to(dev),
                 torch.from_numpy(rng.integers(-1, 12, size=(T, mh)).astype(np.int32)).to(dev),
                 torch.from_numpy(rng.integers(0, 2, size=(T, mh)).astype(np.int32)).to(dev)]
    got = _counted(Tr.level_hist, lambda: Tr.level_hist(*args, m, B, *extra))
    assert got.shape == (T, m, c + 1, d, B)
    assert torch.equal(got, Tr.level_hist_plain(*args, m, B, *extra))


@pytest.mark.parametrize("cap_mode", [Tr.CAP_NONE, Tr.CAP_BEAM])
@pytest.mark.parametrize("c", [3, 8])
def test_split_scan_matches_plain_over_class_channels(dev, cap_mode, c):
    rng = np.random.default_rng(8 + c)
    n, d, B, T, m = 3001, 8, 32, 4, 16
    Xb = torch.from_numpy(rng.integers(0, B, size=(n, d)).astype(np.int8)).to(dev)
    w = rng.integers(0, 4000, size=(T, n)).astype(np.float32)  # sums of squares round
    g = -np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    ghw = torch.from_numpy(np.concatenate([w[..., None] * g[None], w[..., None]], 2)).to(dev)
    ids = torch.from_numpy(rng.integers(-1, m, size=(T, n)).astype(np.int32)).to(dev)
    hist = Tr.level_hist_plain(Xb, ghw, ids, m, B)
    fm = torch.ones((T, d), device=dev)
    fm[1, 3] = 0.0
    params = torch.tensor([[1e-6, 0.0, 10.0, 0.001], [1e-6, 0.0, 100.0, 0.01],
                           [1e-6, 0.0, 1.0, 0.1], [1.0, 0.5, 10.0, 0.0]], device=dev)
    next_cap = 2 * m if cap_mode == Tr.CAP_NONE else m
    P = 4 * m
    outs = []
    n_act = torch.tensor([m, m - 5, 7, 0], dtype=torch.int32, device=dev)
    for fn in (Tr.split_scan, Tr.split_scan_plain):
        nodes = torch.full((T, P, 4), 9, dtype=torch.int32, device=dev)
        leaf = torch.full((T, P, c), 9.0, device=dev)
        res = fn(hist, fm, params, n_act, nodes, leaf, m - 1, 2 * m - 1, next_cap,
                 cap_mode, True)
        outs.append((nodes, leaf) + tuple(res))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_grow_forest_matches_plain_over_class_channels(dev):
    rng = np.random.default_rng(9)
    n, d, B, T, depth, c = 5000, 8, 32, 6, 12, 3
    Xb = torch.from_numpy(rng.integers(0, B, size=(n, d)).astype(np.int8))
    g = torch.from_numpy(-np.eye(c, dtype=np.float32)[rng.integers(0, c, n)])
    w = torch.from_numpy(rng.poisson(1.0, size=(T, n)).astype(np.float32))
    fm = torch.from_numpy((rng.random((T, d)) < 0.4).astype(np.float32))
    hp = (np.full(T, 1e-6, np.float32), np.zeros(T, np.float32),
          np.full(T, 10.0, np.float32), np.full(T, 0.001, np.float32))
    want = Tr.grow_forest(Xb, g, torch.ones(n), w, fm, depth, B, 16, *hp,
                          return_row_node=True)
    got = Tr.grow_forest(Xb.to(dev), g.to(dev), torch.ones(n, device=dev), w.to(dev),
                         fm.to(dev), depth, B, 16, *hp, return_row_node=True)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("G,T,n,c", [(1, 1, 7, 3), (54, 50, 20000, 3), (2, 300, 5000, 8)])
def test_forest_leaf_mean_matches_plain_over_class_channels(dev, G, T, n, c):
    rng = np.random.default_rng(T + c)
    P = 63
    leaf = torch.from_numpy(rng.random((G, T, P, c)).astype(np.float32)).to(dev)
    node = torch.from_numpy(rng.integers(0, P, (G, T, n)).astype(np.int32)).to(dev)
    got = _counted(Tr.forest_leaf_mean, lambda: Tr.forest_leaf_mean(leaf, node))
    assert got.shape == (G, n, c)
    assert torch.equal(got, Tr.forest_leaf_mean_plain(leaf, node))



# ---------------------------------------------------------------------------
# softmax boosting and the Newton / ridge fits: K-R softmax_boost_step, K-S
# weighted_gram; K-L on NaN scores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,update", [(3, True), (3, False), (5, True), (8, True)])
def test_softmax_boost_step_matches_plain(dev, k, update):
    rng = np.random.default_rng(k)
    T, n, P = 6, 20011, 63
    F = torch.from_numpy((rng.normal(size=(T, n, k)) * 2).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, k, n).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.integers(0, 3, size=(T, n)).astype(np.float32)).to(dev)
    eta = torch.from_numpy(rng.random(T).astype(np.float32)).to(dev)
    leaf = torch.from_numpy(rng.normal(size=(T, P, k)).astype(np.float32)).to(dev)
    node = torch.from_numpy(rng.integers(0, P, size=(T, n)).astype(np.int32)).to(dev)
    upd = (leaf, node) if update else (None, None)
    F1, F2 = F.clone(), F.clone()
    g1, g2 = (torch.empty((T, n, k + 1), device=dev) for _ in range(2))
    _counted(Tr.softmax_boost_step, lambda: Tr.softmax_boost_step(F1, y, w, eta, *upd, g1))
    Tr.softmax_boost_step_plain(F2, y, w, eta, *upd, g2)
    assert torch.equal(F1, F2)  # one fused multiply-add a channel in both
    # the same expf; float32 operations in one order
    torch.testing.assert_close(g1, g2, rtol=0, atol=2.4e-7 * 2)


@pytest.mark.parametrize("n,p,C,F,newton", [(1, 3, 1, 1, True), (70000, 11, 18, 3, True),
                                            (235930, 17, 3, 3, False), (5000, 64, 3, 1, True),
                                            (40000, 9, 40, 4, True), (3000, 33, 2, 2, False)])
def test_weighted_gram_matches_plain(dev, n, p, C, F, newton):
    from transmogrifai_tpu_torch.ops import linear as L

    rng = np.random.default_rng(n + p)
    X1 = np.concatenate([rng.normal(size=(n, p - 1)), np.ones((n, 1))], 1).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.integers(0, 3, size=(F, n)).astype(np.float32)
    fold = (np.arange(C) % F).astype(np.int32)
    beta = (rng.normal(size=(C, p)) * 0.3).astype(np.float32) if newton else None
    ts = [torch.from_numpy(a).to(dev) for a in (X1, y, w, fold)]
    bt = None if beta is None else torch.from_numpy(beta).to(dev)
    H1, g1 = _counted(L.weighted_gram, lambda: L.weighted_gram(*ts, bt))
    H2, g2 = L.weighted_gram_plain(*ts, bt)
    assert torch.equal(H1, L.weighted_gram(*ts, bt)[0])  # a fixed order: repeats
    assert torch.equal(H1, H1.transpose(1, 2))
    # float64 sums in both; the margins' float32 dot products in other orders
    torch.testing.assert_close(H1, H2, rtol=1e-5, atol=1e-5 * float(H2.abs().max()))
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-5 * float(g2.abs().max()))


def test_binary_metrics_matches_plain_on_nan_scores(dev):
    from transmogrifai_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(4)
    n, F, C = 5000, 2, 3
    y = torch.from_numpy(rng.integers(0, 2, n).astype(np.float32)).to(dev)
    s = rng.random((F, C, n)).astype(np.float32)
    s[:, 0] = np.nan
    s[:, 1, ::3] = np.nan
    s[:, 2, ::7] = np.inf
    vm = torch.from_numpy((rng.random((F, n)) < 0.4).astype(np.float32)).to(dev)
    strict = torch.zeros(C, dtype=torch.int32, device=dev)
    ss, order = M.sort_scores(torch.from_numpy(s).to(dev), vm)
    got = _counted(M.binary_metrics, lambda: M.binary_metrics(ss, order, y, vm, strict, C))
    assert torch.equal(got, M.binary_metrics_plain(ss, order, y, vm, strict, C))
    assert torch.equal(got[0, :2].cpu(), torch.tensor([0.5, 0.0]))
