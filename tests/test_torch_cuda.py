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


@pytest.mark.parametrize("c", [1, 2, 5, 26, 64])
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
    # the reference's float32 sums in row order: exact in the fixed point
    # (integers) and replayed by the ordered path (real values); the plain
    # version's CPU run gives them (on the card index_add_ takes atomics)
    want = Tr.level_hist_plain(*(a.cpu() for a in args), m, B, *(a.cpu() for a in extra))
    assert Tr.hist_exact(args[1]) == integer
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, Tr.level_hist(*args, m, B, *extra))


@pytest.mark.parametrize("C1,B,light,bins", [(2, 64, True, torch.int8), (4, 256, False, torch.int32),
                                             (27, 32, True, torch.int8), (27, 300, True, torch.int32),
                                             (9, 16, False, torch.int8), (129, 8, True, torch.int8)])
def test_level_hist_ordered_matches_plain_at_every_width(dev, C1, B, light, bins):
    """The ordered path's channel slabs, bin windows and feature groups:
    bit-equal to the plain version's CPU run (the reference's sums)."""
    rng = np.random.default_rng(C1 * B)
    n, d, T, m = 9001, 6, 2, 8
    Xb = torch.from_numpy(rng.integers(0, B, size=(n, d)).astype(np.int32)).to(bins)
    ghw = torch.from_numpy((rng.normal(size=(T, n, C1)) * np.exp(rng.normal(size=(T, n, 1))))
                           .astype(np.float32))
    ghw[:, ::7] = 0.0  # rows whose channels are all zero are skipped
    ids = torch.from_numpy(rng.integers(-1, m // 2 if light else m, size=(T, n)).astype(np.int32))
    extra = []
    if light:
        extra = [torch.from_numpy(rng.normal(size=(T, 5, C1, d, B)).astype(np.float32)),
                 torch.from_numpy(rng.integers(-1, 5, size=(T, m // 2)).astype(np.int32)),
                 torch.from_numpy(rng.integers(0, 2, size=(T, m // 2)).astype(np.int32))]
    want = Tr.level_hist_plain(Xb, ghw, ids, m, B, *extra)
    got = _counted(Tr.level_hist, lambda: Tr.level_hist(
        Xb.to(dev), ghw.to(dev), ids.to(dev), m, B, *(a.to(dev) for a in extra)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("T,n,C1", [(1, 20, 2), (3, 455, 2), (18, 262144, 2), (2, 70001, 27)])
def test_root_sums_match_plain(dev, T, n, C1):
    rng = np.random.default_rng(n)
    ghw = torch.from_numpy((rng.normal(size=(T, n, C1)) * 5).astype(np.float32)).to(dev)
    got = _counted(Tr.root_sums, lambda: Tr.root_sums(ghw))
    assert torch.equal(got.cpu(), Tr.root_sums_plain(ghw.cpu()))


@pytest.mark.parametrize("c,B", [(1, 32), (1, 64), (3, 300), (26, 32), (26, 100)])
def test_split_scan_sums_real_histograms_in_xlas_order(dev, c, B):
    """K-F's prefix sums in XLA's blocked order and its node totals in
    XLA's windows, on real-valued histograms past 16 and 32 bins."""
    rng = np.random.default_rng(c * B)
    T, m, d = 3, 8, 5
    hist = torch.from_numpy((rng.normal(size=(T, m, c + 1, d, B))
                             * np.exp(rng.normal(size=(T, m, 1, d, B)))).astype(np.float32))
    hist[:, :, c] = hist[:, :, c].abs()
    fm = torch.ones((T, d))
    params = torch.tensor([[1.0, 0.0, 1.0, 0.0], [1e-6, 0.0, 0.5, 0.001], [2.0, 0.1, 2.0, 0.0]])
    n_act = torch.tensor([m, m - 3, 5], dtype=torch.int32)
    outs = []
    for fn, dv in ((Tr.split_scan, dev), (Tr.split_scan_plain, torch.device("cpu"))):
        nodes = torch.full((T, 4 * m, 4), 9, dtype=torch.int32, device=dv)
        leaf = torch.full((T, 4 * m) + ((c,) if c > 1 else ()), 9.0, device=dv)
        res = fn(hist.to(dv), fm.to(dv), params.to(dv), n_act.to(dv), nodes, leaf, m - 1,
                 2 * m - 1, 2 * m, Tr.CAP_NONE, False)
        outs.append(tuple(a.cpu() for a in (nodes, leaf) + tuple(res)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


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
    assert torch.equal(F1, F2)  # the update is one fused multiply-add in both
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


def test_grow_trees_matches_plain_on_real_gradients(dev):
    """The ordered sums, XLA's prefix order and the root sums through a
    whole grower: the CPU's trees bit for bit."""
    rng = np.random.default_rng(16)
    n, d, B, T, depth = 20011, 10, 32, 3, 8
    Xb = torch.from_numpy(rng.integers(0, B, size=(n, d)).astype(np.int8))
    g = rng.normal(size=(T, n)).astype(np.float32)
    h = rng.uniform(0.05, 0.25, size=(T, n)).astype(np.float32)
    w = rng.integers(0, 3, size=(T, n)).astype(np.float32)
    ghw = torch.from_numpy(np.stack([g * w, h * w], axis=2))
    fm = torch.ones((T, d))
    params = torch.tensor([[1.0, 0.0, 1.0, 0.0], [1.0, 0.8, 10.0, 0.0], [1e-6, 0.0, 1.0, 0.01]])
    want = Tr.grow_trees(Xb, ghw, fm, params, depth, B, 64, False)
    got = Tr.grow_trees(Xb.to(dev), ghw.to(dev), fm.to(dev), params.to(dev), depth, B, 64,
                        False)
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


@pytest.mark.parametrize("n,d", [(1, 3), (257, 16), (100000, 41), (100000, 23), (3001, 63),
                                 (3001, 64), (3001, 65), (5003, 85), (2001, 300), (1025, 512),
                                 (1, 64), (1, 65), (70, 300)])
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


#: K-X's and K-I centered's float64 sums against their plain versions (other
#: orders, float64 throughout), relative to each output row's largest entry
STREAM_RTOL = 1e-12


def _stream_chunk(rng, n, d):
    """A chunk with offset and scaled columns, an integer column and a
    constant one, and a label."""
    X = rng.normal(size=(n, d)) * rng.uniform(0.1, 30, d) + rng.uniform(-100, 100, d)
    X[:, 0] = rng.integers(0, 16, n)
    X[:, -1] = 2.5
    return X.astype(np.float32), (X[:, 0] + rng.normal(size=n)).astype(np.float32)


def _row_gap(got, want):
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    return float(((got - want).abs() / scale).max())


@pytest.mark.parametrize("n,d", [(1, 1), (1000, 7), (70000, 24), (5000, 300)])
@pytest.mark.parametrize("label", [False, True])
@pytest.mark.parametrize("mode", ["raw", "chan"])
def test_chunk_moments_matches_plain(dev, n, d, label, mode):
    rng = np.random.default_rng(n + d)
    X, y = _stream_chunk(rng, n, d)
    Xt = torch.from_numpy(X).to(dev)
    yt = torch.from_numpy(y).to(dev) if label else None
    before = K.chunk_moments.launches_by_mode[mode]
    got = _counted(K.chunk_moments, lambda: K.chunk_moments(Xt, yt, mode))
    assert K.chunk_moments.launches_by_mode[mode] == before + 1
    want = K.chunk_moments_plain(Xt, yt, mode)
    assert got.shape == want.shape == (4, d + label) and got.dtype == torch.float64
    assert torch.equal(got[2:], want[2:])  # min and max
    assert _row_gap(got[:2], want[:2]) <= STREAM_RTOL
    if mode == "chan":
        assert bool((got[1, d - 1] == 0).all())  # the constant column's M2
    assert torch.equal(got, K.chunk_moments(Xt, yt, mode))  # runs repeat bit for bit


@pytest.mark.parametrize("n,d", [(1, 1), (1000, 7), (70000, 24), (3000, 31), (3000, 32),
                                 (5000, 100), (2000, 200), (3001, 23), (3001, 63), (3001, 64),
                                 (5003, 85), (2001, 300), (4097, 512), (1, 63), (1, 64), (1, 512),
                                 (33, 513), (262144, 24)])
def test_centered_gram_matches_plain(dev, n, d):
    rng = np.random.default_rng(n * d)
    X, y = _stream_chunk(rng, n, d)
    Xt, yt = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    centers = K.chunk_moments_plain(Xt, yt, "chan")[0]
    got = _counted(K.centered_gram, lambda: K.centered_gram(Xt, yt, centers))
    want = K.centered_gram_plain(Xt, yt, centers)
    assert got.shape == (d + 1, d + 1) and got.dtype == torch.float64
    assert _row_gap(got, want) <= STREAM_RTOL
    assert torch.equal(got, got.T)  # fma(a, b, c) == fma(b, a, c), sums in one order
    assert bool((got[d - 1] == 0).all())  # the constant column centers to 0
    assert torch.equal(got, K.centered_gram(Xt, yt, centers))


@pytest.mark.parametrize("n,k,kind", [(1, 1, "normal"), (2048, 2, "ties"), (2049, 3, "ties"),
                                      (10000, 5, "normal"), (100000, 3, "ties"),
                                      (100000, 2, "constant"), (5000, 130, "binary")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_midranks_matches_plain(dev, n, k, kind, dtype):
    rng = np.random.default_rng(n + k)
    X = {"normal": lambda: rng.normal(size=(n, k)),
         "ties": lambda: rng.integers(0, 16, size=(n, k)),  # runs cross 2,048-row segments
         "constant": lambda: np.full((n, k), 3.0),
         "binary": lambda: rng.integers(0, 2, size=(n, k))}[kind]()
    Xt = torch.from_numpy(np.asarray(X, np.float64)).to(dev, dtype)
    got = _counted(K.midranks, lambda: K.midranks(Xt))
    want = K.midranks_plain(Xt)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(got.double().sum(0), torch.full((k,), n * (n + 1) / 2, device=dev,
                                                       dtype=torch.float64))


@pytest.mark.parametrize("n,k,kind", [(255, 2, "ties"), (257, 2, "ties"), (2047, 3, "ties"),
                                      (2048, 3, "ties"), (2049, 3, "ties"), (6143, 2, "runs"),
                                      (6145, 2, "runs"), (20000, 1, "constant"),
                                      ((1 << 18) + 5, 17, "ties"), ((1 << 18) + 5, 40, "normal"),
                                      ((1 << 21) + 5, 3, "ties")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_midranks_at_its_design_edges(dev, n, k, kind, dtype):
    """K-Y at its segment (2,048 and 1,024 positions) and warp boundaries,
    with runs longer than a block ("runs": 10,000 equal values), a constant
    column, and outputs past ``MIDRANK_DIRECT_BYTES``: the partition route
    (three and five column groups, the last one short) and past 2^21 rows
    the direct route again; where the partition takes the shape, both
    routes: bit-equal to the plain version and repeated bit for bit."""
    rng = np.random.default_rng(n * 7 + k)
    X = {"normal": lambda: rng.normal(size=(n, k)),
         "ties": lambda: rng.integers(0, 5, size=(n, k)),
         "runs": lambda: np.sort(rng.integers(0, 3, size=(n, k)), 0)[rng.permutation(n)],
         "constant": lambda: np.full((n, k), -2.5)}[kind]()
    Xt = torch.from_numpy(np.asarray(X, np.float64)).to(dev, dtype)
    plan = K.midrank_plan(n, k, k)
    assert plan.route == ("direct" if n * k * 4 <= K.MIDRANK_DIRECT_BYTES or n > 1 << 21
                          else "partition")
    got = _counted(K.midranks, lambda: K.midranks(Xt))
    want = K.midranks_plain(Xt)
    assert torch.equal(got, want)
    assert torch.equal(got, K.midranks(Xt))
    if n <= 1 << 21:
        ss, order = torch.sort(Xt.T.contiguous(), dim=1)
        for route in K.MIDRANK_ROUTES:
            out = torch.full((n, k), -1.0, device=dev)
            K._midrank_launch(ss, order, out, route)
            assert torch.equal(out, want), route


@pytest.mark.parametrize("n,d,lo,hi", [(5000, 9, 2, 7), (1 << 18, 30, 0, 25), (1 << 18, 30, 25, 26),
                                       (3000, 200, 128, 200)])
def test_midranks_write_into_a_slice(dev, n, d, lo, hi):
    """K-Y into columns [lo, hi) of a wider matrix (rank_transform's blocks):
    the slice bit-equal to the plain version, the other columns untouched,
    on both routes."""
    rng = np.random.default_rng(n + d)
    X = torch.from_numpy(rng.integers(0, 40, size=(n, hi - lo)).astype(np.float32)).to(dev)
    wide = torch.full((n, d), -7.0, device=dev)
    got = _counted(K.midranks, lambda: K.midranks(X, out=wide[:, lo:hi]))
    assert got.data_ptr() == wide[:, lo:hi].data_ptr()
    assert torch.equal(wide[:, lo:hi], K.midranks_plain(X))
    rest = torch.ones(d, dtype=torch.bool, device=dev)
    rest[lo:hi] = False
    assert bool((wide[:, rest] == -7.0).all())


# ---------------------------------------------------------------------------
# the sweep's kernels: K-K fista_grad, K-N linear_fista_grad, K-O
# regression_metrics, K-L binary_metrics, K-M forest_leaf_mean
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,p,C,F", [(1, 3, 1, 1), (5000, 11, 8, 1), (70000, 11, 9, 3),
                                     (3000, 40, 5, 2), (70000, 86, 24, 3), (3000, 100, 5, 2),
                                     (2000, 1024, 3, 1)])
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
                                     (3000, 11, 8, 1), (3000, 40, 5, 2), (5000, 86, 7, 3),
                                     (3000, 130, 4, 1)])
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
                                       (3000, 64, 8, 4, 1), (20000, 85, 3, 6, 2),
                                       (3000, 513, 8, 3, 1), (700, 1024, 4, 2, 1),
                                       # the wide entry's edges (k <= 8, p > 64): p at
                                       # 65, 128, 129 and 1,024, fit groups that do not
                                       # divide C, rows one past a whole tile, one row
                                       (65, 65, 2, 3, 1), (1, 129, 7, 3, 1),
                                       (5000, 128, 5, 5, 2), (4097, 129, 7, 10, 3),
                                       (3001, 1024, 8, 5, 2), (1025, 1024, 3, 7, 3),
                                       (513, 85, 3, 6, 3), (131073, 85, 8, 2, 3),
                                       # past 8 classes: the tiled entry
                                       (20000, 33, 10, 24, 3), (65536, 33, 26, 6, 3),
                                       (5000, 33, 64, 4, 2), (3000, 64, 128, 3, 1),
                                       (20000, 85, 26, 6, 3), (2000, 513, 26, 3, 1),
                                       (700, 1024, 128, 2, 1),
                                       # the tiled entry's edges: fit groups that do
                                       # not divide C, rows past a whole tile
                                       (5003, 33, 9, 25, 3), (3001, 85, 27, 7, 2),
                                       (2049, 40, 65, 5, 2), (999, 130, 127, 3, 1)])
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
    if k <= 8:
        assert float((got - want).abs().max()) <= 1e-6 * scale
    else:
        # past 8 classes (the tiled entry) the margins of 64 - 1,024 terms
        # round apart from the plain version's BLAS products, and the softmax
        # over many competing classes carries that into the residuals: each
        # is held to the float64 function, the kernel within 4x the plain
        # version's own error (or 1e-6 of the largest entry)
        exact = L.softmax_fista_grad_plain(*(t.double() if t.is_floating_point() else t
                                             for t in ts))
        err_k = float((got.double() - exact).abs().max())
        err_p = float((want.double() - exact).abs().max())
        assert err_k <= max(4 * err_p, 1e-6 * scale), (err_k, err_p, scale)


def test_softmax_fista_grad_raises_above_its_limits(dev):
    from transmogrifai_tpu_torch.ops import linear as L

    for p, k in ((3, 129), (1025, 3)):
        X1 = torch.ones((4, p), device=dev)
        args = (X1, torch.zeros(4, device=dev), torch.ones((1, 4), device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), torch.zeros((1, p, k), device=dev),
                torch.zeros((1, p, k), device=dev), torch.ones(1, device=dev))
        with pytest.raises(ValueError, match="at most 128 classes and 1024 coefficients"):
            L.softmax_fista_grad(*args)


@pytest.mark.parametrize("n,F,C,k", [(1, 1, 1, 3), (135, 3, 26, 3), (262144, 3, 26, 3),
                                     (5000, 2, 7, 8), (5000, 3, 4, 10), (65536, 3, 26, 26),
                                     (32768, 3, 26, 64), (3000, 2, 5, 128), (1, 1, 1, 100)])
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


@pytest.mark.parametrize("c", [3, 10, 26, 64, 128])
@pytest.mark.parametrize("light", [False, True])
def test_level_hist_matches_plain_over_class_channels(dev, light, c):
    rng = np.random.default_rng(7 + c)
    n, d, B, T, m = 20011, 8, 32, 6, 16
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
@pytest.mark.parametrize("c", [3, 8, 9, 10, 26, 64, 128])
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


@pytest.mark.parametrize("c", [3, 26, 100])
def test_grow_forest_matches_plain_over_class_channels(dev, c):
    rng = np.random.default_rng(9 + c)
    n, d, B, T, depth = 5000, 8, 32, 6, 12
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


@pytest.mark.parametrize("G,T,n,c", [(1, 1, 7, 3), (54, 50, 20000, 3), (2, 300, 5000, 8),
                                     (54, 50, 20000, 26), (6, 50, 5000, 64)])
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
@pytest.mark.parametrize("k,update", [(3, True), (3, False), (5, True), (8, True), (10, True),
                                      (26, True), (64, True), (64, False), (128, True)])
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
                                            (40000, 9, 40, 4, True), (3000, 33, 2, 2, False),
                                            (20000, 85, 9, 3, True), (3000, 300, 2, 2, False),
                                            (1, 65, 1, 1, True), (2000, 1024, 2, 1, True),
                                            # the wide entry's tile and fit-group edges
                                            (3000, 96, 12, 3, False), (3000, 97, 1, 1, True),
                                            (2000, 128, 33, 3, True), (3001, 129, 12, 4, True),
                                            (4096, 513, 33, 3, True)])
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


# ---------------------------------------------------------------------------
# the binary selector's other families: K-T svc_grad, K-U mlp_grad /
# mlp_forward, K-V nb_tables_mass / nb_tables_score
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,p,C,F", [(1, 3, 1, 1), (235930, 11, 4, 1), (30000, 17, 12, 3),
                                     (5000, 40, 3, 1), (7000, 64, 5, 2), (20000, 85, 8, 2),
                                     (5000, 513, 3, 1), (1000, 1024, 2, 1),
                                     # the wide entry's edges: p at 65, 128, 129 and
                                     # 1,024, fit groups that do not divide C, rows one
                                     # past a whole tile, one row
                                     (65, 65, 5, 2), (1, 129, 3, 1), (4097, 128, 12, 3),
                                     (2049, 129, 7, 1), (3001, 1024, 17, 3),
                                     (513, 85, 12, 3), (32769, 513, 12, 3)])
def test_svc_grad_matches_plain(dev, n, p, C, F):
    from transmogrifai_tpu_torch.ops import linear as L

    rng = np.random.default_rng(n + p)
    X1 = np.concatenate([rng.normal(size=(n, p - 1)) * 3, np.ones((n, 1))],
                        1).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.integers(0, 3, size=(F, n)).astype(np.float32)
    fold = (np.arange(C) % F).astype(np.int32)
    z = (rng.normal(size=(C, p)) * 0.2).astype(np.float32)
    l2v = np.full((C, p), 0.01, np.float32)
    wsum = np.maximum(w.sum(1), 1e-12)[fold].astype(np.float32)
    ts = [torch.from_numpy(a).to(dev) for a in (X1, y, w, fold, z, l2v, wsum)]
    got = _counted(L.svc_grad, lambda: L.svc_grad(*ts))
    want = L.svc_grad_plain(*ts)
    assert torch.equal(got, L.svc_grad(*ts))  # a fixed order: repeats
    # float64 sums in both (the hinge's float32 margins in other orders)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("layers,n,C,F", [((10, 10, 2), 235930, 1, 1), ((4, 10, 3), 150, 3, 3),
                                          ((128, 64, 64, 8), 3001, 2, 2), ((5, 2), 77, 1, 1),
                                          ((32, 128, 64, 26), 20000, 3, 3),
                                          ((450, 128, 64, 32, 2), 20000, 3, 3),
                                          ((2100, 10, 2), 5000, 3, 3),
                                          ((40, 300, 200, 90, 80, 70, 60, 50, 40, 128), 700, 2, 2)])
def test_mlp_kernels_match_plain(dev, layers, n, C, F):
    from transmogrifai_tpu_torch.ops import mlp as M

    rng = np.random.default_rng(n)
    k = layers[-1]
    X = torch.from_numpy((rng.normal(size=(n, layers[0])) * 2).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, k, n).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.integers(0, 3, size=(F, n)).astype(np.float32)).to(dev)
    fold = torch.arange(C, dtype=torch.int32, device=dev) % F
    wsum = torch.clamp_min(w.sum(1), 1e-12)[fold.long()].contiguous()
    params = torch.stack([M.flatten(M.init_params(s, layers, dev)) for s in range(C)])
    params = params + torch.from_numpy(
        (rng.normal(size=tuple(params.shape)) * 0.1).astype(np.float32)).to(dev)
    g1 = _counted(M.mlp_grad, lambda: M.mlp_grad(X, y, w, fold, wsum, params, layers))
    g2 = M.mlp_grad_plain(X, y, w, fold, wsum, params, layers)
    assert torch.equal(g1, M.mlp_grad(X, y, w, fold, wsum, params, layers))
    torch.testing.assert_close(g1, g2, rtol=1e-4, atol=1e-6 * float(g2.abs().max()))
    (z1, p1) = _counted(M.mlp_forward, lambda: M.mlp_forward(X, params, layers))
    z2, p2 = M.mlp_forward_plain(X, params, layers)
    torch.testing.assert_close(z1, z2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(p1, p2, rtol=0, atol=1e-6)


def test_mlp_refuses_what_it_cannot_take(dev):
    from transmogrifai_tpu_torch.ops import mlp as M

    layers = (4, M.MLP_MAX_WIDTH + 1, 2)
    X = torch.zeros((10, 4), device=dev)
    params = torch.zeros((1, M.param_count(layers)), device=dev)
    with pytest.raises(ValueError, match=str(M.MLP_MAX_WIDTH)):
        M.mlp_forward(X, params, layers)


@pytest.mark.parametrize("n,d,k,F,Q", [(1, 1, 2, 1, 1), (235930, 10, 2, 1, 1),
                                       (20000, 256, 8, 3, 6), (5000, 7, 3, 3, 9),
                                       (20000, 2100, 2, 3, 6), (5000, 32, 26, 3, 9),
                                       (3000, 40, 128, 2, 2), (300, 65536, 3, 1, 1)])
def test_nb_tables_match_plain(dev, n, d, k, F, Q):
    from transmogrifai_tpu_torch.impl.classification import naive_bayes as NB

    rng = np.random.default_rng(n + d)
    X = np.concatenate([rng.integers(0, 2, (n, d // 2)),
                        rng.uniform(0, 80, (n, d - d // 2))], 1).astype(np.float32)
    Xd = torch.from_numpy(X).to(dev)
    y = torch.from_numpy(rng.integers(0, k, n).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.integers(0, 3, size=(F, n)).astype(np.float32)).to(dev)
    c1, f1 = _counted(NB.nb_tables_mass, lambda: NB.nb_tables_mass(Xd, y, w, k))
    c2, f2 = NB.nb_tables_mass_plain(Xd, y, w, k)
    assert torch.equal(c1, c2)
    # float64 sums of exact products in two orders, each rounded once
    torch.testing.assert_close(f1, f2, rtol=2.4e-7, atol=0)
    pi = torch.from_numpy(rng.normal(size=(Q, k)).astype(np.float32)).to(dev)
    th = torch.from_numpy(-rng.random((Q, k, d)).astype(np.float32)).to(dev)
    tn = torch.from_numpy(-rng.random((Q, k, d)).astype(np.float32)).to(dev)
    for neg in (None, tn):
        z1 = _counted(NB.nb_tables_score, lambda: NB.nb_tables_score(Xd, pi, th, neg))
        z2 = NB.nb_tables_score_plain(Xd, pi, th, neg)
        torch.testing.assert_close(z1, z2, rtol=2.4e-7, atol=1e-6)


@pytest.mark.parametrize("n,T,rate", [(891, 50, 1.0), (235930, 50, 1.0), (20000, 9, 0.632),
                                      (5000, 3, 2.5), (700, 4, 0.0)])
def test_threefry_bootstrap_matches_plain(dev, n, T, rate):
    from transmogrifai_tpu_torch.ops import threefry as R

    kb, _ = Tr.rng_keys(42)
    before = R.threefry_draws.launches
    got = Tr.bootstrap_weights(kb, n, T, True, rate, dev)
    torch.cuda.synchronize()
    want = Tr.bootstrap_weights_plain(kb, n, T, True, rate, dev)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert R.threefry_draws.launches == before + (rate > 0)
    assert torch.equal(Tr.bootstrap_weights(kb, n, T, False, rate, dev),
                       torch.ones((T, n), device=dev))


@pytest.mark.parametrize("d,T,frac", [(10, 50, np.sqrt(10) / 10), (16, 50, 1.0 / 3.0),
                                      (8, 200, 0.5), (300, 40, 0.1), (1, 3, 0.5)])
def test_threefry_feature_masks_match_plain(dev, d, T, frac):
    _, kf = Tr.rng_keys(7)
    got = _counted(Tr.R.threefry_draws, lambda: Tr.feature_masks(kf, d, T, frac, dev))
    assert torch.equal(got, Tr.feature_masks_plain(kf, d, T, frac, dev))


def test_threefry_feature_masks_keep_ties_as_the_sort_does(dev):
    """Forced ties: at d = 256 about 3e-5 of the trees have a tie at their
    k-th smallest uniform; draw keys until one such tree shows (a row with
    more than k features), then hold K-W to the plain sort there."""
    d, T, frac = 256, 1 << 16, 0.5
    k = int(round(frac * d))
    for seed in range(40):
        _, kf = Tr.rng_keys(seed)
        got = Tr.feature_masks(kf, d, T, frac, dev)
        if bool((got.sum(1) > k).any()):
            break
    else:
        pytest.fail("no tie at a tree's k-th smallest uniform in 40 draws")
    assert torch.equal(got, Tr.feature_masks_plain(kf, d, T, frac, dev))


@pytest.mark.parametrize("n,R_,frac", [(891, 200, 0.8), (235930, 20, 0.8), (1000, 7, 0.5)])
def test_threefry_subsample_and_uniform_match_plain(dev, n, R_, frac):
    from transmogrifai_tpu_torch.ops import threefry as R

    ks, kf = Tr.rng_keys(3)
    got = _counted(R.threefry_draws, lambda: Tr.subsample_weights(ks, n, R_, frac, dev))
    assert torch.equal(got, Tr.subsample_weights_plain(ks, n, R_, frac, dev))
    for shape in ((10, 10), (7,), (3, 5, 11), (2, 40000)):
        assert torch.equal(R.uniform(kf, shape, dev), R.uniform_plain(kf, shape, dev))
        assert torch.equal(R.random_bits(kf, shape, dev), R.random_bits_plain(kf, shape, dev))


GLM_CASES = [("gaussian", "identity"), ("gaussian", "log"), ("binomial", "logit"),
             ("poisson", "log"), ("poisson", "sqrt"), ("gamma", "inverse"), ("gamma", "log"),
             ("tweedie", "log")]


@pytest.mark.parametrize("family,link", GLM_CASES)
@pytest.mark.parametrize("n,p,G,F", [(4000, 6, 3, 3), (235930, 17, 3, 3), (20000, 85, 3, 3),
                                     (5000, 129, 3, 5)])
def test_weighted_gram_glm_mode_matches_plain(dev, family, link, n, p, G, F):
    from transmogrifai_tpu_torch.ops import linear as L

    rng = np.random.default_rng(n + p)
    # past 64 coefficients (the wide entry) the features shrink to keep the
    # margins' spread of the 6-coefficient case: wider, the inverse link's
    # near-zero margins would turn the float32 margins' summation order into
    # weights of any size
    shrink = np.sqrt(5 / (p - 1)) if p > 64 else 1.0
    X1 = np.concatenate([rng.normal(size=(n, p - 1)) * 0.3 * shrink, np.ones((n, 1))], 1)
    y = rng.poisson(2.0, n).astype(np.float64)
    if family == "binomial":
        y = (y > 1).astype(np.float64)
    w = rng.integers(0, 2, size=(F, n))
    beta = rng.normal(size=(F * G, p)) * 0.1
    beta[:, -1] = {"identity": 2.0, "log": 0.7, "logit": 0.2, "inverse": 0.5, "sqrt": 1.4}[link]
    vp = np.tile([1.2, 1.5, 1.8], F)[:F * G] if family == "tweedie" else np.zeros(F * G)
    ts = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (X1, y, w)]
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    bt = torch.tensor(beta, dtype=torch.float32, device=dev)
    glm = (family, link, torch.tensor(vp, dtype=torch.float32, device=dev))
    H1, g1 = _counted(L.weighted_gram, lambda: L.weighted_gram(*ts, fold, bt, glm))
    H2, g2 = L.weighted_gram_plain(*ts, fold, bt, glm)
    assert torch.equal(H1, L.weighted_gram(*ts, fold, bt, glm)[0])  # a fixed order: repeats
    assert torch.equal(H1, H1.transpose(1, 2))
    # float64 sums in both; the margins' float32 dot products in other orders,
    # which the link's exp and the variance's power carry into the weights
    torch.testing.assert_close(H1, H2, rtol=1e-5, atol=1e-5 * float(H2.abs().max()))
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-5 * float(g2.abs().max()))


# ---------------------------------------------------------------------------
# K-Z numeric_op, column_gather: the fused layer's arithmetic and gathers
# ---------------------------------------------------------------------------
#: operations whose plain version rounds more than once on the card (a
#: scalar divisor by its reciprocal, ``s / v`` as ``reciprocal(v) * s``) or
#: takes another library's log / exp / pow: within 2 float32 ulps
LAYER_APPROX = ("divide", "rdivide", "log", "exp", "power", "round")


@pytest.mark.parametrize("op,binary", [(op, False) for op in (
    "plus", "minus", "multiply", "divide", "power", "abs", "log", "exp", "sqrt", "rminus",
    "rdivide", "ceil", "floor", "round")] + [(op, True) for op in (
        "plus", "minus", "multiply", "divide")])
@pytest.mark.parametrize("n", [1, 1000, 300001])
def test_numeric_op_matches_plain(dev, op, binary, n):
    from transmogrifai_tpu_torch.ops import layer as LY

    rng = np.random.default_rng(n + len(op))
    cols = []
    for _ in range(2 if binary else 1):
        v = (rng.normal(size=n) * 4).astype(np.float32)
        v[::7] = 0.0
        v[1::11] = 100.0
        cols += [torch.from_numpy(v).to(dev), torch.from_numpy(rng.random(n) > 0.2).to(dev)]
    scalars = (0.0,) if binary else (2.0, 0.5, -1.0, 1.7, 3.0)
    for s in scalars:
        kw = {} if binary else {"scalar": s}
        got = _counted(LY.numeric_op, lambda: LY.numeric_op(op, *cols, **kw))
        want = LY.numeric_op_plain(op, *cols, **kw)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.bool
        assert torch.equal(got[1], want[1])
        if op in LAYER_APPROX:
            gap = ((got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-30)).max()
            assert float(gap) <= 2.0 ** -22
        else:
            assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("n,widths", [(1, (3,)), (1000, (6, 3, 10)), (300001, (17, 1, 6)),
                                      (5000, tuple(range(1, 70)))])
def test_column_gather_matches_plain(dev, n, widths):
    from transmogrifai_tpu_torch.ops import layer as LY

    rng = np.random.default_rng(n + len(widths))
    parts = [torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)).to(dev)
             for w in widths]
    got = LY.concat_columns(parts)
    assert torch.equal(got, torch.cat(parts, 1))
    sources = parts[:LY.MAX_SOURCES]
    W = 300
    src = rng.integers(0, len(sources), W)
    col = [int(rng.integers(0, sources[s].shape[1])) for s in src]
    got = _counted(LY.column_gather, lambda: LY.column_gather(sources, src, col))
    assert torch.equal(got, LY.column_gather_plain(sources, src, col))


def test_fista_refuses_past_its_limit(dev):
    from transmogrifai_tpu_torch.ops import linear as L

    p = L.FISTA_MAX_COEFS + 1
    ts = [torch.ones((4, p), device=dev), torch.ones(4, device=dev), torch.ones((1, 4), device=dev),
          torch.zeros(1, dtype=torch.int32, device=dev), torch.zeros((1, p), device=dev),
          torch.zeros((1, p), device=dev), torch.ones(1, device=dev)]
    with pytest.raises(ValueError, match=str(L.FISTA_MAX_COEFS)):
        L.fista_grad(*ts)


# ---------------------------------------------------------------------------
# K18: K-AA sgns_epoch, K-AB lda (beta, estep, sstats)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("V,d,P,K", [(40, 8, 500, 5), (2000, 64, 200000, 5), (300, 100, 7000, 3),
                                     (5, 256, 50, 0), (2000, 300, 100000, 5),
                                     (50, 513, 2000, 5), (300, 1024, 7000, 3)])
def test_sgns_epoch_matches_plain(dev, V, d, P, K):
    from transmogrifai_tpu_torch.ops import embeddings as E

    rng = np.random.default_rng(V + d)
    p = 1.0 / np.arange(1, V + 1) ** 1.1
    p /= p.sum()
    W = torch.from_numpy((rng.standard_normal((V, d)) / np.sqrt(d)).astype(np.float32)).to(dev)
    C = torch.from_numpy((0.1 * rng.standard_normal((V, d))).astype(np.float32)).to(dev)
    pairs = torch.from_numpy(rng.choice(V, (P, 2), p=p).astype(np.int32)).to(dev)
    negs = torch.from_numpy(rng.choice(V, (P, K), p=p).astype(np.int32)).to(dev)
    W2, C2, loss = _counted(E.sgns_epoch, lambda: E.sgns_epoch(W, C, pairs, negs, 0.2))
    W0, C0, loss0 = E.sgns_epoch_plain(W, C, pairs, negs, 0.2)
    assert float((W2 - W0).abs().max()) <= 1e-6 and float((C2 - C0).abs().max()) <= 1e-6
    assert abs(float(loss) - float(loss0)) <= 1e-5 * abs(float(loss0))
    W3, C3, loss3 = E.sgns_epoch(W, C, pairs, negs, 0.2)   # no atomics: repeats bit for bit
    assert torch.equal(W2, W3) and torch.equal(C2, C3) and torch.equal(loss, loss3)


def _lda_case(dev, n, k, v, seed):
    rng = np.random.default_rng(seed)
    X = rng.poisson(0.04, (n, v)).astype(np.float32)
    X[0] = 0.0
    lam = rng.gamma(2.0, 1.0, (k, v)).astype(np.float32)
    return torch.from_numpy(X).to(dev), torch.from_numpy(lam).to(dev)


@pytest.mark.parametrize("n,k,v", [(1, 1, 3), (891, 10, 512), (20000, 10, 512), (3000, 32, 1600),
                                   (500, 5, 70), (3000, 100, 1600), (2000, 256, 300),
                                   (3000, 10, 8192), (891, 40, 700)])
def test_lda_kernels_match_plain(dev, n, k, v):
    from transmogrifai_tpu_torch.ops import embeddings as E

    X, lam = _lda_case(dev, n, k, v, n + k)
    eb = _counted(E.lda_beta, lambda: E.lda_beta(lam))
    eb0 = E.lda_beta_plain(lam)
    # exp_beta may underflow to 0; the topic sums in another order move
    # digamma(sum) by an ulp, and the difference's ulp near -60 is 3.8e-6
    torch.testing.assert_close(eb, eb0, rtol=2e-5, atol=0)
    g = _counted(E.lda_estep, lambda: E.lda_estep(eb0, X, 0.1, 30))
    g0 = E.lda_estep_plain(eb0, X, 0.1, 30)
    torch.testing.assert_close(g, g0, rtol=2e-3, atol=0)
    assert torch.equal(g, E.lda_estep(eb0, X, 0.1, 30))
    lam1 = _counted(E.lda_sstats, lambda: E.lda_sstats(eb0, X, g0, 0.01))
    lam0 = E.lda_sstats_plain(eb0, X, g0, 0.01)
    torch.testing.assert_close(lam1, lam0, rtol=1e-5, atol=0)
    assert torch.equal(lam1, E.lda_sstats(eb0, X, g0, 0.01))


def test_lda_kernels_give_nan_where_plain_does(dev):
    from transmogrifai_tpu_torch.ops import embeddings as E

    X, lam = _lda_case(dev, 700, 4, 60, 3)
    lam = lam * 100
    lam[:, 7] = 0.01            # a dead term: exp_beta 0, phi_norm 0 in every document
    eb = E.lda_beta(lam)
    assert float(eb[:, 7].max()) == 0.0
    assert torch.isnan(E.lda_estep(eb, X, 0.1, 30)).all()
    assert torch.isnan(E.lda_estep_plain(eb, X, 0.1, 30)).all()
    g = torch.ones((700, 4), device=dev)
    got, want = E.lda_sstats(eb, X, g, 0.01), E.lda_sstats_plain(eb, X, g, 0.01)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    g[5, 2] = float("nan")
    assert torch.isnan(E.lda_sstats(eb, X, g, 0.01)).all()
    assert torch.isnan(E.lda_sstats_plain(eb, X, g, 0.01)).all()


def test_digamma_on_the_card_matches_plain(dev):
    from transmogrifai_tpu_torch.ops import embeddings as E

    lam = torch.from_numpy(np.geomspace(0.005, 5000, 4096).astype(np.float32)).to(dev)[None]
    got = E.lda_beta(lam)                      # exp(digamma(lam) - digamma(sum))
    torch.testing.assert_close(got, E.lda_beta_plain(lam), rtol=2e-6, atol=0)


# ---------------------------------------------------------------------------
# K-AC numeric_scale, K-AD column_affine: the scalers' device programs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["fill", "standardize", "scale_linear", "scale_log",
                                  "descale_linear", "descale_exp", "bucket"])
@pytest.mark.parametrize("n", [1, 300_001])
def test_numeric_scale_matches_plain(dev, mode, n):
    from transmogrifai_tpu_torch.ops import layer as LY

    rng = np.random.default_rng(n)
    v = (rng.normal(size=n) * 30).astype(np.float32)
    if n > 10:
        v[::17] = 0.0
        v[1::19] = np.nan
        v[2::23] = np.inf
        v[3::29] = -np.inf
        v[4::31] = 1e30
    m = rng.random(n) > 0.2
    splits = np.sort(rng.normal(size=1023) * 30).astype(np.float32)
    if n > 10:
        v[5:200] = splits[rng.integers(0, 1023, 195)]      # values on the splits
    vt, mt = torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev)
    st = torch.from_numpy(splits).to(dev)
    a, b = {"fill": (3.3, 0.0), "standardize": (3.3, 1.7), "scale_linear": (1.37, -0.291),
            "descale_linear": (1.37, -0.291)}.get(mode, (1.0, 0.0))
    kw = {"splits": st} if mode == "bucket" else {}
    got_v, got_m = _counted(LY.numeric_scale, lambda: LY.numeric_scale(mode, vt, mt, a, b, **kw))
    want_v, want_m = LY.numeric_scale_plain(mode, vt, mt, a, b, **kw)
    assert torch.equal(got_m, want_m)
    if mode in ("scale_log", "descale_exp"):   # libdevice's logf / expf against torch's
        torch.testing.assert_close(got_v, want_v, rtol=2.0 ** -22, atol=0, equal_nan=True)
    else:
        assert torch.equal(torch.nan_to_num(got_v, nan=7.0), torch.nan_to_num(want_v, nan=7.0))


@pytest.mark.parametrize("n,d", [(1, 1), (100_000, 24), (3, 5000)])
def test_column_affine_matches_plain(dev, n, d):
    from transmogrifai_tpu_torch.ops import layer as LY

    rng = np.random.default_rng(n + d)
    x = torch.from_numpy((rng.normal(size=(n, d)) * 10).astype(np.float32)).to(dev)
    shift = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(dev)
    scale = torch.from_numpy((1.0 / rng.uniform(0.1, 5, d)).astype(np.float32)).to(dev)
    got = _counted(LY.column_affine, lambda: LY.column_affine(x, shift, scale))
    assert torch.equal(got, LY.column_affine_plain(x, shift, scale))


def test_streamed_run_waits_for_device_inputs_written_on_the_callers_stream(dev, monkeypatch):
    """A base vector already on the card, still being written on the
    caller's stream when the run starts (behind a long sleep), is read by
    the executor only once written: the streamed output equals the CPU's.
    A first run warms the caching allocators, so that no allocation (which
    synchronizes the device) orders the work by chance."""
    import transmogrifai_tpu_torch as P
    import transmogrifai_tpu_torch.types as PT
    from transmogrifai_tpu_torch.columns import Dataset, NumericColumn, VectorColumn
    from transmogrifai_tpu_torch.impl.feature.vectorizers import (
        RealVectorizer, StandardScalerVectorizer, VectorsCombiner)
    from transmogrifai_tpu_torch.workflow import stream as S

    n = 50_000
    rng = np.random.default_rng(7)
    xs = [P.FeatureBuilder(f"x{j}", PT.Real).extract(field=f"x{j}").as_predictor()
          for j in range(4)]
    ds = Dataset({f"x{j}": NumericColumn(PT.Real, rng.normal(size=n), rng.random(n) > 0.1)
                  for j in range(4)})
    m1 = RealVectorizer().set_input(*xs[:2]).fit(ds).to("cpu")
    m2 = RealVectorizer().set_input(*xs[2:]).fit(ds).to("cpu")
    comb = VectorsCombiner().set_input(m1.get_output(), m2.get_output()).to("cpu")
    vecs = {m.get_output().name: m.transform_dataset(ds) for m in (m1, m2)}
    host = Dataset(dict(vecs))
    host = host.with_column(comb.get_output().name, comb.transform_dataset(host))
    sm = StandardScalerVectorizer().set_input(comb.get_output()).fit(host).to("cpu")
    layers = [[comb], [sm]]
    name = sm.get_output().name
    want = S.apply_streamed(Dataset(dict(vecs)), layers)[name].values

    monkeypatch.setattr(S, "CHUNK_ROWS", 16_384)          # four chunks, a tail among them
    comb.to(dev)
    sm.to(dev)
    staged = {k: c.values.to(dev) for k, c in vecs.items()}

    def on_card(vals):
        return Dataset({k: VectorColumn(PT.OPVector, v, vecs[k].metadata)
                        for k, v in vals.items()})

    late = {k: torch.full_like(t, float("nan")) for k, t in staged.items()}
    S.apply_streamed(on_card(staged), layers)              # warm the allocators
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)                         # the caller's stream is busy
    for k, t in staged.items():
        torch.mul(t, 1.0, out=late[k])
    got = S.apply_streamed(on_card(late), layers)[name].values
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# round-collapsed boosting: the collapse modes of K-H and K-R; K-AE
# ---------------------------------------------------------------------------
def _collapse_inputs(dev, B, K, n, P, c, loss, seed):
    rng = np.random.default_rng(seed)
    shape = (B, n) if c == 0 else (B, n, c)
    lshape = (B * K, P) if c == 0 else (B * K, P, c)
    F = rng.normal(size=shape).astype(np.float32) * 2
    if loss == "squared":
        F += 20.0
        y = (20.0 + 9.0 * rng.normal(size=n)).astype(np.float32)
    elif loss == "softmax":
        y = rng.integers(0, c, n).astype(np.float32)
    else:
        y = (rng.random(n) < 0.4).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(F), t(y), t(rng.integers(0, 3, size=(B, n)).astype(np.float32)),
            t(rng.random(B).astype(np.float32)),
            t(rng.normal(size=lshape).astype(np.float32)),
            t(rng.integers(0, P, size=(B * K, n)).astype(np.int32)),
            t((rng.random((K, n)) < 0.8).astype(np.float32)))


@pytest.mark.parametrize("loss", ["logistic", "squared"])
@pytest.mark.parametrize("K,update", [(2, True), (3, True), (4, True), (4, False), (8, True),
                                      (16, True), (6, True), (32, True), (64, True)])
def test_boost_step_collapse_mode_matches_plain(dev, loss, K, update):
    B, n, P = 6, 10007, 63
    F, y, w, eta, leaf, node, rw = _collapse_inputs(dev, B, K, n, P, 0, loss, K)
    upd = (leaf, node) if update else (None, None)
    F1, F2 = F.clone(), F.clone()
    g1, g2 = (torch.empty((B * K, n, 2), device=dev) for _ in range(2))
    before = Tr.boost_step.collapse_launches
    _counted(Tr.boost_step, lambda: Tr.boost_step(F1, y, w, eta, *upd, g1, loss, rw))
    assert Tr.boost_step.collapse_launches == before + 1
    Tr.boost_step_plain(F2, y, w, eta, *upd, g2, loss, rw)
    assert torch.equal(F1, F2)  # XLA's sum order, one fused multiply-add in both
    if loss == "squared":
        assert torch.equal(g1, g2)
    else:  # expf of libdevice and of the host may differ by an ulp
        torch.testing.assert_close(g1, g2, rtol=1e-6, atol=2e-7)
    # the last update of a fit: no gradients
    Tr.boost_step(F1, y, w, eta, leaf, node, None, loss, rw)
    Tr.boost_step_plain(F2, y, w, eta, leaf, node, None, loss, rw)
    assert torch.equal(F1, F2)


@pytest.mark.parametrize("k,K", [(3, 4), (3, 2), (5, 3), (8, 4), (3, 16), (8, 32), (10, 4),
                                 (26, 4), (26, 3), (64, 4), (128, 2), (128, 16)])
def test_softmax_boost_step_collapse_mode_matches_plain(dev, k, K):
    B, n, P = 4, 20011, 63
    F, y, w, eta, leaf, node, rw = _collapse_inputs(dev, B, K, n, P, k, "softmax", k + K)
    F1, F2 = F.clone(), F.clone()
    g1, g2 = (torch.empty((B * K, n, k + 1), device=dev) for _ in range(2))
    _counted(Tr.softmax_boost_step,
             lambda: Tr.softmax_boost_step(F1, y, w, eta, leaf, node, g1, rw))
    Tr.softmax_boost_step_plain(F2, y, w, eta, leaf, node, g2, rw)
    assert torch.equal(F1, F2)
    torch.testing.assert_close(g1, g2, rtol=0, atol=2.4e-7 * 2)


def test_collapse_fit_on_the_card_matches_plain(dev):
    """``fit_gbt`` at K = 4 through the collapse kernel and the growers on
    the card against the same fit on the CPU (integer weights: the
    histogram sums are exact on both)."""
    rng = np.random.default_rng(3)
    n, d, R = 3000, 6, 8
    Xb = rng.integers(0, 16, (n, d)).astype(np.int8)
    y = ((Xb[:, 0] - 0.6 * Xb[:, 1] + rng.standard_normal(n) * 2) > 0).astype(np.float32)
    rw = (rng.random((R, n)) < 0.8).astype(np.float32)
    fm = (rng.random((R, d)) < 0.8).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    out = []
    for where in (dev, torch.device("cpu")):
        t = lambda a: torch.from_numpy(a).to(where)  # noqa: E731
        tree, F = Tr.fit_gbt(t(Xb), t(y), t(w), t(rw), t(fm), "logistic", R, 3, 16, 8,
                             eta=0.3, trees_per_round=4)
        out.append((tree.split_feat.cpu(), F.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,d,F,G", [(1, 3, 1, 1), (10007, 11, 3, 8), (262144, 11, 3, 8),
                                     (5000, 85, 3, 8), (3000, 600, 2, 40)])
def test_logistic_grid_error_matches_plain(dev, n, d, F, G):
    from transmogrifai_tpu_torch.parallel import sweep as S

    rng = np.random.default_rng(n + d)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    X = t(rng.normal(size=(n, d)).astype(np.float32))
    y = t((rng.random(n) < 0.4).astype(np.float32))
    val_w = t((rng.random((F, n)) < 0.33).astype(np.float32))
    coef = t(rng.normal(size=(F, G, d)).astype(np.float32))
    b = t(rng.normal(size=(F, G, 1)).astype(np.float32))
    got = _counted(S.eval_logistic_grid_folds,
                   lambda: S.eval_logistic_grid_folds(X, y, val_w, coef, b))
    want = S.eval_logistic_grid_folds_plain(X, y, val_w, coef, b)
    # rows whose margin lies within float32 rounding of 0 may fall on either
    # side (the plain product sums in cuBLAS's order, the kernel in feature
    # order): allow exactly those, counted from a float64 margin
    z = (torch.einsum("nd,fgd->fgn", X.double(), coef.double()) + b.double())
    scale = torch.einsum("nd,fgd->fgn", X.double().abs(), coef.double().abs()) + b.double().abs()
    near = ((z.abs() <= 4 * d * 2.0 ** -24 * scale) * val_w[:, None].double()).sum(-1)
    den = torch.clamp_min(val_w.double().sum(-1), 1.0)[:, None]
    assert ((got.double() - want.double()).abs() <= near / den + 1e-7).all()


@pytest.mark.parametrize("p", [10, 85, 1024])
@pytest.mark.parametrize("mode,k", [("binary", 1), ("softmax", 3), ("softmax", 26),
                                    ("softmax", 128), ("linear", 1)])
def test_predict_head_matches_plain(dev, p, mode, k):
    """K-AF against its plain version: margins within float32 sums of p
    products in another order; probabilities within 1e-6 plus half the
    largest margin gap (a softmax output p_i moves by at most
    2 p_i (1 - p_i) <= 1/2 times its inputs' largest move, a sigmoid's by
    1/4 of it); predictions equal off the decision boundary."""
    from transmogrifai_tpu_torch.ops import linear as L

    rng = np.random.default_rng(p * 131 + k)
    n = 1000
    X = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)).to(dev)
    shape = (p, k) if mode == "softmax" else (p,)
    coef = torch.from_numpy((rng.normal(size=shape) / np.sqrt(p)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=k).astype(np.float32)).to(dev)
    pred, raw, prob = _counted(L.predict_head, lambda: L.predict_head(X, coef, b, mode))
    pred0, raw0, prob0 = L.predict_head_plain(X, coef, b, mode)
    if mode == "linear":
        assert raw is None and prob is None
        torch.testing.assert_close(pred, pred0, atol=1e-5, rtol=1e-5)
        return
    torch.testing.assert_close(raw, raw0, atol=1e-5, rtol=1e-5)
    gap = float((raw - raw0).abs().max())
    torch.testing.assert_close(prob, prob0, atol=1e-6 + 0.5 * gap, rtol=0)
    top = torch.topk(raw0, 2, dim=1).values
    near = (top[:, 0] - top[:, 1]) <= (2e-4 if mode == "binary" else 1e-4)
    assert torch.equal(pred[~near], pred0[~near])


@pytest.mark.parametrize("p", [1, 7, 10, 16, 1023, 1024, 5001])
@pytest.mark.parametrize("mode", ["binary", "linear"])
def test_predict_head_dot_modes_at_their_design_edges(dev, p, mode):
    """K-AF's dot heads at n below and above the plan's splits (4, 2 and 1
    warps a row at p = 1,024; a warp a row, then lane groups of 4 row sets
    up to 32 coefficients), at p % 4 != 0, past the staged coefficients, and
    with X a view at an offset that is not 16-byte aligned: a row's answer
    is the same value whatever the batch, the split and the alignment, and
    within float32 sums of the plain version."""
    from transmogrifai_tpu_torch.ops import linear as L

    rng = np.random.default_rng(p)
    n = 20000
    base = torch.from_numpy(rng.normal(size=n * p + 8).astype(np.float32)).to(dev)
    X = base[:n * p].view(n, p)
    Xoff = base[1:n * p + 1].view(n, p)  # 4 bytes past a 16-byte boundary
    Xoff_aligned = Xoff.clone()
    coef = torch.from_numpy((rng.normal(size=p) / np.sqrt(p)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=1).astype(np.float32)).to(dev)
    full = _counted(L.predict_head, lambda: L.predict_head(X, coef, b, mode))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = set()
    for rows in (1, 64, 300, 527, 528, 1055, 1056, 3000, n):
        splits.add(L.head_plan(rows, p, 1, sms, mode).split)
        part = L.predict_head(X[:rows], coef, b, mode)
        for got, want in zip(part, full):
            assert got is None or torch.equal(got, want[:rows])
    if p == 1024:
        assert splits == {1, 2, 4}
    elif p <= L.HEAD_NARROW_MAX:
        assert splits == {32, 1 << (p - 1).bit_length()}
    moved = L.predict_head(Xoff, coef, b, mode)
    for got, want in zip(moved, L.predict_head(Xoff_aligned, coef, b, mode)):
        assert got is None or torch.equal(got, want)
    for got, want in zip(full, L.predict_head(X, coef, b, mode)):
        assert got is None or torch.equal(got, want)
    pred0, raw0, _ = L.predict_head_plain(X, coef, b, mode)
    tol = dict(atol=1e-5, rtol=1e-5)
    if mode == "linear":
        torch.testing.assert_close(full[0], pred0, **tol)
    else:
        torch.testing.assert_close(full[1], raw0, **tol)


@pytest.mark.parametrize("name", ["TITANIC_STOCK", "BOSTON_RIDGE", "TITANIC_XGB"])
def test_bucket_graph_replays_the_eager_program_bit_for_bit(dev, name):
    """Each bucket's CUDA graph against the same program launched op by op,
    on the fixture's requests, at every bucket of max_batch 64."""
    import math

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch import fixtures as FX
    from transmogrifai_tpu_torch.serve import shape_buckets
    from transmogrifai_tpu_torch.serve.aot import BucketScorer

    path = getattr(FX, name)
    model = P.load_model(path)
    recs = [{k: (None if isinstance(v, float) and math.isnan(v) else v) for k, v in r.items()}
            for r in FX.records(FX.load_columns(path + "/requests.npz"))
            if not any(isinstance(v, float) and math.isinf(v) for v in r.values())]
    buckets = shape_buckets(64)
    scorer = BucketScorer(model, buckets, dev)
    scorer.warm()
    before = scorer.replays
    try:
        for b in buckets:
            part = recs[:b]
            graph = scorer.device_outputs(part, b)
            eager = scorer.device_outputs(part, b, eager=True)
            assert graph.keys() == eager.keys()
            for key in graph:
                assert np.array_equal(graph[key], eager[key]), (b, key)
        assert scorer.replays - before == len(buckets)
        assert scorer.capture_s.keys() == set(buckets)
    finally:
        scorer.release()


def test_min_child_weight_boundary_tree_on_the_card(dev):
    """The softmax first round at min_child_weight 10 with 45 rows of
    hessian 0.22222221 in one bin (9.9999994 exactly, 10.000003 in float32
    row order): the card's ordered K-E sums as the reference does, so its
    tree splits on them as the plain version's CPU run does
    (``tests/test_torch_softmax_boost.py`` holds that run to the JAX
    package's), and not at 10.00001."""
    idx = np.arange(150)
    left = idx[idx % 3 == 0][:45]
    Xb = np.full((150, 1), 2, np.int32)
    Xb[left, 0] = 0
    y = np.where(np.isin(idx, left), 0, 1 + idx % 2).astype(np.float32)
    host = [torch.from_numpy(a) for a in (Xb, y, np.ones(150, np.float32),
                                          np.ones((1, 150), np.float32),
                                          np.ones((1, 1), np.float32))]
    for mcw, split in ((10.0, True), (10.00001, False)):
        got_t, got_F = Tr.fit_gbt(*[a.to(dev) for a in host], "softmax", 1, 1, 4, 8, eta=0.3,
                                  min_child_weight=mcw, n_classes=3)
        want_t, want_F = Tr.fit_gbt(*host, "softmax", 1, 1, 4, 8, eta=0.3,
                                    min_child_weight=mcw, n_classes=3)
        for name in ("split_feat", "split_bin", "left", "right"):
            assert torch.equal(getattr(got_t, name).cpu(), getattr(want_t, name))
        assert torch.equal(got_F.cpu(), want_F)
        assert bool(got_t.split_feat[0, 0] == 0) == split
