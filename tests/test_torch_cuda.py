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
