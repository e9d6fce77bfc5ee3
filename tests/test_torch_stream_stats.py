"""The streamed column statistics on the port against the JAX package's, on the CPU.

``transmogrifai_tpu_torch/parallel/stats.py`` ports
``transmogrifai_tpu/parallel/stats.py`` on one device: the two-pass
``DataShardedStats`` (``moments``, ``correlations_from``), the one-pass
``fused_moments_and_correlations``, ``sharded_correlations`` (Pearson and
Spearman), ``sharded_column_moments`` and ``rank_transform``.  On CPU tensors
the kernels' plain versions run (K-X's chunk moments, K-I's centered Gram,
K-Y's midranks: float64 sums, float32 ranks).  Each case runs both packages
on the same numpy inputs, the JAX side as its own tests run it, in row
chunks of 777 and 1,024 rows with ``mesh=None`` and of 701 rows on the
8-device CPU mesh of ``tests/conftest.py`` (``tests/test_sharded_stats.py``'s
chunk sizes; a mesh pads a chunk to its shard count), over three data sets:
normal columns with a zero-variance one, a mean that drifts 500 sigma over
the rows (``tests/test_sharded_stats.py:220``), and tie-heavy columns
(integers in [0, 16), one-decimal rounding, a 0/1 indicator).

- Counts, minima and maxima equal the float64 oracle's (numpy on the same
  float32 data) and the JAX package's; midranks are bit-equal to the JAX
  package's and to ``utils/stats._rank_data``.
- Means, variances and correlations are within ``ORACLE_RTOL`` of the
  oracle (relative; correlations absolute, their scale being 1).
- Against the JAX package, whose carries are float32, within ``JAX_RTOL``
  relative to each vector's largest entry (correlations: ``JAX_CORR_ATOL``),
  measured: the largest gaps over these cases were 1.1e-7 (means), 8.0e-7
  (variances and standard deviations) and 4.9e-7 (correlations).
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.parallel import stats as JS
from transmogrifai_tpu.parallel.mesh import make_mesh
from transmogrifai_tpu.utils import stats as JU

from transmogrifai_tpu_torch.parallel import stats as PS
from transmogrifai_tpu_torch.utils import stats as PU

torch.set_num_threads(1)

#: the port's float64 sums against the float64 oracle
ORACLE_RTOL = 1e-12
#: the reference's float32 carries against the port, relative to the largest
#: entry of each vector (measured: 1.1e-7 means, 8.0e-7 variances)
JAX_RTOL = 2e-6
#: the reference's correlations against the port's (measured: 4.9e-7)
JAX_CORR_ATOL = 1e-6

CHUNKS = (777, 701, 1024)
#: the JAX side's mesh for each chunk size
MESH_OF = {777: "none", 701: "data8", 1024: "none"}
KINDS = ("normal", "drift", "ties")


def _data(kind):
    """(X f32[n, d], y f32[n])."""
    if kind == "normal":
        rng = np.random.default_rng(0)
        n, d = 5000, 12
        X = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3, d)).astype(np.float32)
        X[:, 3] = 2.0  # zero variance
        y = (X[:, 0] - X[:, 1] + rng.normal(size=n)).astype(np.float32)
    elif kind == "drift":
        rng = np.random.default_rng(5)
        n, d = 8000, 6
        drift = np.linspace(0.0, 500.0, n)[:, None]
        X = (rng.normal(size=(n, d)) + drift).astype(np.float32)
        y = (X[:, 0] - drift[:, 0] + rng.normal(size=n)).astype(np.float32)
    else:
        rng = np.random.default_rng(17)
        n, d = 3000, 6
        X = rng.integers(0, 16, size=(n, d)).astype(np.float32)
        X[:, 1] = np.round(rng.normal(size=n), 1)
        X[:, 2] = rng.integers(0, 2, n)
        y = (X[:, 0] + 3 * X[:, 2] + rng.integers(0, 4, n)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def datasets():
    return {k: _data(k) for k in KINDS}


@pytest.fixture(scope="module")
def meshes():
    return {"none": None, "data8": make_mesh(n_data=8, n_model=1)}


def _oracle_corr(X, y):
    """The float64 Pearson matrix of [X | y] (NaN for constant columns)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.corrcoef(np.column_stack([X, y]).astype(np.float64), rowvar=False)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, float) - b) / np.maximum(np.abs(b), 1e-300)))


def _scaled_gap(a, b):
    """Largest gap relative to the largest entry of b."""
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / max(np.max(np.abs(b)), 1e-300))


def _same_nan(a, b):
    return np.array_equal(np.isnan(a), np.isnan(b))


def _corr_gap(a, b):
    assert _same_nan(a, b)
    live = ~np.isnan(b)
    return float(np.max(np.abs(a[live] - b[live]))) if live.any() else 0.0


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_moments(datasets, meshes, kind, chunk):
    X, _ = datasets[kind]
    d = X.shape[1]
    port = PS.DataShardedStats(d, device="cpu").moments(PS.chunked(X, chunk_rows=chunk)())
    X64 = X.astype(np.float64)
    assert port.count == len(X)
    np.testing.assert_array_equal(port.min, X.min(0))
    np.testing.assert_array_equal(port.max, X.max(0))
    assert _rel(port.mean, X64.mean(0)) <= ORACLE_RTOL
    assert _rel(port.variance, X64.var(0, ddof=1)) <= ORACLE_RTOL
    ref = JS.DataShardedStats(d, mesh=meshes[MESH_OF[chunk]]).moments(
        JS.chunked(X, chunk_rows=chunk)())
    assert ref.count == port.count
    np.testing.assert_array_equal(ref.min, port.min)
    np.testing.assert_array_equal(ref.max, port.max)
    assert _scaled_gap(ref.mean, port.mean) <= JAX_RTOL
    assert _scaled_gap(ref.variance, port.variance) <= JAX_RTOL


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_correlations_from(datasets, meshes, kind, chunk):
    X, y = datasets[kind]
    d = X.shape[1]
    mean, y_mean = X.astype(np.float64).mean(0), float(y.astype(np.float64).mean())
    corr, mat = PS.DataShardedStats(d, device="cpu").correlations_from(
        PS.chunked(X, y, chunk_rows=chunk), mean, y_mean)
    o = _oracle_corr(X, y)
    assert _corr_gap(corr, o[:-1, -1]) <= ORACLE_RTOL
    assert _corr_gap(mat, o[:-1, :-1]) <= ORACLE_RTOL
    rc, rm = JS.DataShardedStats(d, mesh=meshes[MESH_OF[chunk]]).correlations_from(
        JS.chunked(X, y, chunk_rows=chunk), mean, y_mean)
    assert _corr_gap(rc, corr) <= JAX_CORR_ATOL
    assert _corr_gap(rm, mat) <= JAX_CORR_ATOL


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_fused_moments_and_correlations(datasets, meshes, kind, chunk):
    X, y = datasets[kind]
    d = X.shape[1]
    stats, corr, mat = PS.fused_moments_and_correlations(
        PS.chunked(X, y, chunk_rows=chunk), d, device="cpu")
    X64 = X.astype(np.float64)
    o = _oracle_corr(X, y)
    assert stats.count == len(X)
    np.testing.assert_array_equal(stats.min, X.min(0))
    np.testing.assert_array_equal(stats.max, X.max(0))
    assert _rel(stats.mean, X64.mean(0)) <= ORACLE_RTOL
    assert _rel(stats.variance, X64.var(0, ddof=1)) <= ORACLE_RTOL
    assert _corr_gap(corr, o[:-1, -1]) <= ORACLE_RTOL
    assert _corr_gap(mat, o[:-1, :-1]) <= ORACLE_RTOL
    rs, rc, rm = JS.fused_moments_and_correlations(JS.chunked(X, y, chunk_rows=chunk), d,
                                                   mesh=meshes[MESH_OF[chunk]])
    assert rs.count == stats.count
    np.testing.assert_array_equal(rs.min, stats.min)
    np.testing.assert_array_equal(rs.max, stats.max)
    assert _scaled_gap(rs.mean, stats.mean) <= JAX_RTOL
    assert _scaled_gap(rs.variance, stats.variance) <= JAX_RTOL
    assert _corr_gap(rc, corr) <= JAX_CORR_ATOL
    assert _corr_gap(rm, mat) <= JAX_CORR_ATOL


@pytest.mark.parametrize("method", ["pearson", "spearman"])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_correlations(datasets, meshes, kind, method):
    X, y = datasets[kind]
    stats, corr, mat = PS.sharded_correlations(X, y, chunk_rows=777, method=method, device="cpu")
    if method == "spearman":
        R = np.column_stack([JU._rank_data(c) for c in np.column_stack([X, y]).T.astype(float)])
        o = np.corrcoef(R, rowvar=False)
    else:
        o = _oracle_corr(X, y)
    assert stats.count == len(X)
    np.testing.assert_array_equal(stats.min, X.min(0))
    assert _rel(stats.mean, X.astype(np.float64).mean(0)) <= ORACLE_RTOL
    assert _corr_gap(corr, o[:-1, -1]) <= ORACLE_RTOL
    assert _corr_gap(mat, o[:-1, :-1]) <= ORACLE_RTOL
    _, rc, rm = JS.sharded_correlations(X, y, mesh=meshes["data8"], chunk_rows=777,
                                        method=method)
    assert _corr_gap(rc, corr) <= JAX_CORR_ATOL
    assert _corr_gap(rm, mat) <= JAX_CORR_ATOL


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_column_moments(datasets, kind, chunk):
    X, _ = datasets[kind]
    n, mean, std = PS.sharded_column_moments(X, chunk_rows=chunk, devices=["cpu"])
    X64 = X.astype(np.float64)
    assert n == len(X)
    assert _rel(mean, X64.mean(0)) <= ORACLE_RTOL
    assert _rel(std[std > 0], X64.std(0)[std > 0]) <= ORACLE_RTOL
    rn, rmean, rstd = JS.sharded_column_moments(X, chunk_rows=chunk)
    assert rn == n
    assert _scaled_gap(rmean, mean) <= JAX_RTOL
    assert _scaled_gap(rstd, std) <= JAX_RTOL


@pytest.mark.parametrize("kind", KINDS)
def test_rank_transform_is_bit_equal(datasets, kind):
    X, y = datasets[kind]
    ranks = PS.rank_transform(X, device="cpu")
    assert ranks.dtype == torch.float32
    np.testing.assert_array_equal(ranks.numpy(), JS.rank_transform(X))
    host = np.column_stack([JU._rank_data(c) for c in X.T.astype(np.float64)])
    np.testing.assert_array_equal(ranks.numpy().astype(np.float64), host)
    np.testing.assert_array_equal(PS.rank_transform(y, device="cpu").numpy(),
                                  JS.rank_transform(y))


@pytest.mark.parametrize("kind", KINDS)
def test_in_memory_spearman_matches_jax(datasets, kind):
    """``utils/stats.correlations_with_label(method="spearman")``: K-Y's
    midranks (float64 in, the reference's host ``_rank_data``), then the same
    float64 Pearson; raw-space column stats, rank-space correlations."""
    X, y = (a.astype(np.float64) for a in datasets[kind])
    js, jc, jm = JU.correlations_with_label(X, y, method="spearman", with_corr_matrix=True)
    ps, pc, pm = PU.correlations_with_label(torch.from_numpy(X), torch.from_numpy(y),
                                            method="spearman", with_corr_matrix=True)
    assert ps.count == js.count
    for a in ("mean", "variance", "min", "max"):  # raw space, float64 in both
        np.testing.assert_allclose(getattr(ps, a), getattr(js, a), rtol=1e-12, atol=1e-12)
    assert _same_nan(pc, jc) and _corr_gap(pc, jc) <= ORACLE_RTOL
    # the matrix is a float32 product of the standardized ranks in both
    assert _corr_gap(pm, jm) <= 2e-6
    np.testing.assert_array_equal(PU.rank_data(torch.from_numpy(y)).numpy(), JU._rank_data(y))


def test_rank_data_ranks_float64_values_exactly():
    # distinct in float64, equal in float32: the float64 ranks keep them apart
    y = 1.0 + np.arange(1000)[::-1] * 1e-12
    ranks = PU.rank_data(torch.from_numpy(y))
    assert ranks.dtype == torch.float64
    np.testing.assert_array_equal(ranks.numpy(), JU._rank_data(y))
    np.testing.assert_array_equal(ranks.numpy(), np.arange(1000, 0, -1, dtype=np.float64))


def test_one_device_only():
    X, y = _data("ties")
    mesh = make_mesh(n_data=8, n_model=1)
    for call in (lambda: PS.DataShardedStats(6, mesh=mesh),
                 lambda: PS.fused_moments_and_correlations(PS.chunked(X, y), 6, mesh=mesh),
                 lambda: PS.sharded_correlations(X, y, mesh=mesh),
                 lambda: PS.sharded_column_moments(X, devices=["cpu", "cpu"])):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            call()


def test_numpy_chunks_go_to_the_card_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is available")
    X, y = _data("ties")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PS.DataShardedStats(6).moments(PS.chunked(X)())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PS.sharded_column_moments(X)
    # tensors stay on their own device
    s = PS.DataShardedStats(6).moments(PS.chunked(torch.from_numpy(X))())
    assert s.count == len(X)


def test_empty_streams_match_the_reference():
    port = PS.DataShardedStats(3, device="cpu").moments(iter(()))
    ref = JS.DataShardedStats(3).moments(iter(()))
    for f in ("mean", "variance", "min", "max"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    assert port.count == ref.count == 0
    s, c, m = PS.fused_moments_and_correlations(lambda: iter(()), 3, device="cpu")
    rs, rc, rm = JS.fused_moments_and_correlations(lambda: iter(()), 3)
    assert s.count == rs.count == 0 and m is None and rm is None
    assert np.isnan(c).all() and np.isnan(rc).all()
