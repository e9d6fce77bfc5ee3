"""The launch plan of K-I (both modes), on the CPU.

``ops/stats.py::gram_plan`` chooses K-I's entry (the CUDA-core pass at D <=
64 columns, one diagonal tile; past it the CUDA-core pass over 64-column
tile pairs for ``corr_gram`` and the float64 tensor-core pass over
128-column tile pairs for the centered mode), its threads, row tiles, row
chunks, the finish's lanes a cell and the shared and partial bytes;
``csrc/col_stats.cu`` takes them as launch arguments.  These tests replay the
blocks as the kernels write them: every cell of the upper triangle exactly
once a chunk (``gram_narrow``'s micro-tiles and row splits, ``gram_wide``'s
32 x 32 items), every row in one chunk, the partials within the buffer the
wrapper allocates, the finish's cell decode, and the planned order of the
sums (each chunk's row tiles and splits, then the finish's lanes and its
shuffle tree) emulated in numpy against the plain versions: within
``STREAM_RTOL`` in float64 and within ``STATS_GRAM_ATOL`` for
``corr_gram``'s float32-then-float64 sums.  d runs from 1 to 1,024, n from
1 past 2^18.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from transmogrifai_tpu_torch.ops import stats as K

torch.set_num_threads(1)

#: the card tests' tolerances (tests/test_torch_cuda.py, chip_smoke.py)
STREAM_RTOL = 1e-12
STATS_GRAM_ATOL = 2e-6
#: the H100's shared memory a block, less the kernels' static shared bytes
SMEM_BLOCK_BYTES = 232448 - 2048
ROWS = (1, 3, 31, 32, 33, 127, 128, 129, 1000, 4097, 99999, 100000, 1 << 18, (1 << 18) + 1,
        (1 << 20) + 77)
WIDTHS = (1, 2, 3, 4, 5, 16, 23, 24, 25, 31, 32, 33, 62, 63, 64, 65, 66, 85, 100, 127, 128, 129,
          200, 255, 256, 257, 300, 511, 512, 513, 777, 1000, 1023, 1024)


def _pair(q, nt):
    """The kernels' pair_decode: tile pair q, row-major over ti <= tj."""
    a = 0
    while q >= nt - a:
        q -= nt - a
        a += 1
    return a, a + q


def _micro(m, diag, ma, mb):
    """gram_narrow's micro_decode."""
    if not diag:
        return m // mb, m % mb
    r = 0
    while m >= ma - r:
        m -= ma - r
        r += 1
    return r, r + m


def _tri_offset(i, D):
    return i * D - i * (i - 1) // 2


def _narrow_blocks(plan):
    """Each tile pair's (i, j) cells as gram_narrow's threads write them,
    and its row splits."""
    D, T = plan.D, K._NARROW_TILE
    for q in range(plan.pairs):
        ti, tj = _pair(q, plan.tiles)
        diag = ti == tj
        i0, j0 = ti * T, tj * T
        ma, mb = -(-min(T, D - i0) // 4), -(-min(T, D - j0) // 4)
        mt = ma * (ma + 1) // 2 if diag else ma * mb
        assert mt == K.narrow_micro_tiles(D, ti, tj)
        splits = max(1, min(plan.threads // mt, plan.rows // 4))
        # every micro-tile has its threads, and every column pair of the
        # operand rows its converting thread
        assert mt * splits <= plan.threads
        width = -(-D // 4) * 4 if plan.tiles == 1 else (T if diag else 2 * T)
        assert width // 2 <= plan.threads
        ab = np.array([_micro(m, diag, ma, mb) for m in range(mt)])
        e = np.arange(16)
        i = (i0 + 4 * ab[:, :1] + e[None] // 4).ravel()
        j = (j0 + 4 * ab[:, 1:] + e[None] % 4).ravel()
        keep = (i < D) & (j < D) & ((i <= j) | (not diag))
        yield (ti, tj), i[keep], j[keep], splits


def _wide_blocks(plan):
    """Each tile pair's (i, j) cells as gram_wide's warps write them, and
    each item's split among warps: the 32 x 32 items over the d = D - 1
    feature columns, and on a diagonal pair the label's column, a 32-row
    sub-block a warp left without an item (and its square on tile 0's)."""
    D, T = plan.D, K._WIDE_TILE
    d = D - 1
    warps = plan.threads // 32
    for q in range(plan.pairs):
        ti, tj = _pair(q, plan.tiles)
        diag = ti == tj
        i0, j0 = ti * T, tj * T
        items = [(si, sj) for si in range(4) for sj in range(4)
                 if not (i0 + 32 * si >= d or j0 + 32 * sj >= d or (diag and si > sj))]
        assert 1 <= len(items) <= 16
        split = 4 if 4 * len(items) <= 16 else (2 if 2 * len(items) <= 16 else 1)
        assert len(items) * split <= warps
        r = np.arange(32)
        ii, jj = [], []
        for si, sj in items:
            i = np.repeat(i0 + 32 * si + r, 32)
            j = np.tile(j0 + 32 * sj + r, 32)
            keep = (i < d) & (j < d) & (i <= j)
            ii.append(i[keep])
            jj.append(j[keep])
        if diag:
            subs = [li for li in range(warps - len(items) * split) if li < 4 and i0 + 32 * li < d]
            assert len(subs) == min(4, -(-(d - i0) // 32))  # every sub-block has its warp
            for li in subs:
                i = i0 + 32 * li + r
                ii.append(i[i < d])
                jj.append(np.full((i < d).sum(), d))
            if ti == 0:
                ii.append(np.array([d]))
                jj.append(np.array([d]))
        yield (ti, tj), np.concatenate(ii), np.concatenate(jj), split


def _blocks(plan):
    return _wide_blocks(plan) if plan.tensor_cores else _narrow_blocks(plan)


def _check_rows(n, plan):
    assert plan.chunk_rows % plan.rows == 0 and plan.chunk_rows >= plan.rows
    assert (plan.chunks - 1) * plan.chunk_rows < n <= plan.chunks * plan.chunk_rows
    assert 1 <= plan.chunks <= 65535
    starts = np.arange(plan.chunks) * plan.chunk_rows
    assert starts[0] == 0 and (np.minimum(starts + plan.chunk_rows, n) - starts).min() >= 1


def _check_shape(n, d, mode):
    plan = K.gram_plan(n, d, mode)
    D = d + (mode == "centered")
    assert plan.D == D and plan.cells == D * (D + 1) // 2
    assert plan.entry == ("narrow" if D <= K.GRAM_NARROW_MAX else "wide")
    assert plan.tensor_cores == (mode == "centered" and D > K.GRAM_NARROW_MAX)
    assert plan.tiles == -(-(d if plan.tensor_cores else D) // plan.tile)
    assert plan.pairs == plan.tiles * (plan.tiles + 1) // 2
    if plan.entry == "narrow":
        assert plan.tiles == 1
    _check_rows(n, plan)
    # the partials: the wrapper's buffer holds chunks x cells doubles
    assert plan.partial_bytes == plan.chunks * plan.cells * 8
    assert plan.partial_bytes <= max(K._GRAM_PARTIAL_BYTES, plan.cells * 8)
    assert plan.smem_bytes <= SMEM_BLOCK_BYTES
    assert 32 <= plan.threads <= (K._WIDE_THREADS if plan.tensor_cores else K._NARROW_THREADS)
    assert plan.threads % 32 == 0
    lanes = plan.lanes
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= min(32, plan.chunks)
    return plan


@pytest.mark.parametrize("mode", K.GRAM_MODES)
@pytest.mark.parametrize("d", WIDTHS)
def test_gram_plan_covers_every_cell_once(mode, d):
    D = d + (mode == "centered")
    seen = np.zeros((D, D), np.int32)
    for n in ROWS:
        plan = _check_shape(n, d, mode)
    # the cells of one chunk's blocks: the upper triangle once, nothing below
    for _, i, j, _ in _blocks(plan):
        np.add.at(seen, (i, j), 1)
    assert np.array_equal(seen, np.triu(np.ones((D, D), np.int32)))
    # the partial's offsets stay inside a chunk's cells
    q = _tri_offset(np.arange(D)[:, None], D) + (np.arange(D)[None] - np.arange(D)[:, None])
    assert np.array_equal(np.sort(q[np.triu_indices(D)]), np.arange(plan.cells))


@pytest.mark.parametrize("D", [1, 2, 25, 64, 65, 513, 1025])
def test_gram_finish_decodes_every_cell(D):
    """gram_finish's closed-form row of packed cell q (then corrected), as
    the kernel computes it in float64."""
    q = np.arange(D * (D + 1) // 2, dtype=np.int64)
    b = 2.0 * D + 1.0
    i = np.maximum(np.floor((b - np.sqrt(b * b - 8.0 * q)) / 2.0).astype(np.int64), 0)
    for _ in range(2):
        i = np.where((i > 0) & (_tri_offset(i, D) > q), i - 1, i)
        i = np.where((i + 1 < D) & (_tri_offset(i + 1, D) <= q), i + 1, i)
    j = i + (q - _tri_offset(i, D))
    assert (i <= j).all() and (j < D).all()
    assert np.array_equal(_tri_offset(i, D) + (j - i), q)


@pytest.mark.parametrize("mode,d,narrow", [("corr", 64, True), ("corr", 65, False),
                                           ("centered", 63, True), ("centered", 64, False)])
def test_gram_plan_switches_entry_at_64_columns(mode, d, narrow):
    plan = K.gram_plan(4096, d, mode)
    assert (plan.entry == "narrow") == narrow
    assert plan.tensor_cores == (not narrow and mode == "centered")


@pytest.mark.parametrize("n,d,mode,want", [
    (100000, 23, "corr", (1, 261, 384, 32)),            # the stock train's checker sample
    (1 << 18, 24, "centered", (1, 256, 1024, 32)),      # the scale train's chunk
    (1 << 18, 512, "centered", (10, 106, 2496, 1)),     # 2^18 x 513 on the tensor cores
])
def test_gram_plan_main_path_shapes(n, d, mode, want):
    plan = K.gram_plan(n, d, mode)
    assert (plan.pairs, plan.chunks, plan.chunk_rows, plan.lanes) == want
    # one or two waves of the CUDA-core pass's blocks (two an SM), eight of
    # the tensor-core pass's (one an SM)
    blocks = plan.pairs * plan.chunks
    target = K._WIDE_TARGET_BLOCKS if plan.tensor_cores else K._NARROW_TARGET_BLOCKS
    assert 0.9 * target <= blocks <= target + plan.pairs


@settings(max_examples=60, deadline=None, derandomize=True)
@given(n=st.integers(1, (1 << 18) + 4096), d=st.integers(1, 1024),
       mode=st.sampled_from(K.GRAM_MODES))
def test_gram_plan_holds_at_any_shape(n, d, mode):
    plan = _check_shape(n, d, mode)
    count = sum(len(i) for _, i, _, _ in _blocks(plan))
    assert count == plan.cells


def _finish(partials, lanes):
    """gram_finish's order: lane l adds chunks l, l + lanes, ... in order,
    then the shuffle tree (lane l takes lane l + off, off = lanes / 2 .. 1)."""
    chunks = partials.shape[0]
    s = [partials[lane].copy() if lane < chunks else np.zeros_like(partials[0])
         for lane in range(lanes)]
    for lane in range(lanes):
        for c in range(lane + lanes, chunks, lanes):
            s[lane] = s[lane] + partials[c]
    off = lanes // 2
    while off:
        s = [s[lane] + s[lane + off] if lane + off < lanes else s[lane] for lane in range(lanes)]
        off //= 2
    return s[0]


def _chunk_sums(Z, plan, f32):
    """The planned order of one chunk's sums, each cell of the packed
    triangle: per row tile, each split's rows summed (in float32 for
    corr_gram, sequentially), added into float64, the splits in order."""
    D = plan.D
    iu = np.triu_indices(D)
    out = []
    for c in range(plan.chunks):
        rows = Z[c * plan.chunk_rows:(c + 1) * plan.chunk_rows]
        acc = np.zeros(plan.cells)
        if plan.tensor_cores:  # mma.sync's own order: any float64 order
            out.append((rows.T @ rows)[iu])
            continue
        split_acc = {}
        for blk, i, j, splits in _blocks(plan):
            rs = -(-plan.rows // splits)
            q = _tri_offset(i, D) + (j - i)
            parts = np.zeros((splits, len(i)))
            for t0 in range(0, len(rows), plan.rows):
                tile = rows[t0:t0 + plan.rows]
                for sp in range(splits):
                    seg = tile[sp * rs:(sp + 1) * rs]
                    if not len(seg):
                        continue
                    prod = seg[:, i] * seg[:, j]
                    tot = np.cumsum(prod, axis=0, dtype=np.float32)[-1] if f32 else prod.sum(0)
                    parts[sp] += tot.astype(np.float64)
            split_acc[blk] = (q, parts)
        for q, parts in split_acc.values():
            s = parts[0].copy()
            for sp in range(1, len(parts)):
                s = s + parts[sp]
            acc[q] = s
        out.append(acc)
    return np.stack(out)


def _unpack(packed, D):
    G = np.zeros((D, D))
    G[np.triu_indices(D)] = packed
    return G + np.triu(G, 1).T


def _row_gap(got, want):
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1e-300)
    return float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("n,d", [(1, 1), (3001, 24), (1000, 63), (700, 64), (300, 100)])
def test_centered_gram_planned_order_matches_plain(n, d):
    rng = np.random.default_rng(n + d)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.1, 30, d) + rng.uniform(-100, 100, d))
    X = X.astype(np.float32)
    X[:, -1] = 2.5
    y = (X[:, 0] + rng.normal(size=n)).astype(np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    centers = K.chunk_moments_plain(Xt, yt, "chan")[0]
    want = K.centered_gram_plain(Xt, yt, centers).numpy()
    plan = K.gram_plan(n, d, "centered")
    Z = np.concatenate([X, y[:, None]], 1).astype(np.float64) - centers.numpy()
    got = _unpack(_finish(_chunk_sums(Z, plan, f32=False), plan.lanes), d + 1)
    assert _row_gap(got, want) <= STREAM_RTOL
    assert np.array_equal(got, got.T)
    assert (got[d - 1] == 0).all()  # the constant column centers to 0


@pytest.mark.parametrize("n,d", [(1, 3), (257, 16), (3001, 23), (1500, 64), (600, 85)])
def test_corr_gram_planned_order_matches_plain(n, d):
    Z = np.random.default_rng(n * d).normal(size=(n, d)).astype(np.float32)
    want = K.corr_gram_plain(torch.from_numpy(Z)).numpy()
    plan = K.gram_plan(n, d, "corr")
    total = _unpack(_finish(_chunk_sums(Z, plan, f32=True), plan.lanes), d)
    got = (total.astype(np.float32) / np.float32(max(n - 1, 1))).astype(np.float32)
    assert float(np.abs(got - want).max()) <= STATS_GRAM_ATOL
    assert np.array_equal(got, got.T)
