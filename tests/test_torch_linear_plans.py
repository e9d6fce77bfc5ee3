"""The launch plans of K-S's wide entry, K-P's tiled entry and the wide
entries of K-P (k <= 8) and K-T, on the CPU.

``ops/linear.py``'s ``gram_wide_plan``, ``softmax_tiled_plan`` and
``wide_rows_plan`` choose each launch's fit groups, tiles, row chunks, shared
bytes and partial bytes; the kernels (``csrc/weighted_gram.cu``,
``csrc/fista.cu``, ``csrc/wide_rows.cuh``) take them as they are.  These
tests replay the blocks' coverage as the kernels write it: every output
entry of every fit exactly once, every row in one chunk, a block's shared
memory within the H100's 232,448 bytes and the float64 partials within their
budget, over p 65-1,024, C 1-64 and k 1-128.
"""
import numpy as np
import pytest

from transmogrifai_tpu_torch.ops import linear as L

FITS = (1, 2, 3, 4, 5, 7, 12, 24, 33, 64)
ROWS = (1, 31, 4096, 58983, 1 << 17)


def _rows_once(n, chunk_rows, chunks, unit):
    assert chunk_rows % unit == 0 and chunk_rows >= unit
    assert (chunks - 1) * chunk_rows < n <= chunks * chunk_rows


def _fits_once(C, fits, groups):
    owner = np.arange(C) // fits
    assert owner.max() == groups - 1
    assert np.bincount(owner, minlength=groups).min() >= 1


@pytest.mark.parametrize("p", [65, 85, 96, 97, 127, 128, 129, 300, 511, 513, 777, 1024])
def test_gram_wide_plan_covers_every_entry_once(p):
    T = L._GRAM_WIDE_TILE
    for C in FITS:
        for n in ROWS:
            plan = L.gram_wide_plan(n, p, C)
            assert 1 <= plan.fits <= L._GRAM_WIDE_FITS
            _fits_once(C, plan.fits, plan.groups)
            _rows_once(n, plan.chunk_rows, plan.chunks, L._GRAM_WIDE_SLAB)
            assert plan.chunks <= 65535
            assert plan.smem_bytes <= L.SMEM_BLOCK_BYTES
            E = p * (p + 1) // 2 + p
            assert plan.partial_bytes == plan.chunks * C * E * 8
            assert plan.partial_bytes <= max(L._GRAM_WIDE_PARTIAL_BYTES, C * E * 8)
        # the upper-triangle tile pairs over the p + 1 augmented columns (the
        # moments ride as column p): each block writes its tiles' entries with
        # i < p, i <= j <= p, so every Gram and moment entry comes once
        assert plan.tiles * T >= p + 1 > (plan.tiles - 1) * T
        seen = np.zeros((p, p + 1), np.int32)
        pairs = 0
        for ti in range(plan.tiles):
            for tj in range(ti, plan.tiles):
                pairs += 1
                i = np.arange(ti * T, min(ti * T + T, p))[:, None]
                j = np.arange(tj * T, min(tj * T + T, p + 1))[None, :]
                if i.size and j.size:
                    seen[i, j] += j >= i
        assert pairs == plan.pairs
        want = np.triu(np.ones((p, p + 1), np.int32))
        assert np.array_equal(seen, want)


def test_gram_wide_plan_main_path_shapes():
    # the text flow's p = 85 over 12 fits, and p = 513: three groups of four
    # fits; 3 and 45 tile pairs; about four waves of blocks
    a = L.gram_wide_plan(1 << 17, 85, 12)
    b = L.gram_wide_plan(1 << 15, 513, 12)
    assert (a.fits, a.groups, a.pairs) == (4, 3, 3)
    assert (b.fits, b.groups, b.pairs) == (4, 3, 45)
    for plan in (a, b):
        blocks = plan.groups * plan.pairs * plan.chunks
        assert L._GRAM_WIDE_TARGET_BLOCKS <= blocks < 2 * L._GRAM_WIDE_TARGET_BLOCKS


@pytest.mark.parametrize("k", [9, 10, 16, 17, 26, 27, 32, 33, 64, 65, 100, 127, 128])
def test_softmax_tiled_plan_covers_every_output_once(k):
    for p in (1, 3, 9, 33, 64, 65, 85, 97, 129, 300, 513, 777, 1024):
        for C in FITS:
            for n in (1, 999, 58983):
                plan = L.softmax_tiled_plan(n, p, k, C)
                PP = -(-p // 4) * 4
                NP = -(-(plan.fits * k) // 4) * 4
                _fits_once(C, plan.fits, plan.groups)
                _rows_once(n, plan.chunk_rows, plan.chunks, plan.rows)
                assert plan.rows % 4 == 0 and plan.rows <= L._SOFTMAX_TILE_ROWS
                # the output coefficient slabs cover the padded rows once, and a
                # block's outputs fit its threads' micro-tiles
                assert plan.out_rows % 4 == 0
                assert plan.out_slabs * plan.out_rows >= PP > (plan.out_slabs - 1) * plan.out_rows
                assert plan.out_rows * NP <= L._SOFTMAX_BLOCK_OUTPUTS
                zrows = p if plan.z_resident else L._SOFTMAX_MARGIN_BLOCK
                assert plan.smem_bytes == 4 * (2 * plan.rows * PP + zrows * NP + plan.rows * NP
                                               + 2 * (plan.fits + 1) * plan.rows)
                assert plan.smem_bytes <= L.SMEM_BLOCK_BYTES
                assert plan.partial_bytes == plan.chunks * C * p * k * 8
                assert plan.partial_bytes <= L._WIDE_PARTIAL_BYTES
                assert plan.groups <= 65535 and plan.out_slabs <= 65535


@pytest.mark.parametrize("n,p,k,C,fits,resident", [
    (58983, 33, 26, 24, 8, True),      # the Letter stock train's sweep
    (29496, 33, 64, 24, 3, True),      # the 64-class train's
    (1 << 17, 85, 26, 12, 3, True),    # chip_smoke.py's p = 85 record
    (700, 1024, 128, 2, 1, False),     # the widest: coefficients streamed
])
def test_softmax_tiled_plan_main_path_shapes(n, p, k, C, fits, resident):
    plan = L.softmax_tiled_plan(n, p, k, C)
    assert (plan.fits, plan.z_resident) == (fits, resident)
    # the fit groups share each staged row tile: X1 is read once a group
    assert plan.groups == -(-C // fits)


WIDE_P = (65, 85, 96, 127, 128, 129, 300, 511, 513, 777, 1024)


def _wide_plan_covers(n, p, k, C):
    plan = L.wide_rows_plan(n, p, k, C)
    MR = plan.tile_rows
    PP = -(-p // MR) * MR
    NP = -(-(plan.fits * k) // 4) * 4
    MC = (PP // MR) * (NP // 4)
    R, S, T = plan.rows, plan.splits, plan.threads
    _fits_once(C, plan.fits, plan.groups)
    _rows_once(n, plan.chunk_rows, plan.chunks, R)
    assert plan.groups <= 65535 and plan.chunks < 2 ** 31
    assert R in L._WIDE_TILE_ROWS and R % MR == 0
    assert MR in L._WIDE_THREADS and T % 32 == 0 and T <= L._WIDE_THREADS[MR]
    # a thread's output micro-tiles (items tid, tid + T, ...: 32 float64 sums)
    # take every (micro-tile, split) item of the group
    Q = L._WIDE_OUTPUTS // (MR * 4)
    items = (np.arange(T)[:, None] + T * np.arange(Q)[None]).ravel()
    items = items[items < MC * S]
    assert 1 <= S <= R // 4 and MC * S <= Q * T
    assert np.array_equal(np.sort(items), np.arange(MC * S))
    # the splits cover a tile's rows once
    RS = -(-R // S)
    rows = np.concatenate([np.arange(s * RS, min(s * RS + RS, R)) for s in range(S)])
    assert np.array_equal(rows, np.arange(R))
    # the micro-tiles cover the group's outputs [p x G k] once: the written
    # entries (a < p, column < the group's fits x k) map to every coefficient
    # of every (fit, class) of the group once
    e = np.arange(MR * 4)[None]
    a = (np.arange(MC) // (NP // 4))[:, None] * MR + e // 4
    col = (np.arange(MC) % (NP // 4))[:, None] * 4 + e % 4
    for c0 in range(0, C, plan.fits):
        N = min(plan.fits, C - c0) * k
        keep = (a < p) & (col < N)
        key = (c0 + col[keep] // k) * p * k + a[keep] * k + col[keep] % k
        assert np.array_equal(np.sort(key), np.arange(c0 * p * k, (c0 + N // k) * p * k))
    # a tile's staged rows (each group of MR rows skewed 4 floats further into
    # the banks) stay float4-aligned, apart and inside the tile
    start = np.arange(R) * (-(-PP // 32) * 32) + 4 * (np.arange(R) // MR)
    assert (start % 4 == 0).all() and (np.diff(start) >= PP).all()
    assert start[-1] + PP <= L.wide_tile_floats(p, MR, R)
    # the margins' 32-coefficient blocks cover the padded coefficients once,
    # each a whole number of float4 steps
    nb = -(-p // L._SOFTMAX_MARGIN_BLOCK)
    span = [min(L._SOFTMAX_MARGIN_BLOCK, PP - b * L._SOFTMAX_MARGIN_BLOCK) for b in range(nb)]
    assert all(s % 4 == 0 and s > 0 for s in span) and sum(span) == PP
    assert plan.smem_bytes == L.wide_rows_smem(p, k, plan.fits, R, MR)
    assert plan.smem_bytes + L._WIDE_STATIC_BYTES <= L.SMEM_BLOCK_BYTES
    assert plan.fits <= L._WIDE_MAX_FITS
    # the chunk's float64 partial of the group reuses the block's shared memory
    assert plan.smem_bytes >= 8 * PP * NP
    assert plan.partial_bytes == plan.chunks * C * p * k * 8
    assert plan.partial_bytes <= max(L._WIDE_PARTIAL_BYTES, C * p * k * 8)
    return plan


@pytest.mark.parametrize("p", WIDE_P)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8])
def test_wide_rows_plan_covers_every_output_once(p, k):
    # k = 1 is K-T's (the hinge), 2-8 K-P's
    for C in FITS:
        for n in ROWS:
            _wide_plan_covers(n, p, k, C)


@pytest.mark.parametrize("n,p,k,C", [
    (1 << 17, 85, 3, 6),       # fit_softmax_grid_folds on phase 41's 2^17 x 84 frame
    (1 << 17, 85, 8, 2),       # phase 42's eight classes
    (1 << 15, 513, 3, 6),
    (1 << 15, 513, 8, 2),
    (1 << 17, 85, 1, 12),      # the text flow's SVC grid: 3 folds x 4
    (1 << 15, 513, 1, 12),
])
def test_wide_rows_plan_main_path_shapes(n, p, k, C):
    plan = _wide_plan_covers(n, p, k, C)
    # one fit group: every staged row tile serves every fit, X1 read once
    assert (plan.fits, plan.groups) == (C, 1)
    # about one wave of blocks (two an SM at 256 threads), a few MB of partials
    per_sm = 2 if plan.tile_rows == 4 else 1
    assert per_sm * L._SMS // 2 < plan.chunks <= per_sm * L._SMS
    assert plan.partial_bytes <= 16 << 20
