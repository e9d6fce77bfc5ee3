"""The launch plans of K-S's wide entry and K-P's tiled entry, on the CPU.

``ops/linear.py``'s ``gram_wide_plan`` and ``softmax_tiled_plan`` choose each
launch's fit groups, tiles, row chunks, shared bytes and partial bytes; the
kernels (``csrc/weighted_gram.cu``, ``csrc/fista.cu``) take them as they are.
These tests replay the blocks' coverage as the kernels write it: every
output entry of every fit exactly once, every row in one chunk, a block's
shared memory within the H100's 232,448 bytes and the float64 partials within
their budget, over p 65-1,024, C 1-64 and k 9-128.
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
