"""Triton kernel K-M (forest_leaf_mean): the forest sweep's leaf read.

Imported only by the launching wrapper ``ops/trees.py::forest_leaf_mean``,
on a host with Triton and a CUDA card; no other module imports it.

Replaces the leaf read and tree mean of the JAX package's fused sweep
(``transmogrifai_tpu/ops/sweep.py:253-264``: ``take_along_axis(leaf_val,
row_node)`` then the mean over each (fold, candidate)'s trees): for each
group g, row i and leaf channel ch (one for binary and regression forests,
one per class for the multiclass forests' class distributions), the mean
over t of ``leaf[g, t, row_node[g, t, i], ch]``, summed in the order XLA's
CPU reduction takes (windows of 32 trees, each in tree order, then the
windows in order; ``ops/trees.py::MEAN_WINDOW``; the same per channel) and
multiplied by float32(1 / T), so the scores repeat the reference's bit for
bit and tied forest scores stay tied.  A program takes a block of the
flattened (row, channel) outputs.
It is a gather followed by a reduction over the tree axis with no reuse:
each row's node ids are read once, in coalesced blocks along the rows,
and the gathered leaf values (a few KB a tree) stay in L1/L2.  Neither
shared-memory staging nor tensor cores help such a pass, and Triton's
masked block loads express it directly, so it is written in Triton.
Bound on the card: bytes (``row_node`` read once, the output written
once; the leaf pools are small).
"""
import triton
import triton.language as tl


@triton.jit
def _mul(a, b):
    return tl.inline_asm_elementwise("mul.rn.f32 $0, $1, $2;", "=r,r,r", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def forest_leaf_mean_kernel(leaf_ptr, node_ptr, out_ptr, n, c, T, P, W, lo, inv_t,
                            WINDOW: tl.constexpr, BLOCK: tl.constexpr):
    g = tl.program_id(1).to(tl.int64)
    e = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)  # row * c + channel
    ok = e < n * c
    r = e // c
    ch = e % c
    total = tl.zeros([BLOCK], tl.float32)
    for w in range(0, W):
        t0 = tl.maximum(w * WINDOW - lo, 0)
        t1 = tl.minimum((w + 1) * WINDOW - lo, T)
        part = tl.zeros([BLOCK], tl.float32)
        for t in range(t0, t1):
            gt = g * T + t
            node = tl.load(node_ptr + gt * n + r, mask=ok, other=0)
            part += tl.load(leaf_ptr + (gt * P + node) * c + ch, mask=ok, other=0.0)
        total += part
    tl.store(out_ptr + g * n * c + e, _mul(total, tl.zeros([BLOCK], tl.float32) + inv_t),
             mask=ok)
