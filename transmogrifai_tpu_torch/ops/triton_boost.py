"""Triton kernel ``collapse_step_kernel``: K-H (``ops/trees.py::boost_step``,
the logistic and squared losses) and K-R (``::softmax_boost_step``, the
softmax over k <= 128 class margins), the boosting step's elementwise pass
for K >= 1 trees a batch element.

Imported only by the launching wrappers' ``ops/trees.py::_collapse_launch``,
on a host with Triton and a CUDA card; no other module imports it.

Replaces the margin update and ``_grad_hess`` of the JAX package
(``transmogrifai_tpu/ops/trees.py:1117-1129``, ``:1206``) and its
round-collapsed update and gradients (``:1168-1185``, ``:1301-1330``): for
batch element b and row r, the K leaves of trees bK .. bK + K - 1 are
summed in the order XLA's CPU code reduces the reference's ``leaves.sum``
over K (pairwise halving, leaf k with leaf k + K / 2, when K is a power of
two; in tree order otherwise), scaled by ``eta_b * float32(1 / K)`` (XLA's
product with the reciprocal for the reference's ``eta / K``; eta itself at
K = 1) and added to each margin channel in one fused multiply-add (for
every loss: XLA's CPU code contracts the reference's update so).  Then the
gradients at the new margins are formed once: ``LOSS`` 0 (logistic) ``p =
1 / (1 + exp(-F))``, ``g = p - y``, ``h = max(p (1 - p), 1e-6)``; ``LOSS`` 1
(squared) ``g = F - y``, ``h = 1``; ``LOSS`` 2 (softmax) the row's max, ``e
= exp(F - max)``, their sum in channel order, ``p = e / sum``, the k
gradients ``p_j - [y == j]`` and one scalar hessian ``max(mean_j p_j (1 -
p_j), 1e-6)``, its channel sum in channel order with fused multiply-adds
(past 32 channels in XLA's windows of 32: ``_hess_sum``) and the mean a
product by float32(1 / k), as XLA's CPU code computes the reference's ``(p
* (1 - p)).mean(-1)``.  They are written as K weighted planes, tree bK + k
with weights ``w[b] * rw[k]`` (the product formed first, as the
reference's ``w_batch[:, None, :] * rwk[None]`` and as the K = 1 round's
``w * row_w``), so one launch a step feeds the grower's B * K trees.

For a power of two K the K leaf rows are loaded as one tile and halved in
registers; where K times the padded class count would make that tile too
large, the update walks class slabs of ``CS`` channels (each slab's K
leaves halved alike: the halving is per channel) and the gradients reload
the updated margins after a block barrier.  Each launch is one pass over
[B, n] with no reuse, which shared memory and tensor cores cannot speed up
and Triton's masked block loads and reductions express directly; so it is
written in Triton, as K-C and K-D are.  Every product, sum and quotient is
a round-to-nearest PTX instruction (no FMA contraction except the margin
update and the softmax hessian's sum, where the reference contracts), as
the plain versions round them; ``exp`` is libdevice's ``expf``, which may
differ from the reference's in the last bit.  Bound on the card: bytes (F
read and written, the K nodes read, the leaf pools once, y, w and the K
subsample rows read, K gradient planes written).
"""
import triton
import triton.language as tl

try:  # the libdevice module moved between Triton releases
    from triton.language.extra import libdevice
except ImportError:  # pragma: no cover - older Triton
    from triton.language.extra.cuda import libdevice


@triton.jit
def _mul(a, b):
    return tl.inline_asm_elementwise("mul.rn.f32 $0, $1, $2;", "=r,r,r", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _add(a, b):
    return tl.inline_asm_elementwise("add.rn.f32 $0, $1, $2;", "=r,r,r", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _sub(a, b):
    return tl.inline_asm_elementwise("sub.rn.f32 $0, $1, $2;", "=r,r,r", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _div(a, b):
    return tl.inline_asm_elementwise("div.rn.f32 $0, $1, $2;", "=r,r,r", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _fma(a, b, c):
    return tl.inline_asm_elementwise("fma.rn.f32 $0, $1, $2, $3;", "=r,r,r,r", [a, b, c],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _column(x, cols, j):
    """Column j of a [BLOCK, KP] tile (a sum with zeros: exact)."""
    return tl.sum(tl.where(cols == j, x, 0.0), axis=1)


@triton.jit
def _hess_sum(p, q, cols, K: tl.constexpr, BLOCK: tl.constexpr):
    """sum_j p_j q_j over the K channels of [BLOCK, KP] tiles, as XLA's CPU
    code sums the reference's class mean (``ops/trees.py::softmax_hessian``):
    up to 32 channels the first product rounded and fused multiply-adds in
    channel order (unrolled up to 8); past 32 the rounded products summed in
    XLA's windows of 32 (the padding to a multiple of 32 split, the lower
    half in front), each in channel order, and the windows' sums in order
    (the sums of non-negative terms start from +0, which adds exactly)."""
    if K <= 8:
        h = _mul(_column(p, cols, 0), _column(q, cols, 0))
        for j in tl.static_range(1, K):
            h = _fma(_column(p, cols, j), _column(q, cols, j), h)
    elif K <= 32:
        h = _mul(_column(p, cols, 0), _column(q, cols, 0))
        for j in range(1, K):
            h = _fma(_column(p, cols, j), _column(q, cols, j), h)
    else:
        r = _mul(p, q)
        lo = ((K + 31) // 32 * 32 - K) // 2
        zero = tl.zeros([BLOCK], tl.float32)
        h = zero
        s = zero
        for j in range(0, K):
            edge = ((j + lo) % 32 == 0) & (j > 0)
            h = tl.where(edge, _add(h, s), h)
            s = _add(tl.where(edge, zero, s), _column(r, cols, j))
        h = _add(h, s)
    return h


# ---------------------------------------------------------------------------
# The boosting step: K trees a batch element (K = 1 a plain round, K > 1
# round-collapsed boosting)
# ---------------------------------------------------------------------------
@triton.jit
def _leaf_sum(leaf_ptr, node_ptr, t0, r, ok, n, P, C, c0, cols, okc, KT: tl.constexpr,
              HALVINGS: tl.constexpr, CP: tl.constexpr, BLOCK: tl.constexpr):
    """Sum of the [BLOCK, CP] leaf rows (channels c0 .. c0 + CP - 1; ``cols``
    and ``okc`` already offset by c0) of trees t0 .. t0 + KT - 1 at rows r
    in XLA's order.  KT a power of two (2^HALVINGS): the KT leaf rows as one
    [BLOCK, KT CP] tile (tree k's channel c0 + c in column k CP + c), halved
    HALVINGS times, each column of the first half plus the same column of
    the second (one rounded add); in tree order otherwise."""
    if (KT & (KT - 1)) == 0:
        m = tl.arange(0, KT * CP)[None, :]
        t = t0 + m // CP
        c = c0 + m % CP
        okm = ok[:, None] & (c < C)
        node = tl.load(node_ptr + t * n + r[:, None], mask=okm, other=0)
        acc = tl.load(leaf_ptr + (t * P + node) * C + c, mask=okm, other=0.0)
        for h in tl.static_range(HALVINGS):
            lo, hi = tl.split(tl.permute(tl.reshape(acc, [BLOCK, 2, (KT * CP) >> (h + 1)]),
                                         [0, 2, 1]))
            acc = _add(lo, hi)
    else:
        node = tl.load(node_ptr + t0 * n + r, mask=ok, other=0)
        acc = tl.load(leaf_ptr + (t0 * P + node)[:, None] * C + cols, mask=okc, other=0.0)
        for k in tl.static_range(1, KT):
            node = tl.load(node_ptr + (t0 + k) * n + r, mask=ok, other=0)
            acc = _add(acc, tl.load(leaf_ptr + ((t0 + k) * P + node)[:, None] * C + cols,
                                    mask=okc, other=0.0))
    return acc


@triton.jit
def collapse_step_kernel(F_ptr, y_ptr, w_ptr, rw_ptr, eta_ptr, leaf_ptr, node_ptr, ghw_ptr, n, P,
                         inv_trees, inv_c, UPDATE: tl.constexpr, GRAD: tl.constexpr,
                         LOSS: tl.constexpr, KT: tl.constexpr, HALVINGS: tl.constexpr,
                         C: tl.constexpr, CP: tl.constexpr, CS: tl.constexpr,
                         BLOCK: tl.constexpr):
    """One round-collapsed boosting step of batch element b = program_id(1)
    over C margin channels (1 for the logistic and squared losses, the k
    classes of the softmax): the K-leaf update (in class slabs of CS
    channels where CS < CP), then K gradient planes."""
    b = tl.program_id(1)
    r = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    ok = r < n
    i = b.to(tl.int64) * n + r
    cols = tl.arange(0, CP)[None, :]
    okc = ok[:, None] & (cols < C)
    zero = tl.zeros([BLOCK, CP], tl.float32)
    f = tl.load(F_ptr + i[:, None] * C + cols, mask=okc, other=0.0)
    if UPDATE:
        if CS == CP:
            a = _mul(zero + tl.load(eta_ptr + b), zero + inv_trees)
            s = _leaf_sum(leaf_ptr, node_ptr, b.to(tl.int64) * KT, r, ok, n, P, C, 0, cols, okc,
                          KT, HALVINGS, CP, BLOCK)
            f = _fma(a, s, f)
            tl.store(F_ptr + i[:, None] * C + cols, f, mask=okc)
        else:
            zs = tl.zeros([BLOCK, CS], tl.float32)
            a = _mul(zs + tl.load(eta_ptr + b), zs + inv_trees)
            for c0 in range(0, C, CS):
                cs = c0 + tl.arange(0, CS)[None, :]
                oks = ok[:, None] & (cs < C)
                fs = tl.load(F_ptr + i[:, None] * C + cs, mask=oks, other=0.0)
                s = _leaf_sum(leaf_ptr, node_ptr, b.to(tl.int64) * KT, r, ok, n, P, C, c0, cs,
                              oks, KT, HALVINGS, CS, BLOCK)
                tl.store(F_ptr + i[:, None] * C + cs, _fma(a, s, fs), mask=oks)
            tl.debug_barrier()  # the block's stores before its reloads
            f = tl.load(F_ptr + i[:, None] * C + cols, mask=okc, other=0.0)
    if GRAD:
        one = tl.full([BLOCK], 1.0, tl.float32)
        y = tl.load(y_ptr + r, mask=ok, other=0.0)
        w = tl.load(w_ptr + i, mask=ok, other=0.0)
        if LOSS == 2:
            fm = tl.where(okc, f, float("-inf"))
            mx = tl.max(fm, axis=1)
            e = tl.where(okc, libdevice.exp(_sub(f, mx[:, None] + zero)), 0.0)
            se = _column(e, cols, 0)
            if C <= 8:
                for j in tl.static_range(1, C):
                    se = _add(se, _column(e, cols, j))
            else:
                for j in range(1, C):
                    se = _add(se, _column(e, cols, j))
            p = _div(e, se[:, None] + zero)
            onehot = tl.where(cols == y.to(tl.int32)[:, None], 1.0, 0.0)
            g = _sub(p, onehot)
            h = _hess_sum(p, _sub(zero + 1.0, p), cols, C, BLOCK)
            h = tl.maximum(_mul(h, tl.zeros([BLOCK], tl.float32) + inv_c), 1e-6)
        else:
            f0 = _column(f, cols, 0)
            if LOSS == 1:
                g = _sub(f0, y)
            else:
                p = _div(one, _add(one, libdevice.exp(-f0)))
                g = _sub(p, y)
                h = tl.maximum(_mul(p, _sub(one, p)), 1e-6)
        for k in tl.static_range(KT):
            wk = _mul(w, tl.load(rw_ptr + k * n + r, mask=ok, other=0.0))
            j = (b.to(tl.int64) * KT + k) * n + r
            if LOSS == 2:
                tl.store(ghw_ptr + j[:, None] * (C + 1) + cols, _mul(g, wk[:, None] + zero),
                         mask=okc)
                tl.store(ghw_ptr + j * (C + 1) + C, _mul(h, wk), mask=ok)
            else:
                tl.store(ghw_ptr + 2 * j, _mul(g, wk), mask=ok)
                if LOSS == 1:
                    tl.store(ghw_ptr + 2 * j + 1, wk, mask=ok)
                else:
                    tl.store(ghw_ptr + 2 * j + 1, _mul(h, wk), mask=ok)
