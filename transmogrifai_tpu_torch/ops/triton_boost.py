"""Triton kernels K-H (boost_step) and K-R (softmax_boost_step): the
boosting round's elementwise pass.

Imported only by the launching wrappers ``ops/trees.py::boost_step`` and
``::softmax_boost_step``, on a host with Triton and a CUDA card; no other
module imports it.

Replaces the margin update and ``_grad_hess`` of the JAX package
(``transmogrifai_tpu/ops/trees.py:1117-1129``, ``:1206``).  K-H: for each
(tree t, row r), ``F += eta[t] * leaf[t, row_node[t, r]]`` (one gather),
then with ``LOSS`` 0 (logistic) ``p = 1 / (1 + exp(-F))``, ``g = (p - y) w``
and ``h = max(p (1 - p), 1e-6) w``, with ``LOSS`` 1 (squared) ``g = (F - y)
w`` and ``h = w``.  K-R (``LOSS`` 2, k <= 8 class margins a row): the
update on each channel, then the row's max, ``e = exp(F - max)``, their sum
in channel order, ``p = e / sum``, the k gradients ``(p_j - [y == j]) w``
and one scalar hessian ``max(mean_j p_j (1 - p_j), 1e-6) w``, its channel
sum in channel order with fused multiply-adds and the mean a product by
float32(1 / k), as XLA's CPU code computes the reference's
``(p * (1 - p)).mean(-1)``; the margin update is one fused multiply-add
(a channel), as XLA contracts the reference's, but for the squared loss,
which rounds the product and the sum apart (see ``ops/trees.py::boost_step``).
Each is one
pass over [T, n] (K-R: a [rows,
k] tile and a reduction over its k channels) with no reuse, which shared
memory and tensor cores cannot speed up and Triton's masked block loads
and reductions express directly; so both are written in Triton, as K-C and
K-D are.  Every product, sum and quotient is a round-to-nearest PTX
instruction (no FMA contraction except the logistic and softmax margin
updates and K-R's hessian sum, where the reference contracts), as the plain
versions round them; ``exp`` is
libdevice's ``expf``, which may differ from the reference's in the last
bit.  Bound on the card: bytes (F read and written, y, w and the row's node
read, one leaf row gathered, the gradients and hessian written).
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
def _softmax_step(F_ptr, y_ptr, w_ptr, eta_ptr, leaf_ptr, node_ptr, ghw_ptr, n, P, inv_k,
                  UPDATE: tl.constexpr, GRAD: tl.constexpr, K: tl.constexpr, KP: tl.constexpr,
                  BLOCK: tl.constexpr):
    t = tl.program_id(1)
    r = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    ok = r < n
    i = t.to(tl.int64) * n + r
    cols = tl.arange(0, KP)[None, :]
    okc = ok[:, None] & (cols < K)
    f = tl.load(F_ptr + i[:, None] * K + cols, mask=okc, other=0.0)
    if UPDATE:
        eta = tl.zeros([BLOCK, KP], tl.float32) + tl.load(eta_ptr + t)
        node = tl.load(node_ptr + i, mask=ok, other=0)
        lv = tl.load(leaf_ptr + (t.to(tl.int64) * P + node)[:, None] * K + cols, mask=okc,
                     other=0.0)
        f = _fma(eta, lv, f)
        tl.store(F_ptr + i[:, None] * K + cols, f, mask=okc)
    if GRAD:
        one = tl.full([BLOCK, KP], 1.0, tl.float32)
        fm = tl.where(okc, f, float("-inf"))
        mx = tl.max(fm, axis=1)
        e = tl.where(okc, libdevice.exp(_sub(f, mx[:, None] + tl.zeros([BLOCK, KP], tl.float32))),
                     0.0)
        s = _column(e, cols, 0)
        for j in tl.static_range(1, K):
            s = _add(s, _column(e, cols, j))
        p = _div(e, s[:, None] + tl.zeros([BLOCK, KP], tl.float32))
        y = tl.load(y_ptr + r, mask=ok, other=0.0).to(tl.int32)
        w = tl.load(w_ptr + i, mask=ok, other=0.0)
        onehot = tl.where(cols == y[:, None], 1.0, 0.0)
        g = _mul(_sub(p, onehot), w[:, None] + tl.zeros([BLOCK, KP], tl.float32))
        tl.store(ghw_ptr + i[:, None] * (K + 1) + cols, g, mask=okc)
        q = _sub(one, p)
        h = _mul(_column(p, cols, 0), _column(q, cols, 0))
        for j in tl.static_range(1, K):
            h = _fma(_column(p, cols, j), _column(q, cols, j), h)
        h = _mul(tl.maximum(_mul(h, tl.zeros([BLOCK], tl.float32) + inv_k), 1e-6), w)
        tl.store(ghw_ptr + i * (K + 1) + K, h, mask=ok)


@triton.jit
def boost_step_kernel(F_ptr, y_ptr, w_ptr, eta_ptr, leaf_ptr, node_ptr, ghw_ptr, n, P, inv_k,
                      UPDATE: tl.constexpr, GRAD: tl.constexpr, LOSS: tl.constexpr,
                      K: tl.constexpr, KP: tl.constexpr, BLOCK: tl.constexpr):
    if LOSS == 2:
        _softmax_step(F_ptr, y_ptr, w_ptr, eta_ptr, leaf_ptr, node_ptr, ghw_ptr, n, P, inv_k,
                      UPDATE, GRAD, K, KP, BLOCK)
    else:
        _binary_step(F_ptr, y_ptr, w_ptr, eta_ptr, leaf_ptr, node_ptr, ghw_ptr, n, P,
                     UPDATE, GRAD, LOSS, BLOCK)


@triton.jit
def _binary_step(F_ptr, y_ptr, w_ptr, eta_ptr, leaf_ptr, node_ptr, ghw_ptr, n, P,
                 UPDATE: tl.constexpr, GRAD: tl.constexpr, LOSS: tl.constexpr,
                 BLOCK: tl.constexpr):
    t = tl.program_id(1)
    r = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    ok = r < n
    i = t.to(tl.int64) * n + r
    f = tl.load(F_ptr + i, mask=ok, other=0.0)
    one = tl.full([BLOCK], 1.0, tl.float32)
    if UPDATE:
        eta = tl.zeros([BLOCK], tl.float32) + tl.load(eta_ptr + t)
        node = tl.load(node_ptr + i, mask=ok, other=0)
        lv = tl.load(leaf_ptr + t.to(tl.int64) * P + node, mask=ok, other=0.0)
        if LOSS == 1:
            f = _add(f, _mul(eta, lv))
        else:
            f = _fma(eta, lv, f)
        tl.store(F_ptr + i, f, mask=ok)
    if GRAD:
        y = tl.load(y_ptr + r, mask=ok, other=0.0)
        w = tl.load(w_ptr + i, mask=ok, other=0.0)
        if LOSS == 1:
            g = _mul(_sub(f, y), w)
            h = w
        else:
            p = _div(one, _add(one, libdevice.exp(-f)))
            g = _mul(_sub(p, y), w)
            h = _mul(tl.maximum(_mul(p, _sub(one, p)), 1e-6), w)
        tl.store(ghw_ptr + 2 * i, g, mask=ok)
        tl.store(ghw_ptr + 2 * i + 1, h, mask=ok)
