"""Triton kernel K-H (boost_step): the boosting round's elementwise pass.

Imported only by the launching wrapper ``ops/trees.py::boost_step``, on a
host with Triton and a CUDA card; no other module imports it.

Replaces the margin update and the logistic and squared ``_grad_hess`` of
the JAX package (``transmogrifai_tpu/ops/trees.py:1117-1128``, ``:1206``):
for each (tree t, row r), ``F += eta[t] * leaf[t, row_node[t, r]]`` (one
gather), then with ``LOSS`` 0 (logistic) ``p = 1 / (1 + exp(-F))``,
``g = (p - y) w`` and ``h = max(p (1 - p), 1e-6) w``, with ``LOSS`` 1
(squared) ``g = (F - y) w`` and ``h = w``.  It is one pass over [T, n] with no reuse,
which shared memory and tensor cores cannot speed up and Triton's masked
block loads express directly; so it is written in Triton, as K-C and K-D
are.  Every product, sum and quotient is a round-to-nearest PTX
instruction (no FMA contraction), as the plain version rounds them; ``exp``
is libdevice's ``expf``.  Bound on the card: bytes (F read and written, y,
w and the row's node read, one leaf gathered, g and h written).
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
def boost_step_kernel(F_ptr, y_ptr, w_ptr, eta_ptr, leaf_ptr, node_ptr, ghw_ptr, n, P,
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
        f = _add(f, _mul(eta, lv))
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

