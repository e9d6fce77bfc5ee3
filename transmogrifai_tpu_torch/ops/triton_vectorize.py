"""Triton kernels K-C (fill_indicator) and K-D (one_hot_codes).

Imported only by the launching wrappers in ``ops/vectorize.py``, on a host
with Triton and a CUDA card; no other module imports it.

Both kernels tile the output [n, W] by (BLOCK_R rows, BLOCK_C columns) and
write every element once, so the wrapper allocates the output with
``torch.empty``.  Bound on the card: bytes.  K-C reads 4 + 1 bytes per input
value and writes 4 or 8; K-D reads a 4-byte code per input and row and
writes 4 bytes per output column.
"""
import triton
import triton.language as tl


@triton.jit
def fill_indicator_kernel(v_ptr, m_ptr, fill_ptr, out_ptr, n, W,
                          TRACK: tl.constexpr, BLOCK_R: tl.constexpr,
                          BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    rmask = rows < n
    cmask = cols < W
    ok = rmask[:, None] & cmask[None, :]
    if TRACK:
        j = cols // 2
        is_ind = (cols % 2) == 1
    else:
        j = cols
        is_ind = cols < 0
    src = j[None, :].to(tl.int64) * n + rows[:, None].to(tl.int64)
    v = tl.load(v_ptr + src, mask=ok, other=0.0)
    present = tl.load(m_ptr + src, mask=ok, other=0) != 0
    fill = tl.load(fill_ptr + j, mask=cmask, other=0.0)
    val = tl.where(present, v, fill[None, :])
    ind = tl.where(present, 0.0, 1.0)
    res = tl.where(is_ind[None, :], ind, val)
    dst = rows[:, None].to(tl.int64) * W + cols[None, :]
    tl.store(out_ptr + dst, res, mask=ok)


@triton.jit
def one_hot_kernel(codes_ptr, map_ptr, out_ptr, n, W,
                   BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    rmask = rows < n
    cmask = cols < W
    ok = rmask[:, None] & cmask[None, :]
    j = tl.load(map_ptr + cols, mask=cmask, other=0)
    local = tl.load(map_ptr + W + cols, mask=cmask, other=-2)
    src = j[None, :].to(tl.int64) * n + rows[:, None].to(tl.int64)
    code = tl.load(codes_ptr + src, mask=ok, other=-1)
    res = tl.where(code == local[None, :], 1.0, 0.0)
    dst = rows[:, None].to(tl.int64) * W + cols[None, :]
    tl.store(out_ptr + dst, res, mask=ok)
