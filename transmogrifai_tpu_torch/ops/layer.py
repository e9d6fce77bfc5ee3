"""The fused layer's numeric arithmetic and column gathers (K-Z).

Replace the device halves of the JAX package's fused-layer and chunk
programs (``transmogrifai_tpu/workflow/dag.py:100-160``,
``workflow/stream.py:405-440``) that K-C and K-D (``ops/vectorize.py``) do
not:

- ``numeric_op`` — ``_NumericBinaryOp.jax_transform``
  (``impl/feature/transformers.py:76``: a + b, a - b, a * b, a / b of two
  numeric columns) and ``ScalarMathTransformer.jax_transform`` (``:156``:
  a column <op> a scalar), with the reference's presence masks.
- ``column_gather`` — ``VectorsCombiner.jax_transform``
  (``impl/feature/vectorizers.py:457``: the concatenation of vectors,
  ``concat_columns``) and ``SanityCheckerModel.jax_transform``
  (``impl/preparators/sanity_checker.py:507``: the kept columns).

Both are CUDA (``csrc/fused_layer.cu``): a value an operation or a copy,
bound by bytes.  ``numeric_math`` is the backend-generic body of the
arithmetic: the stages' host path runs it on numpy arrays in float64, the
plain version on torch tensors.  The plain PyTorch version of each kernel
sits beside it; a wrapper takes it only for CPU tensors, and for CUDA
tensors launches its kernel or raises.  ``<wrapper>.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..utils.device import on_cuda as _on_cuda
from . import cuda_build
from .trees import _require, _stream

_SIGNATURES = {
    "numeric_op_f32": ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                                 ctypes.c_double, ctypes.c_void_p], ctypes.c_int),
    "column_gather_f32": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
                          ctypes.c_int),
}
#: the operations, in ``csrc/fused_layer.cu``'s order; the first four are
#: also the binary ones
NUMERIC_OPS = ("plus", "minus", "multiply", "divide", "power", "abs", "log", "exp", "sqrt",
               "rminus", "rdivide", "ceil", "floor", "round")
BINARY_OPS = NUMERIC_OPS[:4]
#: sources a column_gather launch takes
MAX_SOURCES = 64


# ---------------------------------------------------------------------------
# K-Z numeric_op
# ---------------------------------------------------------------------------
def numeric_math(xp, op: str, av, am, bv=None, bm=None, scalar: float = 0.0):
    """(values, mask) of ``av <op> bv`` (``bv`` given) or ``av <op> scalar``
    in ``xp`` (numpy or torch): for + and - the present side wins and the
    output is present when either input is; otherwise it is present when
    every input is and the value is finite.  An absent output holds 0."""
    if bv is not None:
        vals = {"plus": lambda: av + bv, "minus": lambda: av - bv,
                "multiply": lambda: av * bv, "divide": lambda: av / bv}[op]()
        if op in ("plus", "minus"):
            only_a = am & ~bm
            only_b = bm & ~am
            vals = xp.where(only_a, av, vals)
            vals = xp.where(only_b, bv if op == "plus" else -bv, vals)
            mask = am | bm
        else:
            mask = am & bm & xp.isfinite(vals)
        return xp.where(mask, vals, 0.0), mask
    v, s = av, float(scalar)
    vals = {
        "plus": lambda: v + s, "minus": lambda: v - s,
        "multiply": lambda: v * s, "divide": lambda: v / s,
        "power": lambda: v ** s, "abs": lambda: xp.abs(v),
        "log": lambda: xp.log(v), "exp": lambda: xp.exp(v),
        "sqrt": lambda: xp.sqrt(v),
        "rminus": lambda: s - v, "rdivide": lambda: s / v,
        "ceil": lambda: xp.ceil(v), "floor": lambda: xp.floor(v),
        # round(digits) scales by 10^digits; HALF-UP like the reference
        # (scala.math.round = floor(x + 0.5)), not banker's rounding
        "round": lambda: xp.floor(v * (10.0 ** s) + 0.5) / (10.0 ** s),
    }[op]()
    mask = am & xp.isfinite(vals)
    return xp.where(mask, vals, 0.0), mask


def numeric_op_plain(op: str, av: torch.Tensor, am: torch.Tensor,
                     bv: Optional[torch.Tensor] = None, bm: Optional[torch.Tensor] = None,
                     scalar: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K-Z's numeric_op."""
    return numeric_math(torch, op, av, am, bv, bm, scalar)


def numeric_op(op: str, av: torch.Tensor, am: torch.Tensor,
               bv: Optional[torch.Tensor] = None, bm: Optional[torch.Tensor] = None,
               scalar: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values f32[n], mask bool[n]) of ``av <op> bv`` over two numeric
    columns (values f32[n], presence bool[n]) or of ``av <op> scalar``."""
    binary = bv is not None
    _require(op in (BINARY_OPS if binary else NUMERIC_OPS), f"unknown operation {op!r}")
    _require(av.dtype == torch.float32 and av.ndim == 1, "av must be float32[n]")
    _require(am.dtype == torch.bool and am.shape == av.shape, "am must be bool[n]")
    if binary:
        _require(bv.dtype == torch.float32 and bv.shape == av.shape, "bv must be float32[n]")
        _require(bm is not None and bm.dtype == torch.bool and bm.shape == av.shape,
                 "bm must be bool[n]")
    tensors = (av, am, bv, bm) if binary else (av, am)
    if not _on_cuda(*tensors):
        return numeric_op_plain(op, av, am, bv, bm, scalar)
    av, am = av.contiguous(), am.contiguous()
    if binary:
        bv, bm = bv.contiguous(), bm.contiguous()
    n = av.shape[0]
    vals = torch.empty(n, dtype=torch.float32, device=av.device)
    mask = torch.empty(n, dtype=torch.bool, device=av.device)
    lib = cuda_build.load("fused_layer", _SIGNATURES)
    with torch.cuda.device(av.device):
        rc = lib.numeric_op_f32(av.data_ptr(), am.data_ptr(),
                                bv.data_ptr() if binary else None,
                                bm.data_ptr() if binary else None,
                                vals.data_ptr(), mask.data_ptr(), n, NUMERIC_OPS.index(op),
                                float(scalar), _stream(av))
    cuda_build.check_launch("numeric_op", rc)
    numeric_op.launches += 1
    return vals, mask


numeric_op.launches = 0


# ---------------------------------------------------------------------------
# K-Z column_gather
# ---------------------------------------------------------------------------
def column_gather_plain(sources: Sequence[torch.Tensor], src: Sequence[int],
                        col: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of K-Z's column_gather."""
    offsets, o = [], 0
    for s in sources:
        offsets.append(o)
        o += s.shape[1]
    idx = torch.tensor([offsets[s] + c for s, c in zip(src, col)], dtype=torch.long,
                       device=sources[0].device)
    return torch.cat(list(sources), dim=1).index_select(1, idx)


@functools.lru_cache(maxsize=64)
def _gather_map(src: Tuple[int, ...], col: Tuple[int, ...], device: torch.device
                ) -> torch.Tensor:
    """i32[2, W] on ``device``, cached: a layer's map is fixed, and a
    host-to-device copy a call would stall the stream longer than the
    kernel runs."""
    return torch.tensor([src, col], dtype=torch.int32).reshape(2, len(src)).to(device)


def column_gather(sources: Sequence[torch.Tensor], src: Sequence[int],
                  col: Sequence[int]) -> torch.Tensor:
    """f32[n, W]: output column j is column ``col[j]`` of
    ``sources[src[j]]`` (each source f32[n, w_i], at most ``MAX_SOURCES``)."""
    src, col = tuple(int(s) for s in src), tuple(int(c) for c in col)
    _require(len(src) == len(col), "src and col differ in length")
    _require(1 <= len(sources) <= MAX_SOURCES, f"1 to {MAX_SOURCES} sources")
    n = sources[0].shape[0]
    for s in sources:
        _require(s.dtype == torch.float32 and s.ndim == 2 and s.shape[0] == n,
                 f"sources must be float32[{n}, w]")
    for s, c in zip(src, col):
        _require(0 <= s < len(sources) and 0 <= c < sources[s].shape[1],
                 f"column {c} of source {s} does not exist")
    if not _on_cuda(*sources):
        return column_gather_plain(sources, src, col)
    sources = [s.contiguous() for s in sources]
    out = torch.empty((n, len(src)), dtype=torch.float32, device=sources[0].device)
    if n == 0 or not src:
        return out
    ptrs = (ctypes.c_void_p * len(sources))(*[s.data_ptr() for s in sources])
    strides = (ctypes.c_longlong * len(sources))(*[s.shape[1] for s in sources])
    cmap = _gather_map(src, col, out.device)
    lib = cuda_build.load("fused_layer", _SIGNATURES)
    with torch.cuda.device(out.device):
        rc = lib.column_gather_f32(ptrs, strides, len(sources), cmap.data_ptr(),
                                   out.data_ptr(), n, len(src), _stream(out))
    cuda_build.check_launch("column_gather", rc)
    column_gather.launches += 1
    return out


column_gather.launches = 0


def concat_columns(sources: Sequence[torch.Tensor]) -> torch.Tensor:
    """The column concatenation f32[n, sum w_i] of the sources, by
    ``column_gather`` (more than ``MAX_SOURCES`` are joined in groups)."""
    sources = list(sources)
    while len(sources) > MAX_SOURCES:
        sources = [concat_columns(sources[i:i + MAX_SOURCES])
                   for i in range(0, len(sources), MAX_SOURCES)]
    src = [i for i, s in enumerate(sources) for _ in range(s.shape[1])]
    col = [c for s in sources for c in range(s.shape[1])]
    return column_gather(sources, src, col)
