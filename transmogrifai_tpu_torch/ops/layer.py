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

and the scalers' device programs:

- ``numeric_scale`` (K-AC) — ``FillMissingWithMeanModel.jax_transform``
  (``impl/feature/transformers.py:310``), ``OpScalarStandardScalerModel``
  (``impl/feature/scalers.py:64``), ``ScalerTransformer`` (``:109``, linear
  and log), ``DescalerTransformer`` (``:146``, linear and exp) and
  ``PercentileCalibratorModel`` (``:187``, buckets by a right-sided search
  of the float32 splits).
- ``column_affine`` (K-AD) — ``StandardScalerModel.jax_transform``
  (``impl/feature/vectorizers.py:541``): ``(x - mean_j) / std_j``.

Each rounds as XLA's CPU code compiles the JAX package's program (compared
bit for bit on the CPU): ``slope * v + intercept`` is one fused
multiply-add, and a division by a fitted constant is a multiplication by its
float32 reciprocal (XLA's algebraic simplifier rewrites it so); log and exp
are the libraries' own (XLA's approximations differ by up to 2 ulps).

All are CUDA (``csrc/fused_layer.cu``): a value an operation or a copy,
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

import numpy as np
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
    "numeric_scale_f32": ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p], ctypes.c_int),
    "column_affine_f32": ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_void_p], ctypes.c_int),
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


# ---------------------------------------------------------------------------
# K-AC numeric_scale
# ---------------------------------------------------------------------------
#: the modes, in ``csrc/fused_layer.cu``'s order
SCALE_MODES = ("fill", "standardize", "scale_linear", "scale_log", "descale_linear",
               "descale_exp", "bucket")
#: the most splits a bucket launch takes (shared memory)
MAX_SPLITS = 1023


def _f32(x: float) -> np.float32:
    return np.float32(x)


def _scale_constants(mode: str, a: float, b: float) -> Tuple[float, float]:
    """The two float32 constants a launch takes: the division modes' divisor
    becomes its float32 reciprocal, as XLA folds it."""
    if mode == "standardize":
        return float(_f32(a)), float(_f32(1.0) / _f32(b))
    if mode == "descale_linear":
        return float(_f32(1.0) / _f32(a)), float(_f32(b))
    return float(_f32(a)), float(_f32(b))


def numeric_scale_plain(mode: str, v: torch.Tensor, m: torch.Tensor, a: float = 0.0,
                        b: float = 1.0, splits: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K-AC (see ``numeric_scale``)."""
    ca, cb = (torch.tensor(c, dtype=torch.float32, device=v.device)
              for c in _scale_constants(mode, a, b))
    ones = torch.ones_like(m)
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    if mode == "fill":
        return torch.where(m, v, ca), ones
    if mode == "standardize":
        return (torch.where(m, v, ca) - ca) * cb, ones
    if mode == "scale_linear":
        # one rounding of slope * v + intercept, as the fused multiply-add
        # (the product of two float32 values is exact in float64)
        vals = (ca.double() * v.double() + cb.double()).to(torch.float32)
        return torch.where(m, vals, zero), m
    if mode == "scale_log":
        vals = torch.log(v)
        mask = m & torch.isfinite(vals)
        return torch.where(mask, vals, zero), mask
    if mode == "descale_linear":
        return torch.where(m, (v - cb) * ca, zero), m
    if mode == "descale_exp":
        return torch.where(m, torch.exp(v), zero), m
    # bucket: the count of splits <= v (NaN above every split)
    idx = torch.searchsorted(splits, v, right=True)
    return idx.to(torch.float32), ones


def numeric_scale(mode: str, v: torch.Tensor, m: torch.Tensor, a: float = 0.0, b: float = 1.0,
                  splits: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values f32[n], mask bool[n]) of one scaler over a numeric column
    (values ``v`` f32[n], presence ``m`` bool[n]):

    - ``fill``: ``where(m, v, a)``, all present (a = the mean);
    - ``standardize``: ``(where(m, v, a) - a) / b``, all present (a, b = the
      mean and the standard deviation);
    - ``scale_linear``: ``a v + b`` where present (a, b = slope, intercept);
    - ``scale_log``: ``log v``, present where ``m`` and finite;
    - ``descale_linear``: ``(v - b) / a`` where present (a, b = slope,
      intercept);
    - ``descale_exp``: ``exp v`` where present;
    - ``bucket``: the right-sided search position of v among ``splits``
      f32[s] (sorted, at most ``MAX_SPLITS``; NaN above all), all present.

    Absent outputs hold 0."""
    _require(mode in SCALE_MODES, f"unknown scale mode {mode!r}")
    _require(v.dtype == torch.float32 and v.ndim == 1, "v must be float32[n]")
    _require(m.dtype == torch.bool and m.shape == v.shape, "m must be bool[n]")
    tensors = (v, m)
    if mode == "bucket":
        _require(splits is not None and splits.dtype == torch.float32 and splits.ndim == 1
                 and splits.shape[0] <= MAX_SPLITS,
                 f"bucket needs splits float32[s], s <= {MAX_SPLITS}")
        tensors += (splits,)
    if not _on_cuda(*tensors):
        return numeric_scale_plain(mode, v, m, a, b, splits)
    v, m = v.contiguous(), m.contiguous()
    ca, cb = _scale_constants(mode, a, b)
    n = v.shape[0]
    vals = torch.empty(n, dtype=torch.float32, device=v.device)
    mask = torch.empty(n, dtype=torch.bool, device=v.device)
    sp = splits.contiguous() if mode == "bucket" else None
    lib = cuda_build.load("fused_layer", _SIGNATURES)
    with torch.cuda.device(v.device):
        rc = lib.numeric_scale_f32(v.data_ptr(), m.data_ptr(),
                                   sp.data_ptr() if sp is not None else None, vals.data_ptr(),
                                   mask.data_ptr(), n, SCALE_MODES.index(mode), ca, cb,
                                   0 if sp is None else sp.shape[0], _stream(v))
    cuda_build.check_launch("numeric_scale", rc)
    numeric_scale.launches += 1
    numeric_scale.launches_by_mode[mode] = numeric_scale.launches_by_mode.get(mode, 0) + 1
    return vals, mask


numeric_scale.launches = 0
numeric_scale.launches_by_mode = {}


# ---------------------------------------------------------------------------
# K-AD column_affine
# ---------------------------------------------------------------------------
def column_affine_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of K-AD."""
    return (x - shift) * scale


def column_affine(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32[n, d]: ``(x - shift_j) * scale_j`` (``StandardScalerModel``
    passes the mean and the float32 reciprocal of the standard deviation,
    the product XLA compiles its division into)."""
    _require(x.dtype == torch.float32 and x.ndim == 2, "x must be float32[n, d]")
    d = x.shape[1]
    for name, t in (("shift", shift), ("scale", scale)):
        _require(t.dtype == torch.float32 and tuple(t.shape) == (d,), f"{name} must be float32[{d}]")
    if not _on_cuda(x, shift, scale):
        return column_affine_plain(x, shift, scale)
    x, shift, scale = x.contiguous(), shift.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = cuda_build.load("fused_layer", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.column_affine_f32(x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                                   out.data_ptr(), x.shape[0], d, _stream(x))
    cuda_build.check_launch("column_affine", rc)
    column_affine.launches += 1
    return out


column_affine.launches = 0
