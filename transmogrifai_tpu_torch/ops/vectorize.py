"""Vectorizer kernels of the fused layer: fill + null indicator (K-C) and
the categorical one-hot (K-D).

Replace the device halves of two fused-layer programs of the JAX package
(``transmogrifai_tpu/workflow/dag.py:99-167``):

- ``fill_indicator`` — ``RealVectorizerModel.jax_transform``
  (``impl/feature/vectorizers.py:108-117``): fill nulls with the fitted
  fill, and interleave each value column with its null indicator.
- ``one_hot_codes`` — ``OneHotVectorizerModel.jax_transform``
  (``impl/feature/vectorizers.py:403-412``): expand host-prepared category
  codes into the concatenated one-hot block; code -1 (or any code outside
  its block) gives a zero row.

Both are written in Triton (``ops/triton_vectorize.py``): each is one
elementwise pass with no reuse, which shared memory and tensor cores cannot
speed up and Triton's masked block loads express directly.  Triton is
imported inside the launching function only.  The plain PyTorch version of
each sits beside it; a wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from ..utils.device import on_cuda as _on_cuda


def _pow2(x: int, lo: int, hi: int) -> int:
    p = lo
    while p < x and p < hi:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# K-C fill_indicator
# ---------------------------------------------------------------------------
def fill_indicator_plain(values: torch.Tensor, mask: torch.Tensor, fills: torch.Tensor,
                         track_nulls: bool) -> torch.Tensor:
    """Plain PyTorch version of K-C."""
    filled = torch.where(mask, values, fills[:, None])  # [k, n]
    if not track_nulls:
        return filled.T.contiguous()
    k, n = values.shape
    return torch.stack([filled, (~mask).to(torch.float32)], dim=2) \
        .permute(1, 0, 2).reshape(n, 2 * k)


def fill_indicator(values: torch.Tensor, mask: torch.Tensor, fills: torch.Tensor,
                   track_nulls: bool) -> torch.Tensor:
    """f32[n, 2k] (value, null indicator per input) or f32[n, k] from
    values f32[k, n], mask bool[k, n] (True = present) and fills f32[k]."""
    k = values.shape[0]
    if values.dtype != torch.float32 or values.ndim != 2:
        raise ValueError("values must be float32[k, n]")
    if mask.dtype != torch.bool or mask.shape != values.shape:
        raise ValueError(f"mask must be bool{list(values.shape)}")
    if fills.dtype != torch.float32 or tuple(fills.shape) != (k,):
        raise ValueError(f"fills must be float32[{k}]")
    if not _on_cuda(values, mask, fills):
        return fill_indicator_plain(values, mask, fills, track_nulls)
    from . import triton_vectorize as tv

    values, mask, fills = values.contiguous(), mask.contiguous(), fills.contiguous()
    n = values.shape[1]
    width = 2 * k if track_nulls else k
    out = torch.empty((n, width), dtype=torch.float32, device=values.device)
    if n == 0 or width == 0:
        return out
    block_c = _pow2(width, 2, 64)
    block_r = max(4096 // block_c, 16)
    grid = (-(-n // block_r), -(-width // block_c))
    with torch.cuda.device(values.device):
        tv.fill_indicator_kernel[grid](
            values, mask.view(torch.uint8), fills, out, n, width,
            TRACK=bool(track_nulls), BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    fill_indicator.launches += 1
    return out


fill_indicator.launches = 0


# ---------------------------------------------------------------------------
# K-D one_hot_codes
# ---------------------------------------------------------------------------
def one_hot_codes_plain(codes: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of K-D."""
    blocks = [(codes[j].long()[:, None]
               == torch.arange(w, device=codes.device)[None, :]).to(torch.float32)
              for j, w in enumerate(widths)]
    if not blocks:
        return torch.zeros((codes.shape[1], 0), dtype=torch.float32, device=codes.device)
    return torch.cat(blocks, dim=1)


@functools.lru_cache(maxsize=64)
def _column_map(widths: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """i32[2, W] on ``device``: each output column's input and its index
    within that input's block.  Cached per (widths, device): a model's
    layout is fixed, and a host-to-device copy per call would stall the
    stream for longer than the kernel runs."""
    col_input = torch.repeat_interleave(torch.arange(len(widths), dtype=torch.int32),
                                        torch.tensor(widths))
    col_local = torch.cat([torch.arange(w, dtype=torch.int32) for w in widths])
    return torch.stack([col_input, col_local]).to(device)


def one_hot_codes(codes: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """f32[n, sum(widths)]: input j's code c sets column offset_j + c of its
    row; a code outside [0, widths[j]) sets nothing."""
    widths = [int(w) for w in widths]
    if codes.dtype != torch.int32 or codes.ndim != 2 or codes.shape[0] != len(widths):
        raise ValueError(f"codes must be int32[{len(widths)}, n]")
    if not _on_cuda(codes):
        return one_hot_codes_plain(codes, widths)
    from . import triton_vectorize as tv

    codes = codes.contiguous()
    n = codes.shape[1]
    width = sum(widths)
    out = torch.empty((n, width), dtype=torch.float32, device=codes.device)
    if n == 0 or width == 0:
        return out
    col_map = _column_map(tuple(widths), codes.device)
    block_c = _pow2(width, 2, 64)
    block_r = max(4096 // block_c, 16)
    grid = (-(-n // block_r), -(-width // block_c))
    with torch.cuda.device(codes.device):
        tv.one_hot_kernel[grid](codes, col_map, out, n, width,
                                BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    one_hot_codes.launches += 1
    return out


one_hot_codes.launches = 0
