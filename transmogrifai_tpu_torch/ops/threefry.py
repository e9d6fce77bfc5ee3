"""Threefry-2x32 keys and draws, bit for bit as ``jax.random`` makes them.

The port's copy of the parts of ``jax.random`` that the JAX package's draws
use (``jax._src.prng``: ``threefry_2x32``, ``threefry_split``,
``threefry_random_bits`` and ``random.uniform``), under
``jax_threefry_partitionable = True``: a draw of shape S hashes the 64-bit
row-major index of each element, split into its high and low 32-bit words,
with the key; ``split(key, k)`` is the draw of shape (k,) with both words
of the hash kept.  The port has no JAX, and the forests of the sweep must
train on the JAX package's bootstraps bit for bit, so the draws are
replayed here with torch integer ops: int64 tensors holding uint32 values
(``& 0xFFFFFFFF`` after each add and shift; torch's uint32 lacks most ops).

A key is a pair of Python ints ``(k1, k2)``; splits are computed on the
host, draws on the device the caller names.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count words ``x1``, ``x2``
    (int64 tensors of uint32 values) under the key ``(k1, k2)``."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _counts(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the row-major element index (``iota_2x32_shape``)."""
    idx = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64,
                       device=device).reshape(tuple(shape))
    return idx >> 32, idx & _MASK


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(jnp.uint32(seed))``: high word 0, low word the seed."""
    return 0, int(seed) & _MASK


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)`` as ``num`` keys."""
    hi, lo = _counts((num,), "cpu")
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return [(int(a), int(b)) for a, b in zip(b1.tolist(), b2.tolist())]


def random_bits(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32): the xor of the
    hash's two words."""
    hi, lo = _counts(shape, device)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return b1 ^ b2


def uniform(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1) from the top 23
    bits, as 1.m - 1."""
    bits = (random_bits(k, shape, device) >> 9) | 0x3F800000
    return torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0, 0.0)
