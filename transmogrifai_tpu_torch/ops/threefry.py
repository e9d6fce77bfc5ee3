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
host, draws on the device the caller names.  On a CUDA device a draw is one
launch of K-W (``threefry_draws``, ``csrc/threefry.cu``), the hand-written
hash in every mode the port draws in: the bits, the uniforms, the
below-a-threshold masks, and (for ``ops/trees.py``) the Poisson bootstrap
and the exactly-k feature masks.  The integer-op replays (``*_plain``) run
only for a CPU device; a CUDA draw launches the kernel or raises.
``threefry_draws.launches`` counts K-W's launches, and
``threefry_draws.launches_by_mode`` those of each of its three modes:
``poisson``, ``masks``, and ``uniform`` (the bits, the uniforms and the
below-a-threshold masks: one hash and its map).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

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


def random_bits_plain(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """Plain version of ``random_bits``: torch int64 ops."""
    hi, lo = _counts(shape, device)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return b1 ^ b2


def uniform_plain(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """Plain version of ``uniform``: torch int64 ops."""
    bits = (random_bits_plain(k, shape, device) >> 9) | 0x3F800000
    return torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0, 0.0)


# ---------------------------------------------------------------------------
# K-W threefry_draws
# ---------------------------------------------------------------------------
#: K-W's draws, by their code in ``csrc/threefry.cu``, and the mode each
#: counts under
MODES = {"bits": 0, "uniform": 1, "below": 2, "poisson": 3, "masks": 4}
MODE_OF = {"bits": "uniform", "uniform": "uniform", "below": "uniform", "poisson": "poisson",
           "masks": "masks"}
#: the most features a tree K-W's mask mode takes (a warp's shared memory)
MASK_MAX_FEATURES = 2048
_DRAW_ARGS = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def is_cuda(device) -> bool:
    """Whether a draw on ``device`` launches K-W (a CUDA device) or runs its
    plain version (the CPU, and ``None``, torch's default device)."""
    if device is None:
        return False
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda"


def threefry_draws(mode: str, k: Key, shape: Sequence[int], device, param: float = 0.0,
                   keep: int = 0) -> torch.Tensor:
    """One launch of K-W on the CUDA ``device``: the draw of ``shape`` under
    key ``k`` as ``mode`` (``MODES``): the bits (int32 holding the uint32
    bits), the uniforms, ``uniform < param`` as 0/1 (``below``), Poisson(
    ``param``) counts by Knuth's loop (``poisson``, 0 < param < 10), or the
    masks of the ``keep`` smallest uniforms of each row of a [T, d] draw,
    ties included (``masks``, d <= ``MASK_MAX_FEATURES``).  Raises
    ``KernelError`` when the launch fails."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    dev = torch.device(device)
    out = torch.empty(shape, dtype=torch.int32 if mode == "bits" else torch.float32,
                      device=dev)
    if n == 0:
        return out
    rows, cols = (shape[0], shape[1]) if mode == "masks" else (0, 0)
    if mode == "masks" and (len(shape) != 2 or not 1 <= keep <= cols
                            or cols > MASK_MAX_FEATURES):
        raise ValueError(f"threefry_draws masks takes [T, d] with d <= {MASK_MAX_FEATURES} "
                         f"and 1 <= keep <= d, got {shape}, keep {keep}")
    if mode == "poisson" and not 0.0 < param < 10.0:
        raise ValueError(f"threefry_draws poisson takes 0 < rate < 10, got {param}")
    lib = cuda_build.load("threefry", {"threefry_draws": (_DRAW_ARGS, ctypes.c_int)})
    with torch.cuda.device(dev):
        rc = lib.threefry_draws(k[0] & _MASK, k[1] & _MASK, out.data_ptr(), n, MODES[mode],
                                float(param), rows, cols, int(keep),
                                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check_launch("threefry_draws", rc)
    threefry_draws.launches += 1
    threefry_draws.launches_by_mode[MODE_OF[mode]] += 1
    return out


def reset_launches() -> None:
    """Zero K-W's launch counts (the total and each mode's)."""
    threefry_draws.launches = 0
    threefry_draws.launches_by_mode = {m: 0 for m in ("poisson", "masks", "uniform")}


reset_launches()


def random_bits(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32): the xor of the
    hash's two words.  K-W on a CUDA device."""
    if not is_cuda(device):
        return random_bits_plain(k, shape, device)
    return threefry_draws("bits", k, shape, device).to(torch.int64) & _MASK


def uniform(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1) from the top 23
    bits, as 1.m - 1.  K-W on a CUDA device."""
    if not is_cuda(device):
        return uniform_plain(k, shape, device)
    return threefry_draws("uniform", k, shape, device)
