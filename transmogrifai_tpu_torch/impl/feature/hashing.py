"""Feature hashing — MurMur3 x86/32 with Spark's seed (42).

The port's copy of the hashing core of
``transmogrifai_tpu/impl/feature/hashing.py`` (reference HashingTF /
OPCollectionHashingVectorizer.scala:59): the pure-Python ``_murmur3_32_py``,
``hash_term`` and ``HashingFunction``, so hash layouts match the JAX package
and the reference bit for bit.  Hashing runs on the host; the native C++
helper and the hashing stages are not ported.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np


def _murmur3_32_py(data: bytes, seed: int = 42) -> int:
    """MurMur3 x86 32-bit (the hash behind Spark's HashingTF)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = n % 4
    if tail >= 3:
        k ^= data[rounded + 2] << 16
    if tail >= 2:
        k ^= data[rounded + 1] << 8
    if tail >= 1:
        k ^= data[rounded]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def hash_term(term: str, num_features: int, seed: int = 42) -> int:
    """Token -> bucket, matching Spark HashingTF's nonNegativeMod."""
    h = _murmur3_32_py(term.encode("utf-8"), seed)
    # interpret as signed 32-bit then non-negative mod
    signed = h - 0x100000000 if h >= 0x80000000 else h
    return ((signed % num_features) + num_features) % num_features


class HashingFunction:
    """The shared hashing core (term iteration + bucketing) used by
    OpHashingTF and OPCollectionHashingVectorizer."""

    def __init__(self, num_features: int = 512, binary_freq: bool = False, seed: int = 42):
        self.num_features = int(num_features)
        self.binary_freq = bool(binary_freq)
        self.seed = int(seed)

    def tf_row(self, terms: Iterable[str], out: np.ndarray, offset: int = 0) -> None:
        for t in terms:
            j = offset + hash_term(str(t), self.num_features, self.seed)
            if self.binary_freq:
                out[j] = 1.0
            else:
                out[j] += 1.0
