"""Devices of the serving replica slots.

The port's copy of ``serve_devices`` and ``serve_chip_index`` of
``transmogrifai_tpu/parallel/mesh.py:177-205``.  The rest of that module
(meshes, sharding, the multi-host layout) waits for multi-GPU through
``torch.distributed`` (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..utils.env import env_int

__all__ = ["serve_devices", "serve_chip_index"]


def serve_devices(n: Optional[int] = None) -> List[torch.device]:
    """Devices for the serving replica slots: one per CUDA card by default,
    overridable by ``TMOG_SERVE_REPLICAS`` (or the explicit ``n``).  Asking
    for more replicas than cards cycles the cards, as the JAX package does.
    Without a card this raises: the CPU route is asked for by name."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available for the serving replicas. The port serves "
            "on the GPU unless the caller asks for the CPU: pass "
            "devices=[torch.device(\"cpu\")] to ModelRegistry to score on the host "
            "with the kernels' plain PyTorch versions.")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n is None:
        n = env_int("TMOG_SERVE_REPLICAS", len(devs))
    n = max(1, int(n))
    return [devs[i % len(devs)] for i in range(n)]


def serve_chip_index(devices: Sequence[torch.device]) -> List[int]:
    """Each serving slot's device as a stable card ordinal (first-appearance
    order over the slot list), so slots that cycle one card share one."""
    order: dict = {}
    out: List[int] = []
    for d in devices:
        key = str(torch.device(d))
        if key not in order:
            order[key] = len(order)
        out.append(order[key])
    return out
