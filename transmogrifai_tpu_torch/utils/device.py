"""Device resolution and the float32 policy of the port.

Replaces ``transmogrifai_tpu/utils/backend.py`` and ``utils/devcache.py``.
There is no silent CPU fallback: ``device=None`` means the CUDA card, and a
host without one raises, naming the fix.  The CPU runs only when a caller
asks for it (the tests pass ``device="cpu"``), and then every kernel wrapper
takes its plain PyTorch version because its tensors lie on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def apply_f32_policy() -> None:
    """Keep float32 products in full float32 on the card.

    The JAX package's reference numbers are float32; TF32 keeps about three
    decimal digits, so both matmul and cuDNN TF32 are switched off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available. The port runs on the GPU unless "
                "the caller asks for the CPU: pass device=\"cpu\" to run the "
                "plain PyTorch versions of its kernels on the host.")
        apply_f32_policy()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Whether a kernel wrapper launches its kernel (CUDA tensors) or runs
    its plain version (CPU tensors).  Raises on tensors spread over devices
    or on any other device: there is no fallback between the two."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    kind = devs.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda"
