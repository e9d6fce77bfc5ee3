"""Linear-model prediction on the device.

The port's counterpart of the prediction kernels of
``transmogrifai_tpu/ops/linear.py`` (``predict_binary_logistic``,
``predict_softmax``).  These are plain products: ``torch.matmul`` in full
float32 (see ``utils/device.apply_f32_policy``).  The solvers are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch


def predict_binary_logistic(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(raw [n, 2], prob [n, 2], pred [n]) matching the reference's
    Prediction schema (rawPrediction_*, probability_*, prediction)."""
    z = X @ coef + intercept[0]
    p1 = torch.sigmoid(z)
    raw = torch.stack([-z, z], dim=-1)
    prob = torch.stack([1.0 - p1, p1], dim=-1)
    pred = (p1 >= 0.5).to(torch.float32)
    return raw, prob, pred


def predict_softmax(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    z = X @ coef + intercept
    prob = torch.softmax(z, dim=-1)
    pred = torch.argmax(z, dim=-1).to(torch.float32)
    return z, prob, pred
