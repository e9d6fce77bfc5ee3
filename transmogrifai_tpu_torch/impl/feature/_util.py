"""Shared vectorizer plumbing: host blocks to device columns, and the
device-side run of one stage of the fused-layer protocol.

A stage of the protocol defines ``torch_transform(*tensors)`` (the device
program), ``torch_out_metadata(cols)`` for vector outputs, and optionally
``torch_host_prep(cols)``, which turns its input columns into the arrays
its program takes (e.g. category codes); without it each input column is
uploaded as is: a numeric column as (values f32, mask), a vector column as
its matrix.  ``torch_output = "numeric"`` marks a stage that returns
(values, mask).  It is the port of the ``jax_*`` protocol that
``transmogrifai_tpu/workflow/dag.py:79-167`` consumes, run eagerly.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import types as T
from ...columns import Column, NumericColumn, VectorColumn
from ...features.metadata import VectorColumnMetadata, VectorMetadata
from ...utils.device import resolve_device


def stage_device(stage) -> torch.device:
    return stage.device if stage.device is not None else resolve_device(None)


def stage_constant(stage, name: str, values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fitted stage's constant (fills, means, reciprocals) as a device
    tensor, cached on the stage per (name, device, values): a copy from the
    host on every call would stall the stream, and a bucket's CUDA graph
    (``serve/aot.py``) cannot capture one.  Keyed by the values too, so a
    stage whose constants change gets new tensors."""
    values = np.ascontiguousarray(values)
    cache = stage.__dict__.setdefault("_device_constants", {})
    key = (name, str(device), values.dtype.str, values.shape, values.tobytes())
    t = cache.get(key)
    if t is None:
        t = cache.setdefault(key, torch.from_numpy(values.copy()).to(device))
    return t


def _upload(a: Any, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def device_inputs(stage, cols: Sequence[Column], device: torch.device,
                  uploads: Optional[Dict[Any, torch.Tensor]] = None) -> List[torch.Tensor]:
    """The stage's program inputs on ``device``.  ``uploads`` (shared by a
    layer's stages) keeps each distinct input column to one upload."""
    if hasattr(stage, "torch_host_prep"):
        return [_upload(a, device) for a in stage.torch_host_prep(cols)]
    uploads = {} if uploads is None else uploads
    out: List[torch.Tensor] = []
    for f, col in zip(stage.inputs, cols):
        if isinstance(col, NumericColumn):
            if (f.name, "v") not in uploads:
                uploads[(f.name, "v")] = _upload(col.values.astype(np.float32), device)
                uploads[(f.name, "m")] = _upload(col.mask, device)
            out += [uploads[(f.name, "v")], uploads[(f.name, "m")]]
        else:
            assert isinstance(col, VectorColumn), f"{stage} input {f.name} is not device data"
            out.append(col.tensor(device))
    return out


def run_on_device(stage, cols: Sequence[Column],
                  uploads: Optional[Dict[Any, torch.Tensor]] = None) -> Column:
    """One stage of the fused-layer protocol on its device."""
    out = stage.torch_transform(*device_inputs(stage, cols, stage_device(stage), uploads))
    if getattr(stage, "torch_output", "vector") == "numeric":
        vals, mask = out
        return NumericColumn(stage.get_outputs()[0].ftype, vals.cpu().numpy(),
                             mask.cpu().numpy())
    return VectorColumn(T.OPVector, out, stage.torch_out_metadata(cols))


def finalize_vector(stage, blocks: Sequence[Any],
                    meta: Sequence[VectorColumnMetadata], n: int) -> VectorColumn:
    """Concatenate transform blocks (host arrays or device tensors) on the
    stage's device, re-index the column metadata and stash it on the stage."""
    device = stage_device(stage)
    out = (torch.cat([_upload(b, device).to(torch.float32) for b in blocks], dim=1)
           if len(blocks) else torch.zeros((n, 0), dtype=torch.float32, device=device))
    cols_meta = tuple(
        VectorColumnMetadata(c.parent_feature_name, c.parent_feature_type, c.grouping,
                             c.indicator_value, c.descriptor_value, i)
        for i, c in enumerate(meta))
    vm = VectorMetadata(stage.get_outputs()[0].name, cols_meta)
    stage.metadata["vector_metadata"] = vm
    return VectorColumn(T.OPVector, out, vm)
