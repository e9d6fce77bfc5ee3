"""Tree-model parameters carried from the JAX package to the device.

The port's counterpart of ``tree_params`` / ``tree_from_params`` of
``transmogrifai_tpu/impl/trees_common.py``.  ``tree_from_params`` is the
carry-across function: it turns a fitted predictor's numpy parameters (as
the JAX package saves them) into the port's ``Tree`` of tensors on a
device, after checking that every index in the pools is in range, since
the walk kernel follows them without bounds checks.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.trees import Tree


def tree_params(tree: Tree, **extra) -> Dict[str, Any]:
    """Flatten a ``Tree`` into a serializable params dict (numpy arrays)."""
    return {"split_feat": tree.split_feat.cpu().numpy(),
            "split_bin": tree.split_bin.cpu().numpy(),
            "left": tree.left.cpu().numpy(), "right": tree.right.cpu().numpy(),
            "leaf_val": tree.leaf_val.cpu().numpy(), **extra}


def tree_from_params(params: Dict[str, Any], device) -> Tree:
    """The ``Tree`` of a params dict, on ``device``: pools i32[T, P] and
    leaf values f32[T, P, c]."""
    sf = np.asarray(params["split_feat"])
    if sf.ndim != 2:
        raise ValueError(f"split_feat must be [trees, pool], got shape {sf.shape}")
    T, P = sf.shape
    arrays = {}
    for name in ("split_feat", "split_bin", "left", "right"):
        a = np.asarray(params[name])
        if a.shape != (T, P) or a.dtype.kind not in "iu":
            raise ValueError(f"{name} must be integer[{T}, {P}], got {a.dtype}{a.shape}")
        arrays[name] = a.astype(np.int32)
    leaf = np.asarray(params["leaf_val"], np.float32)
    if leaf.ndim != 3 or leaf.shape[:2] != (T, P):
        raise ValueError(f"leaf_val must be [{T}, {P}, c], got shape {leaf.shape}")
    d = int(np.asarray(params["edges"]).shape[0]) if "edges" in params else None
    if d is not None and (sf.min(initial=-1) < -1 or sf.max(initial=-1) >= d):
        raise ValueError(f"split_feat out of range [-1, {d})")
    for name in ("left", "right"):
        a = arrays[name][sf >= 0]
        if a.size and (a.min() < 0 or a.max() >= P):
            raise ValueError(f"{name} child index out of range [0, {P})")
    dev = torch.device(device)
    # torch.tensor copies (the saved arrays may be read-only views of the
    # npz) but keeps a Fortran-ordered array's strides: make them C-ordered
    return Tree(*(torch.tensor(np.ascontiguousarray(arrays[k]), device=dev)
                  for k in ("split_feat", "split_bin", "left", "right")),
                torch.tensor(np.ascontiguousarray(leaf), device=dev))
