"""SanityCheckerModel — the fitted checker's column gather.

The port's copy of ``SanityCheckerModel`` from
``transmogrifai_tpu/impl/preparators/sanity_checker.py`` (reference:
DerivedFeatureFilterUtils.removeFeatures:289): the kept columns of the
feature vector, gathered on the device.  The checker's fit (label
correlations, contingency statistics) is not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ... import types as T
from ...columns import Column, VectorColumn
from ...features.metadata import VectorMetadata
from ...stages.base import Model
from ..feature._util import run_on_device


class SanityCheckerModel(Model):
    """Pure column gather (DerivedFeatureFilterUtils.removeFeatures:289)."""

    def __init__(self, indices_to_keep: np.ndarray, out_metadata: Optional[VectorMetadata],
                 operation_name: str = "sanityChecker", output_type=T.OPVector,
                 uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.indices_to_keep = np.asarray(indices_to_keep, dtype=int)
        self.out_metadata = out_metadata

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        assert isinstance(cols[-1], VectorColumn)
        return run_on_device(self, cols)

    # ---- fused-layer protocol (workflow/dag._apply_layer_transforms): a
    # column gather on the device; only the vector input is uploaded ---------
    def torch_host_prep(self, cols):
        return [cols[-1].values, self.indices_to_keep]

    def torch_transform(self, vec, keep):
        return vec.index_select(1, keep)

    def torch_out_metadata(self, cols) -> Optional[VectorMetadata]:
        return self.out_metadata
