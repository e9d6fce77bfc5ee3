"""The scoring DAG: layer-by-layer transform on the device.

The port's counterpart of the scoring half of
``transmogrifai_tpu/workflow/dag.py`` (reference FitStagesUtil.scala:51):
``apply_transformations_dag`` applies the saved antichain layers in order.  A layer's stages
that implement the fused-layer protocol (``torch_transform``, see
``impl/feature/_util.py``) run back to back on the device, sharing one upload
of each distinct input column; the rest apply per stage.  As in the JAX
package, a layer with a single such stage takes its ``transform_columns``
path, which keeps numeric arithmetic on the host in float64.

The port runs eagerly, with no compiled-program cache, and scores a layer
whole at any row count; the streaming executor of the JAX package
(``workflow/stream.py``) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

from ..columns import Dataset, NumericColumn, VectorColumn
from ..impl.feature._util import run_on_device
from ..stages.base import PipelineStage, Transformer

Layer = List[PipelineStage]


def _fusable(t, ds: Dataset) -> bool:
    if not (hasattr(t, "torch_transform") and t.n_outputs == 1):
        return False
    cols = [ds.columns.get(f.name) for f in t.inputs]
    if any(c is None for c in cols):
        return False
    if hasattr(t, "torch_host_prep"):
        ready = getattr(t, "torch_host_ready", None)
        return ready(cols) if ready is not None else True
    return all(isinstance(c, (NumericColumn, VectorColumn)) for c in cols)


def _apply_layer_transforms(ds: Dataset, transformers: Sequence[Transformer]) -> Dataset:
    """One layer (applyOpTransformations analog, FitStagesUtil.scala:96)."""
    fusables = [t for t in transformers if _fusable(t, ds)]
    if len(fusables) == 1:  # a lone stage takes its own transform_columns path
        fusables = []
    fused_ids = {id(t) for t in fusables}
    new_cols = {}
    uploads: Dict[Any, Any] = {}
    for t in fusables:
        new_cols[t.get_outputs()[0].name] = run_on_device(
            t, [ds[f.name] for f in t.inputs], uploads)
    for t in transformers:
        if id(t) in fused_ids:
            continue
        col = t.transform_dataset(ds)
        out_feats = t.get_outputs()
        if t.n_outputs == 1:
            new_cols[out_feats[0].name] = col
        else:
            for f, c in zip(out_feats, col):
                new_cols[f.name] = c
    return ds.with_columns(new_cols)


def apply_transformations_dag(ds: Dataset, dag: List[Layer]) -> Dataset:
    """Scoring path: every stage must already be a transformer
    (OpWorkflowCore.applyTransformationsDAG, OpWorkflowCore.scala:324)."""
    for layer in dag:
        for stage in layer:
            if not isinstance(stage, Transformer):
                raise TypeError(
                    f"Scoring DAG contains unfitted estimator {stage}; fit the workflow first")
    for layer in dag:
        ds = _apply_layer_transforms(ds, layer)
    return ds
