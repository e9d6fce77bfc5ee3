"""DAG computation, layered fitting and the layer-by-layer transform.

The port's counterpart of ``transmogrifai_tpu/workflow/dag.py`` (reference
FitStagesUtil.scala:51): ``compute_dag`` groups stages into antichain
layers by their distance from the result features, ``fit_and_transform_dag``
fits a layer's estimators then transforms the training data with the
layer, ``cut_dag`` splits the DAG around the ModelSelector for the
workflow-level CV, and ``apply_transformations_dag`` applies fitted layers
in order.  A layer's stages
that implement the fused-layer protocol (``torch_transform``, see
``impl/feature/_util.py``) run back to back on the device, sharing one upload
of each distinct input column; the rest apply per stage.  As in the JAX
package, a layer with a single such stage takes its ``transform_columns``
path, which keeps numeric arithmetic on the host in float64, unless the
layer has more than ``STREAM_ROWS`` rows: there the JAX package streams
every such stage through its device chunk program (``workflow/stream.py``),
and the port runs each one's kernel on the device too.

The port runs eagerly, one launch a stage, with no compiled-program cache,
and transforms a layer whole at any row count: the chunking, prefetch and
multi-device dispatch of the JAX package's streaming executor are not
ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set

from ..columns import Dataset, NumericColumn, VectorColumn
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..impl.feature._util import run_on_device
from ..stages.base import Estimator, PipelineStage, Transformer

Layer = List[PipelineStage]

#: rows above which the JAX package streams a layer's fusable stages through
#: its device chunk program, a lone one included (``_fuse_max_rows``,
#: ``transmogrifai_tpu/workflow/dag.py:187-205``)
STREAM_ROWS = 200_000


def compute_dag(result_features: Sequence[Feature]) -> List[Layer]:
    """Stages layered by max distance from the results, farthest first;
    raw-feature generator stages are left out (their work is the reader's)."""
    dist: Dict[str, int] = {}
    stages: Dict[str, PipelineStage] = {}
    for rf in result_features:
        for stage, d in rf.parent_stages().items():
            if isinstance(stage, FeatureGeneratorStage):
                continue
            if stage.uid not in dist or dist[stage.uid] < d:
                dist[stage.uid] = d
                stages[stage.uid] = stage
    by_layer: Dict[int, Layer] = {}
    for uid, d in dist.items():
        by_layer.setdefault(d, []).append(stages[uid])
    return [sorted(by_layer[d], key=lambda s: s.uid) for d in sorted(by_layer, reverse=True)]


@dataclass
class FittedDAG:
    """Result of fit_and_transform_dag (FitStagesUtil.FittedDAG)."""

    train: Dataset
    fitted_stages: List[PipelineStage]


def fit_and_transform_dag(dag: List[Layer], train: Dataset,
                          fitted_so_far: Optional[Dict[str, PipelineStage]] = None,
                          listener=None) -> FittedDAG:
    """Fit each layer's estimators on ``train``, then transform ``train``
    with the layer (FitStagesUtil.fitAndTransformDAG:212).  ``fitted_so_far``
    maps stage uids to models applied instead of refitted.  ``listener``,
    when given, is called as ``listener(layer_index, layer, seconds)``."""
    import time

    fitted_so_far = fitted_so_far or {}
    fitted: List[PipelineStage] = []
    for li, layer in enumerate(dag):
        t0 = time.perf_counter()
        transformers: List[Transformer] = []
        for stage in layer:
            if stage.uid in fitted_so_far:
                model = fitted_so_far[stage.uid]
            elif isinstance(stage, Estimator):
                model = stage.fit(train)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"Stage {stage} is neither Estimator nor Transformer")
            transformers.append(model)
            fitted.append(model)
        train = _apply_layer_transforms(train, transformers)
        if listener is not None:
            listener(li, layer, time.perf_counter() - t0)
    return FittedDAG(train=train, fitted_stages=fitted)


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
    if len(fusables) == 1 and len(ds) <= STREAM_ROWS:
        fusables = []  # a lone stage takes its own transform_columns path
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


@dataclass
class CutDAG:
    """DAG split around the ModelSelector (FitStagesUtil.CutDAG)."""

    model_selector: Optional[PipelineStage]
    before: List[Layer]
    during: List[Layer]
    after: List[Layer]


def cut_dag(dag: List[Layer]) -> CutDAG:
    """Split for workflow-level CV (FitStagesUtil.cutDAG:302): 'during'
    (refit per fold) is the suffix of the selector's ancestor sub-DAG from
    the first layer holding a label-using stage (inputs mixing the response
    and predictors); label-free feature engineering fits once in 'before';
    layers past the selector are 'after'.  At most one ModelSelector."""
    selectors = [(i, s) for i, layer in enumerate(dag) for s in layer
                 if getattr(s, "is_model_selector", False)]
    if not selectors:
        return CutDAG(None, before=dag, during=[], after=[])
    if len(selectors) > 1:
        raise ValueError(
            f"Only one ModelSelector is supported per workflow, found {len(selectors)}")
    idx, selector = selectors[0]
    anc = compute_dag(list(selector.inputs))
    ci = next((i for i, layer in enumerate(anc) for s in layer
               if any(f.is_response for f in s.inputs)
               and any(not f.is_response for f in s.inputs)), None)
    during_feats: List[Layer] = [list(l) for l in anc[ci:]] if ci is not None else []
    during_uids: Set[str] = {s.uid for layer in during_feats for s in layer}
    before: List[Layer] = []
    for layer in dag[:idx + 1]:
        keep = [s for s in layer if s is not selector and s.uid not in during_uids]
        if keep:
            before.append(keep)
    after: List[Layer] = [list(l) for l in dag[idx + 1:]]
    return CutDAG(selector, before=before, during=during_feats + [[selector]], after=after)
