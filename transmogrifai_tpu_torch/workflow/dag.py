"""DAG computation, layered fitting and the transforms.

The port's counterpart of ``transmogrifai_tpu/workflow/dag.py`` (reference
FitStagesUtil.scala:51): ``compute_dag`` groups stages into antichain
layers by their distance from the result features, ``fit_and_transform_dag``
fits the layers' estimators in order, ``cut_dag`` splits the DAG around the
ModelSelector for the workflow-level CV, and ``apply_transformations_dag``
applies fitted layers.

As in the JAX package, ``fit_and_transform_dag`` defers transformer-only
layers and flushes them together right before the next estimator needs their
outputs (``_apply_pending``), and ``apply_transformations_dag`` takes the
whole scoring DAG at once: past ``STREAM_ROWS`` rows such a run of layers
goes through the streaming executor (``workflow/stream.py``) in chunks of
``stream.CHUNK_ROWS`` rows, intermediates staying on the device.  The only
way back to the layer path is the planner's: a run with fewer than two
fusable stages.  On the layer path a layer's stages that implement the
fused-layer protocol (``torch_transform``, see ``impl/feature/_util.py``)
run back to back on the device, sharing one upload of each distinct input
column, and the rest apply per stage; a layer with a single such stage
takes its ``transform_columns`` path (numeric arithmetic on the host in
float64) at or below ``STREAM_ROWS`` rows and its device program above.
Past ``FREE_INTERMEDIATES_CELLS`` cells, columns no later stage reads are
dropped, and a streamed run leaves its intermediates on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..columns import Dataset, NumericColumn, VectorColumn
from . import stream
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
                          listener=None, responses: Optional[Set[str]] = None) -> FittedDAG:
    """Fit the layers' estimators on ``train`` in order, transforming it as
    the next fit needs (FitStagesUtil.fitAndTransformDAG:212).
    ``fitted_so_far`` maps stage uids to models applied instead of refitted;
    ``responses`` are columns kept however dead they look.  Transformer-only
    layers are deferred and flushed as one run before the next estimator
    layer and at the end (``_apply_pending``).  ``listener``, when given, is
    called as ``listener(layer_index, layer, seconds)`` with each layer's
    fit seconds and, for the last layer of a flushed run, the run's
    transform seconds."""
    import time

    fitted_so_far = fitted_so_far or {}
    responses = set(responses or ())
    fitted: List[PipelineStage] = []
    pending: List[Tuple[int, List[Transformer]]] = []

    def flush(train: Dataset) -> Dataset:
        if not pending:
            return train
        t0 = time.perf_counter()
        # the flushed vectors stay on the card for the fits that read them
        # (the sanity checker, the selector's sweep), as the layer path keeps
        # them, within the executor's handoff budget
        handoff = {f.name for _, ts in pending for t in ts for f in t.get_outputs()}
        train = _apply_pending(train, pending, dag, responses, handoff=handoff)
        if listener is not None:
            li = pending[-1][0]
            listener(li, dag[li], time.perf_counter() - t0)
        pending.clear()
        return train

    for li, layer in enumerate(dag):
        if any(isinstance(s, Estimator) and s.uid not in fitted_so_far for s in layer):
            train = flush(train)
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
        if listener is not None:
            listener(li, layer, time.perf_counter() - t0)
        pending.append((li, transformers))
    train = flush(train)
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
    """One layer on the layer path (applyOpTransformations analog,
    FitStagesUtil.scala:96)."""
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


#: past this many cells a dataset drops the columns no later stage reads,
#: and a streamed run materializes only the live ones (the Spark
#: persist/unpersist cadence analog, FitStagesUtil.scala:117,158)
FREE_INTERMEDIATES_CELLS = 100_000_000


def _dead_columns(dag: List[Layer], layer_idx: int, ds: Dataset) -> List[str]:
    """Columns no stage after ``layer_idx`` reads and that are not
    predictions (they feed evaluators after training)."""
    live: Set[str] = set()
    for later in dag[layer_idx + 1:]:
        for stage in later:
            for f in stage.inputs:
                live.add(f.name)
    if dag:
        for stage in dag[-1]:
            for f in stage.get_outputs():
                live.add(f.name)
    return [name for name, col in ds.columns.items()
            if name not in live
            and getattr(getattr(col, "ftype", None), "__name__", "") != "Prediction"]


def _total_cells(ds: Dataset) -> int:
    n = len(ds)
    return sum(n * (getattr(c, "width", None) or 1) for c in ds.columns.values())


def _maybe_free(dag: List[Layer], layer_idx: int, ds: Dataset, responses: Set[str]) -> Dataset:
    if _total_cells(ds) < FREE_INTERMEDIATES_CELLS:
        return ds
    dead = [c for c in _dead_columns(dag, layer_idx, ds) if c not in responses]
    return ds.drop(dead) if dead else ds


def _live_after(dag: List[Layer], layer_idx: int, responses: Set[str]) -> Set[str]:
    """Column names still needed after ``layer_idx``: the complement of
    ``_dead_columns`` for outputs not materialized yet."""
    live: Set[str] = set(responses)
    for later in dag[layer_idx + 1:]:
        for stage in later:
            for f in stage.inputs:
                live.add(f.name)
    if dag:
        for stage in dag[-1]:
            for f in stage.get_outputs():
                live.add(f.name)
    return live


def _apply_pending(ds: Dataset, pending: List[Tuple[int, List[Transformer]]],
                   dag: List[Layer], responses: Set[str],
                   handoff: Optional[Set[str]] = None) -> Dataset:
    """Apply a run of deferred transformer layers: past ``STREAM_ROWS`` rows
    as one streamed run (unless its planner declines), else layer by
    layer.  Liveness skips intermediates only past
    ``FREE_INTERMEDIATES_CELLS`` cells, as ``_maybe_free`` does."""
    last_li = pending[-1][0]
    if len(ds) > STREAM_ROWS:
        live = (_live_after(dag, last_li, responses)
                if _total_cells(ds) >= FREE_INTERMEDIATES_CELLS else None)
        out = stream.apply_streamed(ds, [ts for _, ts in pending], live=live, handoff=handoff)
        if out is not None:
            return _maybe_free(dag, last_li, out, responses)
    for li, ts in pending:
        ds = _apply_layer_transforms(ds, ts)
        ds = _maybe_free(dag, li, ds, responses)
    return ds


def apply_transformations_dag(ds: Dataset, dag: List[Layer],
                              keep: Optional[Sequence[str]] = None) -> Dataset:
    """Scoring path: every stage must already be a transformer
    (OpWorkflowCore.applyTransformationsDAG, OpWorkflowCore.scala:324).
    Past ``STREAM_ROWS`` rows the whole scoring DAG streams as one run;
    ``keep`` names the columns the caller reads afterwards, and past
    ``FREE_INTERMEDIATES_CELLS`` cells the other intermediates never leave
    the device (default: every output is kept)."""
    for layer in dag:
        for stage in layer:
            if not isinstance(stage, Transformer):
                raise TypeError(
                    f"Scoring DAG contains unfitted estimator {stage}; fit the workflow first")
    if dag and len(ds) > STREAM_ROWS:
        live = None
        if keep is not None and _total_cells(ds) >= FREE_INTERMEDIATES_CELLS:
            live = set(keep) | {f.name for s in dag[-1] for f in s.get_outputs()}
        out = stream.apply_streamed(ds, [list(layer) for layer in dag], live=live)
        if out is not None:
            return out
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
