"""Per-record and batched scoring functions (OpWorkflowModelLocal.scala:42-80).

The port's copy of ``transmogrifai_tpu/local/scoring.py``.  ``ScoreFunction``
threads one record through every stage's row path; ``BatchScoreFunction``
assembles the records into a columnar ``Dataset`` and runs the model's
batch DAG once for the whole batch: the request path of the serving plane.
Both score on the device the model was loaded on.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from .. import types as T
from ..columns import Dataset, column_from_scalars
from ..features.generator import FeatureGeneratorStage
from ..stages.base import Transformer
from ..workflow import dag as dag_util
from ..workflow.model import OpWorkflowModel, load_model


def _emit(v: Any) -> Any:
    """Scored FeatureType -> plain JSON-able value (shared by row/batch paths)."""
    if isinstance(v, T.Prediction):
        return v.to_dict()
    if isinstance(v, T.FeatureType):
        val = v.value
        return val.tolist() if isinstance(val, np.ndarray) else val
    return v


def _placed(model: OpWorkflowModel) -> None:
    """A model must sit on a device before it scores: ``load_model`` places
    it; an unplaced one goes to the CUDA card (raising when there is none)."""
    if model.device is None:
        model.to(None)


def _check_fitted(model: OpWorkflowModel) -> None:
    for layer in model.dag:
        for stage in layer:
            if not isinstance(stage, Transformer):
                raise TypeError(
                    f"Model contains unfitted estimator {stage}; train first")


class ScoreFunction:
    """Callable record -> scores dict; precomputed stage schedule."""

    def __init__(self, model: OpWorkflowModel):
        _placed(model)
        self._raw_features = list(model.raw_features)
        _check_fitted(model)
        self._schedule: List[Transformer] = [s for layer in model.dag for s in layer]
        self._result_names = [f.name for f in model.result_features]

    def __call__(self, record: Dict[str, Any]) -> Dict[str, Any]:
        row: Dict[str, T.FeatureType] = {}
        for f in self._raw_features:
            stage = f.origin_stage
            if isinstance(stage, FeatureGeneratorStage):
                row[f.name] = stage.extract(record)
            else:  # already-typed input
                v = record.get(f.name)
                row[f.name] = v if isinstance(v, T.FeatureType) else T.make(f.ftype, v)
        for stage in self._schedule:
            outs = stage.get_outputs()
            if stage.n_outputs == 1:
                row[outs[0].name] = stage.transform_row(row)
            else:
                vals = stage.transform_row(row)
                for f, v in zip(outs, vals):
                    row[f.name] = v
        out: Dict[str, Any] = {}
        for name in self._result_names:
            v = row.get(name)
            if v is None:
                continue
            out[name] = _emit(v)
        return out


class BatchScoreFunction:
    """Callable records -> list of score dicts, vectorized.

    Record dicts are assembled into a columnar ``Dataset`` (same per-feature
    extraction contract as ``ScoreFunction``) and scored through the fitted
    DAG's batch transform path once for the whole batch.  Output dicts match
    ``ScoreFunction``'s format element-for-element, so the two paths are
    interchangeable (serve/ falls back from this to the row path on error).
    """

    def __init__(self, model: OpWorkflowModel):
        _placed(model)
        self._raw_features = list(model.raw_features)
        _check_fitted(model)
        self._dag = model.dag
        self._result_names = [f.name for f in model.result_features]

    def records_to_dataset(self, records: Sequence[Dict[str, Any]]) -> Dataset:
        """Record dicts -> raw-feature Dataset (the reader-less ingest path)."""
        cols: Dict[str, Any] = {}
        for f in self._raw_features:
            stage = f.origin_stage
            if isinstance(stage, FeatureGeneratorStage):
                vals = [stage.extract(r) for r in records]
            else:
                vals = [v if isinstance(v, T.FeatureType) else T.make(f.ftype, v)
                        for v in (r.get(f.name) for r in records)]
            cols[f.name] = column_from_scalars(f.ftype, vals)
        keys = np.arange(len(records)).astype(str).astype(object)
        return Dataset(cols, keys)

    def __call__(self, records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        records = list(records)
        if not records:
            return []
        raw = self.records_to_dataset(records)
        full = dag_util.apply_transformations_dag(raw, self._dag, keep=self._result_names)
        out_cols = [(n, full[n]) for n in self._result_names if n in full.columns]
        return [{n: _emit(col.to_scalar(i)) for n, col in out_cols}
                for i in range(len(records))]


def score_function(model: OpWorkflowModel) -> ScoreFunction:
    """model.scoreFunction analog."""
    return ScoreFunction(model)


def batch_score_function(model: OpWorkflowModel) -> BatchScoreFunction:
    """Vectorized many-records scorer (the serve/ bucket path)."""
    return BatchScoreFunction(model)


def load_model_local(path: str, device=None) -> ScoreFunction:
    """Load a saved model directly as a local score function
    (OpWorkflowModel.loadModel + scoreFunction in one step)."""
    return ScoreFunction(load_model(path, device))
