"""OpWorkflowModel — the fitted workflow, scoring on a device.

The port's counterpart of ``transmogrifai_tpu/workflow/model.py`` (reference
OpWorkflowModel.scala:60): ``score`` (:261), ``score_fn`` (:333) and
``save`` (:224).  A model is placed on one device when it is trained or
loaded (``load_model(path, device)``); every stage computes there.
Evaluation and insights are not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..columns import Dataset
from ..features.feature import Feature
from ..stages.base import PipelineStage
from ..utils.device import resolve_device
from . import dag as dag_util
from .params import OpParams


class OpWorkflowModel:
    """Fitted workflow: result features, raw features and the stage DAG."""

    def __init__(self):
        self.result_features: List[Feature] = []
        self.raw_features: List[Feature] = []
        self.blocklisted_features: List[Feature] = []
        self.blocklisted_map_keys: Dict[str, List[str]] = {}
        self.stages: List[PipelineStage] = []
        self.dag: List[dag_util.Layer] = []
        self.parameters: OpParams = OpParams()
        self.device: Optional[torch.device] = None
        #: the training reader and transformed training data (``train`` only)
        self.reader = None
        self.train_data: Optional[Dataset] = None

    def to(self, device=None) -> "OpWorkflowModel":
        """Place every stage on ``device`` (``None``: the CUDA card)."""
        self.device = resolve_device(device)
        for s in self.stages:
            s.to(self.device)
        return self

    # ---- scoring (OpWorkflowModel.scala:261,333) ---------------------------
    def score_fn(self) -> Callable[[Dataset], Dataset]:
        """Precompute the scoring DAG once; returns dataset -> scored dataset."""
        dag = self.dag
        names = [f.name for f in self.result_features]

        def fn(raw: Dataset) -> Dataset:
            full = dag_util.apply_transformations_dag(raw, dag, keep=names)
            return full.select([n for n in names if n in full.columns])

        return fn

    def score(self, data: Any = None, params: Optional[Dict[str, Any]] = None,
              keep_raw_features: bool = False,
              keep_intermediate_features: bool = False) -> Dataset:
        """Score a dataset (defaults: KeepRawFeatures=false,
        KeepIntermediateFeatures=false — OpWorkflowModel.scala:458-463).
        ``data``: a ``Dataset`` of raw features, numpy columns
        (``dict[str, np.ndarray]``), a pandas DataFrame or record dicts."""
        raw = self._raw_for_scoring(data, params)
        names = [f.name for f in self.result_features]
        # the streamed scoring path's liveness hint: intermediates can stay
        # on the device unless the caller asked to keep them
        hint = None if keep_intermediate_features else \
            names + ([f.name for f in self.raw_features] if keep_raw_features else [])
        full = dag_util.apply_transformations_dag(raw, self.dag, keep=hint)
        if keep_intermediate_features:
            keep = full.column_names()
        elif keep_raw_features:
            keep = [f.name for f in self.raw_features if f.name in full.columns] + \
                   [n for n in names if n in full.columns]
        else:
            keep = [n for n in names if n in full.columns]
        return full.select(dict.fromkeys(keep))

    def _raw_for_scoring(self, data: Any, params: Optional[Dict[str, Any]]) -> Dataset:
        if isinstance(data, Dataset):
            return data
        if data is None:
            raise ValueError("score() needs data: a loaded model carries no reader")
        from ..readers.base import CustomReader

        return CustomReader(data).generate_dataset(self.raw_features, params)

    def save(self, path: str, overwrite: bool = True) -> None:
        """Save in the JAX package's format (``op_model.json`` +
        ``op_model_arrays.npz``): both packages load the result."""
        from .serialization import save_model

        save_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str, device=None) -> "OpWorkflowModel":
        from .serialization import load_model

        return load_model(path, device)


def load_model(path: str, device=None) -> OpWorkflowModel:
    """Module-level loader (OpWorkflow.loadModel analog, OpWorkflow.scala:483)."""
    return OpWorkflowModel.load(path, device)
