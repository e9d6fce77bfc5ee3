"""OpWorkflow — the training entry point.

The port's counterpart of ``transmogrifai_tpu/workflow/workflow.py``
(reference OpWorkflow.scala:61): ``set_result_features`` rebuilds the DAG
from feature lineage (:90), ``set_input_dataset`` wires the reader, and
``train(device=None)`` reads the data, fits the DAG layer by layer on the
device and returns an ``OpWorkflowModel``.  With exactly one ModelSelector
in the DAG, training takes the workflow-level CV path (OpWorkflow.scala:
403-453): the label-using feature stages upstream of the selector are refit
on every fold's training rows.  ``device=None`` is the CUDA card, and a host
without one raises; ``device="cpu"`` runs the kernels' plain versions.
The raw-feature filter and warm starts from fitted models are not ported.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Union

from ..columns import Dataset
from ..features.feature import Feature
from ..readers.base import CustomReader, Reader
from ..stages.base import PipelineStage
from ..utils.device import resolve_device
from . import dag as dag_util
from .model import OpWorkflowModel
from .params import OpParams


class OpWorkflow:
    """The user-facing workflow (OpWorkflow.scala:61)."""

    def __init__(self):
        self.reader: Optional[Reader] = None
        self.result_features: List[Feature] = []
        self.raw_features: List[Feature] = []
        self.stages: List[PipelineStage] = []
        self.dag: List[dag_util.Layer] = []
        self.parameters: OpParams = OpParams()
        #: host seconds of the last ``train``, by phase (reader, each DAG
        #: layer's fit + transform, the selector's sweep, refit and holdout)
        self.train_timings: Dict[str, float] = {}

    # ---- wiring (OpWorkflowCore.scala:147-176) -----------------------------
    def set_reader(self, reader: Reader) -> "OpWorkflow":
        self.reader = reader
        return self

    def set_input_dataset(self, data: Any, key: Union[str, Callable, None] = None
                          ) -> "OpWorkflow":
        """``data``: numpy columns (``dict[str, np.ndarray]``), a pandas
        DataFrame or record dicts."""
        self.reader = CustomReader(data, key=key)
        return self

    def set_parameters(self, params: OpParams) -> "OpWorkflow":
        self.parameters = params
        return self

    def set_result_features(self, *features: Feature) -> "OpWorkflow":
        """Reconstruct the DAG from the result features' lineage
        (OpWorkflow.scala:90)."""
        if not features:
            raise ValueError("At least one result feature is required")
        self.result_features = list(features)
        self.dag = dag_util.compute_dag(self.result_features)
        self.stages = [s for layer in self.dag for s in layer]
        raw: Dict[str, Feature] = {}
        for rf in self.result_features:
            for f in rf.raw_features():
                raw[f.uid] = f
        self.raw_features = sorted(raw.values(), key=lambda f: f.name)
        seen: Dict[str, PipelineStage] = {}
        for s in self.stages:
            if s.uid in seen and seen[s.uid] is not s:
                raise ValueError(f"Duplicate stage uid {s.uid!r} on distinct stages")
            seen[s.uid] = s
        return self

    # ---- training (OpWorkflow.scala:347) -----------------------------------
    def train(self, params: Optional[Dict[str, Any]] = None,
              device=None) -> OpWorkflowModel:
        """Fit the workflow on ``device`` (``None``: the CUDA card)."""
        dev = resolve_device(device)
        if self.reader is None:
            raise ValueError("A reader must be set before reading data "
                             "(set_reader / set_input_dataset)")
        for s in self.stages:
            s.to(dev)
        timings: Dict[str, float] = {}
        self.train_timings = timings
        t0 = time.perf_counter()
        p = dict(self.parameters.reader_params)
        p.update(params or {})
        data = self.reader.generate_dataset(self.raw_features, p)
        timings["reader"] = time.perf_counter() - t0

        def layer_timer(prefix):
            def record(li, layer, seconds):
                key = f"{prefix}layer{li}:" + "+".join(sorted({type(s).__name__
                                                              for s in layer}))
                timings[key] = timings.get(key, 0.0) + seconds
            return record

        selectors = [s for s in self.stages if getattr(s, "is_model_selector", False)]
        if len(selectors) == 1:
            fitted = self._fit_stages_cv(data, layer_timer)
        else:
            fitted = dag_util.fit_and_transform_dag(self.dag, data, listener=layer_timer(""),
                                                    responses=self._response_names())
        for s in selectors:
            timings.update(getattr(s, "fit_timings", {}))

        model = OpWorkflowModel()
        model.reader = self.reader
        model.parameters = self.parameters
        model.result_features = self.result_features
        model.raw_features = self.raw_features
        model.stages = fitted.fitted_stages
        by_uid = {s.uid: s for s in fitted.fitted_stages}
        model.dag = [[by_uid.get(s.uid, s) for s in layer] for layer in self.dag]
        model.device = dev
        model.train_data = fitted.train
        return model

    def _response_names(self) -> set:
        """Names that must survive the freeing of intermediate columns: the
        responses (labels feed the selector and evaluators) and the result
        features."""
        return ({f.name for f in self.raw_features if f.is_response}
                | {f.name for f in self.result_features})

    def _fit_stages_cv(self, data: Dataset, layer_timer) -> dag_util.FittedDAG:
        """The workflow-level CV path: fit the before-DAG once, let the
        selector refit the during-DAG per fold in its sweep, then fit the
        during + after DAG with the winner pinned."""
        cut = dag_util.cut_dag(self.dag)
        before = dag_util.fit_and_transform_dag(cut.before, data,
                                                listener=layer_timer("before:"),
                                                responses=self._response_names())
        selector = cut.model_selector
        feature_layers = [layer for layer in cut.during
                          if not (len(layer) == 1 and layer[0] is selector)]
        if feature_layers:
            t0 = time.perf_counter()
            selector.find_best_estimator_cv(feature_layers, before.train)
            self.train_timings["workflow_cv"] = time.perf_counter() - t0
        rest = dag_util.fit_and_transform_dag(cut.during + cut.after, before.train,
                                              listener=layer_timer("final:"),
                                              responses=self._response_names())
        return dag_util.FittedDAG(train=rest.train,
                                  fitted_stages=before.fitted_stages + rest.fitted_stages)
