"""The selected model on the scoring path.

The port's copy of ``SelectedModel`` and ``ModelSelectorSummary`` from
``transmogrifai_tpu/impl/selector/model_selector.py`` (reference:
ModelSelector.scala:224, ModelSelectorSummary.scala:61).  The selection
sweep itself is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .predictor import PredictorModel


def _scrub(obj: Any) -> Any:
    """Plain-JSON scrub: numpy scalars/arrays -> python values."""
    if isinstance(obj, dict):
        return {str(k): _scrub(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    return obj


@dataclass
class ModelSelectorSummary:
    """Serializable selection report (ModelSelectorSummary.scala:61)."""

    validation_type: str
    validation_parameters: Dict[str, Any]
    data_prep_parameters: Dict[str, Any]
    data_prep_results: Optional[Dict[str, Any]]
    evaluation_metric: str
    problem_type: str
    best_model_uid: str
    best_model_name: str
    best_model_type: str
    best_grid: Dict[str, Any]
    validation_results: List[Dict[str, Any]] = field(default_factory=list)
    train_evaluation: Dict[str, Any] = field(default_factory=dict)
    holdout_evaluation: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return _scrub({
            "validationType": self.validation_type,
            "validationParameters": self.validation_parameters,
            "dataPrepParameters": self.data_prep_parameters,
            "dataPrepResults": self.data_prep_results,
            "evaluationMetric": self.evaluation_metric,
            "problemType": self.problem_type,
            "bestModelUID": self.best_model_uid,
            "bestModelName": self.best_model_name,
            "bestModelType": self.best_model_type,
            "bestGrid": self.best_grid,
            "validationResults": self.validation_results,
            "trainEvaluation": self.train_evaluation,
            "holdoutEvaluation": self.holdout_evaluation,
        })

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ModelSelectorSummary":
        return ModelSelectorSummary(
            validation_type=d["validationType"],
            validation_parameters=d.get("validationParameters", {}),
            data_prep_parameters=d.get("dataPrepParameters", {}),
            data_prep_results=d.get("dataPrepResults"),
            evaluation_metric=d.get("evaluationMetric", ""),
            problem_type=d.get("problemType", "Unknown"),
            best_model_uid=d.get("bestModelUID", ""),
            best_model_name=d.get("bestModelName", ""),
            best_model_type=d.get("bestModelType", ""),
            best_grid=d.get("bestGrid", {}),
            validation_results=d.get("validationResults", []),
            train_evaluation=d.get("trainEvaluation", {}),
            holdout_evaluation=d.get("holdoutEvaluation"),
        )


class SelectedModel(PredictorModel):
    """The winning candidate wrapped as a transformer (ModelSelector.scala:224)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.summary: Optional[ModelSelectorSummary] = None

    def transform_columns(self, cols):
        out = super().transform_columns(cols)
        # summary travels on the output column (reference: summary metadata in
        # the output column schema) so SelectedModelCombiner can read it
        if self.summary is not None:
            out.metadata = {"model_selector_summary": self.summary.to_json()}
        return out
