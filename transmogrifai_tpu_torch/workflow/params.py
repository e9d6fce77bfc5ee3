"""OpParams — the JSON-loadable runtime configuration object.

Reference parity: features/src/main/scala/com/salesforce/op/OpParams.scala:81-97 —
``stageParams`` (per-stage overrides by class name or uid), ``readerParams``,
``modelLocation``, ``writeLocation``, ``metricsLocation``, ``customParams``,
``alternateReaderParams``, ``collectStageMetrics``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class OpParams:
    stage_params: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    reader_params: Dict[str, Any] = field(default_factory=dict)
    alternate_reader_params: Dict[str, Any] = field(default_factory=dict)
    model_location: Optional[str] = None
    write_location: Optional[str] = None
    metrics_location: Optional[str] = None
    custom_params: Dict[str, Any] = field(default_factory=dict)
    collect_stage_metrics: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {
            "stageParams": self.stage_params,
            "readerParams": self.reader_params,
            "alternateReaderParams": self.alternate_reader_params,
            "modelLocation": self.model_location,
            "writeLocation": self.write_location,
            "metricsLocation": self.metrics_location,
            "customParams": self.custom_params,
            "collectStageMetrics": self.collect_stage_metrics,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "OpParams":
        return OpParams(
            stage_params=d.get("stageParams", {}),
            reader_params=d.get("readerParams", {}),
            alternate_reader_params=d.get("alternateReaderParams", {}),
            model_location=d.get("modelLocation"),
            write_location=d.get("writeLocation"),
            metrics_location=d.get("metricsLocation"),
            custom_params=d.get("customParams", {}),
            collect_stage_metrics=bool(d.get("collectStageMetrics", False)),
        )

    @staticmethod
    def load(path: str) -> "OpParams":
        with open(path) as fh:
            return OpParams.from_json(json.load(fh))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2)
