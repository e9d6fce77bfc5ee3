"""FeatureGeneratorStage — the DAG origin stage for raw features.

Reference parity: features/.../stages/FeatureGeneratorStage.scala:67 — holds
the extract function, a MonoidAggregator and an optional time window for
event aggregation (GenericFeatureAggregator, aggregators/FeatureAggregator.scala:100).

Serialization note (SURVEY §7 "Hard parts"): the reference serializes extract
closures by source string; we use *declarative extractor specs* instead —
a named-field extractor is fully serializable, arbitrary callables are
supported in-session and flagged at save time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Type

from .. import types as T
from ..stages.base import PipelineStage
from .aggregators import Event, MonoidAggregator, default_aggregator


class Extractor:
    """Declarative extract function: record -> FeatureType."""

    spec: Dict[str, Any]

    def __call__(self, record: Any) -> T.FeatureType:
        raise NotImplementedError


@dataclass
class FieldExtractor(Extractor):
    """Extract a named field from a mapping/attribute record — serializable."""

    field_name: str
    ftype: Type[T.FeatureType]

    def __call__(self, record: Any) -> T.FeatureType:
        if isinstance(record, dict):
            raw = record.get(self.field_name)
        else:
            raw = getattr(record, self.field_name, None)
        if isinstance(raw, float) and raw != raw:  # NaN -> missing
            raw = None
        if raw is None:
            # Missing field: fall back to the type default so scoring data
            # without e.g. the label column still flows (the reference scores
            # unlabeled data the same way — nullable-everywhere semantics;
            # RealNN default is 0.0 and evaluators mask unlabeled rows).
            return T.default_of(self.ftype)
        return T.make(self.ftype, raw)

    @property
    def spec(self) -> Dict[str, Any]:
        return {"kind": "field", "field": self.field_name, "type": self.ftype.__name__}


@dataclass
class FnExtractor(Extractor):
    """Arbitrary callable extractor — not serializable across processes."""

    fn: Callable[[Any], Any]
    ftype: Type[T.FeatureType]

    def __call__(self, record: Any) -> T.FeatureType:
        out = self.fn(record)
        if isinstance(out, T.FeatureType):
            return out
        return T.make(self.ftype, out)

    @property
    def spec(self) -> Dict[str, Any]:
        return {"kind": "fn", "type": self.ftype.__name__,
                "repr": getattr(self.fn, "__name__", repr(self.fn))}


def extractor_from_spec(spec: Dict[str, Any]) -> Extractor:
    if spec.get("kind") == "field":
        return FieldExtractor(spec["field"], T.feature_type_by_name(spec["type"]))
    raise ValueError(f"Cannot reconstruct extractor from spec: {spec!r}")


class FeatureGeneratorStage(PipelineStage):
    """Origin stage of a raw feature (FeatureGeneratorStage.scala:67)."""

    def __init__(self, extract_fn: Extractor, output_type: Type[T.FeatureType],
                 output_name: str, is_response: bool = False,
                 aggregator: Optional[MonoidAggregator] = None,
                 aggregate_window_ms: Optional[int] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name=f"FeatureGeneratorStage_{output_name}",
                         output_type=output_type, uid=uid)
        self.extract_fn = extract_fn
        self._output_name = output_name
        self.is_response = is_response
        self.aggregator = aggregator or default_aggregator(output_type)
        self.aggregate_window_ms = aggregate_window_ms

    def output_name(self, index: int = 0) -> str:
        return self._output_name

    def output_is_response(self) -> bool:
        return self.is_response

    def extract(self, record: Any) -> T.FeatureType:
        return self.extract_fn(record)

    def aggregate(self, events: Sequence[Event], cutoff_ms: Optional[int] = None,
                  responses_after_cutoff: bool = False,
                  response_window_inclusive: bool = True) -> T.FeatureType:
        """GenericFeatureAggregator semantics (FeatureAggregator.scala:100):
        predictors aggregate events strictly *before* the cutoff, responses
        events *at/after* it; the optional window further restricts the range.

        ``response_window_inclusive``: the plain aggregate path bounds the
        response window INCLUSIVELY (date <= cutoff + window,
        FeatureAggregator.scala:121) but the post-join aggregation uses an
        EXCLUSIVE bound (timeStamp < cutOff + timeWindow,
        JoinedDataReader.scala:434) — JoinedAggregateReader passes False.
        """
        sel = events
        if cutoff_ms is not None:
            if responses_after_cutoff:
                sel = [e for e in events if e.time >= cutoff_ms]
                if self.aggregate_window_ms is not None:
                    hi = cutoff_ms + self.aggregate_window_ms
                    sel = [e for e in sel
                           if (e.time <= hi if response_window_inclusive
                               else e.time < hi)]
            else:
                sel = [e for e in events if e.time < cutoff_ms]
                if self.aggregate_window_ms is not None:
                    sel = [e for e in sel if e.time >= cutoff_ms - self.aggregate_window_ms]
        return self.aggregator.aggregate(self.output_type, sel)
