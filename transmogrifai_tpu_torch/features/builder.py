"""FeatureBuilder — the user entry point for defining raw features.

Reference parity: features/src/main/scala/com/salesforce/op/features/FeatureBuilder.scala:48 —
``FeatureBuilder.Text[Passenger].extract(...).asPredictor`` and
``FeatureBuilder.fromDataFrame[RealNN](df, response=...)`` which auto-infers
features from a schema (:232).

Python surface::

    age  = FeatureBuilder.real("age").extract(field="age").as_predictor()
    name = FeatureBuilder.text("name").extract(lambda r: r["name"]).as_predictor()
    feats, label = FeatureBuilder.from_dataframe(df, response="survived")
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Type, Union

import numpy as np

from .. import types as T
from .aggregators import MonoidAggregator
from .feature import Feature
from .generator import Extractor, FieldExtractor, FnExtractor, FeatureGeneratorStage


class FeatureBuilderWithExtract:
    """Second step: extractor attached, choose predictor/response + aggregation
    (reference FeatureBuilderWithExtract, FeatureBuilder.scala:297)."""

    def __init__(self, name: str, ftype: Type[T.FeatureType], extractor: Extractor):
        self.name = name
        self.ftype = ftype
        self.extractor = extractor
        self._aggregator: Optional[MonoidAggregator] = None
        self._window_ms: Optional[int] = None

    def aggregate(self, aggregator: MonoidAggregator) -> "FeatureBuilderWithExtract":
        self._aggregator = aggregator
        return self

    def window(self, window_ms: int) -> "FeatureBuilderWithExtract":
        self._window_ms = window_ms
        return self

    def _build(self, is_response: bool) -> Feature:
        stage = FeatureGeneratorStage(
            extract_fn=self.extractor, output_type=self.ftype, output_name=self.name,
            is_response=is_response, aggregator=self._aggregator,
            aggregate_window_ms=self._window_ms)
        return stage.get_output()

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)


class FeatureBuilder:
    """First step: named + typed; ``extract`` attaches the extract function."""

    def __init__(self, name: str, ftype: Type[T.FeatureType]):
        self.name = name
        self.ftype = ftype

    def extract(self, fn: Optional[Callable[[Any], Any]] = None, *,
                field: Optional[str] = None) -> FeatureBuilderWithExtract:
        if (fn is None) == (field is None):
            raise ValueError("extract() takes exactly one of fn= or field=")
        extractor: Extractor
        if field is not None:
            extractor = FieldExtractor(field, self.ftype)
        else:
            extractor = FnExtractor(fn, self.ftype)
        return FeatureBuilderWithExtract(self.name, self.ftype, extractor)

    def from_field(self) -> FeatureBuilderWithExtract:
        """Extract the record field with the same name as the feature."""
        return self.extract(field=self.name)

    # ---- typed constructors (FeatureBuilder.Text / .Real / ... analog) -----
    @classmethod
    def _typed(cls, ftype: Type[T.FeatureType]):
        def ctor(name: str) -> "FeatureBuilder":
            return cls(name, ftype)
        return ctor


# install FeatureBuilder.real / .text / ... for every concrete type
for _name, _t in T.FEATURE_TYPES.items():
    _snake = "".join(("_" + c.lower() if c.isupper() and i else c.lower())
                     for i, c in enumerate(_name))
    setattr(FeatureBuilder, _snake, staticmethod(FeatureBuilder._typed(_t)))
    setattr(FeatureBuilder, _name, staticmethod(FeatureBuilder._typed(_t)))


def _infer_ftype(dtype, series=None) -> Type[T.FeatureType]:
    """Schema inference for from_dataframe (FeatureBuilder.scala:232
    fromDataFrame maps Spark SQL types to feature types), by numpy dtype
    kind: the same mapping as the JAX package's pandas dtype checks."""
    kind = getattr(dtype, "kind", "O")  # numpy and pandas dtypes both carry it
    if kind == "b":
        return T.Binary
    if kind in "iu":
        return T.Integral
    if kind == "f":
        return T.Real
    if kind == "M":
        return T.DateTime
    return T.Text


def from_dataframe(df, response: str,
                   response_type: Type[T.FeatureType] = T.RealNN,
                   feature_types: Optional[Dict[str, Type[T.FeatureType]]] = None,
                   ignore: Tuple[str, ...] = (),
                   ) -> Tuple[List[Feature], Feature]:
    """Auto-infer raw features from a DataFrame schema (or a
    ``dict[str, np.ndarray]``: anything with ``.columns`` and ``[name].dtype``).

    Returns (predictor features, response feature).  Reference parity:
    ``FeatureBuilder.fromDataFrame`` (FeatureBuilder.scala:232).
    """
    if response not in df.columns:
        raise ValueError(
            f"Response feature {response!r} is not present in the dataframe: {list(df.columns)}")
    feature_types = feature_types or {}
    label = FeatureBuilder(response, response_type).extract(field=response).as_response()
    feats: List[Feature] = []
    for col in df.columns:
        if col == response or col in ignore:
            continue
        ftype = feature_types.get(col) or _infer_ftype(df[col].dtype, df[col])
        feats.append(FeatureBuilder(col, ftype).extract(field=col).as_predictor())
    return feats, label


FeatureBuilder.from_dataframe = staticmethod(from_dataframe)
