"""Map feature types — one map type per scalar type, plus ``Prediction``.

Reference parity: features/.../types/Maps.scala — 24 map types mirroring
scalars (TextMap…StreetMap, BinaryMap:139, IntegralMap:152, RealMap:165,
PercentMap:178, CurrencyMap:189, DateMap:200, DateTimeMap:211,
MultiPickListMap:222, GeolocationMap:325, NameStats:288) and **Prediction**
(Maps.scala:339) — the model-output type holding ``prediction`` /
``rawPrediction_*`` / ``probability_*`` keys.
"""
from __future__ import annotations

from typing import ClassVar, Dict, List, Optional, Type

from .base import FeatureType, Location, NonNullable, OPMap
from . import numerics as _num
from . import text as _text
from . import collections as _coll


def _map_of(element: Type[FeatureType], convert):
    """Internal: build the _convert classmethod for a typed map."""

    def _convert(cls, value):
        if value is None:
            return {}
        return {str(k): convert(v) for k, v in dict(value).items()}

    return classmethod(_convert)


class TextMap(OPMap):
    __slots__ = ()
    kind = "text_map"
    ElementType = _text.Text
    _convert = _map_of(_text.Text, str)


class EmailMap(TextMap):
    __slots__ = ()
    ElementType = _text.Email


class Base64Map(TextMap):
    __slots__ = ()
    ElementType = _text.Base64


class PhoneMap(TextMap):
    __slots__ = ()
    ElementType = _text.Phone


class IDMap(TextMap):
    __slots__ = ()
    ElementType = _text.ID


class URLMap(TextMap):
    __slots__ = ()
    ElementType = _text.URL


class TextAreaMap(TextMap):
    __slots__ = ()
    ElementType = _text.TextArea


class PickListMap(TextMap):
    __slots__ = ()
    ElementType = _text.PickList


class ComboBoxMap(TextMap):
    __slots__ = ()
    ElementType = _text.ComboBox


class CountryMap(TextMap, Location):
    __slots__ = ()
    ElementType = _text.Country


class StateMap(TextMap, Location):
    __slots__ = ()
    ElementType = _text.State


class CityMap(TextMap, Location):
    __slots__ = ()
    ElementType = _text.City


class PostalCodeMap(TextMap, Location):
    __slots__ = ()
    ElementType = _text.PostalCode


class StreetMap(TextMap, Location):
    __slots__ = ()
    ElementType = _text.Street


class BinaryMap(OPMap):
    __slots__ = ()
    kind = "binary_map"
    ElementType = _num.Binary
    _convert = _map_of(_num.Binary, bool)


class IntegralMap(OPMap):
    __slots__ = ()
    kind = "integral_map"
    ElementType = _num.Integral
    _convert = _map_of(_num.Integral, int)


class RealMap(OPMap):
    __slots__ = ()
    kind = "real_map"
    ElementType = _num.Real
    _convert = _map_of(_num.Real, float)


class PercentMap(RealMap):
    __slots__ = ()
    ElementType = _num.Percent


class CurrencyMap(RealMap):
    __slots__ = ()
    ElementType = _num.Currency


class DateMap(IntegralMap):
    __slots__ = ()
    ElementType = _num.Date


class DateTimeMap(DateMap):
    __slots__ = ()
    ElementType = _num.DateTime


class MultiPickListMap(OPMap):
    __slots__ = ()
    kind = "multipicklist_map"
    ElementType = _coll.MultiPickList

    @classmethod
    def _convert(cls, value):
        if value is None:
            return {}
        return {str(k): {str(x) for x in v} for k, v in dict(value).items()}


class GeolocationMap(OPMap):
    __slots__ = ()
    kind = "geolocation_map"
    ElementType = _coll.Geolocation

    @classmethod
    def _convert(cls, value):
        if value is None:
            return {}
        return {str(k): [float(x) for x in v] for k, v in dict(value).items()}


class NameStats(TextMap):
    """Name-detection statistics map (Maps.scala:288).

    Keys mirror the reference's NameStats.Key enum: isNameIndicator,
    originalName, genderValue.
    """

    __slots__ = ()

    KEY_IS_NAME = "isNameIndicator"
    KEY_ORIGINAL = "originalName"
    KEY_GENDER = "genderValue"


class Prediction(RealMap, NonNullable):
    """Model output (Maps.scala:339): ``prediction`` + ``rawPrediction_*`` +
    ``probability_*`` keys; non-nullable, ``prediction`` key required.
    """

    __slots__ = ()
    kind = "prediction"

    PredictionName: ClassVar[str] = "prediction"
    RawPredictionName: ClassVar[str] = "rawPrediction"
    ProbabilityName: ClassVar[str] = "probability"

    def __init__(self, value=None, *, prediction: Optional[float] = None,
                 raw_prediction=None, probability=None):
        if value is None:
            value = {}
            if prediction is not None:
                value[self.PredictionName] = float(prediction)
            if raw_prediction is not None:
                for i, v in enumerate(raw_prediction):
                    value[f"{self.RawPredictionName}_{i}"] = float(v)
            if probability is not None:
                for i, v in enumerate(probability):
                    value[f"{self.ProbabilityName}_{i}"] = float(v)
        super().__init__(value)
        if self.PredictionName not in self._value:
            raise ValueError(
                f"Prediction map must contain a '{self.PredictionName}' key, got {sorted(self._value)}")

    @property
    def prediction(self) -> float:
        return self._value[self.PredictionName]

    @property
    def raw_prediction(self) -> List[float]:
        pfx = self.RawPredictionName + "_"
        keys = sorted((k for k in self._value if k.startswith(pfx)),
                      key=lambda k: int(k[len(pfx):]))
        return [self._value[k] for k in keys]

    @property
    def probability(self) -> List[float]:
        pfx = self.ProbabilityName + "_"
        keys = sorted((k for k in self._value if k.startswith(pfx)),
                      key=lambda k: int(k[len(pfx):]))
        return [self._value[k] for k in keys]

    def to_dict(self) -> Dict[str, float]:
        return dict(self._value)
