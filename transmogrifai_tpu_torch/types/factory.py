"""Runtime type construction and per-type empty defaults.

Reference parity: features/.../types/FeatureTypeFactory.scala and
FeatureTypeDefaults.scala — construct a FeatureType instance from a raw
value given the type, and provide the canonical empty instance per type.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Type

from . import base, collections as _coll, maps as _maps, numerics as _num, text as _text
from .base import FeatureType


def _all_concrete_types():
    out = []
    for mod in (_num, _text, _coll, _maps):
        for name in dir(mod):
            obj = getattr(mod, name)
            if (isinstance(obj, type) and issubclass(obj, FeatureType)
                    and obj.__module__ == mod.__name__):
                out.append(obj)
    return out


#: name -> type for every concrete feature type
FEATURE_TYPES: Dict[str, Type[FeatureType]] = {t.__name__: t for t in _all_concrete_types()}


def feature_type_by_name(name: str) -> Type[FeatureType]:
    if name == "FeatureType":
        # type-polymorphic stages (alias/filter/replace) declare the base
        return FeatureType
    try:
        return FEATURE_TYPES[name]
    except KeyError:
        raise ValueError(f"Unknown feature type: {name!r}") from None


def make(ftype: Type[FeatureType], value: Any) -> FeatureType:
    """Construct an instance of ``ftype`` from a raw value.

    Reference parity: FeatureTypeFactory.scala — the runtime factory used by
    readers and transformers to lift raw values into typed values.
    """
    if isinstance(value, FeatureType):
        value = value.value
    return ftype(value)


def default_of(ftype: Type[FeatureType]) -> FeatureType:
    """The canonical empty instance (FeatureTypeDefaults.scala).

    NonNullable numeric types default to 0.0 / empty-but-valid values
    (RealNN(0.0), Prediction(prediction=0.0)) matching the reference's
    defaults for non-nullable types.
    """
    if issubclass(ftype, _maps.Prediction):
        return ftype(prediction=0.0)
    if issubclass(ftype, _num.RealNN):
        return ftype(0.0)
    return ftype(None)


def is_nullable(ftype: Type[FeatureType]) -> bool:
    return not issubclass(ftype, base.NonNullable)
