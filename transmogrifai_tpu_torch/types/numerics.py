"""Numeric feature types.

Reference parity: features/.../types/Numerics.scala — ``Real``, ``RealNN``
(non-nullable; the label type), ``Binary``, ``Integral``, ``Percent``,
``Currency``, ``Date``, ``DateTime``; subclassing mirrors the reference
(``Currency extends Real``, ``DateTime extends Date extends Integral``).
"""
from __future__ import annotations

from typing import Optional

from .base import FeatureType, NonNullable, OPNumeric, SingleResponse, Categorical


class Real(OPNumeric):
    __slots__ = ()

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        return float(value)

    @property
    def v(self) -> Optional[float]:
        return self._value


class RealNN(Real, NonNullable):
    """Non-nullable real — the response/label type (Numerics.scala RealNN)."""

    __slots__ = ()

    def __init__(self, value):
        if value is None:
            raise ValueError("RealNN cannot be empty")
        super().__init__(value)


class Binary(OPNumeric, SingleResponse, Categorical):
    __slots__ = ()

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        return bool(value)

    def to_double(self) -> Optional[float]:
        return None if self._value is None else float(self._value)


class Integral(OPNumeric):
    __slots__ = ()

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        return int(value)


class Percent(Real):
    __slots__ = ()


class Currency(Real):
    __slots__ = ()


class Date(Integral):
    """Milliseconds since epoch (reference uses joda millis)."""

    __slots__ = ()


class DateTime(Date):
    __slots__ = ()
