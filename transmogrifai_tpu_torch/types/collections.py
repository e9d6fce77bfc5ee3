"""List/set/vector/geolocation feature types.

Reference parity: features/.../types/{Lists,Sets,Geolocation,OPVector}.scala —
``TextList``, ``DateList``, ``DateTimeList``, ``MultiPickList``,
``Geolocation`` (lat/lon/accuracy), ``OPVector``.  Where the reference wraps
``ml.linalg.Vector``, we wrap a numpy array (dense f32/f64) — the natural
columnar/XLA representation.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .base import Location, OPList, OPSet, OPCollection


class TextList(OPList):
    __slots__ = ()
    kind = "text_list"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return []
        return [str(v) for v in value]


class DateList(OPList):
    """List of epoch-millis timestamps (Lists.scala DateList)."""

    __slots__ = ()
    kind = "date_list"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return []
        return [int(v) for v in value]


class DateTimeList(DateList):
    __slots__ = ()


class MultiPickList(OPSet):
    __slots__ = ()
    kind = "set"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return set()
        return {str(v) for v in value}


class Geolocation(OPList, Location):
    """[lat, lon, accuracy] triple (Geolocation.scala:47).

    accuracy is an integer code (GeolocationAccuracy in the reference); we
    keep it as a float in-place for columnar friendliness.
    """

    __slots__ = ()
    kind = "geolocation"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return []
        vals = [float(v) for v in value]
        if vals and len(vals) != 3:
            raise ValueError(f"Geolocation must have 3 elements, got {len(vals)}")
        if vals:
            lat, lon = vals[0], vals[1]
            if not (-90.0 <= lat <= 90.0) or not (-180.0 <= lon <= 180.0):
                raise ValueError(f"Invalid geolocation: {vals}")
        return vals

    @property
    def lat(self) -> Optional[float]:
        return self._value[0] if self._value else None

    @property
    def lon(self) -> Optional[float]:
        return self._value[1] if self._value else None

    @property
    def accuracy(self) -> Optional[float]:
        return self._value[2] if self._value else None

    def to_unit_sphere(self) -> List[float]:
        """3D unit-sphere encoding used by the geolocation vectorizer."""
        if self.is_empty:
            return [0.0, 0.0, 0.0]
        lat, lon = math.radians(self.lat), math.radians(self.lon)
        return [math.cos(lat) * math.cos(lon), math.cos(lat) * math.sin(lon), math.sin(lat)]


class OPVector(OPCollection):
    """Dense feature vector (OPVector.scala:41) — wraps a numpy 1-D array."""

    __slots__ = ()
    kind = "vector"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return np.zeros((0,), dtype=np.float32)
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim != 1:
            raise ValueError(f"OPVector must be 1-D, got shape {arr.shape}")
        return arr

    @property
    def is_empty(self) -> bool:
        return self._value.size == 0

    def __eq__(self, other) -> bool:
        if not isinstance(other, OPVector):
            return NotImplemented
        return bool(np.array_equal(self._value, other._value))

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._value.tobytes()))
