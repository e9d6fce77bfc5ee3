"""Feature type system — the typed value hierarchy.

Re-design of the reference's FeatureType hierarchy
(reference: features/src/main/scala/com/salesforce/op/features/types/FeatureType.scala:44).

Every value is nullable-by-construction: scalar types wrap ``Optional``
values, collection types wrap possibly-empty collections.  The scalar objects
here are the *row-level* API (used by extract functions, the testkit and local
scoring); the batch path stores data columnar (see
``transmogrifai_tpu_torch.columns``) with an explicit (value, mask) representation
that maps onto device tensors.

Marker traits mirror the reference (FeatureType.scala:140-155):
``NonNullable``, ``SingleResponse``, ``MultiResponse``, ``Categorical``,
``Location``.
"""
from __future__ import annotations

from typing import Any, ClassVar, Optional, Type


class FeatureType:
    """Base of the feature type hierarchy.

    Reference parity: FeatureType trait with ``value``, ``isEmpty``, ``===``
    (features/.../types/FeatureType.scala:44).
    """

    __slots__ = ("_value",)

    #: set by subclasses — the "kind" used for columnar storage dispatch
    kind: ClassVar[str] = "abstract"

    def __init__(self, value: Any = None):
        self._value = self._convert(value)

    @classmethod
    def _convert(cls, value: Any) -> Any:
        return value

    @property
    def value(self) -> Any:
        return self._value

    @property
    def is_empty(self) -> bool:
        return self._value is None

    @property
    def non_empty(self) -> bool:
        return not self.is_empty

    def exists(self, pred) -> bool:
        return self.non_empty and bool(pred(self._value))

    def __eq__(self, other) -> bool:
        if not isinstance(other, FeatureType):
            return NotImplemented
        return type(self) is type(other) and self._value == other._value

    def __hash__(self) -> int:
        v = self._value
        if isinstance(v, (list, dict, set)):
            v = repr(v)
        return hash((type(self).__name__, v))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._value!r})"

    # ---- type-level helpers -------------------------------------------------
    @classmethod
    def type_name(cls) -> str:
        return cls.__name__

    @classmethod
    def is_subtype_of(cls, other: Type["FeatureType"]) -> bool:
        return issubclass(cls, other)


# ---- marker traits (reference FeatureType.scala:140-155) --------------------
class NonNullable:
    """Values of this type may never be empty."""


class SingleResponse:
    """Categorical with a single response (e.g. PickList)."""


class MultiResponse:
    """Categorical with multiple responses (e.g. MultiPickList)."""


class Categorical:
    """Marker: categorical semantics."""


class Location:
    """Marker: geographic semantics."""


# ---- collection bases -------------------------------------------------------
class OPCollection(FeatureType):
    """Base for list/set/map/vector types."""

    __slots__ = ()

    @property
    def is_empty(self) -> bool:
        v = self._value
        return v is None or len(v) == 0


class OPList(OPCollection):
    __slots__ = ()
    kind = "list"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return []
        return list(value)

    @property
    def value(self) -> list:
        return self._value


class OPSet(OPCollection, MultiResponse):
    __slots__ = ()
    kind = "set"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return set()
        return set(value)

    @property
    def value(self) -> set:
        return self._value


class OPMap(OPCollection):
    __slots__ = ()
    kind = "map"

    #: FeatureType of this map's values (e.g. RealMap -> Real)
    ElementType: ClassVar[Optional[Type[FeatureType]]] = None

    @classmethod
    def _convert(cls, value):
        if value is None:
            return {}
        return dict(value)

    @property
    def value(self) -> dict:
        return self._value


class OPNumeric(FeatureType):
    """Base of numeric scalar types."""

    __slots__ = ()
    kind = "numeric"

    def to_double(self) -> Optional[float]:
        return None if self._value is None else float(self._value)
