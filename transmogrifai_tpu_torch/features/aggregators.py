"""Monoid aggregators — event aggregation for aggregate/conditional readers.

Reference parity: features/src/main/scala/com/salesforce/op/aggregators/
(algebird ``MonoidAggregator[Event[O], _, O]`` per type; defaults in
MonoidAggregatorDefaults.scala; TimeBasedAggregator first/last-by-time;
CustomMonoidAggregator for user functions).

An aggregator folds a sequence of typed events (value + timestamp) for one
key into a single typed value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Generic, List, Optional, Sequence, Tuple, Type, TypeVar

from .. import types as T


@dataclass(frozen=True)
class Event:
    """A timestamped value (reference Event[T])."""

    value: T.FeatureType
    time: int = 0


class MonoidAggregator:
    """prepare -> fold(monoid plus) -> present (algebird shape)."""

    name = "monoid"

    def prepare(self, event: Event) -> Any:
        raise NotImplementedError

    def zero(self) -> Any:
        raise NotImplementedError

    def plus(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def present(self, acc: Any, ftype: Type[T.FeatureType]) -> T.FeatureType:
        raise NotImplementedError

    def aggregate(self, ftype: Type[T.FeatureType], events: Sequence[Event]) -> T.FeatureType:
        acc = self.zero()
        for e in events:
            acc = self.plus(acc, self.prepare(e))
        return self.present(acc, ftype)


class _NumericAgg(MonoidAggregator):
    def prepare(self, event: Event) -> Optional[float]:
        v = event.value.value
        return None if v is None else float(v)

    def zero(self):
        return None

    def present(self, acc, ftype):
        if acc is None:
            return T.default_of(ftype)
        if issubclass(ftype, T.Integral):
            return ftype(int(acc))
        return ftype(acc)


class SumNumeric(_NumericAgg):
    name = "Sum"

    def plus(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a + b


class MaxNumeric(_NumericAgg):
    name = "Max"

    def plus(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return max(a, b)


class MinNumeric(_NumericAgg):
    name = "Min"

    def plus(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return min(a, b)


class MeanNumeric(MonoidAggregator):
    name = "Mean"

    def prepare(self, event):
        v = event.value.value
        return (0.0, 0) if v is None else (float(v), 1)

    def zero(self):
        return (0.0, 0)

    def plus(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def present(self, acc, ftype):
        s, n = acc
        return T.default_of(ftype) if n == 0 else ftype(s / n)


class LogicalOr(_NumericAgg):
    name = "LogicalOr"

    def plus(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return bool(a) or bool(b)


class ConcatText(MonoidAggregator):
    """Concatenate non-empty texts with a separator (reference ConcatTextWithSeparator)."""

    name = "ConcatText"

    def __init__(self, separator: str = " "):
        self.separator = separator

    def prepare(self, event):
        v = event.value.value
        return [] if v is None else [str(v)]

    def zero(self):
        return []

    def plus(self, a, b):
        return a + b

    def present(self, acc, ftype):
        return ftype(self.separator.join(acc)) if acc else ftype(None)


class UnionCollection(MonoidAggregator):
    """Union of lists/sets (reference UnionTextList / UnionMultiPickList)."""

    name = "Union"

    def prepare(self, event):
        v = event.value.value
        return list(v) if v else []

    def zero(self):
        return []

    def plus(self, a, b):
        return a + b

    def present(self, acc, ftype):
        return ftype(acc if acc else None)


class UnionMap(MonoidAggregator):
    """Right-biased map merge (reference UnionMaps family)."""

    name = "UnionMap"

    def prepare(self, event):
        v = event.value.value
        return dict(v) if v else {}

    def zero(self):
        return {}

    def plus(self, a, b):
        out = dict(a)
        out.update(b)
        return out

    def present(self, acc, ftype):
        return ftype(acc if acc else None)


class TimeBasedAggregator(MonoidAggregator):
    """Keep first/last non-empty value by event time
    (aggregators/TimeBasedAggregator.scala)."""

    def __init__(self, last: bool = True):
        self.last = last
        self.name = "LastByTime" if last else "FirstByTime"

    def prepare(self, event):
        if event.value.is_empty:
            return None
        return (event.time, event.value)

    def zero(self):
        return None

    def plus(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        if self.last:
            return b if b[0] >= a[0] else a
        return a if a[0] <= b[0] else b

    def present(self, acc, ftype):
        return T.default_of(ftype) if acc is None else acc[1]


class CustomMonoidAggregator(MonoidAggregator):
    """User-supplied zero/plus over raw values (CustomMonoidAggregator)."""

    name = "Custom"

    def __init__(self, zero_value: Any, plus_fn: Callable[[Any, Any], Any]):
        self._zero = zero_value
        self._plus = plus_fn

    def prepare(self, event):
        return event.value.value

    def zero(self):
        return self._zero

    def plus(self, a, b):
        if b is None:
            return a
        return self._plus(a, b)

    def present(self, acc, ftype):
        return ftype(acc)


def default_aggregator(ftype: Type[T.FeatureType]) -> MonoidAggregator:
    """Per-type defaults (MonoidAggregatorDefaults.scala)."""
    if issubclass(ftype, T.Binary):
        return LogicalOr()
    if issubclass(ftype, (T.Date, T.DateTime)):
        return MaxNumeric()
    if issubclass(ftype, T.Percent):
        return MeanNumeric()
    if issubclass(ftype, T.OPNumeric):
        return SumNumeric()
    if issubclass(ftype, T.OPMap):
        return UnionMap()
    if issubclass(ftype, (T.OPList, T.OPSet)):
        return UnionCollection()
    if issubclass(ftype, (T.PickList, T.ComboBox, T.ID, T.Country, T.State,
                          T.City, T.PostalCode, T.Street)):
        return TimeBasedAggregator(last=True)
    if issubclass(ftype, T.Text):
        return ConcatText()
    return TimeBasedAggregator(last=True)
