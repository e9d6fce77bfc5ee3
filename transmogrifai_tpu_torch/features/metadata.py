"""Vector column metadata — per-column provenance of assembled vectors.

Reference parity: features/.../utils/spark/OpVectorColumnMetadata.scala:67 and
OpVectorMetadata.scala:89.  Every column of every assembled OPVector carries:
``parent_feature_name``, ``parent_feature_type``, ``grouping`` (e.g. the map
key or categorical group), ``indicator_value`` (e.g. the pivoted category),
``descriptor_value`` (e.g. "sin(dayOfWeek)"), and its ``index`` in the vector.

This sidecar powers SanityChecker drop decisions, ModelInsights and
RecordInsightsLOCO — it is a first-class structure here (SURVEY §7).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

NULL_INDICATOR = "NullIndicatorValue"  # OpVectorColumnMetadata.NullString
OTHER_INDICATOR = "OTHER"              # OpOneHotVectorizer other-category


@dataclass(frozen=True)
class VectorColumnMetadata:
    """One vector slot's provenance (OpVectorColumnMetadata.scala:67)."""

    parent_feature_name: Tuple[str, ...]
    parent_feature_type: Tuple[str, ...]
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    descriptor_value: Optional[str] = None
    index: int = 0

    @property
    def is_null_indicator(self) -> bool:
        """OpVectorColumnMetadata.scala:106."""
        return self.indicator_value == NULL_INDICATOR

    @property
    def is_other_indicator(self) -> bool:
        return self.indicator_value == OTHER_INDICATOR

    def feature_group(self) -> Optional[str]:
        """The categorical-group key for Cramér's-V style stats
        (OpVectorColumnMetadata.scala:158): grouping if set, else the parent
        feature name when this is an indicator column."""
        if self.grouping is not None:
            return f"{self.parent_feature_name[0]}_{self.grouping}" \
                if self.parent_feature_name else self.grouping
        if self.indicator_value is not None and self.parent_feature_name:
            return self.parent_feature_name[0]
        return None

    def make_col_name(self) -> str:
        """OpVectorColumnMetadata.scala:125 makeColName."""
        parent = "_".join(self.parent_feature_name)
        parts = [parent]
        if self.grouping:
            parts.append(self.grouping)
        if self.indicator_value:
            parts.append(self.indicator_value)
        elif self.descriptor_value:
            parts.append(self.descriptor_value)
        parts.append(str(self.index))
        return "_".join(parts)

    def to_json(self) -> Dict[str, Any]:
        return {
            "parentFeatureName": list(self.parent_feature_name),
            "parentFeatureType": list(self.parent_feature_type),
            "grouping": self.grouping,
            "indicatorValue": self.indicator_value,
            "descriptorValue": self.descriptor_value,
            "index": self.index,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "VectorColumnMetadata":
        return VectorColumnMetadata(
            tuple(d["parentFeatureName"]), tuple(d["parentFeatureType"]),
            d.get("grouping"), d.get("indicatorValue"), d.get("descriptorValue"),
            int(d.get("index", 0)))


@dataclass(frozen=True)
class VectorMetadata:
    """Full vector provenance: ordered columns + per-parent history
    (OpVectorMetadata.scala:89)."""

    name: str
    columns: Tuple[VectorColumnMetadata, ...] = ()

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.make_col_name() for c in self.columns]

    def index_of_parent(self, parent_name: str) -> List[int]:
        return [i for i, c in enumerate(self.columns) if parent_name in c.parent_feature_name]

    def select(self, indices: Sequence[int]) -> "VectorMetadata":
        """Slice + reindex (used by SanityChecker's column dropper)."""
        cols = tuple(replace(self.columns[i], index=j) for j, i in enumerate(indices))
        return VectorMetadata(self.name, cols)

    @staticmethod
    def flatten(name: str, parts: Sequence["VectorMetadata"]) -> "VectorMetadata":
        """Concatenate vector metadatas, reindexing (OpVectorMetadata.flatten)."""
        cols: List[VectorColumnMetadata] = []
        for part in parts:
            for c in part.columns:
                cols.append(replace(c, index=len(cols)))
        return VectorMetadata(name, tuple(cols))

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "columns": [c.to_json() for c in self.columns]}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "VectorMetadata":
        return VectorMetadata(d["name"],
                              tuple(VectorColumnMetadata.from_json(c) for c in d["columns"]))


def make_columns(parent_name: str, parent_type: str, *,
                 groupings: Optional[Sequence[Optional[str]]] = None,
                 indicators: Optional[Sequence[Optional[str]]] = None,
                 descriptors: Optional[Sequence[Optional[str]]] = None,
                 n: Optional[int] = None) -> List[VectorColumnMetadata]:
    """Convenience builder for a run of columns sharing one parent feature."""
    if n is None:
        n = max(len(x) for x in (groupings, indicators, descriptors) if x is not None)
    out = []
    for i in range(n):
        out.append(VectorColumnMetadata(
            parent_feature_name=(parent_name,),
            parent_feature_type=(parent_type,),
            grouping=groupings[i] if groupings else None,
            indicator_value=indicators[i] if indicators else None,
            descriptor_value=descriptors[i] if descriptors else None,
            index=i,
        ))
    return out
