"""Feature — the typed, lazy DAG node.

Reference parity: features/src/main/scala/com/salesforce/op/features/FeatureLike.scala:49.
A Feature is a *lazy pointer*: it holds its origin stage and parent features,
so the whole program is recoverable from the result features alone
(FeatureLike.scala:370 ``parentStages()``).  Graph ops implemented here:
``parent_stages`` (BFS with distances), ``raw_features``, ``traverse``,
``history``, ``same_origin``, ``copy_with_new_stages``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, TYPE_CHECKING

from .. import types as T

if TYPE_CHECKING:
    from ..stages.base import PipelineStage

_UID_COUNTER = itertools.count()


@dataclass(frozen=True)
class FeatureHistory:
    """Lineage record (reference FeatureHistory): originating raw features and
    all stages applied along the way."""

    origin_features: Tuple[str, ...]
    stages: Tuple[str, ...]

    def merge(self, other: "FeatureHistory") -> "FeatureHistory":
        return FeatureHistory(
            tuple(sorted(set(self.origin_features) | set(other.origin_features))),
            tuple(sorted(set(self.stages) | set(other.stages))),
        )


@dataclass(frozen=True, eq=False)
class Feature:
    """Typed handle to a (future) column: name, uid, response flag, origin."""

    name: str
    ftype: Type[T.FeatureType]
    is_response: bool
    origin_stage: "PipelineStage"
    parents: Tuple["Feature", ...] = ()
    # deterministic counter, not random hex: a restarted process rebuilding
    # the same DAG reconstructs the same uids, which is what lets
    # content-keyed checkpoints resume across preemptions (stages/base.py
    # make_uid has the full rationale)
    uid: str = field(
        default_factory=lambda: f"Feature_{next(_UID_COUNTER):012x}")

    # identity semantics: DAG nodes are compared by object identity (uid)
    def __eq__(self, other):
        return isinstance(other, Feature) and self.uid == other.uid

    def __hash__(self):
        return hash(self.uid)

    def __repr__(self):
        return (f"Feature(name={self.name!r}, type={self.ftype.__name__}, "
                f"response={self.is_response}, uid={self.uid!r})")

    # ---- graph properties ---------------------------------------------------
    @property
    def is_raw(self) -> bool:
        return len(self.parents) == 0

    def same_origin(self, other: "Feature") -> bool:
        """FeatureLike.scala:162 — same origin stage."""
        return self.origin_stage is not None and other.origin_stage is not None \
            and self.origin_stage.uid == other.origin_stage.uid

    def traverse(self, acc, f: Callable[[Any, "Feature"], Any]):
        """Fold over the upstream DAG (FeatureLike.scala:316)."""
        acc = f(acc, self)
        for p in self.parents:
            acc = p.traverse(acc, f)
        return acc

    def raw_features(self) -> List["Feature"]:
        """All raw ancestors (FeatureLike.scala:345)."""
        seen: Dict[str, Feature] = {}

        def visit(feat: Feature):
            if feat.uid in seen:
                return
            seen[feat.uid] = feat
            for p in feat.parents:
                visit(p)

        visit(self)
        return sorted((f for f in seen.values() if f.is_raw), key=lambda f: f.name)

    def parent_stages(self) -> Dict["PipelineStage", int]:
        """BFS from this feature: stage -> max distance from result
        (FeatureLike.scala:370).  Distance is the max over all paths — this is
        what makes DAG layers antichains (FitStagesUtil.computeDAG:173)."""
        dist: Dict[str, int] = {}
        stages: Dict[str, "PipelineStage"] = {}
        frontier: List[Tuple[Feature, int]] = [(self, 0)]
        while frontier:
            nxt: List[Tuple[Feature, int]] = []
            for feat, d in frontier:
                st = feat.origin_stage
                if st is not None:
                    if st.uid not in dist or dist[st.uid] < d:
                        dist[st.uid] = d
                        stages[st.uid] = st
                for p in feat.parents:
                    nxt.append((p, d + 1))
            frontier = nxt
        return {stages[uid]: d for uid, d in dist.items()}

    def history(self) -> FeatureHistory:
        """FeatureLike.scala:293 — originating features + stages applied."""
        if self.is_raw:
            return FeatureHistory((self.name,), ())
        h = FeatureHistory((), (self.origin_stage.operation_name,))
        for p in self.parents:
            h = h.merge(p.history())
        return h

    def all_features(self) -> List["Feature"]:
        """Every feature in the upstream closure, this one included."""
        seen: Dict[str, Feature] = {}

        def visit(feat: Feature):
            if feat.uid in seen:
                return
            seen[feat.uid] = feat
            for p in feat.parents:
                visit(p)

        visit(self)
        return list(seen.values())

    def copy_with_new_stages(self, stage_map: Dict[str, "PipelineStage"]) -> "Feature":
        """Rebuild this feature subtree swapping stages by uid
        (FeatureLike.scala:463) — used by workflow-level CV to refit the
        feature DAG per fold on fresh stage copies."""
        new_parents = tuple(p.copy_with_new_stages(stage_map) for p in self.parents)
        new_stage = stage_map.get(self.origin_stage.uid, self.origin_stage)
        return replace(self, parents=new_parents, origin_stage=new_stage)


@dataclass(frozen=True)
class TransientFeature:
    """Serializable feature reference used inside stages — avoids capturing
    the DAG in fitted-model state (reference TransientFeature.scala:61)."""

    name: str
    type_name: str
    is_response: bool
    is_raw: bool
    uid: str

    @staticmethod
    def from_feature(f: Feature) -> "TransientFeature":
        return TransientFeature(f.name, f.ftype.__name__, f.is_response, f.is_raw, f.uid)

    @property
    def ftype(self) -> Type[T.FeatureType]:
        return T.feature_type_by_name(self.type_name)
