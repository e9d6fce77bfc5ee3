"""SmartTextVectorizer — per-feature pivot-or-hash of free text.

The port's copy of ``SmartTextVectorizer`` and its model from
``transmogrifai_tpu/impl/feature/smart_text.py`` (reference:
SmartTextVectorizer.scala:62).  The fit counts each feature's values on the
host and decides categorical (pivot the top values) or hashed, as the JAX
package does; the value counts come from one ``np.unique`` per column.  The
transform builds its blocks on the host (strings never reach the device)
and places the assembled matrix on the stage's device.  Hashing uses the
pure-Python MurMur3 of ``hashing.py``.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ... import types as T
from ...columns import Column, Dataset, ObjectColumn, VectorColumn
from ...features.metadata import NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata
from ...stages.base import Model, SequenceEstimator
from ._util import finalize_vector
from .hashing import HashingFunction
from .text import analyze


def _categorical_block(values: np.ndarray, cats: List[str]) -> np.ndarray:
    """f32[n, k+2] one-hot: category j, k = OTHER (any other value, NaN
    included), k+1 = null (None), looked up once per distinct value."""
    index = {c: j for j, c in enumerate(cats)}
    k = len(cats)
    n = len(values)
    target = np.full(n, k + 1, dtype=np.int64)
    present = np.not_equal(values, None).astype(bool)
    if present.any():
        labels, inv = np.unique(values[present].astype(str), return_inverse=True)
        target[present] = np.array([index.get(lab, k) for lab in labels], np.int64)[inv]
    block = np.zeros((n, k + 2), dtype=np.float32)
    block[np.arange(n), target] = 1.0
    return block


@dataclass
class TextStats:
    """Value distribution of one text feature (SmartTextVectorizer.scala:232)."""

    value_counts: Counter = field(default_factory=Counter)

    @staticmethod
    def of(values: np.ndarray) -> "TextStats":
        """Counts of ``str(v)`` over the non-None values."""
        present = np.not_equal(values, None).astype(bool)
        labels, counts = np.unique(values[present].astype(str), return_counts=True)
        return TextStats(Counter(dict(zip(labels.tolist(), counts.tolist()))))

    @property
    def cardinality(self) -> int:
        return len(self.value_counts)

    def coverage(self, top_k: int) -> float:
        """Fraction of non-null mass captured by the top-K values
        (SmartTextVectorizer.scala:113-131 coverage check)."""
        total = sum(self.value_counts.values())
        if total == 0:
            return 0.0
        top = sum(c for _, c in self.value_counts.most_common(top_k))
        return top / total


@dataclass
class SmartTextFeatureInfo:
    """Fit decision for one feature: pivot categories or hashed."""

    is_categorical: bool
    categories: List[str] = field(default_factory=list)


class SmartTextVectorizer(SequenceEstimator):
    """N Text features -> OPVector; per-feature pivot-or-hash
    (SmartTextVectorizer.scala:62)."""

    def __init__(self, max_cardinality: int = 100, top_k: int = 20,
                 min_support: int = 10, min_top_k_coverage: float = 0.9,
                 num_hashes: int = 512, binary_freq: bool = False,
                 track_nulls: bool = True, tokenize_for_hashing: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtVec", output_type=T.OPVector, uid=uid,
                         max_cardinality=max_cardinality, top_k=top_k,
                         min_support=min_support, min_top_k_coverage=min_top_k_coverage,
                         num_hashes=num_hashes, binary_freq=binary_freq,
                         track_nulls=track_nulls, tokenize_for_hashing=tokenize_for_hashing)

    def decide(self, stats: TextStats) -> SmartTextFeatureInfo:
        max_card = int(self.get_param("max_cardinality"))
        top_k = int(self.get_param("top_k"))
        min_support = int(self.get_param("min_support"))
        min_cov = float(self.get_param("min_top_k_coverage"))
        if stats.cardinality == 0:
            return SmartTextFeatureInfo(is_categorical=True, categories=[])
        if stats.cardinality <= max_card and stats.coverage(top_k) >= min_cov:
            keep = [(v, c) for v, c in stats.value_counts.items() if c >= min_support]
            keep.sort(key=lambda vc: (-vc[1], vc[0]))
            return SmartTextFeatureInfo(is_categorical=True,
                                        categories=[v for v, _ in keep[:top_k]])
        return SmartTextFeatureInfo(is_categorical=False)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "SmartTextVectorizerModel":
        infos = []
        for col in cols:
            assert isinstance(col, ObjectColumn), "SmartTextVectorizer needs text columns"
            infos.append(self.decide(TextStats.of(col.values)))
        return SmartTextVectorizerModel(
            is_categorical=[i.is_categorical for i in infos],
            categories=[i.categories for i in infos],
            num_hashes=int(self.get_param("num_hashes")),
            binary_freq=bool(self.get_param("binary_freq")),
            track_nulls=bool(self.get_param("track_nulls")),
            tokenize_for_hashing=bool(self.get_param("tokenize_for_hashing")),
            operation_name=self.operation_name, output_type=self.output_type)


class SmartTextVectorizerModel(Model):
    def __init__(self, is_categorical: List[bool], categories: List[List[str]],
                 num_hashes: int = 512, binary_freq: bool = False,
                 track_nulls: bool = True, tokenize_for_hashing: bool = True,
                 operation_name: str = "smartTxtVec", output_type=T.OPVector,
                 uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.is_categorical = list(is_categorical)
        self.categories = [list(c) for c in categories]
        self.num_hashes = int(num_hashes)
        self.binary_freq = bool(binary_freq)
        self.track_nulls = bool(track_nulls)
        self.tokenize_for_hashing = bool(tokenize_for_hashing)

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        n = len(cols[0])
        blocks: List[np.ndarray] = []
        meta: List[VectorColumnMetadata] = []
        hash_fn = HashingFunction(self.num_hashes, self.binary_freq)
        for f, col, is_cat, cats in zip(self.inputs, cols, self.is_categorical,
                                        self.categories):
            assert isinstance(col, ObjectColumn)
            fname, ftype = f.name, f.ftype.__name__
            if is_cat:
                block = _categorical_block(col.values, cats)  # cats + OTHER + null
                k = len(cats)
                if not self.track_nulls:
                    block = block[:, : k + 1]
                blocks.append(block)
                for v in cats:
                    meta.append(VectorColumnMetadata((fname,), (ftype,), indicator_value=v))
                meta.append(VectorColumnMetadata((fname,), (ftype,),
                                                 indicator_value=OTHER_INDICATOR))
                if self.track_nulls:
                    meta.append(VectorColumnMetadata((fname,), (ftype,),
                                                     indicator_value=NULL_INDICATOR))
            else:
                block = np.zeros((n, self.num_hashes + (1 if self.track_nulls else 0)),
                                 dtype=np.float32)
                for i in range(n):
                    v = col.values[i]
                    if v is None:
                        if self.track_nulls:
                            block[i, self.num_hashes] = 1.0
                        continue
                    terms = analyze(str(v)) if self.tokenize_for_hashing else [str(v)]
                    hash_fn.tf_row(terms, block[i])
                blocks.append(block)
                for j in range(self.num_hashes):
                    meta.append(VectorColumnMetadata((fname,), (ftype,),
                                                     descriptor_value=f"hash_{j}"))
                if self.track_nulls:
                    meta.append(VectorColumnMetadata((fname,), (ftype,),
                                                     indicator_value=NULL_INDICATOR))
        return finalize_vector(self, blocks, meta, n)
