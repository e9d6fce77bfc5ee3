"""SmartTextVectorizerModel — per-feature pivot-or-hash, transform only.

The port's copy of ``SmartTextVectorizerModel`` from
``transmogrifai_tpu/impl/feature/smart_text.py`` (reference:
SmartTextVectorizer.scala:62).  The fit-time decision (categorical or hashed)
is read from the saved model; the transform builds its blocks on the host
(strings never reach the device) and places the assembled matrix on the
stage's device.  Hashing uses the pure-Python MurMur3 of ``hashing.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ... import types as T
from ...columns import Column, ObjectColumn, VectorColumn
from ...features.metadata import NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata
from ...stages.base import Model
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
