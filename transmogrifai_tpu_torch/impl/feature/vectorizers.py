"""Numeric and categorical vectorizers + vector assembly.

The port's copy of ``RealVectorizer`` / ``IntegralVectorizer`` (fits: mean
or mode fills), ``OneHotVectorizer`` (fit: top-K / min-support categories),
their models, and ``VectorsCombiner`` from
``transmogrifai_tpu/impl/feature/vectorizers.py`` (reference: numeric
vectorizers, OpOneHotVectorizer.scala:61,140, VectorsCombiner.scala:51).
The fits are host numpy, as in the JAX package.  The transforms run on
their device through the fused-layer protocol (``impl/feature/_util.py``):

- ``RealVectorizerModel`` and ``BinaryVectorizer``: the value and mask
  columns stacked on the device, the device program K-C ``fill_indicator``
  (``ops/vectorize.py``).
- ``RealNNVectorizer``: the values side by side, K-Z's ``column_gather``
  over width-1 sources.
- ``StandardScalerModel``: K-AD ``column_affine`` (``ops/layer.py``); its
  fit takes the single-device branch of the JAX package's
  ``_scaler_moments`` (the sharded one waits for a mesh in the port).
- ``OneHotVectorizerModel``: host prep maps labels to fitted category codes
  without pandas, the device program is K-D ``one_hot_codes``.  Columns
  holding collections pivot through the per-row host path, as in the JAX
  package.
- ``VectorsCombiner``: the concatenation of device matrices, K-Z's
  ``column_gather`` (``ops/layer.py``).
"""
from __future__ import annotations

import decimal
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import types as T
from ...columns import Column, Dataset, NumericColumn, ObjectColumn, VectorColumn
from ...features.metadata import (NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata,
                                  VectorMetadata)
from ...ops import layer as L
from ...ops.vectorize import fill_indicator, one_hot_codes
from ...readers.base import null_mask
from ...stages.base import Model, SequenceEstimator, SequenceTransformer, UnaryEstimator
from ._util import finalize_vector, run_on_device, stage_constant


def _vector_meta(stage, cols_meta: List[VectorColumnMetadata]) -> VectorMetadata:
    name = stage.get_outputs()[0].name
    cols = [VectorColumnMetadata(c.parent_feature_name, c.parent_feature_type, c.grouping,
                                 c.indicator_value, c.descriptor_value, i)
            for i, c in enumerate(cols_meta)]
    return VectorMetadata(name, tuple(cols))


# ---------------------------------------------------------------------------
# Numeric vectorizers
# ---------------------------------------------------------------------------
class RealVectorizer(SequenceEstimator):
    """Real features -> OPVector with mean/constant fill + null tracking."""

    def __init__(self, fill_with_mean: bool = True, fill_value: float = 0.0,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="vecReal", output_type=T.OPVector, uid=uid,
                         fill_with_mean=fill_with_mean, fill_value=fill_value,
                         track_nulls=track_nulls)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "RealVectorizerModel":
        fills = []
        for col in cols:
            assert isinstance(col, NumericColumn)
            if self.get_param("fill_with_mean"):
                n = col.mask.sum()
                fills.append(float(col.values[col.mask].mean()) if n else 0.0)
            else:
                fills.append(float(self.get_param("fill_value")))
        return RealVectorizerModel(fills=np.asarray(fills, dtype=np.float64),
                                   track_nulls=bool(self.get_param("track_nulls")),
                                   operation_name=self.operation_name,
                                   output_type=self.output_type)


class IntegralVectorizer(RealVectorizer):
    """Integral features -> OPVector with mode/constant fill + null tracking."""

    def __init__(self, fill_with_mode: bool = True, fill_value: float = 0.0,
                 track_nulls: bool = True, uid: Optional[str] = None):
        SequenceEstimator.__init__(self, operation_name="vecIntegral",
                                   output_type=T.OPVector, uid=uid,
                                   fill_with_mode=fill_with_mode, fill_value=fill_value,
                                   track_nulls=track_nulls)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "RealVectorizerModel":
        fills = []
        for col in cols:
            assert isinstance(col, NumericColumn)
            if self.get_param("fill_with_mode") and col.mask.any():
                vals, counts = np.unique(col.values[col.mask], return_counts=True)
                fills.append(float(vals[np.argmax(counts)]))
            else:
                fills.append(float(self.get_param("fill_value")))
        return RealVectorizerModel(fills=np.asarray(fills),
                                   track_nulls=bool(self.get_param("track_nulls")),
                                   operation_name=self.operation_name,
                                   output_type=self.output_type)


class RealVectorizerModel(Model):
    def __init__(self, fills: np.ndarray, track_nulls: bool, operation_name: str = "vecReal",
                 output_type=T.OPVector, uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.fills = np.asarray(fills, dtype=np.float64)
        self.track_nulls = track_nulls

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        for f, col in zip(self.inputs, cols):
            assert isinstance(col, NumericColumn), f"RealVectorizer input {f.name} not numeric"
        return run_on_device(self, cols)

    # ---- fused-layer protocol: (values, mask) of each input, so the stage
    # streams on intermediates as the JAX package's does ---------------------
    def torch_transform(self, *args):
        return _fill_indicator_pairs(self, args, np.asarray(self.fills, np.float32),
                                     bool(self.track_nulls))

    def torch_out_metadata(self, cols):
        meta = []
        for f in self.inputs:
            meta.append(VectorColumnMetadata((f.name,), (f.ftype.__name__,)))
            if self.track_nulls:
                meta.append(VectorColumnMetadata((f.name,), (f.ftype.__name__,),
                                                 indicator_value=NULL_INDICATOR))
        vm = _vector_meta(self, meta)
        self.metadata["vector_metadata"] = vm
        return vm


def _fill_indicator_pairs(stage, args, fills: np.ndarray, track_nulls: bool) -> torch.Tensor:
    """K-C over (values f32[n], mask bool[n]) pairs, stacked to [k, n]."""
    values = torch.stack([a.to(torch.float32) for a in args[0::2]])
    mask = torch.stack(list(args[1::2]))
    return fill_indicator(values, mask, stage_constant(stage, "fills", fills, values.device),
                          track_nulls)


class BinaryVectorizer(SequenceTransformer):
    """Binary features -> OPVector: value (false fill) + null indicator."""

    def __init__(self, fill_value: bool = False, track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecBinary", output_type=T.OPVector, uid=uid,
                         fill_value=fill_value, track_nulls=track_nulls)

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        for f, col in zip(self.inputs, cols):
            assert isinstance(col, NumericColumn), f"BinaryVectorizer input {f.name} not numeric"
        return run_on_device(self, cols)

    # ---- fused-layer protocol ---------------------------------------------
    def torch_transform(self, *args):
        fill = float(self.get_param("fill_value", False))
        return _fill_indicator_pairs(self, args, np.full(len(args) // 2, fill, np.float32),
                                     bool(self.get_param("track_nulls", True)))

    def torch_out_metadata(self, cols):
        meta = []
        for f in self.inputs:
            meta.append(VectorColumnMetadata((f.name,), (f.ftype.__name__,)))
            if self.get_param("track_nulls", True):
                meta.append(VectorColumnMetadata((f.name,), (f.ftype.__name__,),
                                                 indicator_value=NULL_INDICATOR))
        vm = _vector_meta(self, meta)
        self.metadata["vector_metadata"] = vm
        return vm


class RealNNVectorizer(SequenceTransformer):
    """Non-nullable reals -> OPVector (no fill, no null tracking)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="vecRealNN", output_type=T.OPVector, uid=uid)

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        return run_on_device(self, cols)

    # ---- fused-layer protocol ---------------------------------------------
    def torch_transform(self, *args):
        return L.concat_columns([a.to(torch.float32).reshape(-1, 1) for a in args[0::2]])

    def torch_out_metadata(self, cols):
        meta = [VectorColumnMetadata((f.name,), (f.ftype.__name__,)) for f in self.inputs]
        vm = _vector_meta(self, meta)
        self.metadata["vector_metadata"] = vm
        return vm


# ---------------------------------------------------------------------------
# Categorical pivot (one-hot)
# ---------------------------------------------------------------------------
_SCALAR_SETS = ({str}, {bool}, {int}, {float}, {int, float}, {decimal.Decimal})


def _kind_of_type(t: type) -> type:
    for kind, types in ((str, (str, np.str_)), (bool, (bool, np.bool_)),
                        (int, (int, np.integer)), (float, (float, np.floating)),
                        (decimal.Decimal, (decimal.Decimal,))):
        if issubclass(t, types):
            return kind
    return object


def is_scalar_kind(values: np.ndarray) -> bool:
    """Whether non-null values all infer to one scalar categorical kind:
    the numpy counterpart of the JAX package's check
    ``pd.api.types.infer_dtype(values) in SCALAR_DTYPE_KINDS`` (string,
    boolean, integer, floating, mixed-integer-float, decimal or empty).  Any
    other mix, and every collection, pivots through the per-row path."""
    kinds = {_kind_of_type(t) for t in set(map(type, values))}
    return not kinds or any(kinds == s for s in _SCALAR_SETS)


def _present(values: np.ndarray) -> np.ndarray:
    """``~pd.isnull``: None, float NaN and NaT are null."""
    return ~null_mask(values)


def scalar_codes(col: Column) -> Optional[Tuple[List[str], np.ndarray, np.ndarray]]:
    """Vectorized (labels, codes, present) for SCALAR categorical columns, or
    None for collection-typed columns (sets/lists pivot per row)."""
    if isinstance(col, NumericColumn):
        uniq, inv = np.unique(col.values, return_inverse=True)
        return [str(u) for u in uniq], inv, col.mask.copy()
    assert isinstance(col, ObjectColumn)
    vals = col.values
    present = _present(vals)
    if not is_scalar_kind(vals[present]):
        return None
    filled = np.where(present, vals, "")
    uniq, inv = np.unique(filled.astype(str), return_inverse=True)
    return list(uniq), inv, present


def _values_of(col: Column, i: int) -> List[str]:
    if isinstance(col, ObjectColumn):
        v = col.values[i]
        if v is None:
            return []
        if isinstance(v, (set, frozenset, list, tuple)):
            return [str(x) for x in v]
        return [str(v)]
    assert isinstance(col, NumericColumn)
    return [str(col.values[i])] if col.mask[i] else []


class OneHotVectorizer(SequenceEstimator):
    """TopK/minSupport pivot with OTHER + null columns
    (OpOneHotVectorizer.scala:61); features whose cardinality exceeds
    ``max_pct_cardinality`` of the rows are not pivoted (all mass to OTHER)."""

    def __init__(self, top_k: int = 20, min_support: int = 10, track_nulls: bool = True,
                 unseen_name: str = OTHER_INDICATOR, max_pct_cardinality: float = 1.0,
                 uid: Optional[str] = None):
        super().__init__(operation_name="pivot", output_type=T.OPVector, uid=uid,
                         top_k=top_k, min_support=min_support, track_nulls=track_nulls,
                         unseen_name=unseen_name, max_pct_cardinality=max_pct_cardinality)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "OneHotVectorizerModel":
        top_k = int(self.get_param("top_k"))
        min_support = int(self.get_param("min_support"))
        max_pct = float(self.get_param("max_pct_cardinality"))
        categories: List[List[str]] = []
        for col in cols:
            n = len(col)
            coded = scalar_codes(col)
            if coded is not None:
                labels, inv, present = coded
                cnt = np.bincount(inv[present], minlength=len(labels))
                counts = Counter({lab: int(c) for lab, c in zip(labels, cnt) if c})
            else:
                counts = Counter()
                for i in range(n):
                    counts.update(_values_of(col, i))
            if n > 0 and len(counts) > max_pct * n:
                categories.append([])
                continue
            keep = [(c, k) for c, k in counts.items() if k >= min_support]
            keep.sort(key=lambda t: (-t[1], t[0]))
            categories.append([c for c, _ in keep[:top_k]])
        return OneHotVectorizerModel(categories=categories,
                                     track_nulls=bool(self.get_param("track_nulls")),
                                     unseen_name=str(self.get_param("unseen_name")),
                                     operation_name=self.operation_name,
                                     output_type=self.output_type)


class OneHotVectorizerModel(Model):
    def __init__(self, categories: List[List[str]], track_nulls: bool,
                 unseen_name: str = OTHER_INDICATOR, operation_name: str = "pivot",
                 output_type=T.OPVector, uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.categories = categories
        self.track_nulls = track_nulls
        self.unseen_name = unseen_name

    def _widths(self) -> List[int]:
        return [len(c) + (2 if self.track_nulls else 1) for c in self.categories]

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        if self.torch_host_ready(cols):
            return run_on_device(self, cols)
        # a column of collections: the JAX package's host path, column by column
        n = len(cols[0])
        blocks = []
        for col, cats, width in zip(cols, self.categories, self._widths()):
            index = {c: j for j, c in enumerate(cats)}
            k = len(cats)
            coded = scalar_codes(col)
            if coded is not None:
                block = one_hot_codes(torch.from_numpy(self._targets(coded, cats))[None],
                                      [width]).numpy()
            else:
                block = np.zeros((n, width), dtype=np.float32)
                for i in range(n):
                    vals = _values_of(col, i)
                    if not vals:
                        if self.track_nulls:
                            block[i, k + 1] = 1.0
                        continue
                    for v in vals:
                        j = index.get(v)
                        block[i, k if j is None else j] = 1.0  # k = OTHER
            blocks.append(block)
        vm = self.torch_out_metadata(cols)
        return finalize_vector(self, blocks, vm.columns, n)

    def _targets(self, coded, cats: List[str]) -> np.ndarray:
        """i32[n]: [0,k) category, k OTHER, k+1 null, -1 no output (null
        with track_nulls off)."""
        index = {c: j for j, c in enumerate(cats)}
        k = len(cats)
        labels, inv, present = coded
        lab_target = np.array([index.get(lab, k) for lab in labels] or [0], dtype=np.int32)
        return np.where(present, lab_target[inv],
                        k + 1 if self.track_nulls else -1).astype(np.int32)

    # ---- fused-layer protocol: the label -> code lookup stays on the host,
    # the one-hot expansion + null/OTHER columns run on the device ----------
    def torch_host_ready(self, cols) -> bool:
        for col in cols:
            if isinstance(col, NumericColumn):
                continue
            if not isinstance(col, ObjectColumn):
                return False
            if not is_scalar_kind(col.values[_present(col.values)]):
                return False  # collection values pivot through the host path
        return True

    #: the rows of ``torch_host_prep``'s codes run along their last axis
    torch_prep_row_axis = 1

    def torch_host_prep(self, cols) -> List[np.ndarray]:
        """Category codes i32[inputs, n] (see ``_targets``): one upload."""
        n = len(cols[0])
        outs = [self._targets(scalar_codes(col), cats)
                for col, cats in zip(cols, self.categories)]
        return [np.stack(outs) if outs else np.zeros((0, n), np.int32)]

    def torch_transform(self, codes):
        return one_hot_codes(codes, self._widths())

    def torch_out_metadata(self, cols):
        meta = []
        for f, cats in zip(self.inputs, self.categories):
            ind = list(cats) + [self.unseen_name] \
                + ([NULL_INDICATOR] if self.track_nulls else [])
            for v in ind:
                meta.append(VectorColumnMetadata((f.name,), (f.ftype.__name__,),
                                                 grouping=None, indicator_value=v))
        vm = _vector_meta(self, meta)
        self.metadata["vector_metadata"] = vm
        return vm


# ---------------------------------------------------------------------------
# Vector assembly
# ---------------------------------------------------------------------------
class VectorsCombiner(SequenceTransformer):
    """Concatenate OPVectors, merging metadata (VectorsCombiner.scala:51)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="combineVector", output_type=T.OPVector, uid=uid)

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        for f, col in zip(self.inputs, cols):
            assert isinstance(col, VectorColumn), f"VectorsCombiner input {f.name} not a vector"
        return run_on_device(self, cols)

    # ---- fused-layer protocol ---------------------------------------------
    def torch_transform(self, *args):
        return L.concat_columns([a.to(torch.float32) for a in args])

    def torch_out_metadata(self, cols):
        metas = []
        for f, col in zip(self.inputs, cols):
            if col.metadata is not None:
                metas.append(col.metadata)
            else:
                metas.append(VectorMetadata(f.name, tuple(
                    VectorColumnMetadata((f.name,), (f.ftype.__name__,), index=i)
                    for i in range(col.width))))
        vm = VectorMetadata.flatten(self.get_outputs()[0].name, metas)
        self.metadata["vector_metadata"] = vm
        return vm


# ---------------------------------------------------------------------------
# Vector standardization
# ---------------------------------------------------------------------------
def _scaler_moments(V) -> tuple:
    """Column mean and population std of the matrix (the single-device
    branch of the JAX package's ``_scaler_moments``: numpy on the host)."""
    V = V.detach().cpu().numpy() if isinstance(V, torch.Tensor) else np.asarray(V)
    return V.mean(axis=0), V.std(axis=0)


class StandardScalerVectorizer(UnaryEstimator):
    """Standardize an OPVector column (z-score); the OpScalarStandardScaler /
    Spark StandardScaler analog."""

    def __init__(self, with_mean: bool = True, with_std: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="stdScaler", input_type=T.OPVector,
                         output_type=T.OPVector, uid=uid,
                         with_mean=with_mean, with_std=with_std)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "StandardScalerModel":
        col = cols[0]
        assert isinstance(col, VectorColumn)
        mean, std = _scaler_moments(col.values)
        std = np.where(std < 1e-12, 1.0, std)
        return StandardScalerModel(
            mean=mean if self.get_param("with_mean") else np.zeros_like(mean),
            std=std if self.get_param("with_std") else np.ones_like(std),
            operation_name=self.operation_name, output_type=self.output_type)


class StandardScalerModel(Model):
    def __init__(self, mean: np.ndarray, std: np.ndarray, operation_name: str = "stdScaler",
                 output_type=T.OPVector, uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        """The JAX package's host path: a float32 division where the matrix
        lies (its device program multiplies by the reciprocal instead)."""
        col = cols[0]
        assert isinstance(col, VectorColumn)
        x = col.values
        out = (x - torch.from_numpy(self.mean).to(x.device)) / torch.from_numpy(self.std).to(x.device)
        return VectorColumn(T.OPVector, out, self.torch_out_metadata(cols))

    # ---- fused-layer protocol ---------------------------------------------
    def torch_transform(self, x):
        """``(x - mean) / std`` as XLA compiles the JAX package's program: a
        product with the float32 reciprocal of std (K-AD)."""
        rcp = (np.float32(1.0) / self.std).astype(np.float32)
        return L.column_affine(x.to(torch.float32), stage_constant(self, "mean", self.mean, x.device),
                               stage_constant(self, "rcp", rcp, x.device))

    def torch_out_metadata(self, cols):
        vm = cols[0].metadata
        if vm is not None:
            vm = VectorMetadata(self.get_outputs()[0].name, vm.columns)
            self.metadata["vector_metadata"] = vm
        return vm
