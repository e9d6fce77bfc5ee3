"""General-purpose transformers: feature arithmetic and value munging.

The port's copy of ``transmogrifai_tpu/impl/feature/transformers.py``
(reference: ``MathTransformers``, ``AliasTransformer.scala:51``,
``FillMissingWithMean.scala``, ``DropIndicesByTransformer.scala``,
``PredictionDeIndexer.scala``): ``AddTransformer``,
``SubtractTransformer``, ``MultiplyTransformer``, ``DivideTransformer``,
``ScalarMathTransformer``, ``AliasTransformer``, ``LambdaTransformer`` (the
callable held as an ``FnExtractor``, so a saved model round-trips it by
source capture), ``FilterTransformer``, ``ReplaceTransformer``,
``SubstringTransformer``, ``ExistsTransformer``, ``ToOccurTransformer``,
``FillMissingWithMean`` / ``FillMissingWithMeanModel`` (device program: K-AC
``numeric_scale`` in fill mode), ``DropIndicesByTransformer`` (the host prep
works out the kept columns from the metadata, K-Z's ``column_gather`` takes
them) and
``PredictionDeIndexer``.  Every ``torch_transform`` is row-wise, so the
streaming executor (``workflow/stream.py``) runs it chunk by chunk.  As in
the JAX package,
a stage alone in its layer computes on the host in float64
(``transform_columns``), and one fused with other stages of its layer, or
any one in a layer of more than 200,000 rows (the JAX package's streamed
chunk program), on the device in float32 (``torch_transform``: K-Z's
``numeric_op``, ``ops/layer.py``).  Both run ``ops/layer.numeric_math``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Type

import numpy as np

from ... import types as T
from ...columns import Column, Dataset, NumericColumn, ObjectColumn, PredictionColumn, VectorColumn
from ...features.generator import FnExtractor
from ...ops import layer as L
from ...stages.base import BinaryTransformer, Model, UnaryEstimator, UnaryTransformer


class _NumericBinaryOp(BinaryTransformer):
    """Elementwise arithmetic on two numeric features; missing operands
    follow the reference's semantics: the present side wins for +/- (missing
    treated as absent, not zero-poisoning), both required for * and /."""

    op: str = "?"
    torch_output = "numeric"  # fused-layer protocol: returns (values, mask)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name=self.op, output_type=T.Real, uid=uid)

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        a, b = cols
        assert isinstance(a, NumericColumn) and isinstance(b, NumericColumn)
        with np.errstate(divide="ignore", invalid="ignore"):
            vals, mask = L.numeric_math(np, self.op, a.values, a.mask, b.values, b.mask)
        return NumericColumn(T.Real, vals, mask)

    def torch_transform(self, av, am, bv, bm):
        return L.numeric_op(self.op, av, am, bv, bm)


class AddTransformer(_NumericBinaryOp):
    op = "plus"


class SubtractTransformer(_NumericBinaryOp):
    op = "minus"


class MultiplyTransformer(_NumericBinaryOp):
    op = "multiply"


class DivideTransformer(_NumericBinaryOp):
    op = "divide"


class ScalarMathTransformer(UnaryTransformer):
    """feature <op> scalar (MathTransformers' scalar variants)."""

    torch_output = "numeric"  # fused-layer protocol: returns (values, mask)

    @staticmethod
    def _is_integral(op: str, scalar: float) -> bool:
        """ceil/floor and digit-less round produce whole numbers (the
        reference types them Integral; round(digits) stays Real —
        RichNumericFeature.scala:179-200)."""
        return op in ("ceil", "floor") or (op == "round" and scalar == 0.0)

    def __init__(self, op: str, scalar: float, uid: Optional[str] = None):
        assert op in L.NUMERIC_OPS
        super().__init__(operation_name=f"{op}Scalar", input_type=T.Real,
                         output_type=(T.Integral
                                      if self._is_integral(op, float(scalar))
                                      else T.Real),
                         uid=uid, op=op, scalar=float(scalar))

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        with np.errstate(divide="ignore", invalid="ignore"):
            vals, mask = L.numeric_math(np, self.get_param("op"), col.values, col.mask,
                                        scalar=float(self.get_param("scalar")))
        return NumericColumn(self.output_type, vals, mask)

    def torch_transform(self, v, m):
        return L.numeric_op(self.get_param("op"), v, m, scalar=float(self.get_param("scalar")))


class AliasTransformer(UnaryTransformer):
    """Rename a feature (AliasTransformer.scala:51): identity on values."""

    def __init__(self, name: str, uid: Optional[str] = None):
        super().__init__(operation_name="alias", input_type=T.FeatureType,
                         output_type=T.FeatureType, uid=uid, alias=name)

    def output_types(self) -> List[Type[T.FeatureType]]:
        return [self.inputs[0].ftype if self.inputs else self.output_type]

    def output_name(self, index: int = 0) -> str:
        return str(self.get_param("alias"))

    def transform_columns(self, cols: Sequence[Column]) -> Column:
        return cols[0]


class LambdaTransformer(UnaryTransformer):
    """User map function over scalars (RichFeature.map analog).  The callable
    is held as an FnExtractor so save/load round-trips it by source
    capture."""

    def __init__(self, fn: Callable[[T.FeatureType], T.FeatureType],
                 input_type: Type[T.FeatureType], output_type: Type[T.FeatureType],
                 uid: Optional[str] = None):
        super().__init__(operation_name="mapFn", input_type=input_type,
                         output_type=output_type, uid=uid)
        self.fn = FnExtractor(fn, output_type)

    def transform_fn(self, value: T.FeatureType) -> T.FeatureType:
        out = self.fn.fn(value)
        return out if isinstance(out, T.FeatureType) else self.output_type(out)


class FilterTransformer(UnaryTransformer):
    """Keep values matching a predicate, else empty (FilterTransformer)."""

    def __init__(self, predicate: Callable[[Any], bool],
                 input_type: Type[T.FeatureType] = T.Text, uid: Optional[str] = None):
        super().__init__(operation_name="filter", input_type=input_type,
                         output_type=input_type, uid=uid)
        self.predicate = FnExtractor(predicate, T.Binary)

    def output_types(self) -> List[Type[T.FeatureType]]:
        return [self.inputs[0].ftype if self.inputs else self.output_type]

    def transform_fn(self, value: T.FeatureType) -> T.FeatureType:
        ftype = self.inputs[0].ftype
        if value.is_empty or self.predicate.fn(value.value):
            return value if isinstance(value, ftype) else ftype(value.value)
        return T.default_of(ftype)


class ReplaceTransformer(UnaryTransformer):
    """Replace matching values (ReplaceTransformer / RichFeature.replaceWith)."""

    def __init__(self, match_value: Any, replace_with: Any,
                 input_type: Type[T.FeatureType] = T.Text, uid: Optional[str] = None):
        super().__init__(operation_name="replace", input_type=input_type,
                         output_type=input_type, uid=uid,
                         match_value=match_value, replace_with=replace_with)

    def output_types(self) -> List[Type[T.FeatureType]]:
        return [self.inputs[0].ftype if self.inputs else self.output_type]

    def transform_fn(self, value: T.FeatureType) -> T.FeatureType:
        ftype = self.inputs[0].ftype
        if not value.is_empty and value.value == self.get_param("match_value"):
            return ftype(self.get_param("replace_with"))
        return value if isinstance(value, ftype) else ftype(value.value)


class SubstringTransformer(BinaryTransformer):
    """(Text, Text) -> Binary: is the second a substring of the first
    (SubstringTransformer)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="substring", output_type=T.Binary, uid=uid)

    def transform_fn(self, a: T.FeatureType, b: T.FeatureType) -> T.FeatureType:
        if a.is_empty or b.is_empty:
            return T.Binary(None)
        return T.Binary(str(b.value).lower() in str(a.value).lower())


class ExistsTransformer(UnaryTransformer):
    """Any -> Binary presence flag (ExistsTransformer)."""

    def __init__(self, input_type: Type[T.FeatureType] = T.FeatureType,
                 uid: Optional[str] = None):
        super().__init__(operation_name="exists", input_type=input_type,
                         output_type=T.Binary, uid=uid)

    def transform_fn(self, value: T.FeatureType) -> T.FeatureType:
        return T.Binary(not value.is_empty)


class ToOccurTransformer(UnaryTransformer):
    """Any -> RealNN 1.0/0.0 occurrence (ToOccurTransformer.scala: the
    default ``matchFn`` is non-empty-and-truthy)."""

    def __init__(self, input_type: Type[T.FeatureType] = T.FeatureType,
                 uid: Optional[str] = None):
        super().__init__(operation_name="toOccur", input_type=input_type,
                         output_type=T.RealNN, uid=uid)

    def transform_fn(self, value: T.FeatureType) -> T.FeatureType:
        if value.is_empty:
            return T.RealNN(0.0)
        v = value.value
        if isinstance(v, (bool, int, float)):
            return T.RealNN(1.0 if v else 0.0)
        return T.RealNN(1.0)


class FillMissingWithMean(UnaryEstimator):
    """Real -> RealNN with the training mean filled in (FillMissingWithMean.scala)."""

    def __init__(self, default: float = 0.0, uid: Optional[str] = None):
        super().__init__(operation_name="fillWithMean", input_type=T.Real,
                         output_type=T.RealNN, uid=uid, default=default)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "FillMissingWithMeanModel":
        col = cols[0]
        assert isinstance(col, NumericColumn)
        mean = float(col.values[col.mask].mean()) if col.mask.any() \
            else float(self.get_param("default"))
        return FillMissingWithMeanModel(mean=mean, operation_name=self.operation_name,
                                        output_type=self.output_type)


class FillMissingWithMeanModel(Model):
    torch_output = "numeric"  # fused-layer protocol

    def __init__(self, mean: float, operation_name: str = "fillWithMean",
                 output_type=T.RealNN, uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.mean = float(mean)

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        vals = np.where(col.mask, col.values, self.mean)
        return NumericColumn(T.RealNN, vals, np.ones_like(col.mask))

    def torch_transform(self, v, m):
        return L.numeric_scale("fill", v, m, self.mean)


class DropIndicesByTransformer(UnaryTransformer):
    """OPVector -> OPVector dropping the columns whose metadata matches a
    predicate (DropIndicesByTransformer.scala).  The keep-set depends only
    on metadata: the host prep works it out, and the device program
    gathers the kept columns (K-Z's ``column_gather``)."""

    def __init__(self, predicate: Callable[[Any], bool], uid: Optional[str] = None):
        super().__init__(operation_name="dropIndicesBy", input_type=T.OPVector,
                         output_type=T.OPVector, uid=uid)
        self.predicate = FnExtractor(predicate, T.Binary)

    def _keep(self, col) -> Optional[List[int]]:
        if col.metadata is None:
            return None
        return [i for i, c in enumerate(col.metadata.columns) if not self.predicate.fn(c)]

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        col = cols[0]
        assert isinstance(col, VectorColumn)
        if col.metadata is None:
            return col
        keep = self._keep(col)
        return VectorColumn(T.OPVector, col.values[:, keep], self.torch_out_metadata(cols))

    # ---- fused-layer protocol ---------------------------------------------
    def torch_host_prep(self, cols) -> list:
        # every chunk of a plan has the same metadata, so the same keep-set
        self._kept = self._keep(cols[0])
        return [cols[0].values]

    def torch_transform(self, v):
        keep = getattr(self, "_kept", None)
        return v if keep is None else L.column_gather([v], [0] * len(keep), keep)

    def torch_out_metadata(self, cols):
        col = cols[0]
        if col.metadata is None:
            return None
        vm = col.metadata.select(self._keep(col))
        vm = type(vm)(self.get_outputs()[0].name, vm.columns)
        self.metadata["vector_metadata"] = vm
        return vm


class PredictionDeIndexer(UnaryTransformer):
    """Prediction -> Text original label through the indexer's labels
    (impl/preparators/PredictionDeIndexer.scala)."""

    def __init__(self, labels: Sequence[str], uid: Optional[str] = None):
        super().__init__(operation_name="deindexPred", input_type=T.Prediction,
                         output_type=T.Text, uid=uid, labels=list(labels))

    def transform_columns(self, cols: Sequence[Column]) -> ObjectColumn:
        col = cols[0]
        assert isinstance(col, PredictionColumn)
        labels = self.get_param("labels")
        out = np.empty(len(col), dtype=object)
        for i in range(len(col)):
            j = int(col.prediction[i])
            out[i] = labels[j] if 0 <= j < len(labels) else None
        return ObjectColumn(T.Text, out)

    def transform_row(self, row):
        v = row[self.inputs[0].name]
        labels = self.get_param("labels")
        j = int(v.prediction)
        return T.Text(labels[j] if 0 <= j < len(labels) else None)
