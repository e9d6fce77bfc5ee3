"""Feature arithmetic and aliasing on the scoring path.

The port's copy of the slice's stages of
``transmogrifai_tpu/impl/feature/transformers.py`` (reference:
``MathTransformers``, ``AliasTransformer.scala:51``): ``AddTransformer``,
``SubtractTransformer``, ``MultiplyTransformer``, ``DivideTransformer``,
``ScalarMathTransformer`` and ``AliasTransformer``.  As in the JAX package,
a stage alone in its layer computes on the host in float64
(``transform_columns``), and one fused with other stages of its layer, or
any one in a layer of more than 200,000 rows (the JAX package's streamed
chunk program), on the device in float32 (``torch_transform``: K-Z's
``numeric_op``, ``ops/layer.py``).  Both run ``ops/layer.numeric_math``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Type

import numpy as np

from ... import types as T
from ...columns import Column, NumericColumn
from ...ops import layer as L
from ...stages.base import BinaryTransformer, UnaryTransformer


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
