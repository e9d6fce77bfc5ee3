"""Feature arithmetic and aliasing on the scoring path.

The port's copy of the slice's stages of
``transmogrifai_tpu/impl/feature/transformers.py`` (reference:
``MathTransformers``, ``AliasTransformer.scala:51``): ``AddTransformer``,
``SubtractTransformer``, ``MultiplyTransformer``, ``DivideTransformer``,
``ScalarMathTransformer`` and ``AliasTransformer``.  As in the JAX package,
a stage alone in its layer computes on the host in float64
(``transform_columns``), and one fused with other stages of its layer
computes on the device in float32 (``torch_transform``: plain torch ops).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Type

import numpy as np
import torch

from ... import types as T
from ...columns import Column, NumericColumn
from ...stages.base import BinaryTransformer, UnaryTransformer


class _NumericBinaryOp(BinaryTransformer):
    """Elementwise arithmetic on two numeric features; missing operands
    follow the reference's semantics: the present side wins for +/- (missing
    treated as absent, not zero-poisoning), both required for * and /."""

    op: str = "?"
    torch_output = "numeric"  # fused-layer protocol: returns (values, mask)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name=self.op, output_type=T.Real, uid=uid)

    def _apply(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _compute(self, xp, av, am, bv, bm):
        """Backend-generic body shared by the numpy (host) and torch (device)
        paths."""
        vals = self._apply(av, bv)
        if self.op in ("plus", "minus"):
            only_a = am & ~bm
            only_b = bm & ~am
            vals = xp.where(only_a, av, vals)
            vals = xp.where(only_b, bv if self.op == "plus" else -bv, vals)
            mask = am | bm
        else:
            mask = am & bm & xp.isfinite(vals)
        return xp.where(mask, vals, 0.0), mask

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        a, b = cols
        assert isinstance(a, NumericColumn) and isinstance(b, NumericColumn)
        with np.errstate(divide="ignore", invalid="ignore"):
            vals, mask = self._compute(np, a.values, a.mask, b.values, b.mask)
        return NumericColumn(T.Real, vals, mask)

    def torch_transform(self, av, am, bv, bm):
        return self._compute(torch, av, am, bv, bm)


class AddTransformer(_NumericBinaryOp):
    op = "plus"

    def _apply(self, a, b):
        return a + b


class SubtractTransformer(_NumericBinaryOp):
    op = "minus"

    def _apply(self, a, b):
        return a - b


class MultiplyTransformer(_NumericBinaryOp):
    op = "multiply"

    def _apply(self, a, b):
        return a * b


class DivideTransformer(_NumericBinaryOp):
    op = "divide"

    def _apply(self, a, b):
        return a / b


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
        assert op in ("plus", "minus", "multiply", "divide", "power", "abs",
                      "log", "exp", "sqrt", "rminus", "rdivide",
                      "ceil", "floor", "round")
        super().__init__(operation_name=f"{op}Scalar", input_type=T.Real,
                         output_type=(T.Integral
                                      if self._is_integral(op, float(scalar))
                                      else T.Real),
                         uid=uid, op=op, scalar=float(scalar))

    def _compute(self, xp, v, m):
        op, s = self.get_param("op"), float(self.get_param("scalar"))
        vals = {
            "plus": lambda: v + s, "minus": lambda: v - s,
            "multiply": lambda: v * s, "divide": lambda: v / s,
            "power": lambda: v ** s, "abs": lambda: xp.abs(v),
            "log": lambda: xp.log(v), "exp": lambda: xp.exp(v),
            "sqrt": lambda: xp.sqrt(v),
            "rminus": lambda: s - v, "rdivide": lambda: s / v,
            "ceil": lambda: xp.ceil(v), "floor": lambda: xp.floor(v),
            # round(digits) scales by 10^digits; HALF-UP like the reference
            # (scala.math.round = floor(x + 0.5)), not banker's rounding
            "round": lambda: xp.floor(v * (10.0 ** s) + 0.5) / (10.0 ** s),
        }[op]()
        mask = m & xp.isfinite(vals)
        return xp.where(mask, vals, 0.0), mask

    def transform_columns(self, cols: Sequence[Column]) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        with np.errstate(divide="ignore", invalid="ignore"):
            vals, mask = self._compute(np, col.values, col.mask)
        return NumericColumn(self.output_type, vals, mask)

    def torch_transform(self, v, m):
        return self._compute(torch, v, m)


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
