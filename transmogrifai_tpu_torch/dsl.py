"""DSL — the rich methods of ``Feature`` (the syntax layer).

The port's counterpart of ``transmogrifai_tpu/dsl.py`` (reference:
core/src/main/scala/com/salesforce/op/dsl/ ``RichNumericFeature``,
``RichTextFeature``, ``RichFeature``, ``RichVectorFeature``): the methods
are installed on ``Feature`` when this module imports (the package
``__init__`` imports it).  The port has the methods of the stages it has:
arithmetic with features and scalars, ``alias``, ``vectorize``,
``pivot``, ``smart_vectorize``, ``combine`` and ``sanity_check``, enough
for ``(sib_sp + par_ch + 1).alias("family_size")`` and the rest of the
Titanic flow (OpTitanicSimple.scala:77-130), ``tokenize`` and
``count_vectorize`` of text (RichTextFeature), and the value munging,
scaling and calibration methods (``map``, ``filter``,
``replace_with``, ``exists``, ``occurs``, ``z_normalize``,
``fill_missing_with_mean``, ``scale``, ``descale``, ``to_percentile``,
``to_isotonic_calibrated``, ``deindexed``; RichFeature, RichNumericFeature).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Type

from . import types as T
from .features.feature import Feature
from .impl.feature.smart_text import SmartTextVectorizer
from .impl.feature.text import OpCountVectorizer, TextTokenizer
from .impl.feature.scalers import (DescalerTransformer, IsotonicRegressionCalibrator,
                                   OpScalarStandardScaler, PercentileCalibrator,
                                   ScalerTransformer, ScalingType)
from .impl.feature.text import OpIndexToString
from .impl.feature.transformers import (AddTransformer, AliasTransformer, DivideTransformer,
                                        ExistsTransformer, FillMissingWithMean,
                                        FilterTransformer, LambdaTransformer,
                                        MultiplyTransformer, ReplaceTransformer,
                                        ScalarMathTransformer, SubtractTransformer,
                                        ToOccurTransformer)
from .impl.feature.transmogrifier import transmogrify
from .impl.feature.vectorizers import OneHotVectorizer, VectorsCombiner


def _unary(stage, feature: Feature) -> Feature:
    return stage.set_input(feature).get_output()


def _binary_math(stage_cls, scalar_op: str):
    def method(self: Feature, other):
        if isinstance(other, Feature):
            return stage_cls().set_input(self, other).get_output()
        if not isinstance(other, (int, float)):
            return NotImplemented
        return _unary(ScalarMathTransformer(scalar_op, float(other)), self)
    return method


def _r_scalar(op: str):
    def method(self: Feature, other):
        if not isinstance(other, (int, float)):
            return NotImplemented
        return _unary(ScalarMathTransformer(op, float(other)), self)
    return method


def alias(self: Feature, name: str) -> Feature:
    return _unary(AliasTransformer(name), self)


def vectorize(self: Feature, *others: Feature, label: Optional[Feature] = None,
              **kw) -> Feature:
    """Type-default vectorization of this + more features
    (RichFeature.vectorize / transmogrify on one group)."""
    return transmogrify([self, *others], label=label, **kw)


def smart_vectorize(self: Feature, *others: Feature, **kw) -> Feature:
    return SmartTextVectorizer(**kw).set_input(self, *others).get_output()


def pivot(self: Feature, *others: Feature, top_k: int = 20, min_support: int = 10,
          **kw) -> Feature:
    """Categorical one-hot pivot (RichTextFeature.pivot)."""
    return OneHotVectorizer(top_k=top_k, min_support=min_support, **kw) \
        .set_input(self, *others).get_output()


def tokenize(self: Feature, **kw) -> Feature:
    return _unary(TextTokenizer(**kw), self)


def count_vectorize(self: Feature, **kw) -> Feature:
    return _unary(OpCountVectorizer(**kw), self)


def sanity_check(self: Feature, label: Feature, **kw) -> Feature:
    """RichVectorFeature.sanityCheck — label-aware feature QA."""
    from .impl.preparators.sanity_checker import SanityChecker

    return SanityChecker(**kw).set_input(label, self).get_output()


def combine(self: Feature, *others: Feature) -> Feature:
    return VectorsCombiner().set_input(self, *others).get_output()


def map_fn(self: Feature, fn: Callable, output_type: Type[T.FeatureType]) -> Feature:
    return _unary(LambdaTransformer(fn, self.ftype, output_type), self)


def filter_by(self: Feature, predicate: Callable[[Any], bool]) -> Feature:
    return _unary(FilterTransformer(predicate, self.ftype), self)


def replace_with(self: Feature, match_value: Any, replace_value: Any) -> Feature:
    return _unary(ReplaceTransformer(match_value, replace_value, self.ftype), self)


def exists(self: Feature) -> Feature:
    return _unary(ExistsTransformer(self.ftype), self)


def occurs(self: Feature) -> Feature:
    return _unary(ToOccurTransformer(self.ftype), self)


def z_normalize(self: Feature) -> Feature:
    """RichNumericFeature.zNormalize."""
    return _unary(OpScalarStandardScaler(), self)


def fill_missing_with_mean(self: Feature, default: float = 0.0) -> Feature:
    return _unary(FillMissingWithMean(default=default), self)


def scale(self: Feature, scaling_type=None, slope: float = 1.0,
          intercept: float = 0.0) -> Feature:
    """Invertible scaling (RichNumericFeature.scale:347); pair with ``descale``."""
    st = scaling_type if scaling_type is not None else ScalingType.Linear
    return _unary(ScalerTransformer(scaling_type=st, slope=slope, intercept=intercept), self)


def descale(self: Feature, scaled: Feature) -> Feature:
    """Invert a sibling ``scale`` by its recorded scaler args
    (RichNumericFeature.descale:362): ``value.descale(scaled_origin)``."""
    return DescalerTransformer().set_input(self, scaled).get_output()


def to_percentile(self: Feature, buckets: int = 100) -> Feature:
    """RichNumericFeature.toPercentile:387 (PercentileCalibrator)."""
    return _unary(PercentileCalibrator(buckets=buckets), self)


def to_isotonic_calibrated(self: Feature, label: Feature) -> Feature:
    """RichNumericFeature.toIsotonicCalibrated:398."""
    return IsotonicRegressionCalibrator().set_input(label, self).get_output()


def deindexed(self: Feature, labels: Sequence[str]) -> Feature:
    """Index -> original string label (RichNumericFeature.deindexed:418)."""
    return _unary(OpIndexToString(labels=list(labels)), self)


_METHODS = {
    "map": map_fn, "filter": filter_by, "replace_with": replace_with, "exists": exists,
    "occurs": occurs, "z_normalize": z_normalize,
    "fill_missing_with_mean": fill_missing_with_mean, "scale": scale, "descale": descale,
    "to_percentile": to_percentile, "to_isotonic_calibrated": to_isotonic_calibrated,
    "deindexed": deindexed,
    "alias": alias, "vectorize": vectorize, "smart_vectorize": smart_vectorize,
    "pivot": pivot, "sanity_check": sanity_check, "combine": combine,
    "tokenize": tokenize, "count_vectorize": count_vectorize,
    "__add__": _binary_math(AddTransformer, "plus"),
    "__sub__": _binary_math(SubtractTransformer, "minus"),
    "__mul__": _binary_math(MultiplyTransformer, "multiply"),
    "__truediv__": _binary_math(DivideTransformer, "divide"),
    "__radd__": _r_scalar("plus"),
    "__rsub__": _r_scalar("rminus"),
    "__rmul__": _r_scalar("multiply"),
    "__rtruediv__": _r_scalar("rdivide"),
}


def install() -> None:
    """Install the DSL methods on Feature (idempotent)."""
    for name, fn in _METHODS.items():
        setattr(Feature, name, fn)


install()
