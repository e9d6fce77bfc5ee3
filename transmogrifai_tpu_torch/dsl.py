"""DSL — the rich methods of ``Feature`` (the syntax layer).

The port's counterpart of ``transmogrifai_tpu/dsl.py`` (reference:
core/src/main/scala/com/salesforce/op/dsl/ ``RichNumericFeature``,
``RichTextFeature``, ``RichFeature``, ``RichVectorFeature``): the methods
are installed on ``Feature`` when this module imports (the package
``__init__`` imports it).  The port has the methods of the stages it has:
arithmetic with features and scalars, ``alias``, ``vectorize``,
``pivot``, ``smart_vectorize``, ``combine`` and ``sanity_check``, enough
for ``(sib_sp + par_ch + 1).alias("family_size")`` and the rest of the
Titanic flow (OpTitanicSimple.scala:77-130).
"""
from __future__ import annotations

from typing import Optional

from .features.feature import Feature
from .impl.feature.smart_text import SmartTextVectorizer
from .impl.feature.transformers import (AddTransformer, AliasTransformer, DivideTransformer,
                                        MultiplyTransformer, ScalarMathTransformer,
                                        SubtractTransformer)
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


def sanity_check(self: Feature, label: Feature, **kw) -> Feature:
    """RichVectorFeature.sanityCheck — label-aware feature QA."""
    from .impl.preparators.sanity_checker import SanityChecker

    return SanityChecker(**kw).set_input(label, self).get_output()


def combine(self: Feature, *others: Feature) -> Feature:
    return VectorsCombiner().set_input(self, *others).get_output()


_METHODS = {
    "alias": alias, "vectorize": vectorize, "smart_vectorize": smart_vectorize,
    "pivot": pivot, "sanity_check": sanity_check, "combine": combine,
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
