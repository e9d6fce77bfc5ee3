"""Evaluators (reference core/src/main/scala/com/salesforce/op/evaluators/).

The port's copy of ``transmogrifai_tpu/evaluators``: the binary
classification, multiclass classification and regression evaluators and the
``Evaluators`` factory's AuPR metric
(``Evaluators.BinaryClassification.auPR()``, Evaluators.scala:40), the
binary selector's default, its multiclass F1, Precision, Recall and Error
metrics (``Evaluators.MultiClassification``; Error is the multiclass
selector's default) and its RMSE metric (``Evaluators.Regression.rmse()``),
the regression selector's default.  The factory's other metrics, custom
metrics, log loss and the forecast evaluator are not ported.
"""
from .base import (OpBinaryClassificationEvaluatorBase, OpEvaluatorBase,
                   OpMultiClassificationEvaluatorBase, OpRegressionEvaluatorBase)
from .classification import (OpBinaryClassificationEvaluator, OpMultiClassificationEvaluator,
                             binary_counts, pr_auc, roc_auc)
from .regression import OpRegressionEvaluator


class _SingleMetric(OpEvaluatorBase):
    """Wrap a full evaluator, exposing one metric as the default."""

    def __init__(self, inner: OpEvaluatorBase, metric: str, larger_better: bool):
        super().__init__(inner.label_col, inner.prediction_col)
        self.inner = inner
        self.name = f"{inner.name}.{metric}"
        self.default_metric = metric
        self.is_larger_better = larger_better

    def evaluate_all(self, ds, label_col=None, prediction_col=None):
        return self.inner.evaluate_all(ds, label_col, prediction_col)

    def evaluate_arrays(self, y, prediction, probability=None):
        return self.inner.evaluate_arrays(y, prediction, probability)


class Evaluators:
    class BinaryClassification:
        @staticmethod
        def auPR() -> OpEvaluatorBase:
            return _SingleMetric(OpBinaryClassificationEvaluator(), "AuPR", True)

    class MultiClassification:
        @staticmethod
        def f1() -> OpEvaluatorBase:
            return _SingleMetric(OpMultiClassificationEvaluator(), "F1", True)

        @staticmethod
        def precision() -> OpEvaluatorBase:
            return _SingleMetric(OpMultiClassificationEvaluator(), "Precision", True)

        @staticmethod
        def recall() -> OpEvaluatorBase:
            return _SingleMetric(OpMultiClassificationEvaluator(), "Recall", True)

        @staticmethod
        def error() -> OpEvaluatorBase:
            return _SingleMetric(OpMultiClassificationEvaluator(), "Error", False)

    class Regression:
        @staticmethod
        def rmse() -> OpEvaluatorBase:
            return _SingleMetric(OpRegressionEvaluator(), "RootMeanSquaredError", False)
