"""ModelSelector factories.

The port's counterpart of ``transmogrifai_tpu/impl/selector/factories.py``
(reference: BinaryClassificationModelSelector.scala:49,
MultiClassificationModelSelector.scala:49, RegressionModelSelector.scala:49,
shared ModelSelectorFactory.scala:43):
``with_cross_validation`` / ``apply`` build a ``ModelSelector`` with the
problem's default splitter and metric (the train-validation split is not
ported).  The stock spaces are the JAX package's: for the binary selector
logistic regression (8 candidates), random forest (18) and XGBoost (2);
for the multiclass selector logistic regression (8, multinomial) and
random forest (18); for the regression selector linear regression (8),
random forest (18) and GBT (18); ``model_types`` keeps the named families
of them.  Every family the port fits is importable from here, as from the
JAX package's module, for ``models_and_parameters``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from ...evaluators import Evaluators
from ...evaluators.base import OpEvaluatorBase
from ..classification.logistic import OpLogisticRegression
from ..classification.mlp import OpMultilayerPerceptronClassifier
from ..classification.naive_bayes import OpNaiveBayes
from ..classification.svc import OpLinearSVC
from ..classification.trees import (OpDecisionTreeClassifier, OpGBTClassifier,
                                    OpRandomForestClassifier, OpXGBoostClassifier)
from ..regression.glm import OpGeneralizedLinearRegression
from ..regression.linear import OpLinearRegression
from ..regression.trees import (OpDecisionTreeRegressor, OpGBTRegressor,
                                OpRandomForestRegressor, OpXGBoostRegressor)
from ..tuning.splitters import DataBalancer, DataCutter, DataSplitter, Splitter
from ..tuning.validators import DEFAULT_NUM_FOLDS, OpCrossValidation
from . import defaults as D
from .model_selector import ModelSelector

__all__ = ["BinaryClassificationModelSelector", "MultiClassificationModelSelector",
           "RegressionModelSelector", "OpLogisticRegression", "OpLinearSVC", "OpNaiveBayes",
           "OpMultilayerPerceptronClassifier", "OpDecisionTreeClassifier",
           "OpRandomForestClassifier", "OpGBTClassifier", "OpXGBoostClassifier",
           "OpLinearRegression", "OpGeneralizedLinearRegression", "OpDecisionTreeRegressor",
           "OpRandomForestRegressor", "OpGBTRegressor", "OpXGBoostRegressor"]

Candidates = Sequence[Tuple[Any, Sequence[Dict[str, Any]]]]


class _SelectorFactory:
    """Shared construction logic (ModelSelectorFactory.scala:43)."""

    problem_type = "Unknown"

    @classmethod
    def _default_models(cls) -> Candidates:
        raise NotImplementedError

    @classmethod
    def _default_splitter(cls) -> Splitter:
        raise NotImplementedError

    @classmethod
    def _default_evaluator(cls) -> OpEvaluatorBase:
        raise NotImplementedError

    @classmethod
    def _models_for(cls, model_types: Optional[Sequence[str]],
                    models_and_params: Optional[Candidates]) -> Candidates:
        if models_and_params is not None:
            return models_and_params
        models = cls._default_models()
        if model_types is not None:
            wanted = set(model_types)
            models = [(e, g) for e, g in models if type(e).__name__ in wanted]
            if not models:
                raise ValueError(f"No candidate models left for types {sorted(wanted)}")
        return models

    @classmethod
    def _build(cls, validator, splitter, model_types, models_and_params,
               evaluators) -> ModelSelector:
        sel = ModelSelector(validator=validator, splitter=splitter,
                            models=cls._models_for(model_types, models_and_params),
                            evaluators=evaluators)
        sel.problem_type = cls.problem_type
        return sel

    @classmethod
    def with_cross_validation(cls, splitter: Optional[Splitter] = None,
                              num_folds: int = DEFAULT_NUM_FOLDS,
                              validation_metric: Optional[OpEvaluatorBase] = None,
                              trained_model_evaluators: Sequence[OpEvaluatorBase] = (),
                              seed: int = 42, stratify: bool = False,
                              model_types: Optional[Sequence[str]] = None,
                              models_and_parameters: Optional[Candidates] = None
                              ) -> ModelSelector:
        ev = validation_metric or cls._default_evaluator()
        return cls._build(
            OpCrossValidation(ev, num_folds=num_folds, seed=seed, stratify=stratify),
            splitter if splitter is not None else cls._default_splitter(),
            model_types, models_and_parameters, list(trained_model_evaluators))

    @classmethod
    def apply(cls) -> ModelSelector:
        return cls.with_cross_validation()


class BinaryClassificationModelSelector(_SelectorFactory):
    """Defaults: LR + RF + XGBoost grids, DataBalancer, auPR metric
    (BinaryClassificationModelSelector.scala:62-63,172)."""

    problem_type = "BinaryClassification"

    @classmethod
    def _default_models(cls) -> Candidates:
        return [
            (OpLogisticRegression(max_iter=50), D.logistic_regression_grid()),
            (OpRandomForestClassifier(), D.random_forest_grid()),
            (OpXGBoostClassifier(), D.xgboost_grid()),
        ]

    @classmethod
    def _default_splitter(cls) -> Splitter:
        return DataBalancer(sample_fraction=0.1, reserve_test_fraction=0.1)

    @classmethod
    def _default_evaluator(cls) -> OpEvaluatorBase:
        return Evaluators.BinaryClassification.auPR()


class MultiClassificationModelSelector(_SelectorFactory):
    """Defaults: LR + RF grids, DataCutter, Error metric
    (MultiClassificationModelSelector.scala:62,145)."""

    problem_type = "MultiClassification"

    @classmethod
    def _default_models(cls) -> Candidates:
        return [
            (OpLogisticRegression(max_iter=50), D.logistic_regression_grid()),
            (OpRandomForestClassifier(), D.random_forest_grid()),
        ]

    @classmethod
    def _default_splitter(cls) -> Splitter:
        return DataCutter(max_label_categories=100, min_label_fraction=0.0,
                          reserve_test_fraction=0.1)

    @classmethod
    def _default_evaluator(cls) -> OpEvaluatorBase:
        return Evaluators.MultiClassification.error()


class RegressionModelSelector(_SelectorFactory):
    """Defaults: LinReg + RF + GBT grids, DataSplitter, RMSE metric
    (RegressionModelSelector.scala:62,157)."""

    problem_type = "Regression"

    @classmethod
    def _default_models(cls) -> Candidates:
        return [
            (OpLinearRegression(max_iter=50), D.linear_regression_grid()),
            (OpRandomForestRegressor(), D.random_forest_grid()),
            (OpGBTRegressor(), D.gbt_grid()),
        ]

    @classmethod
    def _default_splitter(cls) -> Splitter:
        return DataSplitter(reserve_test_fraction=0.1)

    @classmethod
    def _default_evaluator(cls) -> OpEvaluatorBase:
        return Evaluators.Regression.rmse()
