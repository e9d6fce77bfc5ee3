"""OpTitanicSimple on the port: the Titanic survival flow and its data.

The port's copy of ``helloworld/titanic.py`` (reference:
helloworld/src/main/scala/com/salesforce/hw/OpTitanicSimple.scala:77-130):
typed raw features, the ``sibSp + parCh + 1`` derived feature, vectorize /
pivot / smart-vectorize / combine, the sanity check, and a
``BinaryClassificationModelSelector`` cross-validated sweep.  The data is
the JAX package's synthetic Titanic frame, as numpy columns (the port has
no pandas outside the reader's DataFrame branch); ``titanic_data(n, seed)``
draws larger frames of the same schema with the same label rule;
``families_space`` is the space of the binary selector's other families
(LinearSVC, NaiveBayes, DecisionTree, MLP).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..features.builder import FeatureBuilder
from ..impl.selector.factories import BinaryClassificationModelSelector
from ..workflow.workflow import OpWorkflow


def titanic_data(n: int = 891, seed: int = 0) -> Dict[str, np.ndarray]:
    """The synthetic Titanic frame: at n = 891 and seed 0 the JAX package's
    ``helloworld/titanic.py::titanic_data`` column for column (Survived is
    female, or true with probability 0.2)."""
    rng = np.random.default_rng(seed)
    sex = rng.choice(["male", "female"], n)
    pclass = rng.choice([1, 2, 3], n)
    age = rng.uniform(1, 80, n)
    y = ((sex == "female") | (rng.random(n) < 0.2)).astype(int)
    return {
        "PassengerId": np.arange(1, n + 1), "Survived": y, "Pclass": pclass,
        "Name": np.array(["p"] * n, dtype=object), "Sex": sex.astype(object), "Age": age,
        "SibSp": rng.integers(0, 4, n), "Parch": rng.integers(0, 3, n),
        "Ticket": np.array(["t"] * n, dtype=object), "Fare": rng.uniform(5, 100, n),
        "Cabin": np.array([None] * n, dtype=object),
        "Embarked": rng.choice(["S", "C", "Q"], n).astype(object)}


def build_workflow(model_types: Optional[Sequence[str]] = None,
                   models_and_parameters: Optional[Sequence[Any]] = None,
                   sanity_check_params: Optional[Dict[str, Any]] = None):
    """(OpWorkflow, prediction feature) of the Titanic flow; by default the
    binary selector's stock space (LR + RF + XGBoost, 28 candidates).
    ``sanity_check_params`` are the sanity checker's keyword arguments
    (``sample_upper_limit``, ``correlation_type``, ``sharded_stats``, ...)."""
    F = FeatureBuilder
    survived = F("Survived", T.RealNN).extract(field="Survived").as_response()
    pclass = F("Pclass", T.PickList).extract(field="Pclass").as_predictor()
    name = F("Name", T.Text).extract(field="Name").as_predictor()
    sex = F("Sex", T.PickList).extract(field="Sex").as_predictor()
    age = F("Age", T.Real).extract(field="Age").as_predictor()
    sib_sp = F("SibSp", T.Integral).extract(field="SibSp").as_predictor()
    par_ch = F("Parch", T.Integral).extract(field="Parch").as_predictor()
    fare = F("Fare", T.Real).extract(field="Fare").as_predictor()
    embarked = F("Embarked", T.PickList).extract(field="Embarked").as_predictor()
    # the reference's derived feature (OpTitanicSimple.scala:93)
    family_size = (sib_sp + par_ch + 1).alias("family_size")
    features = family_size.vectorize(age, fare, label=survived).combine(
        sex.pivot(pclass, embarked, top_k=10, min_support=1),
        name.smart_vectorize(max_cardinality=10, num_hashes=64, min_support=1))
    checked = features.sanity_check(survived, **(sanity_check_params or {}))
    pred = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, model_types=model_types,
        models_and_parameters=models_and_parameters,
    ).set_input(survived, checked).get_output()
    return OpWorkflow().set_result_features(pred), pred


def families_space(naive_bayes: bool = True) -> List[Tuple[Any, List[Dict[str, Any]]]]:
    """The binary selector's other families as a ``models_and_parameters``
    space: LinearSVC x ``linear_svc_grid()`` (4), NaiveBayes x
    ``naive_bayes_grid()`` (1), DecisionTree x ``decision_tree_grid()`` (18)
    and the default MLP (1): 24 candidates.  Naive Bayes is not a fused
    family, so this space trains on the per-family sweep; without it (23
    candidates) on the fused one."""
    from ..impl.classification.mlp import OpMultilayerPerceptronClassifier
    from ..impl.classification.naive_bayes import OpNaiveBayes
    from ..impl.classification.svc import OpLinearSVC
    from ..impl.classification.trees import OpDecisionTreeClassifier
    from ..impl.selector import defaults as D

    return ([(OpLinearSVC(), D.linear_svc_grid())]
            + ([(OpNaiveBayes(), D.naive_bayes_grid())] if naive_bayes else [])
            + [(OpDecisionTreeClassifier(), D.decision_tree_grid()),
               (OpMultilayerPerceptronClassifier(), [{}])])


def train_titanic(cols: Optional[Dict[str, np.ndarray]] = None, device=None, **kw):
    """Train the Titanic flow on ``cols`` (default: the 891-row frame) on
    ``device``, ``kw`` passed to ``build_workflow``; returns (the
    OpWorkflowModel, the workflow)."""
    wf, _ = build_workflow(**kw)
    model = wf.set_input_dataset(titanic_data() if cols is None else cols,
                                 key="PassengerId").train(device=device)
    return model, wf
