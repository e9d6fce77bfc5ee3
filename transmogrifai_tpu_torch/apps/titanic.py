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
(LinearSVC, NaiveBayes, DecisionTree, MLP).  ``text_columns(n, seed)`` adds
a free-text column ``Notes``, which ``build_workflow(text_embeddings=True)``
embeds by Word2Vec and LDA beside the flow's other features.
``build_workflow(reference_features=True)`` builds the reference's own
OpTitanicSimple feature set instead (OpTitanicSimple.scala:77-120):
``family_size``, ``estimated_cost = family_size * Fare``, ``Sex.pivot()``,
``Age.fill_missing_with_mean().z_normalize()`` and an ``age_group``
(``Age.map``) beside the raw predictors, all through ``transmogrify``.
``build_workflow(selector=...)`` picks the selector over the checked
vector: ``"cv"`` (the default: the binary selector, 3-fold CV),
``"split"`` (the binary selector's ``with_train_validation_split``) or
``"multiclass"`` (``MultiClassificationModelSelector``, 3-fold CV: the
two-class label under the multiclass evaluator).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..features.builder import FeatureBuilder
from ..impl.selector.factories import (BinaryClassificationModelSelector,
                                      MultiClassificationModelSelector)
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


#: the Notes column's generator: vocabulary size, topics, Zipf exponent,
#: Dirichlet concentration, token counts [low, high], null share
NOTES_VOCAB = 2000
NOTES_TOPICS = 4
NOTES_ZIPF = 1.1
NOTES_DIRICHLET = 0.3
NOTES_TOKENS = (8, 32)
NOTES_NULL = 0.01


def text_columns(n: int = 891, seed: int = 0) -> Dict[str, np.ndarray]:
    """``titanic_data(n, seed)``'s columns plus ``Notes``, a case-description
    field: each row draws a Dirichlet(0.3) mixture of 4 topics (topic 0's
    weight doubled for survivors, then renormalised, so the text carries
    signal) and 8-32 tokens (uniform), each token a topic from the mixture
    and a word from that topic's Zipf(1.1) distribution over its own
    permutation of the 2,000 types ``w0000``...``w1999``; 1% of rows are
    null.  All draws come from one generator seeded by ``seed``."""
    cols = titanic_data(n, seed)
    rng = np.random.default_rng([seed, 10])
    vocab = np.array([f"w{i:04d}" for i in range(NOTES_VOCAB)], dtype=object)
    zipf = 1.0 / np.arange(1, NOTES_VOCAB + 1) ** NOTES_ZIPF
    cdfs = []
    for _ in range(NOTES_TOPICS):
        p = np.empty(NOTES_VOCAB)
        p[rng.permutation(NOTES_VOCAB)] = zipf / zipf.sum()
        cdfs.append(np.cumsum(p))
    mix = rng.dirichlet(np.full(NOTES_TOPICS, NOTES_DIRICHLET), n)
    mix[:, 0] *= np.where(cols["Survived"] == 1, 2.0, 1.0)
    mix /= mix.sum(axis=1, keepdims=True)
    lengths = rng.integers(NOTES_TOKENS[0], NOTES_TOKENS[1] + 1, n)
    row = np.repeat(np.arange(n), lengths)
    mix_cdf = np.cumsum(mix, axis=1)
    topic = np.minimum((rng.random(row.size)[:, None] > mix_cdf[row]).sum(axis=1),
                       NOTES_TOPICS - 1)
    u = rng.random(row.size)
    words = np.empty(row.size, dtype=np.int64)
    for t in range(NOTES_TOPICS):
        at = topic == t
        words[at] = np.minimum(np.searchsorted(cdfs[t], u[at], side="right"), NOTES_VOCAB - 1)
    tokens = vocab[words]
    ends = np.cumsum(lengths)
    notes = np.array([" ".join(tokens[e - m:e]) for e, m in zip(ends, lengths)], dtype=object)
    notes[rng.random(n) < NOTES_NULL] = None
    cols["Notes"] = notes
    return cols


def age_group(v):
    """OpTitanicSimple's ``ageGroup``: "adult" above 18, else "child"; empty
    stays empty."""
    return None if v.value is None else ("adult" if v.value > 18 else "child")


def reference_features(survived, F=FeatureBuilder, types=T):
    """OpTitanicSimple's predictors (OpTitanicSimple.scala:77-120) through
    ``transmogrify``: the raw Pclass, Name, Age, SibSp, Parch, Ticket, Cabin
    and Embarked (Ticket and Cabin as PickList), ``family_size = SibSp +
    Parch + 1``, ``estimated_cost = family_size * Fare``, ``Sex.pivot()``,
    ``Age.fill_missing_with_mean().z_normalize()`` (a RealNN) and
    ``age_group``.  ``F`` and ``types`` are the feature builder and types of
    the package that builds it (the tests build the JAX package's the same
    way); returns the combined vector feature."""
    pclass = F("Pclass", types.PickList).extract(field="Pclass").as_predictor()
    name = F("Name", types.Text).extract(field="Name").as_predictor()
    sex = F("Sex", types.PickList).extract(field="Sex").as_predictor()
    age = F("Age", types.Real).extract(field="Age").as_predictor()
    sib_sp = F("SibSp", types.Integral).extract(field="SibSp").as_predictor()
    par_ch = F("Parch", types.Integral).extract(field="Parch").as_predictor()
    ticket = F("Ticket", types.PickList).extract(field="Ticket").as_predictor()
    fare = F("Fare", types.Real).extract(field="Fare").as_predictor()
    cabin = F("Cabin", types.PickList).extract(field="Cabin").as_predictor()
    embarked = F("Embarked", types.PickList).extract(field="Embarked").as_predictor()
    family_size = (sib_sp + par_ch + 1).alias("family_size")
    estimated_cost = (family_size * fare).alias("estimated_cost")
    pivoted_sex = sex.pivot()
    normed_age = age.fill_missing_with_mean().z_normalize()
    group = age.map(age_group, types.PickList)
    return pclass.vectorize(name, age, sib_sp, par_ch, ticket, cabin, embarked, family_size,
                            estimated_cost, pivoted_sex, group, normed_age)


def build_workflow(model_types: Optional[Sequence[str]] = None,
                   models_and_parameters: Optional[Sequence[Any]] = None,
                   sanity_check_params: Optional[Dict[str, Any]] = None,
                   text_embeddings: bool = False, reference_features: bool = False,
                   selector: str = "cv"):
    """(OpWorkflow, prediction feature) of the Titanic flow; by default the
    binary selector's stock space (LR + RF + XGBoost, 28 candidates).
    ``sanity_check_params`` are the sanity checker's keyword arguments
    (``sample_upper_limit``, ``correlation_type``, ``sharded_stats``, ...).
    With ``text_embeddings`` the free-text ``Notes`` column (``text_columns``)
    joins the combined vector twice: its tokens' mean Word2Vec vector
    (``OpWord2Vec()``: 64 dimensions) and the LDA topic mixture of its
    token counts (``count_vectorize()``: 512 terms, ``OpLDA()``: 10
    topics).  With ``reference_features`` the predictors are OpTitanicSimple's
    (``reference_features``).  ``selector`` is ``"cv"``, ``"split"`` or
    ``"multiclass"`` (``SELECTORS``)."""
    F = FeatureBuilder
    survived = F("Survived", T.RealNN).extract(field="Survived").as_response()
    if reference_features:
        return _selector_flow(survived, globals()["reference_features"](survived),
                              model_types, models_and_parameters, sanity_check_params,
                              selector)
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
    vectors = [sex.pivot(pclass, embarked, top_k=10, min_support=1),
               name.smart_vectorize(max_cardinality=10, num_hashes=64, min_support=1)]
    if text_embeddings:
        from ..impl.feature.embeddings import OpLDA, OpWord2Vec

        notes = F("Notes", T.Text).extract(field="Notes").as_predictor()
        tokens = notes.tokenize()
        vectors += [OpWord2Vec().set_input(tokens).get_output(),
                    OpLDA().set_input(tokens.count_vectorize()).get_output()]
    features = family_size.vectorize(age, fare, label=survived).combine(*vectors)
    return _selector_flow(survived, features, model_types, models_and_parameters,
                          sanity_check_params, selector)


#: the selectors ``build_workflow`` takes: (factory, method, its arguments)
SELECTORS = {
    "cv": (BinaryClassificationModelSelector, "with_cross_validation",
           {"num_folds": 3, "seed": 42}),
    "split": (BinaryClassificationModelSelector, "with_train_validation_split", {"seed": 42}),
    "multiclass": (MultiClassificationModelSelector, "with_cross_validation",
                   {"num_folds": 3, "seed": 42}),
}


def _selector_flow(survived, features, model_types, models_and_parameters,
                   sanity_check_params, selector="cv"):
    """The sanity check and the ``selector`` (``SELECTORS``) over
    ``features``: (OpWorkflow, prediction feature)."""
    checked = features.sanity_check(survived, **(sanity_check_params or {}))
    factory, method, args = SELECTORS[selector]
    pred = getattr(factory, method)(
        model_types=model_types, models_and_parameters=models_and_parameters, **args,
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
