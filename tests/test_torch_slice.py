"""PyTorch port vs JAX package: the serve slice end to end.

Small Titanic workflows (``helloworld/titanic.py``'s flow: DSL arithmetic,
transmogrification, sanity check, a model selector) are trained and saved
by the JAX package, one per predictor family of the stock binary grid
(XGBoost at num_round=10 / max_depth=4, a random forest, a logistic
regression), then loaded by the port on the CPU and scored three ways:
``OpWorkflowModel.score``, ``BatchScoreFunction`` and ``ScoreFunction``.

- Predictions are equal except within 1e-4 of the decision boundary (the
  margin for boosted trees and logistic regression, the probability's
  distance to 0.5 for forests).
- Probabilities agree within atol=1e-6: float64 sigmoids of float32 margins
  whose tree sums run in another order (trees), or float32 products summed
  in another order (logistic regression).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.impl.classification.logistic import OpLogisticRegression
from transmogrifai_tpu.impl.classification.trees import (OpRandomForestClassifier,
                                                         OpXGBoostClassifier)

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX

from test_torch_fixture import make_requests, train_titanic

torch.set_num_threads(1)

BOUNDARY = 1e-4
PROB_ATOL = 1e-6

FAMILIES = {
    "xgboost": [(OpXGBoostClassifier(), [{"num_round": 10, "max_depth": 4, "eta": 0.3}])],
    "random_forest": [(OpRandomForestClassifier(), [{"num_trees": 4, "max_depth": 3}])],
    "logistic": [(OpLogisticRegression(), [{"reg_param": 0.01}])],
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def trained(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp(request.param))
    jmodel = train_titanic(path, models_and_parameters=FAMILIES[request.param])
    return request.param, path, jmodel


def _check(family, want_pred, want_prob, want_raw, pred, prob):
    np.testing.assert_allclose(prob, want_prob, atol=PROB_ATOL, rtol=0)
    near = (np.abs(want_prob[:, 1] - 0.5) if family == "random_forest"
            else np.abs(want_raw[:, 1])) < BOUNDARY
    np.testing.assert_array_equal(pred[~near], want_pred[~near])


def test_port_scores_like_jax_three_ways(trained):
    family, path, _ = trained
    jmodel = J.OpWorkflowModel.load(path)
    pmodel = P.load_model(path, device="cpu")
    name = jmodel.result_features[0].name
    assert [f.name for f in pmodel.result_features] == [name]
    cols = make_requests(jmodel, n=128, seed=1)
    want = jmodel.score(pd.DataFrame(cols))[name]
    wp, wq, wr = want.prediction, want.probability, want.raw_prediction

    got = pmodel.score(cols)[name]
    _check(family, wp, wq, wr, got.prediction, got.probability)

    recs = FX.records(cols)
    pred, prob, _ = FX.prediction_arrays(P.BatchScoreFunction(pmodel)(recs), name)
    _check(family, wp, wq, wr, pred, prob)

    pred, prob, _ = FX.prediction_arrays([P.ScoreFunction(pmodel)(r) for r in recs[:16]],
                                         name)
    _check(family, wp[:16], wq[:16], wr[:16], pred, prob)


def test_scored_columns_and_intermediates(trained):
    _, path, _ = trained
    pmodel = P.load_model(path, device="cpu")
    cols = make_requests(J.OpWorkflowModel.load(path), n=32, seed=2)
    out = pmodel.score(cols, keep_intermediate_features=True)
    vec = out[pmodel.stages[-1].inputs[-1].name]
    assert isinstance(vec, P.VectorColumn) and vec.values.device.type == "cpu"
    assert set(f.name for f in pmodel.raw_features) <= set(out.columns)
    name = pmodel.result_features[0].name
    assert list(pmodel.score(cols).columns) == [name]
    from transmogrifai_tpu_torch.readers.base import CustomReader

    raw = CustomReader(cols).generate_dataset(pmodel.raw_features)
    np.testing.assert_array_equal(pmodel.score_fn()(raw)[name].probability,
                                  pmodel.score(cols)[name].probability)
