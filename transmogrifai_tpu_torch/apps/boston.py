"""OpBostonSimple on the port: regression on Boston-housing-style data.

The port's copy of ``helloworld/boston.py`` (reference:
helloworld/src/main/scala/com/salesforce/hw/OpBostonSimple.scala): six real
predictors vectorized, the ``chas`` pick list pivoted, both combined, and a
``RegressionModelSelector`` cross-validated sweep over the regression
selector's stock space (linear regression, random forest, GBT: 44
candidates) for the ``medv`` response.  The data is the JAX package's
synthetic frame, as numpy columns; ``boston_data(n, seed)`` draws larger
frames of the same schema by the same formula.  ``glm_space()`` is the GLM
family's space for ``models_and_parameters``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from .. import types as T
from ..features.builder import FeatureBuilder
from ..impl.selector.factories import RegressionModelSelector
from ..workflow.workflow import OpWorkflow

REAL_FEATURES = ("crim", "rm", "age", "dis", "tax", "lstat")


def boston_data(n: int = 506, seed: int = 13) -> Dict[str, np.ndarray]:
    """The synthetic housing frame: at n = 506 and seed 13 the JAX package's
    ``helloworld/boston.py::boston_data`` column for column (``medv`` a
    linear function of rooms, lower-status share, crime, age and the river
    flag, plus Gaussian noise)."""
    rng = np.random.default_rng(seed)
    crim = rng.exponential(3.0, n)
    rm = rng.normal(6.3, 0.7, n)          # rooms
    age = rng.uniform(2, 100, n)
    dis = rng.exponential(3.8, n)
    tax = rng.uniform(187, 711, n)
    lstat = rng.uniform(1.7, 38, n)
    chas = rng.choice([0, 1], n, p=[0.93, 0.07])
    medv = (9.1 * rm - 0.65 * lstat - 0.21 * crim - 0.02 * age
            + 2.7 * chas + rng.normal(0, 2.5, n) - 22.0)
    return {"id": np.arange(n), "crim": crim, "rm": rm, "age": age, "dis": dis, "tax": tax,
            "lstat": lstat, "chas": chas, "medv": medv}


#: the GLM grid: (family, link, variance_power) x reg_param.  Reg 0 is left
#: out (the float32 reference's solve breaks down on the ``chas`` pivot and
#: gives NaN folds), and so is the inverse link (NaN folds on Boston)
GLM_FAMILIES = (("gaussian", "identity", 0.0), ("poisson", "log", 0.0), ("gamma", "log", 0.0),
                ("tweedie", "log", 1.5))
GLM_REGS = (0.001, 0.01, 0.1)


def glm_space():
    """``[(OpGeneralizedLinearRegression(), grid)]``: the 12 GLM candidates
    of ``GLM_FAMILIES`` x ``GLM_REGS``, each naming its family, link,
    variance power and reg_param (the link is bound at construction, and the
    variance power defaults to 0, so both are given)."""
    from ..impl.regression.glm import OpGeneralizedLinearRegression

    grid = [{"family": fam, "link": link, "variance_power": vp, "reg_param": reg}
            for fam, link, vp in GLM_FAMILIES for reg in GLM_REGS]
    return [(OpGeneralizedLinearRegression(), grid)]


def build_workflow(model_types: Optional[Sequence[str]] = None,
                   models_and_parameters: Optional[Sequence[Any]] = None):
    """(OpWorkflow, prediction feature) of the Boston flow; by default the
    regression selector's stock space (LinReg + RF + GBT, 44 candidates)."""
    medv = FeatureBuilder("medv", T.RealNN).extract(field="medv").as_response()
    nums = [FeatureBuilder(n, T.Real).extract(field=n).as_predictor() for n in REAL_FEATURES]
    chas = FeatureBuilder("chas", T.PickList).extract(field="chas").as_predictor()
    features = nums[0].vectorize(*nums[1:]).combine(chas.pivot(min_support=1))
    pred = RegressionModelSelector.with_cross_validation(
        num_folds=3, seed=42, model_types=model_types,
        models_and_parameters=models_and_parameters,
    ).set_input(medv, features).get_output()
    return OpWorkflow().set_result_features(pred), pred


def train_boston(cols: Optional[Dict[str, np.ndarray]] = None, device=None, **kw):
    """Train the Boston flow on ``cols`` (default: the 506-row frame) on
    ``device``; returns (the OpWorkflowModel, the workflow)."""
    wf, _ = build_workflow(**kw)
    model = wf.set_input_dataset(boston_data() if cols is None else cols,
                                 key="id").train(device=device)
    return model, wf
