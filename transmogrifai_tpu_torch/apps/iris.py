"""OpIrisSimple on the port: multiclass classification on Iris-style data.

The port's copy of ``helloworld/iris.py`` (reference:
helloworld/src/main/scala/com/salesforce/hw/OpIrisSimple.scala): the four
real measurements vectorized (each with its null indicator) and a
``MultiClassificationModelSelector`` cross-validated sweep over the
multiclass selector's stock space (multinomial logistic regression and
random forest: 26 candidates) for the indexed species label.  The data is
the JAX package's synthetic frame, as numpy columns; ``iris_data(n, seed)``
draws larger frames of the same schema by the same formula; ``mlp_space``
is the one-MLP space.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..features.builder import FeatureBuilder
from ..impl.selector.factories import MultiClassificationModelSelector
from ..workflow.workflow import OpWorkflow

REAL_FEATURES = ("sepal_length", "sepal_width", "petal_length", "petal_width")
#: each species' centre and the measurements' spread (the JAX package's)
CENTERS = {"setosa": [5.0, 3.4, 1.5, 0.2],
           "versicolor": [5.9, 2.8, 4.3, 1.3],
           "virginica": [6.6, 3.0, 5.6, 2.0]}
SPREAD = [0.35, 0.3, 0.3, 0.15]


def iris_data(n: int = 150, seed: int = 7) -> Dict[str, np.ndarray]:
    """The synthetic iris frame: three Gaussian species clusters in 4-D,
    ``n // 3`` rows a species (the last takes the remainder), drawn species
    by species.  At n = 150 and seed 7 it is the JAX package's
    ``helloworld/iris.py::iris_data`` column for column."""
    rng = np.random.default_rng(seed)
    sizes = [n // 3, n // 3, n - 2 * (n // 3)]
    pts = np.concatenate([rng.normal(c, SPREAD, size=(m, 4))
                          for c, m in zip(CENTERS.values(), sizes)])
    species = np.repeat(np.array(list(CENTERS), dtype=object), sizes)
    cols = {f: pts[:, j] for j, f in enumerate(REAL_FEATURES)}
    cols["species"] = species
    cols["id"] = np.arange(n)
    # label index (the reference indexes the species string)
    cols["label"] = np.repeat(np.arange(3, dtype=np.float64), sizes)
    return cols


def build_workflow(model_types: Optional[Sequence[str]] = None,
                   models_and_parameters: Optional[Sequence[Any]] = None, **selector_kw):
    """(OpWorkflow, prediction feature) of the Iris flow; by default the
    multiclass selector's stock space (multinomial LR + RF, 26 candidates)
    with 3-fold CV, seed 42."""
    label = FeatureBuilder("label", T.RealNN).extract(field="label").as_response()
    feats = [FeatureBuilder(f, T.Real).extract(field=f).as_predictor() for f in REAL_FEATURES]
    features = feats[0].vectorize(*feats[1:])
    kw = {"num_folds": 3, "seed": 42, **selector_kw}
    pred = MultiClassificationModelSelector.with_cross_validation(
        model_types=model_types, models_and_parameters=models_and_parameters, **kw,
    ).set_input(label, features).get_output()
    return OpWorkflow().set_result_features(pred), pred


def mlp_space() -> List[Tuple[Any, List[Dict[str, Any]]]]:
    """The default MLP as a ``models_and_parameters`` space: one multiclass
    "mlp" fragment over the three species."""
    from ..impl.classification.mlp import OpMultilayerPerceptronClassifier

    return [(OpMultilayerPerceptronClassifier(), [{}])]


def train_iris(frame: Optional[Dict[str, np.ndarray]] = None, device=None, **selector_kw):
    """Train the Iris flow on ``frame`` (default: the 150-row frame) on
    ``device`` (default: the CUDA card; ``device="cpu"`` runs the kernels'
    plain versions); ``selector_kw`` go to ``build_workflow``.  Returns
    (the OpWorkflowModel, the workflow)."""
    wf, _ = build_workflow(**selector_kw)
    model = wf.set_input_dataset(iris_data() if frame is None else frame,
                                 key="id").train(device=device)
    return model, wf
