"""Default hyperparameter grids of the binary selector's stock space.

The port's copy of the logistic-regression, random-forest and XGBoost
grids of ``transmogrifai_tpu/impl/selector/defaults.py`` (reference:
core/.../impl/selector/DefaultSelectorParams.scala:37-75: MaxDepth=[3,6,12],
Regularization=[0.001,0.01,0.1,0.2], ElasticNet=[0.1,0.5], MaxTrees=[50],
MinInstancesPerNode=[10,100], MinInfoGain=[0.001,0.01,0.1], NumRound=[200],
Eta=[0.02], MinChildWeight=[1,10], XGB maxDepth=[10], XGB gamma=[0.8]).
The other families' grids come with their fits.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Sequence


# DefaultSelectorParams values (DefaultSelectorParams.scala:37-75)
MAX_DEPTH = [3, 6, 12]
MIN_INSTANCES_PER_NODE = [10, 100]
MIN_INFO_GAIN = [0.001, 0.01, 0.1]
REGULARIZATION = [0.001, 0.01, 0.1, 0.2]
ELASTIC_NET = [0.1, 0.5]
MAX_TREES = [50]
NUM_ROUND = [200]
ETA = [0.02]
MIN_CHILD_WEIGHT = [1.0, 10.0]
XGB_MAX_DEPTH = [10]
XGB_GAMMA = [0.8]


def grid(**axes: Sequence[Any]) -> List[Dict[str, Any]]:
    """Cartesian product of param axes -> list of param dicts (ParamGridBuilder)."""
    keys = list(axes)
    out = []
    for combo in itertools.product(*(axes[k] for k in keys)):
        out.append(dict(zip(keys, combo)))
    return out


def logistic_regression_grid() -> List[Dict[str, Any]]:
    return grid(reg_param=REGULARIZATION, elastic_net_param=ELASTIC_NET)


def random_forest_grid() -> List[Dict[str, Any]]:
    # MaxDepth(3) x MinInfoGain(3) x MinInstancesPerNode(2) x MaxTrees(1) = 18
    # candidates (BinaryClassificationModelSelector.scala:81-87)
    return grid(max_depth=MAX_DEPTH, min_info_gain=MIN_INFO_GAIN,
                min_instances_per_node=MIN_INSTANCES_PER_NODE, num_trees=MAX_TREES)


def xgboost_grid() -> List[Dict[str, Any]]:
    return grid(num_round=NUM_ROUND, eta=ETA, min_child_weight=MIN_CHILD_WEIGHT,
                max_depth=XGB_MAX_DEPTH, gamma=XGB_GAMMA)
