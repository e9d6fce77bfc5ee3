"""Default hyperparameter grids of the selectors' model families.

The port's copy of the logistic- and linear-regression, random-forest, GBT
and XGBoost grids of ``transmogrifai_tpu/impl/selector/defaults.py``
(reference: core/.../impl/selector/DefaultSelectorParams.scala:37-75:
MaxDepth=[3,6,12], Regularization=[0.001,0.01,0.1,0.2], ElasticNet=[0.1,0.5],
MaxTrees=[50], MinInstancesPerNode=[10,100], MinInfoGain=[0.001,0.01,0.1],
MaxIterTree=[20], StepSize=[0.1], NumRound=[200], Eta=[0.02],
MinChildWeight=[1,10], XGB maxDepth=[10], XGB gamma=[0.8], NB smoothing=[1.0]),
and the linear SVC, naive Bayes and decision-tree grids that
``models_and_parameters`` takes for the other families.
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
MAX_ITER_TREE = [20]
STEP_SIZE = [0.1]
MAX_TREES = [50]
NUM_ROUND = [200]
ETA = [0.02]
MIN_CHILD_WEIGHT = [1.0, 10.0]
XGB_MAX_DEPTH = [10]
XGB_GAMMA = [0.8]
NB_SMOOTHING = [1.0]


def grid(**axes: Sequence[Any]) -> List[Dict[str, Any]]:
    """Cartesian product of param axes -> list of param dicts (ParamGridBuilder)."""
    keys = list(axes)
    out = []
    for combo in itertools.product(*(axes[k] for k in keys)):
        out.append(dict(zip(keys, combo)))
    return out


def logistic_regression_grid() -> List[Dict[str, Any]]:
    return grid(reg_param=REGULARIZATION, elastic_net_param=ELASTIC_NET)


def linear_regression_grid() -> List[Dict[str, Any]]:
    return grid(reg_param=REGULARIZATION, elastic_net_param=ELASTIC_NET)


def random_forest_grid() -> List[Dict[str, Any]]:
    # MaxDepth(3) x MinInfoGain(3) x MinInstancesPerNode(2) x MaxTrees(1) = 18
    # candidates (BinaryClassificationModelSelector.scala:81-87)
    return grid(max_depth=MAX_DEPTH, min_info_gain=MIN_INFO_GAIN,
                min_instances_per_node=MIN_INSTANCES_PER_NODE, num_trees=MAX_TREES)


def gbt_grid() -> List[Dict[str, Any]]:
    # MaxDepth(3) x MinInfoGain(3) x MinInstancesPerNode(2) = 18 candidates
    # (BinaryClassificationModelSelector.scala:90-98)
    return grid(max_depth=MAX_DEPTH, min_info_gain=MIN_INFO_GAIN,
                min_instances_per_node=MIN_INSTANCES_PER_NODE,
                max_iter=MAX_ITER_TREE, step_size=STEP_SIZE)


def xgboost_grid() -> List[Dict[str, Any]]:
    return grid(num_round=NUM_ROUND, eta=ETA, min_child_weight=MIN_CHILD_WEIGHT,
                max_depth=XGB_MAX_DEPTH, gamma=XGB_GAMMA)


def linear_svc_grid() -> List[Dict[str, Any]]:
    return grid(reg_param=REGULARIZATION)


def naive_bayes_grid() -> List[Dict[str, Any]]:
    return grid(smoothing=NB_SMOOTHING)


def decision_tree_grid() -> List[Dict[str, Any]]:
    # MaxDepth(3) x MinInfoGain(3) x MinInstancesPerNode(2) = 18 candidates
    return grid(max_depth=MAX_DEPTH, min_info_gain=MIN_INFO_GAIN,
                min_instances_per_node=MIN_INSTANCES_PER_NODE)
