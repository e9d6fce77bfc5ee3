"""Default hyperparameter grids.

The port's copy of the XGBoost grid of
``transmogrifai_tpu/impl/selector/defaults.py``, the one family the port
fits (reference: core/.../impl/selector/DefaultSelectorParams.scala:37-75:
NumRound=[200], Eta=[0.02], MinChildWeight=[1,10], XGB maxDepth=[10],
XGB gamma=[0.8]).  The other families' grids come with their fits.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Sequence


# DefaultSelectorParams values (DefaultSelectorParams.scala:37-75)
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


def xgboost_grid() -> List[Dict[str, Any]]:
    return grid(num_round=NUM_ROUND, eta=ETA, min_child_weight=MIN_CHILD_WEIGHT,
                max_depth=XGB_MAX_DEPTH, gamma=XGB_GAMMA)
