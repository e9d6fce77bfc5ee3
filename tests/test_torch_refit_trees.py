"""How far the port's refit trees follow the JAX package's on the fixtures'
real-valued gradients, on the CPU.

K-E sums each histogram bucket as the reference does (float32, row by row
in row order; ``tests/test_torch_ordered_sums.py``), K-F takes its prefix
sums and node totals in XLA's order, and the roots and the folds' label
means are summed in XLA's order too, so near-tied splits no longer flip
against the reference's.  The refit winners of the Boston stock train (GBT,
squared loss, 20 trees) and of the Titanic XGBoost train (logistic loss,
200 trees) are compared with the fixture models node for node
(``FX.refit_trees_equal``): every tree equal, where the 64-bit fixed-point
sums reached 15 of 20 and 121 of 200.  The counts are printed.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import boston, titanic

torch.set_num_threads(1)

#: the counts of equal refit trees: under the fixed-point sums (PR 14), and
#: now (every tree)
FIXED_POINT_EQUAL = {"boston": 15, "titanic_xgb": 121}
ORDERED_EQUAL = {"boston": 20, "titanic_xgb": 200}


@pytest.mark.parametrize("flow", ["boston", "titanic_xgb"])
def test_refit_trees_follow_the_fixture(flow):
    if flow == "boston":
        model, _ = boston.train_boston(device="cpu")
        gaps = FX.check_boston_train(model)
        assert all(np.isfinite(list(gaps.values())))
        equal, total = FX.refit_trees_equal(model, FX.BOSTON_STOCK)
        assert total == 20
    else:
        model, _ = titanic.train_titanic(device="cpu", model_types=["OpXGBoostClassifier"])
        equal, total = FX.refit_trees_equal(model, FX.TITANIC_XGB)
        assert total == 200
    print(f"{flow}: {equal} of {total} refit trees equal to the fixture's")
    assert equal >= ORDERED_EQUAL[flow] > FIXED_POINT_EQUAL[flow], (equal, total)
