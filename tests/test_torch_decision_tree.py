"""The decision trees (``OpDecisionTreeClassifier``, ``OpDecisionTreeRegressor``) on
the port against the JAX package's, on the CPU.

A decision tree is a one-tree forest, unbagged and on every feature, grown
by K-E, K-F and K-G.  On integer weights with 0/1 or one-hot gradients (and
integer-valued regression targets) the histogram sums are exact in both
packages, so the trees are bit for bit the reference's: the refit's arrays,
and the fold x grid sweep's predictions and probabilities.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.impl.classification.trees import OpDecisionTreeClassifier as JDTC
from transmogrifai_tpu.impl.regression.trees import OpDecisionTreeRegressor as JDTR
from transmogrifai_tpu.impl.selector import defaults as JD

from transmogrifai_tpu_torch.impl.classification.trees import OpDecisionTreeClassifier as PDTC
from transmogrifai_tpu_torch.impl.regression.trees import OpDecisionTreeRegressor as PDTR
from transmogrifai_tpu_torch.impl.selector import defaults as PD

torch.set_num_threads(1)

TREE_KEYS = ("split_feat", "split_bin", "left", "right", "leaf_val", "edges")


def _data(seed=0, n=500, k=2, regression=False):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.integers(0, 2, (n, 5)), rng.integers(0, 4, (n, 2)),
                        rng.uniform(1, 80, (n, 1)), rng.uniform(5, 100, (n, 1))],
                       1).astype(np.float32)
    if regression:
        y = (X[:, 5] * 3 + rng.integers(0, 5, n) + (X[:, 7] > 40) * 4).astype(np.float32)
    elif k == 2:
        y = ((X[:, 0] > 0) | (rng.random(n) < 0.2)).astype(np.float32)
    else:
        y = ((X[:, 5] + rng.integers(0, 2, n)) % k).astype(np.float32)
    tw = np.ones((3, n), np.float32)
    for f in range(3):
        tw[f, f::3] = 0.0
    return X, y, tw


def _estimators(regression):
    je, pe = (JDTR(), PDTR()) if regression else (JDTC(), PDTC())
    pe.device = torch.device("cpu")
    return je, pe


@pytest.mark.parametrize("k,regression", [(2, False), (3, False), (0, True)])
def test_refit_is_bit_equal(k, regression):
    X, y, tw = _data(k=k, regression=regression)
    je, pe = _estimators(regression)
    for g in ({"max_depth": 6, "min_instances_per_node": 10, "min_info_gain": 0.001},
              {"max_depth": 6, "min_instances_per_node": 1}):
        jp = je.copy_with_params(g).fit_arrays(X, y, tw[1])
        pp = pe.copy_with_params(g).fit_arrays(torch.from_numpy(X), y, tw[1])
        for key in TREE_KEYS:
            np.testing.assert_array_equal(np.asarray(pp[key]), np.asarray(jp[key]), err_msg=key)
        assert pp.get("num_trees") == jp.get("num_trees")
        pj = type(je).predict_arrays(jp, X)
        pq = type(pe).predict_arrays(pp, torch.from_numpy(X))
        for a, b in zip(pq, pj):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("k,regression", [(2, False), (3, False), (0, True)])
def test_fold_sweep_is_bit_equal(k, regression):
    X, y, tw = _data(seed=1, k=k, regression=regression)
    je, pe = _estimators(regression)
    grids = [JD.decision_tree_grid()[i] for i in (0, 7, 9)]  # depths 3 and 6
    assert PD.decision_tree_grid() == JD.decision_tree_grid()
    jp, pp = je.fit_grid_folds(X, y, tw, grids), pe.fit_grid_folds(X, y, tw, grids)
    for f in range(3):
        for c in range(len(grids)):
            for a, b in zip(pp[f][c], jp[f][c]):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("problem", ["binary", "regression", "multiclass"])
def test_fused_plans_take_the_decision_trees(problem):
    """The decision trees ride the fused sweep's forest fragment (one tree,
    unbagged, every feature) in all three problems, with the MLP beside
    them in the multiclass one: the same spec and blob as the JAX
    package's."""
    from transmogrifai_tpu.evaluators import Evaluators as JE
    from transmogrifai_tpu.impl import sweep_fragments as JSF
    from transmogrifai_tpu.impl.classification.mlp import OpMultilayerPerceptronClassifier as JM

    from transmogrifai_tpu_torch.evaluators import Evaluators as PE
    from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
    from transmogrifai_tpu_torch.impl.classification.mlp import (
        OpMultilayerPerceptronClassifier as PM)

    k = {"binary": 2, "multiclass": 3}.get(problem, 0)
    X, y, tw = _data(seed=2, k=max(k, 2), regression=problem == "regression")
    grids = [JD.decision_tree_grid()[i] for i in (0, 7, 9)]
    regression = problem == "regression"
    cands = {"jax": [(JDTR() if regression else JDTC(), grids)],
             "port": [(PDTR() if regression else PDTC(), grids)]}
    if problem == "multiclass":
        cands["jax"].append((JM(), [{}]))
        cands["port"].append((PM(), [{}]))
    ev = {"binary": lambda E: E.BinaryClassification.auPR(),
          "regression": lambda E: E.Regression.rmse(),
          "multiclass": lambda E: E.MultiClassification.error()}[problem]
    jplan = JSF.build_sweep_plan(cands["jax"], X, y, tw[:1], ev(JE))
    pplan = PSF.build_sweep_plan(cands["port"], torch.from_numpy(X), y, tw[:1], ev(PE))
    assert pplan.spec == jplan.spec
    np.testing.assert_array_equal(pplan.blob, np.asarray(jplan.blob))
    forest = pplan.spec[1][0]
    assert forest[0] == "forest" and all(g[2] == 1 and g[7] is False for g in forest[2])


def test_fixed_parameters_stay_fixed():
    for cls, name in ((PDTC, "OpDecisionTreeClassifier"), (PDTR, "OpDecisionTreeRegressor")):
        est = cls(max_depth=3)
        cand = est.copy_with_params({"max_depth": 6, "num_trees": 50})
        assert cand.operation_name == name and cls._grid_bootstrap is False
        assert cand.get_param("num_trees") == 1 and cand.get_param("max_depth") == 6
        assert cand.get_param("feature_subset_strategy") == "all"
        assert cand._subset_frac(10) == 1.0
