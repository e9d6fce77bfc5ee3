"""Committed reference data for the port.

``titanic_xgb/`` holds a full-width Titanic workflow model that the JAX
package trained and saved (XGBoost candidate of the stock binary grid: 200
rounds, depth 10, 32 bins), 256 request records made from a seed
(``requests.npz``) and the JAX package's answers for them
(``expected.npz``: prediction, rawPrediction, probability, the binned
feature matrix ``Xb`` and the margins ``F``).  ``tests/test_torch_fixture.py``
regenerates all of it (``python tests/test_torch_fixture.py --write``).

``titanic_stock/`` holds the same for the stock binary space (LR + RF +
XGBoost, 28 candidates; the winner is a logistic regression, whose margins
are ``F``), and ``sweep.npz``: each of the three workflow-level CV calls'
fused-sweep metrics [3, 1, 28, 6] (``BINARY_METRICS`` order) and the stock
forests' draws (bootstrap [50, 891], feature masks [50, 10]).
``tests/test_torch_stock_slice.py --write`` regenerates it.

``boston_stock/`` holds the Boston workflow's model over the regression
selector's stock space (LinReg + RF + GBT, 44 candidates; the winner is a
GBT regressor), 256 request records and the JAX package's predictions for
them (``expected.npz``), and ``sweep.npz``: the one fused-sweep call's
metrics [1, 3, 44, 4] (``REGRESSION_METRICS`` order) and the forests'
draws (bootstrap [50, 455], feature masks [50, 16]).
``tests/test_torch_boston_slice.py --write`` regenerates it.

``iris_stock/`` holds the Iris workflow's model over the multiclass
selector's stock space (multinomial LR + RF, 26 candidates; the winner is
a random forest of depth 3), 256 request records and the JAX package's
answers for them (``expected.npz``: prediction, probability,
rawPrediction), and ``sweep.npz``: the one fused-sweep call's inputs (the
feature matrix ``X``, labels ``y``, fold weights ``train_w`` and masks
``val_mask``), its metrics [1, 3, 26, 4] (``MULTICLASS_METRICS`` order)
and the forests' draws (bootstrap [50, 135], feature masks [50, 8]).
``tests/test_torch_iris_slice.py --write`` regenerates it.  The answers
travel as data because the machine with the card has no JAX.

``iris_boost/`` holds the Iris workflow's model over the one-family space
``[(OpXGBoostClassifier(), xgboost_grid())]`` (the winner: min_child_weight
1, a softmax-boosted model of 200 rounds over 3 class margins), 256
request records and the JAX package's answers for them (``expected.npz``),
and ``sweep.npz``: that call's fused-sweep metrics [1, 3, 2, 4]
(``metrics``), and the metrics [1, 3, 46, 4] (``mixed_metrics``) and
winner's index (``mixed_best``) of the 46-candidate call (the stock LR +
RF space with ``gbt_grid()`` and ``xgboost_grid()`` added).
``tests/test_torch_iris_boost_slice.py --write`` regenerates it.

``titanic_newton/`` holds the Titanic workflow's model over the five
pure-L2 logistic points (``reg_param`` {0, 0.001, 0.01, 0.1, 0.2},
``elastic_net_param`` 0, ``max_iter`` 50: Newton fits of 12 steps; the
winner reg 0.2), 256 requests and the JAX package's answers, and
``sweep.npz``: that train's three workflow-level sweep calls' metrics [3,
1, 5, 6] (``metrics``), and the metrics [3, 1, 10, 6] (``mixed_metrics``)
and winner's index (``mixed_best``) of the grid with ``elastic_net_param``
{0, 0.1} (six Newton points, four FISTA).
``tests/test_torch_titanic_newton_slice.py --write`` regenerates it.

``boston_ridge/`` holds the Boston workflow's model over the five ridge
points of ``OpLinearRegression()`` (``reg_param`` {0, 0.001, 0.01, 0.1,
0.2}; the sweep fits them by FISTA, the winner reg 0 refits in closed
form), 256 requests and the JAX package's predictions, and ``sweep.npz``:
the sweep call's metrics [1, 3, 5, 4].
``tests/test_torch_boston_ridge_slice.py --write`` regenerates it.

``titanic_families/`` holds the Titanic workflow's models over the binary
selector's other families (``apps/titanic.families_space``): ``space_a/``,
the JAX-saved winner of the 24-candidate space (LinearSVC x 4, NaiveBayes
x 1, DecisionTree x 18, MLP x 1; the per-family sweep, since naive Bayes
is not fused; the winner is naive Bayes), and ``space_b/``, the winner of
the same space without naive Bayes (23 candidates, one fused sweep per
workflow-level fold; the winner is the MLP); 256 request records and the
JAX package's answers for both winners (``expected.npz``: ``a_*`` and
``b_*`` prediction, probability, rawPrediction); and ``sweep.npz``: space
B's three fused-sweep calls' metrics [3, 1, 23, 6] (``b_metrics``) and the
Iris flow's one-MLP space's sweep metrics [1, 3, 1, 4]
(``iris_mlp_metrics``).  Space A's fold metrics are in its saved summary.
``tests/test_torch_families_slice.py --write`` regenerates it.

``boston_glm/`` holds the Boston workflow's model over the GLM space
(``apps/boston.glm_space``: gaussian / identity, poisson / log, gamma / log
and tweedie / log at variance power 1.5, each x ``reg_param`` {0.001, 0.01,
0.1}: 12 candidates through the per-family sweep, since the GLM has no
fused fragment; the winner gaussian / identity at 0.001), 256 requests and
the JAX package's predictions, and ``sweep.npz``: the 506-row train's fold
RMSE [12, 3] (``fold_rmse``) and winner's index (``best``), and the same of
the JAX package's train on ``boston_data(scale_rows, scale_seed)``
(``scale_fold_rmse``, ``scale_best``; 2^18 rows, seed 0).
``tests/test_torch_boston_glm_slice.py --write`` regenerates it.

``titanic_sanity/summaries.json`` holds the JAX package's sanity-checker
summaries (dropped features, reasons, label correlations, column moments,
categorical statistics) and feature x feature correlation matrices, one
entry a setting of ``SANITY_SETTINGS``: {pearson, spearman} x {in memory,
``sharded_stats=True``} and Pearson with ``correlation_exclusion=
"hashed_text"`` on the 891-row Titanic vector (the last on the frame with
distinct names, whose hashed columns it excludes), and the 2^20-row frame's
final fit (``chip_smoke.titanic_columns(1 << 20, 0)`` through the workflow's
vectorizers) under Pearson and Spearman with ``sample_upper_limit`` 2^20;
with the port's gaps to them on the CPU when it was written.
``tests/test_torch_sanity_scale_slice.py --write`` regenerates it (the JAX
package on the CPU's 8-device mesh, about a minute).  No feature matrix
travels: the card computes the vectors through the port's vectorizers.

``titanic_text/`` holds the JAX package's Titanic workflow with the free-text
``Notes`` column (``apps/titanic.text_columns(891, 0)``,
``build_workflow(text_embeddings=True)``: Word2Vec and LDA beside the other
features) over the binary selector's stock space (28 candidates; the winner
is a logistic regression {0.001, 0.1}), 256 request records with notes and
the JAX package's answers (``expected.npz``), ``sweep.npz``: the three
workflow-level sweep calls' metrics [3, 1, 28, 6] (``metrics``), and
``k18.npz``: the 891 rows' tokens (space-joined) and count matrix under the
saved count model, the final Word2Vec fit's pair count and the SHA-256 of
its skip-gram pairs, negatives and ``W0``, and small K18 cases with the JAX
package's outputs (one SGNS epoch: ``sgns_*``; one E-step and one M-step:
``lda_*``).  ``tests/test_torch_text_slice.py --write`` regenerates it.

``titanic_collapse/`` holds round-collapsed boosting (slice 12), trained
by the JAX package: the Titanic workflow's model over the one-family space
``[(OpXGBoostClassifier(trees_per_round=4, subsample=0.8,
colsample_bytree=0.8), xgboost_grid())]`` (K = 4: 50 steps of 4 trees, each
with its round's draws), 256 request records and the JAX package's answers
(``expected.npz``), and ``sweep.npz``: that train's three workflow-level
sweep calls' metrics [3, 1, 2, 6] (``xgb_metrics``), and the metrics [3, 1,
28, 6] (``stock_metrics``) and winner's index (``stock_best``) of the stock
binary space under ``TMOG_GBT_ROUND_COLLAPSE=4``.  ``iris_collapse/sweep.npz``
holds the Iris flow's ``[(OpXGBoostClassifier(trees_per_round=4),
xgboost_grid())]`` sweep metrics [1, 3, 2, 4] and winner's index, and
``boston_collapse/sweep.npz`` the Boston stock space's under
``TMOG_GBT_ROUND_COLLAPSE=4`` (GBT squared from each fold's label mean):
metrics [1, 3, 44, 4] and winner's index.
``tests/test_torch_collapse_slice.py --write`` regenerates all three.

``titanic_branches/sweep.npz`` holds the Titanic flow over the binary
selector's stock space (28 candidates) under
``MultiClassificationModelSelector`` (a two-class label under the multiclass
evaluator: ``multiclass_*``) and under the binary selector's
``with_train_validation_split`` (``split_*``): each train's fused-sweep
metrics, fold metrics [28, F], winner's index and the first call's fold
weights and validation masks.
``tests/test_torch_selector_branches.py --write`` regenerates it.

``letters_stock/`` holds the 26-class Letter-Recognition-shaped workflow
(``letters_data``: 16 integer attributes 0-15, 26 classes) over the
multiclass selector's stock space (multinomial LR + RF, 26 candidates) at
``LETTERS_ROWS`` rows, as the JAX package trained and saved it, 256
requests and the JAX package's answers (``expected.npz``), and
``sweep.npz``: the fused call's metrics [1, 3, 26, 4] and the forests'
draws.  ``many_class/sweep.npz`` holds the JAX package's 64-class fused
call's metrics, the 70-class per-family train's fold metrics and winner,
and the 10-class boosting trains' fold metrics and winners (XGBoost's grid
at ``trees_per_round`` 1 and 4, ``OpGBTClassifier``).
``tests/test_torch_many_classes.py --write`` regenerates both.

Strings with nulls are stored as a unicode array plus ``<name>__null``, so
the files load without pickles.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

TITANIC_XGB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_xgb")
TITANIC_STOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_stock")
BOSTON_STOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "boston_stock")
IRIS_STOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iris_stock")
IRIS_BOOST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iris_boost")
TITANIC_NEWTON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_newton")
BOSTON_RIDGE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "boston_ridge")
TITANIC_FAMILIES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "titanic_families")
BOSTON_GLM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "boston_glm")
TITANIC_SANITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_sanity")
TITANIC_TEXT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_text")
TITANIC_SIMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_simple")
TITANIC_COLLAPSE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_collapse")
IRIS_COLLAPSE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iris_collapse")
BOSTON_COLLAPSE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "boston_collapse")
TITANIC_BRANCHES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_branches")
LETTERS_STOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "letters_stock")
MANY_CLASS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "many_class")
NULL_SUFFIX = "__null"

#: tolerances of the comparison with the JAX package's answers.  Margins are
#: float32 sums over trees taken in another order than XLA's reduction;
#: probabilities are float64 sigmoids of those margins, on the host in both.
MARGIN_ATOL = MARGIN_RTOL = 1e-5
PROB_ATOL = 1e-6
#: predictions may differ only where the margin is this close to 0 (p = 0.5)
BOUNDARY = 1e-4
#: fold AuPR of the stock sweep's logistic-regression candidates: FISTA's
#: float32 sums in another order (the winner leads the next candidate by 4e-5)
LR_AUPR_TOL = 1e-5
#: fold AuPR of the random-forest candidates: the forests are bit-equal
#: (integer weights, exact histogram sums); the AuPR's own sum differs
RF_AUPR_TOL = 1e-6
#: fold RMSE of the Boston sweep's candidates, relative, per family.  None
#: is above 1e-3, a quarter of the winner's 0.40% lead.  Linear regression:
#: FISTA's float32 sums in another order (measured 9e-7 on the CPU).  The
#: forests and GBT follow the JAX package's splits, since K-E sums w*g in
#: XLA's float32 row order; the metrics' and the trees' sums in another order
#: move the RMSE in its last bits (measured on the CPU and on the H100, the
#: stock and the K = 4 trains: at most 6.6e-8 RF, 8.0e-8 GBT)
BOSTON_RMSE_RTOL = {"OpLinearRegression": 1e-5, "OpRandomForestRegressor": 2e-7,
                    "OpGBTRegressor": 2e-7}
#: predictions of a saved regression model on the fixture's requests:
#: float32 sums over the trees in another order than XLA's
PRED_RTOL = PRED_ATOL = 1e-5
#: fold F1, Precision and Recall of the Iris sweep's softmax candidates:
#: FISTA's float32 sums in another order move a probability in its last
#: bits; the forests' are bit-equal (their leaves and tree means are)
IRIS_SOFTMAX_METRIC_TOL = 1e-6
#: class probabilities of a saved Iris model on the fixture's requests:
#: float32 sums over the trees in another order than XLA's
IRIS_PROB_ATOL = 1e-6


def check(cond, msg="check failed") -> None:
    """Raise AssertionError unless ``cond`` (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def save_columns(path: str, cols: Dict[str, np.ndarray]) -> None:
    out = {}
    for name, arr in cols.items():
        if arr.dtype == object:
            null = np.array([v is None for v in arr])
            out[name] = np.array(["" if v is None else str(v) for v in arr])
            out[name + NULL_SUFFIX] = null
        else:
            out[name] = arr
    np.savez_compressed(path, **out)


def load_columns(path: str) -> Dict[str, np.ndarray]:
    """Request columns: numeric arrays, and object arrays (None = null) for
    strings."""
    with np.load(path, allow_pickle=False) as z:
        raw = {k: z[k] for k in z.files}
    cols = {}
    for name, arr in raw.items():
        if name.endswith(NULL_SUFFIX):
            continue
        if arr.dtype.kind == "U":
            obj = arr.astype(object)
            obj[raw[name + NULL_SUFFIX]] = None
            cols[name] = obj
        else:
            cols[name] = arr
    return cols


def records(cols: Dict[str, np.ndarray]) -> List[Dict[str, Any]]:
    """Column arrays as request records (plain Python values)."""
    names = list(cols)
    n = len(cols[names[0]])
    return [{k: (cols[k][i].item() if hasattr(cols[k][i], "item") else cols[k][i])
             for k in names} for i in range(n)]


def load_expected(path: str = os.path.join(TITANIC_XGB, "expected.npz")
                  ) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def compare(expected: Dict[str, np.ndarray], prediction: np.ndarray,
            probability: np.ndarray, raw: np.ndarray, Xb=None, F=None) -> Dict[str, float]:
    """Measured gaps to the JAX package's answers; raises AssertionError
    naming the first one out of tolerance."""
    out: Dict[str, float] = {}
    margin = np.abs(np.asarray(expected["F"], np.float64)[:, 0])
    off = margin >= BOUNDARY
    out["prediction_mismatches_off_boundary"] = float(
        np.sum(prediction[off] != expected["prediction"][off]))
    out["probability_max_abs_err"] = float(np.max(np.abs(probability - expected["probability"])))
    raw_ref = expected["rawPrediction"]
    out["raw_max_abs_err"] = float(np.max(np.where(raw == raw_ref, 0.0, np.abs(raw - raw_ref))))
    if Xb is not None:
        out["Xb_mismatches"] = float(np.sum(np.asarray(Xb) != expected["Xb"]))
        check(np.asarray(Xb).dtype == expected["Xb"].dtype, "Xb dtype differs")
    if F is not None:
        np.testing.assert_allclose(F, expected["F"], atol=MARGIN_ATOL, rtol=MARGIN_RTOL)
        out["F_max_abs_err"] = float(np.max(np.abs(np.asarray(F) - expected["F"])))
    check(out["prediction_mismatches_off_boundary"] == 0, out)
    check(out["probability_max_abs_err"] <= PROB_ATOL, out)
    check(out.get("Xb_mismatches", 0) == 0, out)
    return out


def prediction_arrays(outputs: List[Dict[str, Any]], name: str
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(prediction, probability, rawPrediction) from score-function dicts."""
    rows = [o[name] for o in outputs]
    pred = np.array([r["prediction"] for r in rows], np.float64)
    prob = np.array([[r["probability_0"], r["probability_1"]] for r in rows], np.float64)
    raw = np.array([[r["rawPrediction_0"], r["rawPrediction_1"]] for r in rows], np.float64)
    return pred, prob, raw


def port_answers(model, cols: Dict[str, np.ndarray]):
    """The port's answers for request columns: (prediction, probability,
    rawPrediction) through ``BatchScoreFunction``, and the binned matrix and
    margins of the model's boosted predictor."""
    from ..impl.classification.trees import _BoostedClassifierBase
    from ..local.scoring import BatchScoreFunction
    from ..ops.trees import bin_with_edges

    name = model.result_features[0].name
    pred, prob, raw = prediction_arrays(BatchScoreFunction(model)(records(cols)), name)
    stage = model.stages[-1]
    full = model.score(cols, keep_intermediate_features=True)
    V = full[stage.inputs[-1].name].tensor(model.device)
    dparams = stage._device_params()
    Xb = bin_with_edges(V, dparams["edges"])
    F = _BoostedClassifierBase.margins(dparams, V)
    return pred, prob, raw, Xb.cpu().numpy(), F.cpu().numpy()


def stage_summary(manifest: Dict[str, Any]) -> Dict[str, Any]:
    """The model selector's summary in a saved model's manifest."""
    return manifest["stages"][-1]["state"]["summary"]["__jsonable__"]["data"]


def load_sweep(path: str = os.path.join(TITANIC_STOCK, "sweep.npz")) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def check_stock_train(model, xgb_tol: float) -> Dict[str, float]:
    """Hold a stock-space Titanic train's selector summary to the stock
    fixture's: the same candidates in the same order, the same winner, each
    family's fold AuPR within its tolerance (``LR_AUPR_TOL``,
    ``RF_AUPR_TOL``, ``xgb_tol``).  Returns the largest gap per family."""
    import json

    with open(os.path.join(TITANIC_STOCK, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    check(summ.best_model_name == ref["bestModelName"] and summ.best_grid == ref["bestGrid"],
          f"winner {summ.best_model_name} {summ.best_grid} differs from the fixture's "
          f"{ref['bestModelName']} {ref['bestGrid']}")
    gaps: Dict[str, float] = {}
    for mine, theirs in zip(summ.validation_results, ref["validationResults"]):
        check((mine["modelName"], mine["grid"]) == (theirs["modelName"], theirs["grid"]),
              "candidate order differs from the fixture's")
        g = max(abs(a - b) for a, b in zip(mine["foldMetrics"], theirs["foldMetrics"]))
        gaps[mine["modelName"]] = max(gaps.get(mine["modelName"], 0.0), g)
    check(len(summ.validation_results) == len(ref["validationResults"]), "candidate count")
    tols = {"OpLogisticRegression": LR_AUPR_TOL, "OpRandomForestClassifier": RF_AUPR_TOL,
            "OpXGBoostClassifier": xgb_tol}
    for fam, gap in gaps.items():
        check(gap <= tols[fam], f"{fam} fold AuPR {gap} from the fixture's, above {tols[fam]}")
    return gaps


def regression_predictions(outputs: List[Dict[str, Any]], name: str) -> np.ndarray:
    """The predictions in score-function dicts of a regression model."""
    return np.array([o[name]["prediction"] for o in outputs], np.float64)


def check_boston_train(model) -> Dict[str, float]:
    """Hold a Boston train's selector summary to the fixture's: the same
    candidates in the same order, the same winner, each family's fold RMSE
    within its relative tolerance (``BOSTON_RMSE_RTOL``), and the fixture's
    exact tie of the depth-6 GBT candidates at min_info_gain 0.001 and 0.01
    kept (the first of them ranks first among equals).  Returns the largest
    relative gap per family."""
    import json

    with open(os.path.join(BOSTON_STOCK, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    check(summ.best_model_name == ref["bestModelName"] and summ.best_grid == ref["bestGrid"],
          f"winner {summ.best_model_name} {summ.best_grid} differs from the fixture's "
          f"{ref['bestModelName']} {ref['bestGrid']}")
    check(len(summ.validation_results) == len(ref["validationResults"]), "candidate count")
    gaps: Dict[str, float] = {}
    for mine, theirs in zip(summ.validation_results, ref["validationResults"]):
        check((mine["modelName"], mine["grid"]) == (theirs["modelName"], theirs["grid"]),
              "candidate order differs from the fixture's")
        g = max(abs(a - b) / abs(b) for a, b in zip(mine["foldMetrics"], theirs["foldMetrics"]))
        gaps[mine["modelName"]] = max(gaps.get(mine["modelName"], 0.0), g)
    for fam, gap in gaps.items():
        check(gap <= BOSTON_RMSE_RTOL[fam],
              f"{fam} fold RMSE {gap} (relative) from the fixture's, above "
              f"{BOSTON_RMSE_RTOL[fam]}")
    tied = [r["metricValue"] for r in summ.validation_results
            if r["modelName"] == "OpGBTRegressor" and r["grid"]["max_depth"] == 6
            and r["grid"]["min_instances_per_node"] == 10
            and r["grid"]["min_info_gain"] in (0.001, 0.01)]
    check(len(tied) == 2 and tied[0] == tied[1], f"the depth-6 GBT tie is lost: {tied}")
    return gaps


def refit_trees_equal(model, fixture: str) -> Tuple[int, int]:
    """(refit trees of ``model``'s winner equal to the fixture model's node
    for node (split feature, bin, children), trees): how far the port's
    refit follows the JAX package's where near-tied splits may flip."""
    import json

    with open(os.path.join(fixture, "op_model.json")) as fh:
        params = json.load(fh)["stages"][-1]["state"]["model_params"]["__dict__"]
    keys = ("split_feat", "split_bin", "left", "right")
    with np.load(os.path.join(fixture, "op_model_arrays.npz")) as z:
        ref = {k: z[params[k]["__array__"]] for k in keys}
    mine = model.stages[-1].model_params
    same = np.all([(np.asarray(ref[k]) == np.asarray(mine[k])).all(axis=1) for k in keys],
                  axis=0)
    return int(same.sum()), int(same.size)


def multiclass_predictions(outputs: List[Dict[str, Any]], name: str, k: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(prediction, probability [n, k], rawPrediction [n, k]) from the
    score-function dicts of a k-class model."""
    rows = [o[name] for o in outputs]
    pred = np.array([r["prediction"] for r in rows], np.float64)
    prob = np.array([[r[f"probability_{j}"] for j in range(k)] for r in rows], np.float64)
    raw = np.array([[r[f"rawPrediction_{j}"] for j in range(k)] for r in rows], np.float64)
    return pred, prob, raw


def check_iris_train(model) -> Dict[str, Any]:
    """Hold an Iris train's selector summary to the fixture's: the same
    candidates in the same order, the same winner, every fold Error equal
    bit for bit (ties decide the winner: nine candidates share the best
    mean), the same ``DataCutter`` summary and the same holdout metrics
    (``ThresholdMetrics`` included).  Returns what it compared."""
    import json

    with open(os.path.join(IRIS_STOCK, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    check(summ.best_model_name == ref["bestModelName"] and summ.best_grid == ref["bestGrid"],
          f"winner {summ.best_model_name} {summ.best_grid} differs from the fixture's "
          f"{ref['bestModelName']} {ref['bestGrid']}")
    check(len(summ.validation_results) == len(ref["validationResults"]), "candidate count")
    differ = []
    for i, (mine, theirs) in enumerate(zip(summ.validation_results, ref["validationResults"])):
        check((mine["modelName"], mine["grid"]) == (theirs["modelName"], theirs["grid"]),
              "candidate order differs from the fixture's")
        if mine["foldMetrics"] != theirs["foldMetrics"]:
            differ.append(i)
    check(not differ, f"fold Errors of candidates {differ} differ from the fixture's")
    check(summ.data_prep_results == ref["dataPrepResults"],
          f"DataCutter summary {summ.data_prep_results} differs from {ref['dataPrepResults']}")
    check(summ.holdout_evaluation == ref["holdoutEvaluation"],
          "holdout metrics differ from the fixture's")
    best = [r["metricValue"] for r in summ.validation_results]
    return {"candidates": len(best), "fold_errors_equal": True,
            "tied_at_best": int(sum(v == min(best) for v in best)),
            "best_mean_error": min(best), "holdout": summ.holdout_evaluation}


#: class probabilities of the softmax-boosted Iris models (the fixture's
#: 200-round XGB winner on its requests; the cut grid's refits): float32
#: margins summed in another order, and the softmax's ``exp`` an ulp from
#: XLA's in the refit's gradients (measured: within 8.4e-8 on the CPU, 2.0e-7
#: on the H100); the same bound as ``IRIS_PROB_ATOL``
IRIS_BOOST_PROB_ATOL = 1e-6
#: fold AuPR of the Titanic Newton (pure-L2) candidates with reg_param > 0:
#: the Hessian's float32 sums in another order move a score in its last
#: bits.  Well under the 1.3e-6 between the Newton-only grid's winner (reg
#: 0.2) and its runner-up (reg 0.1)
NEWTON_AUPR_TOL = 5e-7
#: probabilities of the Newton refit (reg 0.2) on the fixture's requests
NEWTON_PROB_ATOL = 1e-6
#: fold RMSE of the Boston ridge grid's sweep (FISTA through K-N, as the
#: JAX package's sweep fits every linear-regression point), relative: under
#: the 2e-6 between the winner (reg 0) and reg 0.001
RIDGE_RMSE_RTOL = 1.5e-6
#: predictions of the closed-form ridge refit (reg 0) on the fixture's
#: requests whose ``chas`` is a category the model saw, and its holdout
#: metrics, relative.  The chas pivot's two columns sum to the intercept's,
#: so the Gram is singular but for the 1e-9 ridge: the solve puts rounding
#: noise, amplified, into that null direction (the fixture model's chas
#: coefficients are 234 and 238 against an intercept of -256; the port's,
#: on the CPU, -9.8, -6.1 and -11.75) and the identifiable coefficients
#: move with it (4.9e-5 relative on the CPU).  A request with an unseen
#: chas value (the pivot's "other" column, never set in training) reads the
#: null direction's intercept alone, so its prediction is that noise in
#: either package (the fixture's -206 where the port's is 37.6): those rows
#: are compared for being finite only (``compare_ridge_predictions``)
RIDGE_PRED_RTOL = 5e-4
#: and absolute (thousands of dollars), for predictions near 0
RIDGE_PRED_ATOL = 5e-3
#: the chas categories the Boston model saw in training
BOSTON_CHAS_SEEN = (0, 1)


def _check_order(summ, ref_results) -> None:
    check(len(summ.validation_results) == len(ref_results), "candidate count")
    for mine, theirs in zip(summ.validation_results, ref_results):
        check((mine["modelName"], mine["grid"]) == (theirs["modelName"], theirs["grid"]),
              "candidate order differs from the fixture's")


def _best_index(summ) -> int:
    return [(r["modelName"], r["grid"]) for r in summ.validation_results].index(
        (summ.best_model_name, summ.best_grid))


def check_iris_boost_train(model, mixed: bool) -> Dict[str, Any]:
    """Hold an Iris boosting train to the ``iris_boost`` fixture: with
    ``mixed`` the 46-candidate call (``mixed_metrics``: every fold Error bit
    for bit, the winner's index), else the XGB-only call (the saved
    summary: the same candidates and winner, every fold Error bit for bit,
    the holdout's Error, F1, Precision and Recall equal).  Returns what it
    compared."""
    import json

    sweep = load_sweep(os.path.join(IRIS_BOOST, "sweep.npz"))
    summ = model.stages[-1].summary
    folds = np.array([r["foldMetrics"] for r in summ.validation_results], np.float32)
    if mixed:
        ref = sweep["mixed_metrics"][0, :, :, 3].T
        check(folds.shape == ref.shape, f"{folds.shape[0]} candidates, the fixture has "
                                        f"{ref.shape[0]}")
        differ = np.where((folds != ref).any(1))[0].tolist()
        check(not differ, f"fold Errors of candidates {differ} differ from the fixture's")
        check(_best_index(summ) == int(sweep["mixed_best"]),
              f"winner {summ.best_model_name} {summ.best_grid} is not the fixture's "
              f"candidate {int(sweep['mixed_best'])}")
        best = [r["metricValue"] for r in summ.validation_results]
        return {"candidates": len(best), "fold_errors_equal": True,
                "tied_at_best": int(sum(v == min(best) for v in best)),
                "best_mean_error": min(best)}
    with open(os.path.join(IRIS_BOOST, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    _check_order(summ, ref["validationResults"])
    check(summ.best_model_name == ref["bestModelName"] and summ.best_grid == ref["bestGrid"],
          f"winner {summ.best_model_name} {summ.best_grid} differs from the fixture's")
    check(np.array_equal(folds, sweep["metrics"][0, :, :, 3].T),
          "fold Errors differ from the fixture's")
    mine = {k: summ.holdout_evaluation[k] for k in ("Error", "F1", "Precision", "Recall")}
    theirs = {k: ref["holdoutEvaluation"][k] for k in mine}
    check(mine == theirs, f"holdout {mine} differs from the fixture's {theirs}")
    return {"candidates": len(folds), "fold_errors": folds.tolist(), "holdout": mine}


#: AuPR's column in the binary sweep metrics (``ops/metrics.BINARY_METRICS``)
BINARY_AUPR = 1


def _titanic_folds(metrics: np.ndarray) -> np.ndarray:
    """Each candidate's fold AuPR [C, 3] from the three workflow-level sweep
    calls' metrics [3, 1, C, 6]."""
    return metrics[:, 0, :, BINARY_AUPR].T


def check_titanic_newton_train(model, mixed: bool) -> Dict[str, Any]:
    """Hold a Titanic Newton train to the ``titanic_newton`` fixture (the
    five-point Newton grid, or with ``mixed`` the ten-point grid of six
    Newton and four FISTA points): the same winner; each fold AuPR within
    ``NEWTON_AUPR_TOL`` (Newton, reg > 0) or ``LR_AUPR_TOL`` (FISTA) of the
    fixture's.  At reg 0 the Newton fit has no ridge but 1e-8: Titanic's
    one-hot pivots and the intercept make the Hessian singular, and the
    reference's fit breaks down on some folds (all scores NaN, AuPR 0.0)
    where rounding noise tips it, in a pattern that changes with the
    compiled program; there each fold must be the reference's 0.0 or a
    finite AuPR, and the candidate's mean must stay below the winner's.
    Returns the largest gap per kind and the reg-0 folds."""
    sweep = load_sweep(os.path.join(TITANIC_NEWTON, "sweep.npz"))
    summ = model.stages[-1].summary
    ref = _titanic_folds(sweep["mixed_metrics" if mixed else "metrics"])
    best = int(sweep["mixed_best"]) if mixed else int(np.argmax(ref.astype(np.float64).mean(1)))
    check(_best_index(summ) == best,
          f"winner {summ.best_model_name} {summ.best_grid} is not the fixture's candidate {best}")
    gaps = {"newton": 0.0, "fista": 0.0}
    reg0 = []
    win = summ.validation_results[best]["metricValue"]
    for i, r in enumerate(summ.validation_results):
        reg, alpha = r["grid"]["reg_param"], r["grid"]["elastic_net_param"]
        mine = np.asarray(r["foldMetrics"], np.float64)
        theirs = ref[i].astype(np.float64)
        if reg * alpha != 0.0:
            gaps["fista"] = max(gaps["fista"], float(np.abs(mine - theirs).max()))
        elif reg > 0.0:
            gaps["newton"] = max(gaps["newton"], float(np.abs(mine - theirs).max()))
        else:
            check(all(np.isfinite(m) and (abs(m - t) <= NEWTON_AUPR_TOL or t == 0.0)
                      for m, t in zip(mine, theirs)),
                  f"reg-0 Newton folds {mine.tolist()} against the fixture's {theirs.tolist()}")
            check(r["metricValue"] < win, "a reg-0 Newton point reaches the winner's mean")
            reg0.append({"port": mine.tolist(), "fixture": theirs.tolist()})
    check(gaps["newton"] <= NEWTON_AUPR_TOL,
          f"Newton fold AuPR {gaps['newton']} from the fixture's, above {NEWTON_AUPR_TOL}")
    check(gaps["fista"] <= LR_AUPR_TOL,
          f"FISTA fold AuPR {gaps['fista']} from the fixture's, above {LR_AUPR_TOL}")
    return {"max_gap": gaps, "reg0_folds": reg0, "best_grid": summ.best_grid}


def check_boston_ridge_train(model) -> Dict[str, Any]:
    """Hold a Boston ridge train to the ``boston_ridge`` fixture: the same
    candidates and winner, every fold RMSE within ``RIDGE_RMSE_RTOL``
    (relative), the refit's holdout metrics within ``RIDGE_PRED_RTOL``.
    Returns the largest relative gaps."""
    import json

    with open(os.path.join(BOSTON_RIDGE, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    _check_order(summ, ref["validationResults"])
    check(summ.best_model_name == ref["bestModelName"] and summ.best_grid == ref["bestGrid"],
          f"winner {summ.best_model_name} {summ.best_grid} differs from the fixture's")
    gap = max(abs(a - b) / abs(b) for mine, theirs in zip(summ.validation_results,
                                                          ref["validationResults"])
              for a, b in zip(mine["foldMetrics"], theirs["foldMetrics"]))
    check(gap <= RIDGE_RMSE_RTOL, f"fold RMSE {gap} (relative) from the fixture's, above "
                                  f"{RIDGE_RMSE_RTOL}")
    hold = max(abs(summ.holdout_evaluation[k] - ref["holdoutEvaluation"][k])
               / abs(ref["holdoutEvaluation"][k])
               for k in ("RootMeanSquaredError", "MeanSquaredError", "R2", "MeanAbsoluteError"))
    check(hold <= RIDGE_PRED_RTOL, f"holdout metrics {hold} (relative) from the fixture's")
    return {"fold_rmse_max_rel_gap": gap, "holdout_max_rel_gap": hold,
            "holdout": {k: v for k, v in summ.holdout_evaluation.items()
                        if k != "SignedPercentageErrorHistogram"}}


def compare_ridge_predictions(pred: np.ndarray, cols: Dict[str, np.ndarray],
                              expected: np.ndarray) -> Dict[str, float]:
    """Gaps of a reg-0 ridge model's predictions to the fixture's: within
    ``RIDGE_PRED_ATOL`` + ``RIDGE_PRED_RTOL`` (relative) on the requests with
    a seen ``chas`` category, finite on the others (see
    ``RIDGE_PRED_RTOL``).  Raises
    AssertionError on a failed check."""
    seen = np.isin(np.asarray(cols["chas"]), BOSTON_CHAS_SEEN)
    err = np.abs(pred - expected)
    out = {"seen_rows": int(seen.sum()), "seen_max_abs_err": float(err[seen].max()),
           "seen_max_rel_err": float((err / np.abs(expected))[seen].max()),
           "unseen_rows": int((~seen).sum()),
           "unseen_max_abs_diff": float(err[~seen].max(initial=0.0))}
    check(bool((err[seen] <= RIDGE_PRED_ATOL + RIDGE_PRED_RTOL * np.abs(expected[seen])).all()),
          out)
    check(bool(np.isfinite(pred).all()), "a ridge prediction is not finite")
    return out


#: fold RMSE of the Boston GLM candidates, relative.  The reference solves
#: each IRLS step's system in float32, the port in float64: on the 506-row
#: frame the port's fold RMSE are within 4.7e-5 of the fixture's and within
#: 6.8e-6 of the reference's fits run in float64 (on the CPU), at 2^18 rows
#: within 7e-5.  Well under the 2.6e-3 (1.5e-3 at 2^18 rows) between the winner
#: (gaussian / identity, reg 0.001) and the runner-up (reg 0.01)
GLM_RMSE_RTOL = 2e-4
#: the GLM refit's predictions on the fixture's requests whose ``chas`` is a
#: category the model saw, and its holdout metrics, against the JAX
#: package's, relative
GLM_PRED_RTOL = 1e-4
#: and absolute (thousands of dollars) on the requests with an unseen
#: ``chas``.  The chas pivot's two columns sum to the intercept's, so the
#: direction (+1 on both, -1 on the intercept) is conditioned only by reg
#: 0.001 on a Gram whose entries reach ~2.6e5 (``tax``): the reference's
#: float32 solve leaves ~0.007 there (chas coefficients -1.8439 / 1.8576,
#: intercept -19.6043, where the port's float64 solve gives -1.8512 /
#: 1.8505 / -19.5978 and the exact optimum has the two chas coefficients
#: summing to 0).  A request with an unseen chas value reads the intercept
#: alone and moves by that much (0.0075 on the CPU); the seen ones read the
#: sum, which the data fixes (``compare_glm_predictions``)
GLM_UNSEEN_ATOL = 0.05


def compare_glm_predictions(pred: np.ndarray, cols: Dict[str, np.ndarray],
                            expected: np.ndarray) -> Dict[str, float]:
    """Gaps of a GLM winner's predictions to the fixture's: within
    ``PRED_ATOL`` + ``GLM_PRED_RTOL`` (relative) on the requests with a seen
    ``chas`` category, within ``GLM_UNSEEN_ATOL`` on the others (see
    there).  Raises AssertionError on a failed check."""
    seen = np.isin(np.asarray(cols["chas"]), BOSTON_CHAS_SEEN)
    err = np.abs(pred - expected)
    out = {"seen_rows": int(seen.sum()), "seen_max_abs_err": float(err[seen].max()),
           "seen_max_rel_err": float((err / np.abs(expected))[seen].max()),
           "unseen_rows": int((~seen).sum()),
           "unseen_max_abs_err": float(err[~seen].max(initial=0.0))}
    check(bool((err[seen] <= PRED_ATOL + GLM_PRED_RTOL * np.abs(expected[seen])).all()), out)
    check(bool(np.isfinite(pred).all()) and out["unseen_max_abs_err"] <= GLM_UNSEEN_ATOL, out)
    return out


def check_boston_glm_train(model, scale: bool = False) -> Dict[str, Any]:
    """Hold a Boston GLM train to the ``boston_glm`` fixture: the 506-row
    train (the saved summary: the same candidates, winner and holdout
    metrics within ``GLM_PRED_RTOL``) or, with ``scale``, the train on
    ``boston_data(scale_rows, scale_seed)``; every fold RMSE within
    ``GLM_RMSE_RTOL`` (relative) of the JAX package's.  Returns the largest
    gaps."""
    import json

    sweep = load_sweep(os.path.join(BOSTON_GLM, "sweep.npz"))
    with open(os.path.join(BOSTON_GLM, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    _check_order(summ, ref["validationResults"])
    best = int(sweep["scale_best" if scale else "best"])
    check(_best_index(summ) == best,
          f"winner {summ.best_model_name} {summ.best_grid} is not the fixture's candidate {best}")
    folds = np.array([r["foldMetrics"] for r in summ.validation_results], np.float64)
    theirs = sweep["scale_fold_rmse" if scale else "fold_rmse"]
    check(folds.shape == theirs.shape, f"fold RMSE {folds.shape}, the fixture's {theirs.shape}")
    gap = float((np.abs(folds - theirs) / np.abs(theirs)).max())
    check(bool(np.isfinite(folds).all()) and gap <= GLM_RMSE_RTOL,
          f"fold RMSE {gap} (relative) from the fixture's, above {GLM_RMSE_RTOL}")
    out = {"fold_rmse_max_rel_gap": gap,
           "holdout": {k: v for k, v in summ.holdout_evaluation.items()
                       if k != "SignedPercentageErrorHistogram"}}
    if not scale:
        hold = max(abs(summ.holdout_evaluation[k] - ref["holdoutEvaluation"][k])
                   / abs(ref["holdoutEvaluation"][k])
                   for k in ("RootMeanSquaredError", "MeanSquaredError", "R2",
                             "MeanAbsoluteError"))
        check(hold <= GLM_PRED_RTOL, f"holdout metrics {hold} (relative) from the fixture's")
        out["holdout_max_rel_gap"] = hold
    return out


#: fold AuPR of the linear SVC candidates: the evaluator scores the hard
#: 0/1 prediction, and the coefficients after 200 steps differ from the
#: reference's in the last bits (float32 sums in another order), which can
#: flip a row whose margin is within rounding of 0 and move the AuPR by a
#: step (equal on the CPU)
SVC_AUPR_TOL = 1e-6
#: fold AuPR of naive Bayes: the masses of the real columns are correctly
#: rounded where XLA sums float32 (0/1 columns exact in both; equal on the
#: CPU)
NB_AUPR_TOL = 1e-6
#: fold AuPR of the MLP: 200 full-batch Adam steps amplify the float32
#: order differences of the gradients (and XLA's own exp): the normalized
#: step turns a last-bit difference of a small gradient into a difference
#: of the step, so the parameters drift apart from about step 60 (1.5e-4 on
#: the CPU)
MLP_AUPR_TOL = 3e-4
#: the decision trees are bit-equal (integer weights); on the per-family
#: path their metrics are too, on the fused path the AuPR's own float32 sum
#: differs (``RF_AUPR_TOL``)
FAMILIES_AUPR_TOL = {"OpLinearSVC": SVC_AUPR_TOL, "OpNaiveBayes": NB_AUPR_TOL,
                     "OpMultilayerPerceptronClassifier": MLP_AUPR_TOL}
#: probabilities of a families winner on the fixture's requests, against
#: the JAX package's answers for its own winner: "a" naive Bayes, "b" the
#: MLP.  The JAX-saved winners score within 4e-6 (naive Bayes) and 2e-7
#: (MLP) on the CPU, which ``JAX_SAVED_PROB_ATOL`` holds.  A winner the port
#: refits itself differs by its parameters: naive Bayes by its real
#: columns' masses (6.0e-5 on the CPU); the MLP by the Adam drift above,
#: which on the refit's 802 rows grows by about ten times every eight steps
#: from step 64 (3.7e-6) to step 100 (0.16 in a weight), so its
#: probabilities move by up to 0.020 on the CPU, its predictions not at all
FAMILIES_PROB_ATOL = {"a": 2e-4, "b": 0.05}
JAX_SAVED_PROB_ATOL = 1e-5


def check_titanic_families_train(model, space: str) -> Dict[str, Any]:
    """Hold a Titanic train over the binary selector's other families to the
    ``titanic_families`` fixture: ``space`` "a" (with naive Bayes: the
    per-family sweep) or "b" (without: the fused sweep).  The same
    candidates in the same order and the same winner; each family's fold
    AuPR within its tolerance (``FAMILIES_AUPR_TOL``), the decision trees'
    bit for bit on the per-family path and within ``RF_AUPR_TOL`` on the
    fused one.  Returns the largest gap per family and the winner."""
    import json

    with open(os.path.join(TITANIC_FAMILIES, "space_" + space, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    _check_order(summ, ref["validationResults"])
    check(summ.best_model_name == ref["bestModelName"] and summ.best_grid == ref["bestGrid"],
          f"winner {summ.best_model_name} {summ.best_grid} differs from the fixture's "
          f"{ref['bestModelName']} {ref['bestGrid']}")
    tols = dict(FAMILIES_AUPR_TOL,
                OpDecisionTreeClassifier=0.0 if space == "a" else RF_AUPR_TOL)
    gaps: Dict[str, float] = {}
    for mine, theirs in zip(summ.validation_results, ref["validationResults"]):
        check(mine.get("error") is None, f"{mine['modelName']} failed: {mine.get('error')}")
        g = max(abs(a - b) for a, b in zip(mine["foldMetrics"], theirs["foldMetrics"]))
        gaps[mine["modelName"]] = max(gaps.get(mine["modelName"], 0.0), g)
    for fam, gap in gaps.items():
        check(gap <= tols[fam], f"{fam} fold AuPR {gap} from the fixture's, above {tols[fam]}")
    return {"max_gap": gaps, "best": summ.best_model_name, "best_grid": summ.best_grid,
            "tolerances": tols}


def compare_family_answers(expected: Dict[str, np.ndarray], space: str, prediction: np.ndarray,
                           probability: np.ndarray, tol: Optional[float] = None
                           ) -> Dict[str, float]:
    """Gaps of a families winner's answers to the fixture's (``space`` "a"
    or "b"): the probabilities within ``tol`` (default
    ``FAMILIES_PROB_ATOL[space]``), the predictions equal off the class
    boundary (|p1 - p0| above twice that), non-finite answers at the same
    rows.  Raises AssertionError on a failed check."""
    ep, eq = expected[space + "_prediction"], expected[space + "_probability"]
    tol = FAMILIES_PROB_ATOL[space] if tol is None else tol
    fin = np.isfinite(eq).all(1)
    check(np.array_equal(fin, np.isfinite(probability).all(1)), "non-finite rows differ")
    off = fin & (np.abs(eq[:, 1] - eq[:, 0]) > 2 * tol)
    out = {"probability_max_abs_err": float(np.abs(probability[fin] - eq[fin]).max()),
           "prediction_mismatches_off_boundary": float(np.sum(prediction[off] != ep[off])),
           "boundary_rows": int((fin & ~off).sum()), "non_finite_rows": int((~fin).sum())}
    check(out["probability_max_abs_err"] <= tol, out)
    check(out["prediction_mismatches_off_boundary"] == 0, out)
    return out


# ---------------------------------------------------------------------------
# The sanity checker's summaries (titanic_sanity/)
# ---------------------------------------------------------------------------
#: setting -> (the frame, the sanity checker's keyword arguments)
SANITY_SETTINGS: Dict[str, Tuple[str, Dict[str, Any]]] = {
    "pearson": ("titanic", {}),
    "pearson_streamed": ("titanic", {"sharded_stats": True}),
    "spearman": ("titanic", {"correlation_type": "spearman"}),
    "spearman_streamed": ("titanic", {"correlation_type": "spearman", "sharded_stats": True}),
    "pearson_hashed_text": ("titanic_distinct_names",
                            {"correlation_exclusion": "hashed_text", "sharded_stats": True}),
    "scale_pearson": ("scale", {"sample_upper_limit": 1 << 20}),
    "scale_spearman": ("scale", {"sample_upper_limit": 1 << 20, "correlation_type": "spearman"}),
}
#: the rows of the scale frame and its seed (``chip_smoke.titanic_columns``)
SANITY_SCALE_ROWS, SANITY_SCALE_SEED = 1 << 20, 0
#: label and feature x feature correlations against the JAX package's:
#: the reference's float32 sums (its in-memory matrix product, its streamed
#: carries) against the port's float64 ones; 1.2e-6 measured on the CPU
#: (``port_cpu_gaps`` in the fixture)
SANITY_CORR_ATOL = 3e-6
#: column means and variances, relative: the reference's streamed float32
#: carries (its in-memory moments are float64); 2.0e-6 measured (variances
#: of the 2^20-row frame)
SANITY_MOMENT_RTOL = 5e-6
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def load_sanity() -> Dict[str, Any]:
    with open(os.path.join(TITANIC_SANITY, "summaries.json")) as fh:
        return json.load(fh)


def strip_numbers(reasons: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """Drop reasons without their numbers: the statistics they quote differ
    in the last bits between the packages."""
    return {k: [_NUMBER.sub("#", r) for r in v] for k, v in reasons.items()}


class CorrMatrices:
    """Records the feature x feature correlation matrix of every fit of
    ``module.SanityChecker`` while on (its records' ``feature_corrs``, NaN
    rows when the checker computes none), in fit order."""

    def __init__(self, module):
        self.module, self.matrices = module, []

    def __enter__(self):
        cls = self.module.SanityChecker
        self.saved = cls._features_to_drop

        def recording(checker, records, _orig=self.saved):
            d = len(records)
            self.matrices.append(np.array(
                [np.asarray(r.feature_corrs, np.float64) if len(r.feature_corrs)
                 else np.full(d, np.nan) for r in records]).reshape(d, d))
            return _orig(checker, records)

        cls._features_to_drop = recording
        return self

    def __exit__(self, *exc):
        self.module.SanityChecker._features_to_drop = self.saved


def _values(v) -> np.ndarray:
    return np.array([np.nan if x is None else x for x in v], np.float64)


def _nan_gap(a: np.ndarray, b: np.ndarray, what: str) -> float:
    check(np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: NaN at other entries")
    live = ~np.isnan(b)
    return float(np.max(np.abs(a[live] - b[live]))) if live.any() else 0.0


def check_titanic_sanity(summary: Dict[str, Any], setting: str,
                         corr_matrix: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Hold a sanity checker's summary (and correlation matrix) to the JAX
    package's for ``setting``: the same columns, sample size, correlation
    type, dropped features and reasons (without their numbers), the label
    correlations and the matrix within ``SANITY_CORR_ATOL``, each column's
    (and the label's, whatever its name) count, min and max equal and mean
    and variance within
    ``SANITY_MOMENT_RTOL``, the categorical groups' Cramer's V within
    ``SANITY_CORR_ATOL``.  Returns the gaps; raises AssertionError on a
    failed check."""
    ref = load_sanity()[setting]
    rs = ref["summary"]
    check(summary["names"] == rs["names"], f"{setting}: columns {summary['names']}")
    check(summary["sampleSize"] == rs["sampleSize"], f"{setting}: sample size")
    check(summary["correlationType"] == rs["correlationType"], f"{setting}: correlation type")
    check(sorted(summary["dropped"]) == sorted(rs["dropped"]),
          f"{setting}: dropped {sorted(summary['dropped'])}, the JAX package {rs['dropped']}")
    check(strip_numbers(summary["reasons"]) == strip_numbers(rs["reasons"]),
          f"{setting}: reasons differ")
    out: Dict[str, Any] = {"dropped": sorted(summary["dropped"])}
    out["corr_label_max_gap"] = _nan_gap(_values(summary["correlationsWLabel"]["values"]),
                                         _values(rs["correlationsWLabel"]["values"]),
                                         f"{setting}: label correlations")
    if corr_matrix is not None:
        out["corr_matrix_max_gap"] = _nan_gap(np.asarray(corr_matrix, np.float64),
                                              _values(np.ravel(ref["corr_matrix"]))
                                              .reshape(np.shape(corr_matrix)),
                                              f"{setting}: correlation matrix")
    mine, theirs = summary["featuresStatistics"], rs["featuresStatistics"]
    check([f["name"] for f in mine if not f["isLabel"]]
          == [f["name"] for f in theirs if not f["isLabel"]], f"{setting}: statistics")
    for key in ("count", "min", "max"):
        check([f[key] for f in mine] == [f[key] for f in theirs], f"{setting}: {key} differs")
    for key in ("mean", "variance"):
        a = np.array([f[key] for f in mine], np.float64)
        b = np.array([f[key] for f in theirs], np.float64)
        out[f"{key}_max_rel_gap"] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    cm = [(g["group"], g["cramersV"]) for g in summary["categoricalStats"]]
    cr = [(g["group"], g["cramersV"]) for g in rs["categoricalStats"]]
    check([g for g, _ in cm] == [g for g, _ in cr], f"{setting}: categorical groups")
    out["cramers_v_max_gap"] = _nan_gap(_values([v for _, v in cm]), _values([v for _, v in cr]),
                                        f"{setting}: Cramer's V")
    for key, tol in (("corr_label_max_gap", SANITY_CORR_ATOL),
                     ("corr_matrix_max_gap", SANITY_CORR_ATOL),
                     ("mean_max_rel_gap", SANITY_MOMENT_RTOL),
                     ("variance_max_rel_gap", SANITY_MOMENT_RTOL),
                     ("cramers_v_max_gap", SANITY_CORR_ATOL)):
        check(out.get(key, 0.0) <= tol, f"{setting}: {key} {out.get(key)} above {tol}")
    return out


# ---------------------------------------------------------------------------
# the text flow (titanic_text)
# ---------------------------------------------------------------------------
#: fold AuPR of the text flow's families against the fixture's.  The
#: features now include the Word2Vec and LDA outputs of each fold's own fits,
#: which differ from the reference's in their last bits (vectors) and by up
#: to a few 1e-3 relative (the LDA mixtures: see ``TEXT_LDA_RTOL``): the
#: logistic regression's AuPR moves by its FISTA order alone
#: (``LR_AUPR_TOL``); the trees' quantile bins and near-tied splits on those
#: columns move, so the forests and boosted trees are no longer bit-equal
#: (the 891-row stock train on the CPU: LR 6e-8, RF 3.1e-3 in 5 of 18
#: candidates, XGB 7.5e-4; on the card RF 3.4e-3)
TEXT_AUPR_TOL = {"OpLogisticRegression": LR_AUPR_TOL, "OpRandomForestClassifier": 1e-2,
                 "OpXGBoostClassifier": 1e-2}
#: the final Word2Vec fit's vectors against the fixture's: float32 sums of
#: each row's gradient in another order than XLA's scatter, over 30 epochs
TEXT_W2V_ATOL = 2e-5
#: the final LDA fit's topic-word lambda against the fixture's, |gap| <=
#: rtol |lambda| + atol: the E-step's unstable fixed point for small topic
#: weights amplifies last-bit gaps over its 30 iterations, and the M-steps
#: feed them back (gammas within 8.5e-4 relative on the same inputs)
TEXT_LDA_RTOL = 2e-2
TEXT_LDA_ATOL = 2e-3
#: probabilities of the fixture's requests: the JAX-saved model scored by
#: the port (the E-step's gaps reach the LDA features), and a model the port
#: trained itself (its Word2Vec and LDA fits' gaps reach the refit)
TEXT_JAX_SAVED_PROB_ATOL = 1e-5
TEXT_PROB_ATOL = 1e-3


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()


def load_k18() -> Dict[str, np.ndarray]:
    with np.load(os.path.join(TITANIC_TEXT, "k18.npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class PortW2VArgs:
    """Records (W0, pairs, negs) of every Word2Vec fit of the port while on
    (``embeddings_module``: ``transmogrifai_tpu_torch.impl.feature.embeddings``)."""

    def __init__(self, embeddings_module):
        self.module, self.calls = embeddings_module, []

    def __enter__(self):
        cls = self.module.OpWord2Vec
        self._train = train = cls.train

        def recording(stage, W0, pairs, negs, device):
            self.calls.append((W0, pairs, negs))
            return train(stage, W0, pairs, negs, device)

        cls.train = recording
        return self

    def __exit__(self, *exc):
        self.module.OpWord2Vec.train = self._train


def _stage(model, name: str):
    return next(s for s in model.stages if type(s).__name__ == name)


def _fixture_model():
    from ..workflow.model import OpWorkflowModel

    return OpWorkflowModel.load(TITANIC_TEXT, device="cpu")


def check_text_tokens(model, notes: np.ndarray) -> Dict[str, Any]:
    """The port's tokens of ``notes`` (the 891-row frame's) and their count
    matrix under ``model``'s count vectorizer equal the JAX package's in
    ``k18.npz``."""
    from ..columns import ObjectColumn
    from .. import types as T

    k18 = load_k18()
    tokenizer = _stage(model, "TextTokenizer")
    tokens = [tokenizer.tokenize(t) for t in notes]
    check([" ".join(t) for t in tokens] == k18["tokens"].tolist(), "tokens differ")
    col = ObjectColumn(T.TextList, np.empty(len(tokens), dtype=object))
    col.values[:] = tokens
    counts = _stage(model, "OpCountVectorizerModel").transform_columns([col]).numpy()
    check(np.array_equal(counts, k18["counts"].astype(np.float32)), "count vectors differ")
    return {"rows": len(tokens), "tokens": int(sum(len(t) for t in tokens)),
            "nonzeros": int(np.count_nonzero(counts))}


def check_titanic_text_train(model, final_w2v_args) -> Dict[str, Any]:
    """Hold a text-flow train (the stock space or a part of it) to the
    ``titanic_text`` fixture: the fixture's winner; each family's fold AuPR
    within ``TEXT_AUPR_TOL``; the final fit's vocabularies equal; its
    skip-gram pairs, negatives and ``W0`` (``final_w2v_args``, as
    ``PortW2VArgs`` records them) bit-equal by digest; its word vectors
    within ``TEXT_W2V_ATOL`` and its LDA topic-word matrix within
    ``TEXT_LDA_RTOL`` / ``TEXT_LDA_ATOL``.  Every check runs before the
    first failure is raised (all of them named).  Returns the gaps."""
    with open(os.path.join(TITANIC_TEXT, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    theirs = {(r["modelName"], json.dumps(r["grid"], sort_keys=True)): r
              for r in ref["validationResults"]}
    failed: List[str] = []
    gaps: Dict[str, float] = {}
    for r in summ.validation_results:
        t = theirs[(r["modelName"], json.dumps(r["grid"], sort_keys=True))]
        g = max(abs(a - b) for a, b in zip(r["foldMetrics"], t["foldMetrics"]))
        gaps[r["modelName"]] = max(gaps.get(r["modelName"], 0.0), g)
    if (summ.best_model_name, summ.best_grid) != (ref["bestModelName"], ref["bestGrid"]):
        failed.append(f"winner {summ.best_model_name} {summ.best_grid} differs from the "
                      f"fixture's {ref['bestModelName']} {ref['bestGrid']}")
    failed += [f"{fam} fold AuPR {gap} from the fixture's, above {TEXT_AUPR_TOL[fam]}"
               for fam, gap in gaps.items() if gap > TEXT_AUPR_TOL[fam]]
    fx = _fixture_model()
    failed += [f"{name} vocabulary differs" for name in ("OpCountVectorizerModel",
                                                           "OpWord2VecModel")
               if _stage(model, name).vocabulary != _stage(fx, name).vocabulary]
    k18 = load_k18()
    W0, pairs, negs = final_w2v_args
    if pairs.shape[0] != int(k18["final_pairs"]):
        failed.append("skip-gram pair count differs")
    failed += [f"final Word2Vec {what} differ" for what, a in
               (("pairs", pairs), ("negs", negs), ("W0", W0))
               if digest(a) != str(k18[f"final_{what}_sha"])]
    out: Dict[str, Any] = {"max_gap": gaps, "best": summ.best_model_name,
                           "best_grid": summ.best_grid, "final_pairs": int(pairs.shape[0])}
    vec, vec_ref = (_stage(m, "OpWord2VecModel").vectors for m in (model, fx))
    out["w2v_max_abs_gap"] = float(np.abs(vec - vec_ref).max()) if vec.shape == vec_ref.shape \
        else float("inf")
    if not out["w2v_max_abs_gap"] <= TEXT_W2V_ATOL:
        failed.append(f"word vectors {out['w2v_max_abs_gap']} from the fixture's")
    lam, lam_ref = (_stage(m, "OpLDAModel").topic_word.astype(np.float64) for m in (model, fx))
    gap = np.abs(lam - lam_ref)
    out["lda_max_abs_gap"] = float(gap.max())
    out["lda_max_rel_gap"] = float((gap / np.abs(lam_ref)).max())
    if not np.all(gap <= TEXT_LDA_RTOL * np.abs(lam_ref) + TEXT_LDA_ATOL):
        failed.append(f"LDA topic-word {out['lda_max_abs_gap']} ({out['lda_max_rel_gap']} "
                      "relative) from the fixture's")
    check(not failed, "; ".join(failed) + f" (gaps: {out})")
    return out


def check_titanic_text_wide_train(model) -> Dict[str, Any]:
    """Hold a text-flow train over the Newton and SVC space of
    ``tests/test_torch_wide_linear.py`` (85 coefficients: K-S's and K-T's
    wide entries on the card) to ``titanic_text/wide.npz``: the same
    candidates and winner, the Newton points' fold AuPR within
    ``NEWTON_AUPR_TOL`` and the SVC's within ``SVC_AUPR_TOL``.  Returns the
    largest gap per family and the vector's width."""
    ref = load_sweep(os.path.join(TITANIC_TEXT, "wide.npz"))
    summ = model.stages[-1].summary
    res = summ.validation_results
    check([(r["modelName"], json.dumps(r["grid"], sort_keys=True)) for r in res] ==
          list(zip(ref["names"].tolist(), ref["grids"].tolist())), "candidates differ")
    check(_best_index(summ) == int(ref["best"]),
          f"winner {summ.best_model_name} {summ.best_grid} is not the fixture's")
    tols = {"OpLogisticRegression": NEWTON_AUPR_TOL, "OpLinearSVC": SVC_AUPR_TOL}
    gaps: Dict[str, float] = {}
    for r, theirs in zip(res, ref["folds"]):
        g = float(np.abs(np.asarray(r["foldMetrics"], np.float64) - theirs).max())
        gaps[r["modelName"]] = max(gaps.get(r["modelName"], 0.0), g)
    for fam, gap in gaps.items():
        check(gap <= tols[fam], f"{fam} fold AuPR {gap} from the fixture's, above {tols[fam]}")
    width = int(_stage(model, "SanityCheckerModel").indices_to_keep.size) + 1
    return {"max_gap": gaps, "best": summ.best_model_name, "best_grid": summ.best_grid,
            "width": width}


def compare_text_answers(expected: Dict[str, np.ndarray], prediction: np.ndarray,
                         probability: np.ndarray, tol: float) -> Dict[str, float]:
    """Gaps of a text-flow model's answers to the fixture's: probabilities
    within ``tol``, predictions equal off the class boundary (|p1 - p0|
    above twice ``tol``)."""
    eq = expected["probability"]
    gap = float(np.abs(probability - eq).max())
    check(gap <= tol, f"probabilities {gap} from the fixture's, above {tol}")
    off = np.abs(eq[:, 1] - eq[:, 0]) > 2 * tol
    check(np.array_equal(prediction[off], expected["prediction"][off]), "predictions differ")
    return {"probability_max_abs_err": gap, "rows": int(len(prediction))}


# ---------------------------------------------------------------------------
# titanic_simple: the OpTitanicSimple feature set (build_workflow(
# reference_features=True)) over the stock space
# ---------------------------------------------------------------------------
#: probabilities of the JAX-saved OpTitanicSimple model's answers scored by
#: the port: the streamed-free host path computes the same float64 scalers
#: and float32 linear scores in another order
SIMPLE_PROB_ATOL = 1e-6
#: fold AuPR per family of an OpTitanicSimple train against the fixture's.
#: The features are bit-equal to the JAX package's (the scoring path's every
#: intermediate column compared on the 891 rows); the LR candidates' 200
#: FISTA steps sum in float32 in another order, and this flow's unscaled
#: ``estimated_cost`` column (family size x fare, up to about 1,000) shrinks
#: the step and carries those last bits further than the stock flow's
#: (measured 1.2e-5 on the CPU, above the stock flow's ``LR_AUPR_TOL``).
#: The boosted trees' histograms sum in fixed point where XLA sums float32,
#: and on this flow's wide-ranged columns near-tied splits flip (measured
#: 2.19e-4 on the CPU, above the stock flow's 1e-4 and 2e-4)
SIMPLE_AUPR_TOL = {"OpLogisticRegression": 2.5e-5, "OpRandomForestClassifier": RF_AUPR_TOL,
                   "OpXGBoostClassifier": 5e-4}


def check_titanic_simple_train(model, xgb_tol: Optional[float] = None) -> Dict[str, Any]:
    """Hold an OpTitanicSimple train (the stock space or a part of it) to
    ``titanic_simple``: the fixture's best candidate among those trained;
    each candidate's fold AuPR within ``SIMPLE_AUPR_TOL`` of its family
    (``xgb_tol`` for the boosted trees where given: K-E's fixed-point sums
    on the card).  Returns the largest gap per family and the winner."""
    tols = dict(SIMPLE_AUPR_TOL)
    if xgb_tol is not None:
        tols["OpXGBoostClassifier"] = xgb_tol
    with open(os.path.join(TITANIC_SIMPLE, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    theirs = {(r["modelName"], json.dumps(r["grid"], sort_keys=True)): r
              for r in ref["validationResults"]}
    gaps: Dict[str, float] = {}
    best, best_mean = None, -np.inf
    for r in summ.validation_results:
        key = (r["modelName"], json.dumps(r["grid"], sort_keys=True))
        check(key in theirs, f"candidate {key} is not in the fixture")
        t = theirs[key]
        g = max(abs(a - b) for a, b in zip(r["foldMetrics"], t["foldMetrics"]))
        gaps[r["modelName"]] = max(gaps.get(r["modelName"], 0.0), g)
        if t["metricValue"] > best_mean:
            best, best_mean = key, t["metricValue"]
    for fam, gap in gaps.items():
        check(gap <= tols[fam], f"{fam} fold AuPR {gap} from the fixture's, above {tols[fam]}")
    mine = (summ.best_model_name, json.dumps(summ.best_grid, sort_keys=True))
    check(mine == best, f"winner {mine} is not the fixture's {best}")
    return {"max_gap": gaps, "best": summ.best_model_name, "best_grid": summ.best_grid,
            "candidates": len(summ.validation_results)}


# ---------------------------------------------------------------------------
# slice 12: the selectors' branches (two-class multiclass, the split)
# ---------------------------------------------------------------------------
#: fold metrics of the branch trains against the JAX package's, absolute, by
#: selector and family.  The multiclass Error counts wrong rows (a step of
#: 1 / 297 on the 891-row frame's folds): LR (softmax FISTA over the two
#: classes) and RF equal the JAX package's; XGBoost's 200-round trees are
#: grown on K-E's fixed-point sums where XLA sums in float32, so near-tied
#: splits flip (its AuPR gap in the binary selector, 2e-4) and a
#: probability near 0.5 lands on the other side: 3 rows of a fold on the
#: CPU and on the H100, held at 5 rows.  The split's AuPR as the stock
#: space's
BRANCHES_TOL = {
    "multiclass": {"OpLogisticRegression": 0.0, "OpRandomForestClassifier": 0.0,
                   "OpXGBoostClassifier": 5 / 297},
    "split": {"OpLogisticRegression": LR_AUPR_TOL, "OpRandomForestClassifier": RF_AUPR_TOL,
              "OpXGBoostClassifier": 2e-4},
}
#: the evaluators on two packages' trained models' scores, relative
BRANCHES_SCORE_RTOL = 1e-4


def check_titanic_branches_train(model, selector: str, metrics: np.ndarray,
                                 masks: Tuple[np.ndarray, np.ndarray]) -> Dict[str, Any]:
    """Hold a stock-space Titanic train under ``selector`` ("multiclass" or
    "split") to ``titanic_branches/``: the first sweep call's fold weights
    and masks bit for bit, the same metrics' shape, the same winner, each
    family's fold metrics within ``BRANCHES_TOL``.  Returns the largest gap
    per family."""
    ref = load_sweep(os.path.join(TITANIC_BRANCHES, "sweep.npz"))
    for mine, theirs, what in zip(masks, (ref[f"{selector}_train_w"],
                                          ref[f"{selector}_val_mask"]), ("train_w", "val")):
        check(np.array_equal(np.asarray(mine), theirs), f"{selector} fold {what} differ")
    check(metrics.shape == ref[f"{selector}_metrics"].shape,
          f"{selector} metrics {metrics.shape} against {ref[f'{selector}_metrics'].shape}")
    summ = model.stages[-1].summary
    folds = np.array([r["foldMetrics"] for r in summ.validation_results], np.float64)
    check(folds.shape == ref[f"{selector}_folds"].shape, "fold metric shape")
    gaps: Dict[str, float] = {}
    for r, mine, theirs in zip(summ.validation_results, folds, ref[f"{selector}_folds"]):
        g = float(np.max(np.abs(mine - theirs)))
        gaps[r["modelName"]] = max(gaps.get(r["modelName"], 0.0), g)
    for fam, gap in gaps.items():
        check(gap <= BRANCHES_TOL[selector][fam],
              f"{selector} {fam} fold metric {gap} from the fixture's, above "
              f"{BRANCHES_TOL[selector][fam]}")
    check(_best_index(summ) == int(ref[f"{selector}_best"]),
          f"{selector} winner {summ.best_model_name} {summ.best_grid} differs from the fixture's")
    return gaps


# ---------------------------------------------------------------------------
# slice 12: round-collapsed boosting
# ---------------------------------------------------------------------------
#: the collapsed XGB candidates' fold AuPR against the JAX package's: the
#: histogram sums follow XLA's, but the logistic ``exp`` moves a gradient by
#: an ulp, which can move a near-tied split (the full-width trains: 5.8e-5
#: on the CPU, 6.6e-5 on the H100)
COLLAPSE_XGB_AUPR_TOL = 1e-4


def check_titanic_collapse_train(model, space: str) -> Dict[str, float]:
    """Hold a collapsed Titanic train to ``titanic_collapse/sweep.npz``:
    ``space`` "stock" (the stock space under ``TMOG_GBT_ROUND_COLLAPSE=4``)
    or "xgb" (the collapsed XGB-only space): the same candidates' fold AuPR
    within each family's tolerance (LR ``LR_AUPR_TOL``, RF ``RF_AUPR_TOL``,
    XGB ``COLLAPSE_XGB_AUPR_TOL``) and the same winner.  Returns the
    largest gap per family."""
    ref = load_sweep(os.path.join(TITANIC_COLLAPSE, "sweep.npz"))
    summ = model.stages[-1].summary
    folds = np.array([r["foldMetrics"] for r in summ.validation_results], np.float64)
    check(folds.shape == ref[f"{space}_folds"].shape, f"{space} fold metric shape")
    tols = {"OpLogisticRegression": LR_AUPR_TOL, "OpRandomForestClassifier": RF_AUPR_TOL,
            "OpXGBoostClassifier": COLLAPSE_XGB_AUPR_TOL}
    gaps: Dict[str, float] = {}
    for r, mine, theirs in zip(summ.validation_results, folds, ref[f"{space}_folds"]):
        gaps[r["modelName"]] = max(gaps.get(r["modelName"], 0.0),
                                   float(np.max(np.abs(mine - theirs))))
    for fam, gap in gaps.items():
        check(gap <= tols[fam], f"{space} {fam} fold AuPR {gap} from the fixture's, above "
              f"{tols[fam]}")
    check(_best_index(summ) == int(ref[f"{space}_best"]),
          f"{space} winner {summ.best_model_name} {summ.best_grid} differs from the fixture's")
    return gaps


def check_iris_collapse_train(model) -> Dict[str, Any]:
    """Hold the Iris XGB train at K = 4 to ``iris_collapse/sweep.npz``:
    every fold Error bit for bit (the multiclass metrics count in integers),
    the same winner."""
    ref = load_sweep(os.path.join(IRIS_COLLAPSE, "sweep.npz"))
    summ = model.stages[-1].summary
    folds = np.array([r["foldMetrics"] for r in summ.validation_results], np.float64)
    check(np.array_equal(folds, ref["folds"]),
          f"Iris collapsed fold Errors {folds.tolist()} differ from {ref['folds'].tolist()}")
    check(_best_index(summ) == int(ref["best"]), "the Iris collapsed winner differs")
    return {"candidates": len(folds), "best": _best_index(summ)}


def check_boston_collapse_train(model) -> Dict[str, float]:
    """Hold the Boston stock train under ``TMOG_GBT_ROUND_COLLAPSE=4`` to
    ``boston_collapse/sweep.npz``: each family's fold RMSE within its
    relative tolerance (``BOSTON_RMSE_RTOL``), the same winner.  Returns the
    largest relative gap per family."""
    ref = load_sweep(os.path.join(BOSTON_COLLAPSE, "sweep.npz"))
    summ = model.stages[-1].summary
    folds = np.array([r["foldMetrics"] for r in summ.validation_results], np.float64)
    check(folds.shape == ref["folds"].shape, "Boston collapsed fold metric shape")
    gaps: Dict[str, float] = {}
    for r, mine, theirs in zip(summ.validation_results, folds, ref["folds"]):
        gaps[r["modelName"]] = max(gaps.get(r["modelName"], 0.0),
                                   float(np.max(np.abs(mine - theirs) / np.abs(theirs))))
    for fam, gap in gaps.items():
        check(gap <= BOSTON_RMSE_RTOL[fam],
              f"Boston collapsed {fam} fold RMSE {gap} (relative), above {BOSTON_RMSE_RTOL[fam]}")
    check(_best_index(summ) == int(ref["best"]), "the Boston collapsed winner differs")
    return gaps


# ---------------------------------------------------------------------------
# Many classes: a Letter-Recognition-shaped frame (UCI Letter Recognition,
# Frey & Slate 1991: 16 integer attributes 0-15, 26 letters)
# ---------------------------------------------------------------------------
LETTER_FEATURES = ("x_box", "y_box", "width", "high", "onpix", "x_bar", "y_bar", "x2bar",
                   "y2bar", "xybar", "x2ybr", "xy2br", "x_ege", "xegvy", "y_ege", "yegvx")
#: rows of the letters_stock fixture's frame and of the many-class trains
LETTERS_ROWS = 600
MANY_ROWS = 400
#: the cut space of the 64- and 70-class trains: two LR points, two forests
#: of ``MANY_TREES`` trees
MANY_TREES = 10


def letters_data(n: int = LETTERS_ROWS, k: int = 26, seed: int = 0) -> Dict[str, np.ndarray]:
    """A frame with the schema of UCI Letter Recognition: the 16 integer
    attributes (0 .. 15, as float64 columns), a class label 0 .. k - 1 and
    an id, made with numpy from ``seed``.  Each class draws its attributes
    around its own centre (uniform in [2, 13]) with a spread of 2.5, rounded
    and clipped to 0 .. 15; labels are uniform over the k classes, and every
    class has at least one row where n >= k."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(2.0, 13.0, (k, len(LETTER_FEATURES)))
    label = rng.integers(0, k, n)
    label[:min(n, k)] = np.arange(min(n, k))
    pts = np.clip(np.rint(centres[label] + rng.normal(0.0, 2.5, (n, len(LETTER_FEATURES)))),
                  0, 15)
    cols = {f: pts[:, j].astype(np.float64) for j, f in enumerate(LETTER_FEATURES)}
    cols["label"] = label.astype(np.float64)
    cols["id"] = np.arange(n)
    return cols


def letters_workflow(models_and_parameters=None, **selector_kw):
    """(OpWorkflow, prediction feature) of the port's Letter flow: the 16
    ``Integral`` attributes vectorized, ``MultiClassificationModelSelector``
    with 3-fold CV, seed 42 (by default the stock space: multinomial LR + RF,
    26 candidates).  The tests build the JAX package's flow alike."""
    from .. import types as T
    from ..features.builder import FeatureBuilder
    from ..impl.selector.factories import MultiClassificationModelSelector
    from ..workflow.workflow import OpWorkflow

    label = FeatureBuilder("label", T.RealNN).extract(field="label").as_response()
    feats = [FeatureBuilder(f, T.Integral).extract(field=f).as_predictor()
             for f in LETTER_FEATURES]
    kw = {"num_folds": 3, "seed": 42, **selector_kw}
    pred = MultiClassificationModelSelector.with_cross_validation(
        models_and_parameters=models_and_parameters, **kw,
    ).set_input(label, feats[0].vectorize(*feats[1:])).get_output()
    return OpWorkflow().set_result_features(pred), pred


def many_space(est_cls_lr, est_cls_rf):
    """The cut space of the 64- and 70-class trains, from either package's
    classes: two elastic-net LR points and two forests of ``MANY_TREES``
    trees."""
    return [(est_cls_lr(), [{"reg_param": 0.01, "elastic_net_param": 0.0},
                            {"reg_param": 0.1, "elastic_net_param": 0.0}]),
            (est_cls_rf(), [{"num_trees": MANY_TREES, "max_depth": 6},
                            {"num_trees": MANY_TREES, "max_depth": 6, "min_info_gain": 0.01}])]


#: the many_class fixture's trains: name -> (classes, rows, space); each on
#: ``letters_data(rows, classes, 1)``
MANY_RUNS = {
    "fused26": (26, MANY_ROWS, "many"),
    "fused64": (64, MANY_ROWS, "many"),
    "family70": (70, MANY_ROWS, "many"),
    "boost10_k1": (10, 300, "boost1"),
    "boost10_k4": (10, 300, "boost4"),
    "boost10_full": (10, 300, "boostfull"),
}


def many_run_space(space: str, lr, rf, xgb, gbt, xgboost_grid):
    """A ``MANY_RUNS`` space from either package's estimator classes and
    ``xgboost_grid``: ``many_space``; or softmax boosting at
    ``trees_per_round`` K ("boost1", "boost4": XGBoost at 20 rounds of depth
    4, min_child_weight 1 and 10, and a GBT of 8 rounds of depth 3;
    "boostfull": the stock ``xgboost_grid()`` and the default GBT, K = 1)."""
    if space == "many":
        return many_space(lr, rf)
    if space == "boostfull":
        return [(xgb(), [dict(g, trees_per_round=1) for g in xgboost_grid()]),
                (gbt(), [{"trees_per_round": 1}])]
    K = int(space[-1])
    return [(xgb(), [{"num_round": 20, "max_depth": 4, "min_child_weight": m,
                      "trees_per_round": K} for m in (1.0, 10.0)]),
            (gbt(), [{"max_iter": 8, "max_depth": 3, "trees_per_round": K}])]


def port_many_run_space(space: str):
    """``many_run_space`` with the port's classes."""
    from ..impl.classification.logistic import OpLogisticRegression
    from ..impl.classification.trees import (OpGBTClassifier, OpRandomForestClassifier,
                                             OpXGBoostClassifier)
    from ..impl.selector.defaults import xgboost_grid

    return many_run_space(space, OpLogisticRegression, OpRandomForestClassifier,
                          OpXGBoostClassifier, OpGBTClassifier, xgboost_grid)


#: F1, Precision and Recall of K-Q and its plain version against the JAX
#: package's from 11 classes on: XLA's CPU code vectorizes the reference's
#: class sums there, in an order that depends on the host's vector width and
#: on the grid's shape, where the port sums in class order (at most 4 ulps
#: measured over 2 .. 128 classes on an AVX-512 host: PERF.md); Error is a
#: count over the validation rows and stays bit-equal at every k
MANY_CLASS_METRIC_ULPS = 4
#: validation rows a candidate's fold Error may differ by from the JAX
#: package's, by family, counted per candidate and fold: the softmax LR fits
#: agree within 2e-5, so a row whose two top classes lie closer can flip;
#: softmax boosting past 8 classes grows on real-valued gradients, which K-E
#: sums in XLA's float32 row order; the softmax's ``exp``, an ulp from XLA's,
#: can still flip a near-tied split (measured on the CPU and on the H100: no
#: row on the cut 10-class grids at trees_per_round 1 and 4, one row on the
#: full grid)
MANY_FLIP_ROWS = {"OpLogisticRegression": 1, "OpXGBoostClassifier": 2, "OpGBTClassifier": 2}
#: the families compared bit for bit in their fold metrics: integer
#: -onehot gradients that K-E sums exactly
_EXACT_FAMILIES = ("OpRandomForestClassifier", "OpDecisionTreeClassifier")


def ulps(a, b) -> int:
    """The largest distance in float32 ulps between two arrays of one sign."""
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _check_many_folds(summ, ref_folds, ref_best: int, nv: Optional[np.ndarray], what: str
                      ) -> Dict[str, Any]:
    """Fold metrics (Error) of a selector summary against the JAX package's:
    the exact families (forests, decision trees) bit for bit, the others
    within ``MANY_FLIP_ROWS`` rows of each fold's ``nv`` validation rows
    (bit for bit too when ``nv`` is None); the same winner."""
    folds = np.array([r["foldMetrics"] for r in summ.validation_results], np.float64)
    check(folds.shape == ref_folds.shape, f"{what}: fold metric shape {folds.shape}")
    flips = 0
    for r, mine, theirs in zip(summ.validation_results, folds, ref_folds):
        if r["modelName"] in MANY_FLIP_ROWS and nv is not None:
            rows = np.rint(np.abs(mine - theirs) * nv).astype(int)
            check(rows.max() <= MANY_FLIP_ROWS[r["modelName"]],
                  f"{what}: {r['modelName']} {r['grid']} fold Errors {mine} against {theirs}")
            flips += int(rows.sum())
        else:
            check(np.array_equal(mine, theirs),
                  f"{what}: {r['modelName']} {r['grid']} fold metrics {mine} against {theirs}")
    check(_best_index(summ) == int(ref_best),
          f"{what}: winner {summ.best_model_name} {summ.best_grid} differs from the JAX "
          "package's")
    return {"candidates": len(folds), "best": _best_index(summ), "rows_flipped": flips}


def _check_many_metrics(metrics: np.ndarray, ref: np.ndarray, summ, what: str) -> int:
    """The fused calls' [calls, F, C, 4] metrics of the exact families:
    Error bit for bit, F1 / Precision / Recall within
    ``MANY_CLASS_METRIC_ULPS``; returns the largest ulp gap."""
    check(metrics.shape == ref.shape, f"{what}: sweep metrics shape {metrics.shape}")
    exact = [i for i, r in enumerate(summ.validation_results)
             if r["modelName"] not in MANY_FLIP_ROWS]
    check(np.array_equal(metrics[..., exact, 3], ref[..., exact, 3]), f"{what}: Errors differ")
    gap = ulps(metrics[..., exact, :3], ref[..., exact, :3])
    check(gap <= MANY_CLASS_METRIC_ULPS, f"{what}: F1/P/R {gap} ulps from the JAX package's")
    return gap


def check_many_class_train(model, name: str, calls: List) -> Dict[str, Any]:
    """Hold one of the many-class trains (``tests/test_torch_many_classes.py``
    RUNS: the fused 26- and 64-class, the per-family 70-class, the 10-class
    boosting) to ``many_class/sweep.npz``: the same winner, the fold metrics
    by ``_check_many_folds``, the same number of fused calls and their
    metrics by ``_check_many_metrics``."""
    ref = load_sweep(os.path.join(MANY_CLASS, "sweep.npz"))
    summ = model.stages[-1].summary
    check(len(calls) == int(ref[f"{name}_calls"]),
          f"{name}: {len(calls)} fused sweep calls, the JAX package made "
          f"{int(ref[name + '_calls'])}")
    nv = ref[f"{name}_nv"][0] if f"{name}_nv" in ref else None
    metrics = None
    if calls:
        metrics = np.stack([np.asarray(c.cpu() if hasattr(c, "cpu") else c) for c in calls])
    found = _check_many_folds(summ, ref[f"{name}_folds"], ref[f"{name}_best"], nv, name)
    if metrics is not None:
        found["ulps"] = _check_many_metrics(metrics, ref[f"{name}_metrics"], summ, name)
    found["calls"] = len(calls)
    found["classes"] = len(summ.data_prep_results["labelsKept"])
    return found


def check_letters_answers(model, rows: Optional[int] = None) -> Dict[str, Any]:
    """Score ``letters_stock``'s requests with ``model`` (the JAX-saved
    26-class model loaded by the port) through ``BatchScoreFunction``: the
    same predictions, probabilities within ``IRIS_PROB_ATOL``."""
    from ..local.scoring import BatchScoreFunction

    cols = load_columns(os.path.join(LETTERS_STOCK, "requests.npz"))
    expected = load_expected(os.path.join(LETTERS_STOCK, "expected.npz"))
    name = model.result_features[0].name
    pred, prob, raw = multiclass_predictions(BatchScoreFunction(model)(records(cols)), name,
                                             expected["probability"].shape[1])
    check(np.array_equal(pred, expected["prediction"]), "letters predictions differ")
    gap = float(np.max(np.abs(prob - expected["probability"])))
    check(gap <= IRIS_PROB_ATOL, f"letters probabilities {gap} from the fixture's")
    return {"rows": len(pred), "prob_gap": gap,
            "raw_gap": float(np.max(np.abs(raw - expected["rawPrediction"])))}


def check_letters_train(model, metrics: np.ndarray) -> Dict[str, Any]:
    """Hold the full-width 26-class stock train at ``LETTERS_ROWS`` to
    ``letters_stock``: the same candidates and winner, the fold Errors and
    the fused call's metrics as ``check_many_class_train`` holds them, the
    same ``DataCutter`` summary."""
    with open(os.path.join(LETTERS_STOCK, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    summ = model.stages[-1].summary
    sweep = load_sweep(os.path.join(LETTERS_STOCK, "sweep.npz"))
    check([(r["modelName"], r["grid"]) for r in summ.validation_results]
          == [(r["modelName"], r["grid"]) for r in ref["validationResults"]],
          "letters candidates differ from the fixture's")
    ref_folds = np.array([r["foldMetrics"] for r in ref["validationResults"]], np.float64)
    best = [(r["modelName"], r["grid"]) for r in ref["validationResults"]].index(
        (ref["bestModelName"], ref["bestGrid"]))
    found = _check_many_folds(summ, ref_folds, best, None, "letters_stock")
    found["ulps"] = _check_many_metrics(metrics, sweep["metrics"], summ, "letters_stock")
    check(summ.data_prep_results == ref["dataPrepResults"], "letters DataCutter summary")
    return found


# ---------------------------------------------------------------------------
# the MLP and naive Bayes past their old widths, Word2Vec at 300 dimensions
# and LDA at 100 topics: three flows built in either package's DSL
# ---------------------------------------------------------------------------
LETTERS_FAMILIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "letters_families")
WIDE_TEXT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wide_text")
#: the Letter flow's MLP points: one narrow hidden layer, and two of width
#: 128 and 64 over 26 classes
LETTERS_MLP_GRID = ({"hidden_layers": (10,)}, {"hidden_layers": (128, 64)})
#: the wide text flows' widths: Word2Vec's dimensions, LDA's topics, the
#: count vectorizer's vocabulary ceiling, the embedding flow's MLP
WIDE_W2V_DIM = 300
WIDE_LDA_TOPICS = 100
WIDE_VOCAB = 8192
WIDE_MLP_HIDDEN = (128, 64, 32)
#: the wide text flows: "embed" (Word2Vec and LDA beside the Titanic
#: features, the binary stock space and the MLP) and "bow" (the count
#: vector itself and LDA over it, naive Bayes and the default MLP)
WIDE_FLOWS = ("embed", "bow")
#: the wide text fixture's scored rows: ``text_columns(n, seed)``
WIDE_TEXT_REQUESTS = 256
WIDE_TEXT_REQUEST_SEED = 5


def letters_families_space(nb, mlp, naive_bayes_grid):
    """The Letter flow's families space from either package's classes:
    naive Bayes over ``naive_bayes_grid()`` and the MLP at
    ``LETTERS_MLP_GRID`` (the per-family sweep: naive Bayes is not fused)."""
    return [(nb(), naive_bayes_grid()), (mlp(), [dict(g) for g in LETTERS_MLP_GRID])]


def port_letters_families_space():
    """``letters_families_space`` with the port's classes."""
    from ..impl.classification.mlp import OpMultilayerPerceptronClassifier
    from ..impl.classification.naive_bayes import OpNaiveBayes
    from ..impl.selector.defaults import naive_bayes_grid

    return letters_families_space(OpNaiveBayes, OpMultilayerPerceptronClassifier,
                                  naive_bayes_grid)


def wide_text_space(kind: str, selector, mlp, nb, naive_bayes_grid):
    """The space of a wide text flow from either package's classes: the
    binary selector's stock space and the MLP at ``WIDE_MLP_HIDDEN``
    ("embed"), or naive Bayes and the default MLP ("bow")."""
    if kind == "embed":
        return list(selector._default_models()) + [
            (mlp(), [{"hidden_layers": WIDE_MLP_HIDDEN}])]
    return [(nb(), naive_bayes_grid()), (mlp(), [{}])]


def wide_text_flow(kind: str, F, types, w2v, lda, selector, workflow, space):
    """(OpWorkflow, prediction feature) of a wide text flow over
    ``apps/titanic.text_columns``: the Titanic flow's features (as
    ``build_workflow``), and ``Notes`` tokenized, counted over at most
    ``WIDE_VOCAB`` terms and embedded by LDA at ``WIDE_LDA_TOPICS`` topics,
    beside Word2Vec at ``WIDE_W2V_DIM`` dimensions ("embed") or the count
    vector itself ("bow"); the sanity check and the binary selector (3-fold
    CV, seed 42) over ``space``.  ``F``, ``types``, ``w2v``, ``lda``,
    ``selector`` and ``workflow`` are one package's feature builder, types,
    stages, selector factory and workflow class."""
    survived = F("Survived", types.RealNN).extract(field="Survived").as_response()
    pclass = F("Pclass", types.PickList).extract(field="Pclass").as_predictor()
    name = F("Name", types.Text).extract(field="Name").as_predictor()
    sex = F("Sex", types.PickList).extract(field="Sex").as_predictor()
    age = F("Age", types.Real).extract(field="Age").as_predictor()
    sib_sp = F("SibSp", types.Integral).extract(field="SibSp").as_predictor()
    par_ch = F("Parch", types.Integral).extract(field="Parch").as_predictor()
    fare = F("Fare", types.Real).extract(field="Fare").as_predictor()
    embarked = F("Embarked", types.PickList).extract(field="Embarked").as_predictor()
    family_size = (sib_sp + par_ch + 1).alias("family_size")
    notes = F("Notes", types.Text).extract(field="Notes").as_predictor()
    tokens = notes.tokenize()
    counts = tokens.count_vectorize(vocab_size=WIDE_VOCAB)
    topics = lda(k=WIDE_LDA_TOPICS).set_input(counts).get_output()
    text = ([w2v(vector_size=WIDE_W2V_DIM).set_input(tokens).get_output(), topics]
            if kind == "embed" else [counts, topics])
    vectors = [sex.pivot(pclass, embarked, top_k=10, min_support=1),
               name.smart_vectorize(max_cardinality=10, num_hashes=64, min_support=1)] + text
    features = family_size.vectorize(age, fare, label=survived).combine(*vectors)
    checked = features.sanity_check(survived)
    pred = selector.with_cross_validation(num_folds=3, seed=42, models_and_parameters=space) \
        .set_input(survived, checked).get_output()
    return workflow().set_result_features(pred), pred


def port_wide_text_workflow(kind: str):
    """``wide_text_flow`` built from the port's classes."""
    from .. import types as T
    from ..features.builder import FeatureBuilder
    from ..impl.classification.mlp import OpMultilayerPerceptronClassifier
    from ..impl.classification.naive_bayes import OpNaiveBayes
    from ..impl.feature.embeddings import OpLDA, OpWord2Vec
    from ..impl.selector.defaults import naive_bayes_grid
    from ..impl.selector.factories import BinaryClassificationModelSelector
    from ..workflow.workflow import OpWorkflow

    space = wide_text_space(kind, BinaryClassificationModelSelector,
                            OpMultilayerPerceptronClassifier, OpNaiveBayes, naive_bayes_grid)
    return wide_text_flow(kind, FeatureBuilder, T, OpWord2Vec, OpLDA,
                          BinaryClassificationModelSelector, OpWorkflow, space)


#: fold Errors of the Letter families train against ``letters_families``:
#: naive Bayes bit-equal (integer attributes: every mass exact in both
#: packages); the MLP within one validation row of a fold (181 or 180 rows):
#: Adam's normalized step turns last-bit gradient differences into step
#: differences (``MLP_AUPR_TOL``), which can flip a row whose two top classes
#: lie within the drift (equal on the CPU at 1 and 4 threads)
LETTERS_FAMILIES_TOL = {"OpNaiveBayes": 0.0, "OpMultilayerPerceptronClassifier": 1.0 / 180}
#: fold AuPR of the wide text flows against ``wide_text``, by family: the
#: existing tolerances, unwidened (``TEXT_AUPR_TOL`` for the text trees,
#: ``NB_AUPR_TOL``, ``MLP_AUPR_TOL`` for the MLP's Adam drift).  The "embed"
#: flow exceeds two of them on the CPU, a standing gap (ROADMAP Queue 3 item
#: 4) that the JAX package shows against itself
#: (``tests/test_torch_wide_families.py --witness``): its LDA topic
#: mixtures (100 topics) move as far as the port's when only the order of
#: its float32 sums over the terms changes, and the forests move with them;
#: its (128, 64, 32) MLP moves past ``MLP_AUPR_TOL`` when one input entry
#: moves by one ulp (200 Adam steps diverge), and on the JAX package's own
#: inputs the port's MLP stays within that move.  "bow" holds them.
WIDE_TEXT_TOL = {**TEXT_AUPR_TOL, "OpNaiveBayes": NB_AUPR_TOL,
                 "OpMultilayerPerceptronClassifier": MLP_AUPR_TOL}
#: the one (flow, family) whose fold gap ``chip_smoke.py`` prints beside its
#: tolerance without failing: "embed"'s MLP, whose reference metrics move
#: past ``MLP_AUPR_TOL`` under a one-ulp change of one input (the card's
#: forests hold ``TEXT_AUPR_TOL``)
WIDE_TEXT_OPEN_GAP = ("embed", "OpMultilayerPerceptronClassifier")
#: probabilities of the fixture's 256 rows by the port's own text train
#: against the JAX package's: its winner's refit on features with those gaps
#: (the 64-dimension flow's ``TEXT_PROB_ATOL``; naive Bayes's refit moves by
#: its real columns' masses, ``FAMILIES_PROB_ATOL["a"]``)
WIDE_TEXT_PROB_ATOL = {"embed": TEXT_PROB_ATOL, "bow": FAMILIES_PROB_ATOL["a"]}


def same_winner(a, b) -> bool:
    """Whether two (model name, grid) winners are one, grids compared with
    their tuples as lists (a saved summary's JSON form)."""
    norm = lambda w: json.dumps([w[0], w[1]], sort_keys=True, default=list)  # noqa: E731
    return norm(a) == norm(b)


def fixture_gaps(model, ref_results, ref_best, tol: Dict[str, float], what: str
                 ) -> Dict[str, Any]:
    """A train's summary against a fixture's: the same candidates in order
    and the same winner (raised), and each family's largest fold-metric gap
    beside ``tol[family]``.  Returns the winner, the gaps, the tolerances
    and the families beyond them (``beyond``; not raised)."""
    summ = model.stages[-1].summary
    results = summ.validation_results
    check([r["modelName"] for r in results] == [r[0] for r in ref_results],
          f"{what}: candidates {[r['modelName'] for r in results]}")
    gaps: Dict[str, float] = {}
    for r, (name, _, folds) in zip(results, ref_results):
        g = float(np.abs(np.asarray(r["foldMetrics"], np.float64) - np.asarray(folds)).max())
        gaps[name] = max(gaps.get(name, 0.0), g)
    best = [summ.best_model_name, summ.best_grid]
    check(same_winner(best, ref_best), f"{what}: winner {best} differs from the fixture's "
                                       f"{ref_best}")
    return {"best": best, "max_gap": gaps, "tolerance": {f: tol[f] for f in gaps},
            "beyond": [fam for fam, g in gaps.items() if not g <= tol[fam]]}


def check_fixture_train(model, ref_results, ref_best, tol: Dict[str, float], what: str
                        ) -> Dict[str, Any]:
    """``fixture_gaps``, raised when a family's fold metrics are beyond its
    tolerance."""
    found = fixture_gaps(model, ref_results, ref_best, tol, what)
    check(not found["beyond"], f"{what}: " + "; ".join(
        f"{fam} fold metrics {found['max_gap'][fam]} from the fixture's, above {tol[fam]}"
        for fam in found["beyond"]))
    return found


def check_letters_families_train(model) -> Dict[str, Any]:
    """Hold a Letter families train (600 rows) to ``letters_families``
    (``check_fixture_train``)."""
    with open(os.path.join(LETTERS_FAMILIES, "op_model.json")) as fh:
        ref = stage_summary(json.load(fh))
    results = [[r["modelName"], r["grid"], r["foldMetrics"]] for r in ref["validationResults"]]
    return check_fixture_train(model, results, [ref["bestModelName"], ref["bestGrid"]],
                               LETTERS_FAMILIES_TOL, "letters_families")


def check_letters_families_answers(model) -> Dict[str, Any]:
    """The fixture's 256 Letter requests through ``BatchScoreFunction`` of
    ``model`` (the JAX-saved winner as the port loads it): predictions equal,
    probabilities within ``JAX_SAVED_PROB_ATOL``."""
    from ..local.scoring import BatchScoreFunction

    cols = load_columns(os.path.join(LETTERS_FAMILIES, "requests.npz"))
    exp = load_expected(os.path.join(LETTERS_FAMILIES, "expected.npz"))
    pred, prob, _ = multiclass_predictions(BatchScoreFunction(model)(records(cols)),
                                           model.result_features[0].name,
                                           exp["probability"].shape[1])
    gap = float(np.abs(prob - exp["probability"]).max())
    mism = int(np.sum(pred != exp["prediction"]))
    check(mism == 0 and gap <= JAX_SAVED_PROB_ATOL,
          f"letters_families answers: {mism} predictions differ, probabilities {gap}")
    return {"rows": len(pred), "prediction_mismatches": mism, "probability_max_abs_err": gap}


def wide_text_gaps(model, kind: str) -> Dict[str, Any]:
    """A wide text train (``kind`` "embed" or "bow", 891 rows) against
    ``wide_text``: the candidates and the winner (``fixture_gaps`` with
    ``WIDE_TEXT_TOL``), the vector's width, and its model's answers on the
    fixture's rows (predictions equal, probabilities within
    ``WIDE_TEXT_PROB_ATOL``), all raised; the fold gaps returned, with the
    families beyond their tolerance under ``beyond``."""
    from ..apps.titanic import text_columns
    from ..local.scoring import BatchScoreFunction

    with open(os.path.join(WIDE_TEXT, "trains.json")) as fh:
        ref = json.load(fh)[kind]
    found = fixture_gaps(model, ref["results"], ref["best"], WIDE_TEXT_TOL, f"wide_text {kind}")
    checker = _stage(model, "SanityCheckerModel")
    width = int(len(checker.indices_to_keep))
    check(width == ref["width"], f"wide_text {kind}: vector width {width}, not {ref['width']}")
    ans = np.load(os.path.join(WIDE_TEXT, "answers.npz"))
    req = records(text_columns(WIDE_TEXT_REQUESTS, WIDE_TEXT_REQUEST_SEED))
    pred, prob, _ = prediction_arrays(BatchScoreFunction(model)(req),
                                      model.result_features[0].name)
    mism = int(np.sum(pred != ans[f"{kind}_prediction"]))
    gap = float(np.abs(prob - ans[f"{kind}_probability"]).max())
    check(mism == 0 and gap <= WIDE_TEXT_PROB_ATOL[kind],
          f"wide_text {kind} answers: {mism} predictions differ, probabilities {gap}")
    return {**found, "width": width, "prediction_mismatches": mism,
            "probability_max_abs_err": gap}


def check_wide_text_train(model, kind: str) -> Dict[str, Any]:
    """``wide_text_gaps``, raised when a family's fold metrics are beyond
    its tolerance."""
    found = wide_text_gaps(model, kind)
    check(not found["beyond"], f"wide_text {kind}: " + "; ".join(
        f"{fam} fold metrics {found['max_gap'][fam]} from the fixture's, above "
        f"{WIDE_TEXT_TOL[fam]}" for fam in found["beyond"]))
    return found
