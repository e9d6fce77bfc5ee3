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

Strings with nulls are stored as a unicode array plus ``<name>__null``, so
the files load without pickles.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

TITANIC_XGB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_xgb")
TITANIC_STOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_stock")
BOSTON_STOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "boston_stock")
IRIS_STOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iris_stock")
IRIS_BOOST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iris_boost")
TITANIC_NEWTON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_newton")
BOSTON_RIDGE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "boston_ridge")
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
#: forests and GBT are not bit-equal on real targets: K-E sums w*g in fixed
#: point where XLA sums float32, so leaf values move in the last bits and a
#: near-tied split can flip (measured 4.3e-5 and 5.3e-5 on the CPU)
BOSTON_RMSE_RTOL = {"OpLinearRegression": 1e-5, "OpRandomForestRegressor": 2e-4,
                    "OpGBTRegressor": 2e-4}
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
#: margins summed in another order, and K-E's fixed-point histogram sums
#: move a leaf value in its last bits where XLA sums float32 (the port's
#: refit on the CPU: 198 of 200 trees equal, probabilities within 8.7e-8)
IRIS_BOOST_PROB_ATOL = 1e-5
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
