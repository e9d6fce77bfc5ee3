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
``tests/test_torch_stock_slice.py --write`` regenerates it.  The answers
travel as data because the machine with the card has no JAX.

Strings with nulls are stored as a unicode array plus ``<name>__null``, so
the files load without pickles.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

TITANIC_XGB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_xgb")
TITANIC_STOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "titanic_stock")
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
