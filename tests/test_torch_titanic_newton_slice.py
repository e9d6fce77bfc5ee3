"""The Newton logistic fits in the Titanic workflow's binary selector, on the
port against the JAX package's, on the CPU.

``OpLogisticRegression`` fits every point without an L1 share (``reg_param
* elastic_net_param`` = 0, the default constructor's among them) by
full-batch Newton (the sweep's "newton" fragment and the refit's
``fit_logistic_newton``: ``min(max(max_iter // 4, 10), 50)`` steps, each a
weighted Gram from K-S and a batched solve).  Two trains of the Titanic
flow (``transmogrifai_tpu_torch/apps/titanic.py``) through
``models_and_parameters`` with ``OpLogisticRegression(max_iter=50)`` (12
Newton steps):

- the mixed grid ``reg_param`` {0, 0.001, 0.01, 0.1, 0.2} x
  ``elastic_net_param`` {0, 0.1}: six Newton points (the five at 0 and {0,
  0.1}) and four FISTA points in one fused sweep per workflow-level fold;
  the winner is FISTA {0.001, 0.1};
- the five Newton points alone, whose winner {0.2, 0} leads {0.1, 0} by
  1.3e-6 of mean AuPR and refits by Newton.

Both are held to the committed fixture
``transmogrifai_tpu_torch/fixtures/titanic_newton/`` by
``FX.check_titanic_newton_train``: the same winner, each Newton fold AuPR
with reg > 0 within ``FX.NEWTON_AUPR_TOL`` and each FISTA one within
``FX.LR_AUPR_TOL``.  At reg 0 the gap is stated, not closed: the Hessian
of Titanic's one-hot pivots and the intercept is singular but for the
1e-8 ridge, and the reference's fit breaks down (every score NaN, AuPR 0.0,
AuROC 0.5) on two of the three folds, where its float32 rounding tips a
near-zero pivot; which folds break down changes with the compiled program
(a fit of the same data alone breaks down on another fold).  The port's
Gram is summed in float64 and rounded once, and its fits stay finite
there; each such fold must be the reference's 0.0 or finite, and the
candidate's mean below the winner's.  The metrics of NaN scores equal the
reference's (``tests/test_torch_newton_ridge.py``).

Regenerate the fixture with ``python tests/test_torch_titanic_newton_slice.py
--write`` (trains with the JAX package on the CPU, about ten seconds).
"""
import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "helloworld"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.impl import sweep_fragments as JSF
from transmogrifai_tpu.impl.classification import logistic as JLo
from transmogrifai_tpu.impl.selector import defaults as JD

import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import fixtures as FX
from transmogrifai_tpu_torch.apps import titanic as PTitanic
from transmogrifai_tpu_torch.impl import sweep_fragments as PSF
from transmogrifai_tpu_torch.impl.classification import logistic as PLo
from transmogrifai_tpu_torch.impl.selector import defaults as PD

torch.set_num_threads(1)

FIXTURE = FX.TITANIC_NEWTON
REGS = [0.0, 0.001, 0.01, 0.1, 0.2]


def space(pkg, mixed):
    Lo, D = (JLo, JD) if pkg == "jax" else (PLo, PD)
    return [(Lo.OpLogisticRegression(max_iter=50),
             D.grid(reg_param=REGS, elastic_net_param=[0.0, 0.1] if mixed else [0.0]))]


def recorded(module, train, *args):
    """(train(*args), the metrics [calls, F, C, M] of its fused-sweep calls,
    their specs)."""
    calls, specs = [], []
    run = module.SweepPlan.run

    def recording_run(self, *a, **k):
        out = run(self, *a, **k)
        calls.append(np.asarray(out))
        specs.append(self.spec)
        return out

    module.SweepPlan.run = recording_run
    try:
        out = train(*args)
    finally:
        module.SweepPlan.run = run
    return out, np.stack(calls), specs


def jax_train(models):
    from test_torch_fixture import build_titanic
    from titanic import titanic_data

    return build_titanic(None, models).set_input_dataset(titanic_data(),
                                                         key="PassengerId").train()


def port_train(models):
    return PTitanic.train_titanic(device="cpu", models_and_parameters=models)[0]


def write_fixture(path=FIXTURE, seed=0):
    import tempfile

    from test_torch_fixture import make_requests
    from test_torch_stock_slice import lr_answers

    mixed, mixed_metrics, _ = recorded(JSF, jax_train, space("jax", True))
    model, metrics, _ = recorded(JSF, jax_train, space("jax", False))
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        os.makedirs(path, exist_ok=True)
        for f in ("op_model.json", "op_model_arrays.npz"):
            shutil.copy(os.path.join(tmp, f), os.path.join(path, f))
    summ = mixed.stages[-1].summary
    best = [(r["modelName"], r["grid"]) for r in summ.validation_results].index(
        (summ.best_model_name, summ.best_grid))
    np.savez_compressed(os.path.join(path, "sweep.npz"), metrics=metrics,
                        mixed_metrics=mixed_metrics, mixed_best=np.int64(best))
    model = J.OpWorkflowModel.load(path)
    cols = make_requests(model, seed=seed)
    FX.save_columns(os.path.join(path, "requests.npz"), cols)
    np.savez_compressed(os.path.join(path, "expected.npz"), **lr_answers(model, cols))


def _summary():
    with open(os.path.join(FIXTURE, "op_model.json")) as fh:
        return FX.stage_summary(json.load(fh))


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------
def test_fixture_holds_both_newton_trains():
    summ = _summary()
    assert summ["bestModelName"] == "OpLogisticRegression"
    assert summ["bestGrid"] == {"reg_param": 0.2, "elastic_net_param": 0.0}
    assert [r["grid"] for r in summ["validationResults"]] == \
        JD.grid(reg_param=REGS, elastic_net_param=[0.0])
    sweep = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))
    assert sweep["metrics"].shape == (3, 1, 5, 6)
    assert sweep["mixed_metrics"].shape == (3, 1, 10, 6)
    folds = np.array([r["foldMetrics"] for r in summ["validationResults"]], np.float32)
    np.testing.assert_array_equal(FX._titanic_folds(sweep["metrics"]), folds)
    means = folds.astype(np.float64).mean(1)
    # the winner leads the runner-up by about 1.3e-6 of mean AuPR
    assert 1e-7 < means[4] - means[3] < 2e-6
    # the mixed grid: FISTA {0.001, 0.1} wins
    assert int(sweep["mixed_best"]) == 3
    # the reference's reg-0 Newton fits break down (AuPR 0.0) on some folds
    mixed = FX._titanic_folds(sweep["mixed_metrics"])
    assert (mixed[:2] == 0.0).any() and (mixed[2:] > 0.9).all()


def test_jax_reproduces_the_fixture_answers():
    from test_torch_stock_slice import lr_answers

    model = J.OpWorkflowModel.load(FIXTURE)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    got = lr_answers(model, cols)
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    for k, v in expected.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_scores_the_fixture_model():
    model = P.load_model(FIXTURE, device="cpu")
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    name = model.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(P.BatchScoreFunction(model)(FX.records(cols)), name)
    FX.compare(FX.load_expected(os.path.join(FIXTURE, "expected.npz")), pred, prob, raw)


# ---------------------------------------------------------------------------
# the trains, against the fixture
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def newton(tmp_path_factory):
    model, metrics, specs = recorded(PSF, port_train, space("port", False))
    tmp = tmp_path_factory.mktemp("titanic_newton")
    model.save(str(tmp))
    return model, metrics, specs, str(tmp)


def test_newton_train_matches_the_fixture(newton):
    model, metrics, specs, _ = newton
    found = FX.check_titanic_newton_train(model, mixed=False)
    assert found["best_grid"] == {"reg_param": 0.2, "elastic_net_param": 0.0}
    ref = FX.load_sweep(os.path.join(FIXTURE, "sweep.npz"))["metrics"]
    assert metrics.shape == ref.shape
    # the reg > 0 points' every metric: AuROC and AuPR within the tolerance,
    # the thresholded counts' metrics equal
    np.testing.assert_allclose(metrics[:, :, 1:, :2], ref[:, :, 1:, :2], rtol=0,
                               atol=FX.NEWTON_AUPR_TOL)
    np.testing.assert_array_equal(metrics[:, :, 1:, 2:], ref[:, :, 1:, 2:])
    # each call's spec: one "newton" fragment of 12 steps
    assert all(sp[1] == (("newton", (0, 1, 2, 3, 4), 12, True, 0),) for sp in specs)
    assert model.stages[-1].summary.holdout_evaluation["AuPR"] > 0.9


def test_newton_refit_scores_like_the_fixture_in_both_packages(newton):
    model, _, _, port_dir = newton
    mine = model.stages[-1].model_params
    theirs = J.OpWorkflowModel.load(FIXTURE).stages[-1].model_params
    np.testing.assert_allclose(mine["coef"], theirs["coef"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mine["intercept"], theirs["intercept"], rtol=1e-5, atol=1e-6)
    cols = FX.load_columns(os.path.join(FIXTURE, "requests.npz"))
    expected = FX.load_expected(os.path.join(FIXTURE, "expected.npz"))
    loaded = P.load_model(port_dir, device="cpu")
    name = loaded.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(P.BatchScoreFunction(loaded)(FX.records(cols)), name)
    np.testing.assert_allclose(prob, expected["probability"], rtol=0, atol=FX.NEWTON_PROB_ATOL)
    jl = J.OpWorkflowModel.load(port_dir)
    jp = jl.score(pd.DataFrame(cols))[jl.result_features[0].name]
    np.testing.assert_allclose(jp.probability, expected["probability"], rtol=0,
                               atol=FX.NEWTON_PROB_ATOL)
    np.testing.assert_array_equal(jp.prediction, pred)


def test_mixed_newton_and_fista_train_matches_the_fixture():
    model, metrics, specs = recorded(PSF, port_train, space("port", True))
    found = FX.check_titanic_newton_train(model, mixed=True)
    assert found["best_grid"] == {"reg_param": 0.001, "elastic_net_param": 0.1}
    assert len(found["reg0_folds"]) == 2 and metrics.shape == (3, 1, 10, 6)
    # six Newton points (l1 = 0) and four FISTA points, as the JAX package splits them
    frags = specs[0][1]
    assert [f[0] for f in frags] == ["newton", "fista"]
    assert frags[0][1] == (0, 1, 2, 4, 6, 8) and frags[1][1] == (3, 5, 7, 9)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the fixture")
    ap.add_argument("--seed", type=int, default=0, help="seed of the request records")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do: pass --write")
    write_fixture(seed=args.seed)
    print(f"wrote {FIXTURE}")
